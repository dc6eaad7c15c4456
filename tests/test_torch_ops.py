"""PyTorch port vs JAX package: basic ops, RoPE, and the plain versions of
the K1/K4/K5 kernels against the Pallas kernels run in interpret mode.

Inputs come from numpy seeds and go to both sides. fp32 cases use tight
tolerances (the two sides differ only in fp32 summation order and in the
last bits of exp2/rsqrt); bf16 cases allow about one bf16 ULP (2^-8
relative), since one rounding point can flip either way when the fp32
values before it differ in their last bits.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.ops.basic as jb
import video_styler_tpu.ops.flash_attention as jfa
import video_styler_tpu.ops.fused_norm_rope as jfnr
from video_styler_tpu.ops.attention import attention as j_attention, sdpa as j_sdpa
from video_styler_tpu.ops import rope as jrope

from video_styler_tpu_torch.ops import attention as tatt
from video_styler_tpu_torch.ops import basic as tb
from video_styler_tpu_torch.ops import flash_attention as tfa
from video_styler_tpu_torch.ops import fused_norm_rope as tfnr
from video_styler_tpu_torch.ops import rope as trope

from test_torch_pipeline import cpu_share  # noqa: F401

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(rtol=2e-5, atol=2e-6), "bf16": dict(rtol=1e-2, atol=1e-2)}


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _both(a, which):
    """numpy fp32 -> (jax array, torch tensor) in the case's dtype."""
    _, jd, td = DTYPES[which]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, which, **override):
    tol = dict(TOL[which], **override)
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _interp(monkeypatch, module):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module.pl, "pallas_call", interp_call)


# --------------------------------------------------------------------------
# ops/basic.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_linear_and_norms(which):
    x = _rand(0, (2, 7, 64))
    w = _rand(1, (64, 48), 0.125)
    b = _rand(2, (48,), 0.1)
    g = 1.0 + _rand(3, (64,), 0.1)
    beta = _rand(4, (64,), 0.1)
    jx, tx = _both(x, which)
    jw, tw = _both(w, which)
    jbias, tbias = _both(b, which)
    jg, tg = _both(g, which)
    jbeta, tbeta = _both(beta, which)
    _close(tb.linear(tx, tw.T, tbias), jb.linear({"w": jw, "b": jbias}, jx), which)
    _close(tb.layer_norm(tx, tg, tbeta, 1e-6),
           jb.layer_norm({"scale": jg, "bias": jbeta}, jx, 1e-6), which)
    _close(tb.layer_norm(tx, eps=1e-6), jb.layer_norm({}, jx, 1e-6), which)
    _close(tb.rms_norm(tx, tg, 1e-6), jb.rms_norm({"scale": jg}, jx, 1e-6), which)
    _close(tb.t5_layer_norm(tx, tg), jb.t5_layer_norm({"scale": jg}, jx), which)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_elementwise(which):
    x = _rand(5, (3, 50), 2.0)
    s = _rand(6, (3, 50), 0.3)
    t = _rand(7, (3, 50), 0.3)
    jx, tx = _both(x, which)
    js, ts = _both(s, which)
    jt, tt = _both(t, which)
    _close(tb.gelu_tanh(tx), jb.gelu_tanh(jx), which)
    _close(tb.modulate(tx, ts, tt), jb.modulate(jx, js, jt), which)
    _close(tb.silu(tx), jb.silu(jx), which)


def test_sinusoidal_embedding_is_float32():
    pos = np.array([0.0, 1.5, 999.0, 731.25], np.float32)
    got = tb.sinusoidal_embedding_1d(256, torch.from_numpy(pos))
    want = jb.sinusoidal_embedding_1d(256, jnp.asarray(pos))
    assert got.dtype == torch.float32
    # float32 on both sides; torch's and XLA's cos/sin of arguments up to
    # ~1000 rad differ by a few fp32 ULPs of the argument
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


# --------------------------------------------------------------------------
# ops/rope.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rope_indices", [None, np.array([0, 3, 3, 7])])
def test_rope_tables_and_apply(rope_indices):
    for a, b in zip(trope.precompute_freqs_3d(128), jrope.precompute_freqs_3d(128)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    f = 4 if rope_indices is None else len(rope_indices)
    cos_t, sin_t = trope.assemble_freqs_grid(128, f, 3, 5, rope_indices)
    cos_j, sin_j = jrope.assemble_freqs_grid(128, f, 3, 5, rope_indices)
    assert cos_t.shape == (f * 15, 64) and cos_t.dtype == torch.float32
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    x = _rand(8, (2, f * 15, 2, 128))
    _close(trope.rope_apply(torch.from_numpy(x), cos_t, sin_t),
           jrope.rope_apply(jnp.asarray(x), cos_j, sin_j), "fp32")


# --------------------------------------------------------------------------
# K1: capped-softmax flash attention
# --------------------------------------------------------------------------

K1_CASES = {
    "self": (256, 256, 1.0),
    "cross": (300, 512, 1.0),
    "ragged": (200, 333, 1.0),
    "large_magnitude": (256, 300, 24.0),
}


@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_matches_pallas_interpret(monkeypatch, case, which):
    _interp(monkeypatch, jfa)
    sq, sk, mag = K1_CASES[case]
    q = _rand(10, (1, sq, 2, 128), mag)
    k = _rand(11, (1, sk, 2, 128))
    v = _rand(12, (1, sk, 2, 128))
    jq, tq = _both(q, which)
    jk, tk = _both(k, which)
    jv, tv = _both(v, which)
    scale = 1.0 / np.sqrt(128)
    want = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128, block_k=128,
                             capped=True)
    got = tfa.flash_attention_plain(tq, tk, tv, scale)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    # fp32: the two sides differ in fp32 sum order and exp2's last bits
    _close(got, want, which, **({"rtol": 1e-4, "atol": 1e-5} if which == "fp32" else {}))


def test_k1_plain_chunking_and_exact_softmax():
    """Row chunks give the same rows; the capped softmax equals the exact
    softmax (sdpa) in fp32."""
    q = torch.from_numpy(_rand(13, (2, 97, 3, 128)))
    k = torch.from_numpy(_rand(14, (2, 61, 3, 128)))
    v = torch.from_numpy(_rand(15, (2, 61, 3, 128)))
    whole = tfa.flash_attention_plain(q, k, v)
    chunked = tfa.flash_attention_plain(q, k, v, max_elements=2 * 3 * 61 * 10)
    # the CPU GEMM blocks differently per chunk shape: last-bit differences
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(whole, tatt.sdpa(q, k, v), rtol=1e-4, atol=1e-5)


def test_sdpa_and_attention_dispatch_match_jax():
    q = _rand(16, (1, 40, 2, 128))
    k = _rand(17, (1, 52, 2, 128))
    v = _rand(18, (1, 52, 2, 128))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(tatt.sdpa(tq, tk, tv), j_sdpa(jq, jk, jv), "fp32")
    before = tfa.KERNEL.launches
    got = tatt.attention(tq, tk, tv, kv_valid=45)
    want = j_attention(jq, jk, jv, kv_valid=45)
    _close(got, want, "fp32", rtol=1e-4, atol=1e-5)
    assert tfa.KERNEL.launches == before  # CPU tensors take the plain version


# --------------------------------------------------------------------------
# K4 / K5: fused RMSNorm + RoPE, RMSNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("rope_indices", [None, np.array([1, 1, 4])])
def test_k4_k5_plain_match_pallas_interpret(monkeypatch, which, rope_indices):
    _interp(monkeypatch, jfnr)
    f, h, w, n, d = 3, 6, 10, 2, 128
    s = f * h * w
    q = _rand(20, (1, s, n * d))
    k = _rand(21, (1, s, n * d), 0.7)
    wq = 1.0 + _rand(22, (n * d,), 0.1)
    wk = 1.0 + _rand(23, (n * d,), 0.1)
    jq, tq = _both(q, which)
    jk, tk = _both(k, which)
    jwq, twq = _both(wq, which)
    jwk, twk = _both(wk, which)
    cos_j, sin_j = jrope.assemble_freqs_grid(d, f, h, w, rope_indices)
    cos_t, sin_t = trope.assemble_freqs_grid(d, f, h, w, rope_indices)
    oq_j, ok_j = jfnr._fused_fwd(jq, jk, jwq, jwk, cos_j, sin_j, 1e-6)
    oq_t, ok_t = tfnr.fused_rmsnorm_rope(tq, tk, twq, twk, cos_t, sin_t, 1e-6)
    assert oq_t.shape == (1, s, n, d)
    _close(oq_t, oq_j, which)
    _close(ok_t, ok_j, which)
    _close(tfnr.fused_rmsnorm(tq, twq, 1e-6), jfnr._rms_fwd(jq, jwq, 1e-6), which)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_k5_plain_matches_pallas_interpret_at_ditto_width(monkeypatch, which):
    """K5 at the 14B width (Dm = 5120, which the kernel holds in registers,
    20 chunks of 16 bytes a lane) on 37 rows: not a whole number of the
    kernel's 4-row blocks nor of the Pallas call's 8-row blocks (which pads)."""
    _interp(monkeypatch, jfnr)
    x = _rand(24, (1, 37, 5120))
    w = 1.0 + _rand(25, (5120,), 0.1)
    jx, tx = _both(x, which)
    jw, tw = _both(w, which)
    got = tfnr.fused_rmsnorm(tx, tw, 1e-6)
    assert got.shape == (1, 37, 5120) and got.dtype == tx.dtype
    _close(got, jfnr._rms_fwd(jx, jw, 1e-6), which)


# --------------------------------------------------------------------------
# K1 stats and K3: the flash backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["self", "ragged", "large_magnitude"])
def test_k1_plain_stats_match_pallas_interpret(monkeypatch, case, which):
    """L2 = m2 + log2 l, the backward's residual, against the Pallas kernel's
    stats output."""
    _interp(monkeypatch, jfa)
    sq, sk, mag = K1_CASES[case]
    jq, tq = _both(_rand(30, (1, sq, 2, 128), mag), which)
    jk, tk = _both(_rand(31, (1, sk, 2, 128)), which)
    jv, tv = _both(_rand(32, (1, sk, 2, 128)), which)
    scale = 1.0 / np.sqrt(128)
    want_o, want_l2 = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128,
                                        block_k=128, capped=True, return_stats=True)
    got_o, got_l2 = tfa.flash_attention_plain(tq, tk, tv, scale, return_stats=True)
    assert got_l2.dtype == torch.float32 and got_l2.shape == (1, 2, sq)
    _close(got_o, want_o, which, **({"rtol": 1e-4, "atol": 1e-5} if which == "fp32" else {}))
    # L2 is fp32 on both sides (m2 from the same rounded q; l summed in
    # another order): a few fp32 ULPs of |L2| <= 96
    np.testing.assert_allclose(got_l2.numpy(), np.asarray(want_l2), rtol=1e-5, atol=1e-4)


K3_CASES = {"ragged": (300, 520, 1.0), "cross": (300, 40, 1.0),
            "large_magnitude": (200, 257, 8.0)}


def _k3_inputs(case, which, seed=40):
    sq, sk, mag = K3_CASES[case]
    arrays = [_rand(seed, (1, sq, 2, 128), mag), _rand(seed + 1, (1, sk, 2, 128)),
              _rand(seed + 2, (1, sk, 2, 128)), _rand(seed + 3, (1, sq, 2, 128))]
    js, ts = zip(*(_both(a, which) for a in arrays))
    return js, ts


@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_plain_matches_pallas_interpret(monkeypatch, case, which):
    """dq, dk, dv from the same o and L2 against `_fa_bwd_pallas` run in
    interpret mode (the dkv and dq Pallas kernels)."""
    _interp(monkeypatch, jfa)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _k3_inputs(case, which)
    scale = 1.0 / np.sqrt(128)
    to, tl2 = tfa.flash_attention_plain(tq, tk, tv, scale, return_stats=True)
    jo, jl2 = _both(_np(to), which)[0], jnp.asarray(tl2.numpy())
    want = jfa._fa_bwd_pallas(jq, jk, jv, jo, jl2, jg, scale, block_q=128, block_k=128)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, to, tl2, tg, scale)
    for name, t, j in zip("qkv", got, want):
        assert t.dtype == tq.dtype and t.shape == j.shape, name
        # fp32: other summation orders over up to 520 terms; bf16: one
        # dS rounding can flip, moving a sum by about one bf16 ULP of a term
        _close(t, j, which, **({"rtol": 1e-4, "atol": 1e-5} if which == "fp32"
                               else {"rtol": 2e-2, "atol": 2e-2}))


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_plain_matches_exact_softmax_autograd(case):
    """In fp32 the capped forward is the exact softmax, so K3's plain
    version equals autograd through `sdpa`; its row chunks change nothing."""
    _, (tq, tk, tv, tg) = _k3_inputs(case, "fp32", seed=50)
    o, l2 = tfa.flash_attention_plain(tq, tk, tv, return_stats=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, l2, tg)
    chunked = tfa.flash_attention_bwd_plain(tq, tk, tv, o, l2, tg,
                                            max_elements=2 * tk.shape[1] * 7)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    want = torch.autograd.grad(tatt.sdpa(*ins), ins, tg)
    for t, c, w in zip(got, chunked, want):
        # P = exp2(s2 - L2) with |L2| up to ~53 here: the subtraction keeps
        # about 2^-24 * |L2| of the exponent, so the error scales with the
        # gradient's largest magnitude, not elementwise
        err = (t - w).abs().max().item()
        assert err <= 2e-5 * w.abs().max().item(), err
        # chunks reorder the fp32 sums of dK and dV, and the CPU GEMM blocks
        # each chunk shape differently (last-bit differences in s2)
        assert (c - t).abs().max().item() <= 4e-6 * t.abs().max().item()


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_autograd_functions_match_plain_compositions(which):
    """The K1/K4/K5 autograd Functions (kernel forward, K3 or recompute
    backward; plain versions on CPU) against autograd through the plain
    compositions, and the dispatch: no Function without grad."""
    td = DTYPES[which][2]
    tol = TOL[which]
    # K1 + K3: the dispatch through `attention`, cross-shaped with kv_valid
    q, k, v, g = (torch.from_numpy(_rand(60 + i, s)).to(td) for i, s in enumerate(
        [(1, 70, 2, 128), (1, 50, 2, 128), (1, 50, 2, 128), (1, 70, 2, 128)]))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tatt.attention(*ins, kv_valid=45)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tfa.flash_attention_plain(ref_ins[0], ref_ins[1][:, :45], ref_ins[2][:, :45])
    want = torch.autograd.grad(ref, ref_ins, g)
    for t, w in zip(got, want):
        assert t.dtype == td
        # bf16: the plain composition's autograd rounds P and dS at other points
        _close(t, w, which, **({"rtol": 1e-4, "atol": 1e-5} if which == "fp32"
                               else {"rtol": 5e-2, "atol": 5e-2}))
    assert torch.all(got[1][:, 45:] == 0) and torch.all(got[2][:, 45:] == 0)
    with torch.no_grad():
        assert tatt.attention(*ins).grad_fn is None

    # K4 and K5
    f, h, w, n, d = 2, 3, 5, 2, 128
    s = f * h * w
    xq, xk = (torch.from_numpy(_rand(70 + i, (1, s, n * d))).to(td) for i in range(2))
    wq, wk = (torch.from_numpy(1.0 + _rand(72 + i, (n * d,), 0.1)).to(td) for i in range(2))
    gq, gk = (torch.from_numpy(_rand(74 + i, (1, s, n, d))).to(td) for i in range(2))
    cos, sin = trope.assemble_freqs_grid(d, f, h, w)
    for fn, plain, args, cot in (
            (tfnr.fused_rmsnorm_rope, tfnr.fused_rmsnorm_rope_plain,
             (xq, xk, wq, wk), (gq, gk)),
            (tfnr.fused_rmsnorm, tfnr.fused_rmsnorm_plain, (xq, wq),
             (gq.reshape(1, s, n * d),))):
        a = [t.clone().requires_grad_() for t in args]
        consts = (cos, sin) if len(args) == 4 else ()
        outs = fn(*a, *consts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert "Function" in type(outs[0].grad_fn).__name__
        got = torch.autograd.grad(outs, a, cot)
        b = [t.clone().requires_grad_() for t in args]
        refs = plain(*b, *consts)
        want = torch.autograd.grad(refs if isinstance(refs, tuple) else (refs,), b, cot)
        for t, w_ in zip(got, want):
            _close(t, w_, which, **tol)
