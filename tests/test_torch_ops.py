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
