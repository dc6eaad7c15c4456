"""PyTorch port vs JAX package: the online-softmax attention route (K2, its
3-D twin, K8) and the int8 attention (K6 capped/online, K7).

The port's plain versions (what a CPU tensor takes) are held against the
Pallas kernels run in interpret mode on the same numpy inputs. fp32 cases
are tight: the two sides differ in fp32 summation order, in the tiling of
the running max and in exp2's last bits. bf16 cases allow about a bf16 ULP
of the output.

The int8 functions return bfloat16-rounded values on both sides, from the
same integers. Two fp32 results that differ in their last bits can round to
neighbouring bfloat16 values (of an output, or of one p, which moves a whole
output row a little), so those tests allow one bf16 ULP (at most 2^-7
relative) on any element, 1e-3 of the largest output on elements near zero
(sums that cancel), and require that at most 1% of the elements differ at
all.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import importlib

import video_styler_tpu.ops.flash_attention as jfa

# `video_styler_tpu.ops` exports a function of the same name as this module
jatt = importlib.import_module("video_styler_tpu.ops.attention")

from video_styler_tpu_torch.ops import attention as tatt
from video_styler_tpu_torch.ops import flash_attention as tfa

from test_torch_pipeline import cpu_share  # noqa: F401

JD = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grid(seed, shape, offset=0.0):
    """Normal draws on a grid of 1/64: sums of a few hundred of them are
    exact in fp32, so a mean does not depend on the order of its sum."""
    return (np.round(_rand(seed, shape) * 64) / 64 + offset).astype(np.float32)


def _both(a, which="fp32"):
    return jnp.asarray(a, JD[which]), torch.from_numpy(a).to(TD[which])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture
def interp(monkeypatch):
    """Run `pl.pallas_call` of the JAX flash module in interpret mode."""
    orig = jfa.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", interp_call)


@pytest.fixture
def float_attention():
    """The process-wide int8-attention flags, reset whatever the test does."""
    yield
    tatt.set_quantized_attention(False)
    jatt.set_quantized_attention(False)


def _tol(case):
    """fp32 tolerance of a case: logits of magnitude m carry an fp32 rounding
    error of about 2^-24 m, which exp2 turns into a relative error of p."""
    mag = CASES[case][4]
    return dict(rtol=1e-4, atol=1e-5 * max(1.0, mag))


def _qkv(case, which="fp32", seed=0):
    sq, sk, n, d, mag = case
    return [_both(a, which) for a in (_rand(seed, (2, sq, n, d), mag),
                                      _rand(seed + 1, (2, sk, n, d)),
                                      _rand(seed + 2, (2, sk, n, d)))]


# (Sq, Sk, heads, head dim, q magnitude)
CASES = {
    "self": (256, 256, 3, 32, 1.0),
    "ragged": (300, 520, 3, 32, 1.0),
    "cross_d128": (200, 77, 2, 128, 1.0),
    "large_magnitude": (130, 333, 2, 128, 24.0),
}


# --------------------------------------------------------------------------
# K2 and K8: the online softmax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dual", [False, True], ids=["k2", "k8"])
@pytest.mark.parametrize("case", list(CASES))
def test_online_plain_matches_pallas_interpret(interp, case, dual):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(CASES[case])
    scale = 1.0 / np.sqrt(tq.shape[-1])
    want = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128, block_k=128,
                             capped=False, dual=dual)
    got = tfa.flash_attention(tq, tk, tv, scale, capped=False, dual=dual)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(case))
    # the exact softmax: equal to sdpa as well
    np.testing.assert_allclose(_np(got), _np(tatt.sdpa(tq, tk, tv, scale)),
                               **_tol(case))


@pytest.mark.parametrize("dual", [False, True], ids=["k2", "k8"])
def test_online_plain_bf16_matches_pallas_interpret(interp, dual):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(CASES["cross_d128"], "bf16")
    scale = 1.0 / np.sqrt(128)
    want = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128, block_k=128,
                             capped=False, dual=dual)
    got = tfa.flash_attention(tq, tk, tv, scale, capped=False, dual=dual)
    assert got.dtype == torch.bfloat16
    # the same tiling on both sides (steps of 128 keys; dual 2 x 128), so p
    # meets the same running maxima; exp2 and the fp32 sums differ in their
    # last bits, which can move a bf16 rounding of p or of the output
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bf16"])


@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("sk,block_k", [(300, 128), (200, 256)],
                         ids=["port_step_256", "jax_step_512"])
def test_k8_empty_second_sub_tile_matches_pallas_interpret(interp, sk, block_k, which):
    """A last dual step whose second sub-tile holds no real key: Sk = 300
    under steps of 2 x 128 keys (the port's K8 and the Pallas call alike:
    keys 384..511 of the second step), and Sk = 200 under a Pallas step of
    2 x 256 (the port's second sub-tile holds 72 keys there). Those logits
    count as -1e30 on both sides, so their p are 0."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((130, sk, 2, 128, 1.0), which, seed=5)
    scale = 1.0 / np.sqrt(128)
    want = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128, block_k=block_k,
                             capped=False, dual=True)
    got = tfa.flash_attention(tq, tk, tv, scale, capped=False, dual=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL["bf16"] if which == "bf16" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # and the single-tile route on the same inputs: the same exact softmax
    np.testing.assert_allclose(_np(got), _np(tfa.flash_attention_online_plain(tq, tk, tv, scale)),
                               **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_k2_stats_match_pallas_interpret(interp, case):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(CASES[case], seed=10)
    scale = 1.0 / np.sqrt(tq.shape[-1])
    want_o, want_l2 = jfa._flash_fwd_4d(jq, jk, jv, scale, block_q=128, block_k=128,
                                        capped=False, return_stats=True)
    got_o, got_l2 = tfa.flash_attention_online_plain(tq, tk, tv, scale,
                                                     return_stats=True)
    assert got_l2.dtype == torch.float32 and got_l2.shape == want_l2.shape
    np.testing.assert_allclose(_np(got_o), _np(want_o), **_tol(case))
    # L2 = m + log2 l in fp32 on both sides, |L2| up to a few hundred here
    np.testing.assert_allclose(got_l2.numpy(), np.asarray(want_l2), rtol=1e-5, atol=1e-4)
    # the capped route's L2 is the same quantity
    _, capped_l2 = tfa.flash_attention_plain(tq, tk, tv, scale, return_stats=True)
    if CASES[case][4] == 1.0:
        np.testing.assert_allclose(got_l2.numpy(), capped_l2.numpy(), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        tfa.flash_attention_online_plain(tq, tk, tv, scale, dual=True, return_stats=True)


@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 520)])
def test_k2_3d_entry_matches_pallas_interpret(interp, sq, sk):
    q, k, v = _rand(20, (4, sq, 32)), _rand(21, (4, sk, 32)), _rand(22, (4, sk, 32))
    scale = 1.0 / np.sqrt(32)
    want = jfa._flash_fwd_3d(*(jnp.asarray(a) for a in (q, k, v)), scale,
                             block_q=128, block_k=128)
    got = tfa.flash_attention_3d(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert got.shape == (4, sq, 32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["fp32"])


def test_online_route_gradients_match_jax(interp, monkeypatch):
    """`flash_attention` under FLASH_CAPPED=0 and autograd (K2 with stats,
    then K3; here their plain versions) against jax.grad of `_flash_4d`."""
    monkeypatch.setenv("FLASH_CAPPED", "0")
    (jq, tq), (jk, tk), (jv, tv) = _qkv((128, 160, 2, 32, 1.0), seed=30)
    g = _rand(33, (2, 128, 2, 32))
    scale = 1.0 / np.sqrt(32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa._flash_4d(q, k, v, scale) * g),
                    argnums=(0, 1, 2))(jq, jk, jv)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_attention(*ins, scale)
    assert isinstance(out.grad_fn, tfa.FlashAttentionFunction._backward_cls)
    # the forward that ran was the online one: its L2 is K2's
    l2 = out.grad_fn.saved_tensors[4]
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for t, j in zip(got, want):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-5)
    _, want_l2 = tfa.flash_attention_online_plain(tq, tk, tv, scale, return_stats=True)
    assert torch.equal(l2, want_l2)


def test_3d_entry_gradients_match_jax(interp):
    q, k, v = _rand(40, (3, 128, 32)), _rand(41, (3, 160, 32)), _rand(42, (3, 160, 32))
    g = _rand(43, (3, 128, 32))
    scale = 1.0 / np.sqrt(32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa._flash_3d(q, k, v, scale) * g),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention_3d(*ins, scale), ins,
                              torch.from_numpy(g))
    for t, j in zip(got, want):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("env,want_fn", [
    ({}, lambda q, k, v: tfa.flash_attention_plain(q, k, v)),
    ({"FLASH_CAPPED": "0"}, lambda q, k, v: tfa.flash_attention_online_plain(q, k, v)),
    ({"FLASH_DUAL": "1"}, lambda q, k, v: tfa.flash_attention_online_plain(q, k, v, dual=True)),
    ({"FLASH_CAPPED": "0", "FLASH_DUAL": "1"},
     lambda q, k, v: tfa.flash_attention_online_plain(q, k, v, dual=True)),
], ids=["default", "online", "dual", "online_dual"])
def test_flash_env_gates(monkeypatch, env, want_fn):
    """FLASH_CAPPED / FLASH_DUAL are read at call time, as `_flash_fwd_4d`
    reads them: dual switches capped off; a call that needs stats (autograd)
    switches dual off."""
    for name in ("FLASH_CAPPED", "FLASH_DUAL"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    q, k, v = (torch.from_numpy(_rand(50 + i, (1, 150, 2, 32))).to(torch.bfloat16)
               for i in range(3))
    assert torch.equal(tfa.flash_attention(q, k, v), want_fn(q, k, v))
    out = tfa.flash_attention(q.clone().requires_grad_(), k, v)
    capped = env.get("FLASH_CAPPED", "1") == "1"
    want = (tfa.flash_attention_plain(q, k, v) if capped
            else tfa.flash_attention_online_plain(q, k, v))
    assert torch.equal(out.detach(), want)


# --------------------------------------------------------------------------
# K6 and K7: int8 Q K^T
# --------------------------------------------------------------------------

def _assert_bf16_close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3 * np.abs(want).max())
    assert np.mean(got != want) <= 0.01


def _jax_prepass(q, k, scale, capped):
    """`_flash_fwd_4d_int8`'s pre-pass (:1103-1120), with the JAX package's
    own row quantiser."""
    kf = k.astype(jnp.float32)
    q_i8, q_s = jfa._quantize_rows_int8(q)
    k_i8, k_s = jfa._quantize_rows_int8(kf - jnp.mean(kf, axis=1, keepdims=True))
    q_s = q_s * (scale * jfa.LOG2_E)
    m2 = None
    if capped:
        qn = jnp.sqrt(jnp.sum(jnp.square(q_i8.astype(jnp.float32)), axis=-1, keepdims=True))
        kn = jnp.sqrt(jnp.sum(jnp.square(k_i8.astype(jnp.float32)), axis=-1, keepdims=True))
        kmax = jnp.max(k_s * kn, axis=1, keepdims=True)
        m2 = jnp.minimum(q_s * qn * kmax * 1.0001, 96.0)[..., 0].transpose(0, 2, 1)
    return (q_i8, k_i8, q_s[..., 0].transpose(0, 2, 1), k_s[..., 0].transpose(0, 2, 1), m2)


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "online"])
@pytest.mark.parametrize("case", list(CASES))
def test_k6_plain_matches_pallas_interpret(interp, case, capped):
    sq, sk, n, d, mag = CASES[case]
    q, k, v = (_grid(60, (2, sq, n, d)) * mag, _grid(61, (2, sk, n, d), offset=0.75),
               _rand(62, (2, sk, n, d)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    # the pre-pass, exactly: the same integers, scales and bounds
    tq8, tk8, tv16, tqs, tks, tm2 = tfa.int8_prepass(tq, tk, tv, scale, capped)
    jq8, jk8, jqs, jks, jm2 = _jax_prepass(jq, jk, scale, capped)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tk8.numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    assert tv16.dtype == torch.bfloat16
    if capped:
        np.testing.assert_array_equal(tm2.numpy(), np.asarray(jm2))
    else:
        assert tm2 is None
    # the online body rounds p to bf16 against its running max, so the Pallas
    # call gets the port's step of INT8_TILE_K keys: both meet the same maxima
    want = jfa._flash_fwd_4d_int8(jq, jk, jv, scale, block_q=128,
                                  block_k=128 if capped else tfa.INT8_TILE_K, capped=capped)
    got = tfa.flash_attention_int8(tq, tk, tv, scale, capped=capped)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_bf16_close(got, want)
    # and close to the exact softmax: the quantisation noise of int8 Q K^T
    ref = _np(tatt.sdpa(tq, tk, tv, scale))
    cos = (_np(got) * ref).sum() / (np.linalg.norm(_np(got)) * np.linalg.norm(ref))
    # (a q x24 softmax is sharp: a logit's quantisation error moves more mass)
    assert cos > (0.999 if mag == 1.0 else 0.99), cos


@pytest.mark.parametrize("which", ["fp32", "bf16"])
@pytest.mark.parametrize("sk", [300, 301])
def test_k6_online_short_last_step_matches_pallas_interpret(interp, sk, which):
    """K6's online body over steps of INT8_TILE_K keys where the last step is
    short (Sk = 300 and 301: 44 and 45 keys of 128): the padded keys' logits
    count as -1e30 on both sides and both meet the same running maxima."""
    q, k, v = (_grid(110, (1, 200, 2, 128)), _grid(111, (1, sk, 2, 128), offset=0.75),
               _rand(112, (1, sk, 2, 128)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, which) for a in (q, k, v))
    scale = 1.0 / np.sqrt(128)
    want = jfa._flash_fwd_4d_int8(jq, jk, jv, scale, block_q=128,
                                  block_k=tfa.INT8_TILE_K, capped=False)
    got = tfa.flash_attention_int8(tq, tk, tv, scale, capped=False)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 520)])
def test_k7_plain_matches_pallas_interpret(interp, sq, sk):
    q, k, v = _grid(70, (4, sq, 32)), _grid(71, (4, sk, 32), offset=0.75), _rand(72, (4, sk, 32))
    scale = 1.0 / np.sqrt(32)
    want = jfa._flash_fwd_3d_int8(*(jnp.asarray(a) for a in (q, k, v)), scale,
                                  block_q=128, block_k=tfa.INT8_TILE_K)  # as for K6 online
    got = tfa.flash_attention_int8_3d(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16 and got.shape == (4, sq, 32)
    _assert_bf16_close(got, want)


def test_int8_smoothing_invariance_and_no_backward():
    """A constant channel offset on K moves every logit of a row alike: the
    token-mean subtraction absorbs it up to quantisation noise."""
    q, k, v = (torch.from_numpy(_rand(80 + i, (1, 128, 2, 32))) for i in range(3))
    for capped in (True, False):
        a = tfa.flash_attention_int8(q, k, v, capped=capped)
        b = tfa.flash_attention_int8(q, k + 3.0, v, capped=capped)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.05, atol=0.02)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention_int8(q.clone().requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention_int8_3d(q[0].clone().requires_grad_(), k[0], v[0])


def test_int8_env_gate(monkeypatch):
    q, k, v = (torch.from_numpy(_rand(90 + i, (1, 100, 2, 32))) for i in range(3))
    monkeypatch.delenv("FLASH_CAPPED", raising=False)
    assert torch.equal(tfa.flash_attention_int8(q, k, v),
                       tfa.flash_attention_int8_plain(q, k, v, capped=True))
    monkeypatch.setenv("FLASH_CAPPED", "0")
    assert torch.equal(tfa.flash_attention_int8(q, k, v),
                       tfa.flash_attention_int8_plain(q, k, v, capped=False))


def test_quantized_attention_flag_matches_jax(interp, float_attention):
    """`set_quantized_attention` sends `attention` (self and cross alike,
    kv_valid honoured) through the int8 function on both sides."""
    q, k, v = _grid(100, (1, 140, 2, 128)), _grid(101, (1, 64, 2, 128), 0.5), _rand(102, (1, 64, 2, 128))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (q, k, v))
    plain = tatt.attention(tq, tk, tv, kv_valid=50)  # K1's plain version
    tatt.set_quantized_attention(True)
    jatt.set_quantized_attention(True)
    assert tatt._QUANTIZED_ATTENTION
    got = tatt.attention(tq, tk, tv, kv_valid=50)
    want = jatt.attention(jq, jk, jv, use_flash=True, kv_valid=50)
    _assert_bf16_close(got, want)
    assert torch.equal(got, tfa.flash_attention_int8(tq, tk[:, :50], tv[:, :50]))
    assert not torch.equal(got, plain)
    tatt.set_quantized_attention(False)
    assert torch.equal(tatt.attention(tq, tk, tv, kv_valid=50), plain)
