"""PyTorch port vs JAX package: the quantized linears (`ops/quant.py`), the
module walk that installs them, quantised trees through `from_jax_params`,
the quantised DiT in its four modes, the smoke pipeline after
`quantize("int8", quantize_attention=True)`, and the CLI's `--quantize`.

Inputs come from numpy seeds and go to both sides. Quantised values are
compared bit for bit, scales to one fp32 ULP, linears in fp32 at rtol 1e-5
(both sides multiply the same integers; only the order of the fp32 sums and
the last bit of a scale can differ). Model-level tests quantise once in JAX
and carry the integers into the port.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.ops.flash_attention as jfa
import video_styler_tpu.ops.quant as jq

import video_styler_tpu_torch.models.wan_dit as TD
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.ops import attention as tatt
from video_styler_tpu_torch.ops import basic as tb
from video_styler_tpu_torch.ops import quant as tq

from test_torch_pipeline import REQUEST, _frames, _pipelines

# `video_styler_tpu.ops` exports a function of the same name as this module
jatt = importlib.import_module("video_styler_tpu.ops.attention")

DIT = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
           num_layers=2, text_dim=64, freq_dim=32)
MODES = ["int8", "fp8", "int4", "int4_g128"]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "float8_e4m3fn":
        return x.view(np.uint8)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_ulp(t, j, ulps=1):
    """fp32 arrays equal to `ulps` units in the last place."""
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_array_max_ulp(t, j, maxulp=ulps)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture
def float_attention():
    """The process-wide int8-attention flags, reset whatever the test does."""
    yield
    tatt.set_quantized_attention(False)
    jatt.set_quantized_attention(False)


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------

QUANTIZERS = {
    "int8": (tq.quantize_weight_int8, jq.quantize_weight_int8),
    "fp8": (tq.quantize_weight_fp8, jq.quantize_weight_fp8),
    "int4": (tq.quantize_weight_int4, jq.quantize_weight_int4),
    "int4_g128": (tq.quantize_weight_int4_g, jq.quantize_weight_int4_g),
    "int4_g32": (lambda w: tq.quantize_weight_int4_g(w, 32),
                 lambda w: jq.quantize_weight_int4_g(w, 32)),
}


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
@pytest.mark.parametrize("mode", list(QUANTIZERS))
def test_weight_quantizers_match_jax(mode, stacked):
    w = _rand(0, (3, 256, 192) if stacked else (256, 192), 0.07)
    w[..., 5] = 0.0                                # a dead column: the scale floor
    t_fn, j_fn = QUANTIZERS[mode]
    tw, ts = t_fn(torch.from_numpy(w))
    jw, js = j_fn(jnp.asarray(w))
    assert tw.shape == jw.shape and ts.shape == js.shape
    np.testing.assert_array_equal(_np(tw), _np(jw))     # bit for bit
    _assert_ulp(ts, js)
    # bf16 weights upcast first on both sides
    tw, ts = t_fn(torch.from_numpy(w).to(torch.bfloat16))
    jw, js = j_fn(jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_array_equal(_np(tw), _np(jw))
    _assert_ulp(ts, js)


def test_fp8_cast_matches_jax_on_a_grid():
    """float32 -> e4m3 on every value class that occurs: a dense grid over
    [-448, 448], every e4m3 value, the midpoints between neighbours (ties go
    to even on both sides) and values just off them."""
    codes = np.arange(256, dtype=np.uint8)
    vals = torch.from_numpy(codes).view(torch.float8_e4m3fn).float().numpy()
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[1:] + vals[:-1]) / 2
    grid = np.concatenate([np.linspace(-448, 448, 20001, dtype=np.float32), vals, mids,
                           np.nextafter(mids, np.float32(np.inf)),
                           np.nextafter(mids, np.float32(-np.inf)),
                           _rand(1, (4096,), 1e-2)]).astype(np.float32)
    got = torch.from_numpy(grid).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(grid).astype(jnp.float8_e4m3fn)).view(np.uint8)
    # +0 and -0 are the same value
    np.testing.assert_array_equal(np.where(got == 0x80, 0, got),
                                  np.where(want == 0x80, 0, want))


def test_int4_pack_unpack_matches_jax():
    q = np.random.default_rng(2).integers(-8, 8, (2, 64, 24)).astype(np.int8)
    packed_t = tq.pack_int4(torch.from_numpy(q))
    packed_j = jq.pack_int4(jnp.asarray(q))
    assert packed_t.dtype == torch.int8 and packed_t.shape == (2, 32, 24)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(tq.unpack_int4(packed_t).numpy(), q)
    every = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8).reshape(256, 1)
    np.testing.assert_array_equal(tq.unpack_int4(every).numpy(),
                                  np.asarray(jq.unpack_int4(jnp.asarray(every.numpy()))))


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_activation_quantizer_matches_jax(which):
    x = _rand(3, (2, 37, 256), 3.0)
    x[0, 4] = 0.0                                  # an all-zero row: the floor
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[which]
    txq, txs = tq.quantize_act_int8(torch.from_numpy(x).to(td))
    jxq, jxs = jq.quantize_act_int8(jnp.asarray(x, jd))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    _assert_ulp(txs, jxs, ulps=0)


# --------------------------------------------------------------------------
# Linears
# --------------------------------------------------------------------------

def _leaf(mode, w, b):
    """A JAX linear leaf {"w", "b"} quantised by the JAX package, and the
    same tensors for the port."""
    tree = jq.quantize_params({"lin": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
                              mode=mode, min_size=0, min_dim=0)["lin"]
    key = "w_q4" if mode.startswith("int4") else "w_q"
    arr = np.asarray(tree[key])
    if arr.dtype.name == "float8_e4m3fn":
        wq = torch.from_numpy(arr.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    else:
        wq = torch.from_numpy(arr.copy())
    return tree, wq, torch.from_numpy(np.asarray(tree["w_scale"]).copy())


@pytest.mark.parametrize("rows", [(1,), (2, 37)], ids=["one_row", "batched"])
@pytest.mark.parametrize("mode", MODES)
def test_linears_match_jax(mode, rows):
    x = _rand(10, rows + (256,), 2.0)
    w, b = _rand(11, (256, 192), 0.07), _rand(12, (192,), 0.1)
    leaf, wq, ws = _leaf(mode, w, b)
    want = jb_linear(leaf, jnp.asarray(x))
    tx, tbias = torch.from_numpy(x), torch.from_numpy(b)
    fn = {"int8": tq.linear_int8, "fp8": tq.linear_fp8, "int4": tq.linear_int4,
          "int4_g128": tq.linear_int4_g}[mode]
    got = fn(tx, wq, ws, tbias)
    assert got.shape == rows + (192,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the dispatch of `ops.basic` picks the same function from what a layer holds
    layer = tq.QuantLinear(**{"w_q4" if mode.startswith("int4") else "w_q": wq},
                           w_scale=ws, b=tbias)
    assert layer.mode == mode and (layer.in_features, layer.out_features) == (256, 192)
    # (the layer keeps w_q column-major: the CPU's fp32 sums run in another order)
    torch.testing.assert_close(layer(tx), got, rtol=1e-6, atol=1e-6)
    assert torch.equal(tb.quantized_linear(tx, layer.w_q, layer.w_q4, ws, tbias),
                       layer(tx))
    # without a bias, and in bf16 (one bf16 ULP: the fp32 sums differ in order)
    np.testing.assert_allclose(fn(tx, wq, ws).numpy(),
                               np.asarray(jb_linear({k: v for k, v in leaf.items() if k != "b"},
                                                    jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    got16 = fn(tx.to(torch.bfloat16), wq, ws, tbias)
    want16 = jb_linear(leaf, jnp.asarray(x, jnp.bfloat16))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               rtol=2.0 ** -7, atol=1e-2)


def jb_linear(leaf, x):
    from video_styler_tpu.ops.basic import linear
    return linear(leaf, x)


def test_prequant_and_fused_qkv_match_jax():
    x = _rand(20, (2, 19, 256), 2.0)
    leaves, layers = [], []
    for i in range(3):
        leaf, wq, ws = _leaf("int8", _rand(21 + i, (256, 256), 0.07), _rand(24 + i, (256,), 0.1))
        if i == 1:                                 # a layer without bias
            leaf = {k: v for k, v in leaf.items() if k != "b"}
        leaves.append(leaf)
        layers.append(tq.QuantLinear(w_q=wq, w_scale=ws, b=None if i == 1 else
                                     torch.from_numpy(np.asarray(leaf["b"]).copy())))
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    want = jq.fused_qkv_int8(*leaves, jx)
    got = tq.fused_qkv_int8(tx, *layers)
    for t, j, layer in zip(got, want, layers):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        # bit-identical to the separate linear, as the JAX package states of its own
        assert torch.equal(t, layer(tx)) and t.is_contiguous()
    txq, txs = tq.quantize_act_int8(tx)
    jxq, jxs = jq.quantize_act_int8(jx)
    got = tq.linear_int8_prequant(txq, txs, layers[0].w_q, layers[0].w_scale,
                                  layers[0].b, torch.bfloat16)
    want = jq.linear_int8_prequant(leaves[0], jxq, jxs, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=1e-2)


# --------------------------------------------------------------------------
# The module walk
# --------------------------------------------------------------------------

def _quantized_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            if "w_q" in v or "w_q4" in v:
                out[path] = v
            else:
                out.update(_quantized_paths(v, path + "."))
    return out


def _strip_index(name):
    return ".".join(p for p in name.split(".") if not p.isdigit())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_keep_rules_match_jax(mode):
    """The same layers are quantised on both sides, under the JAX defaults
    and under a predicate and a size floor: size counts the stacked block
    list, small dims and excluded paths stay in high precision."""
    cfg = dict(DIT, dim=128, ffn_dim=256)          # 128x128 = 2^14 per layer
    jp = JD.init_wan_dit(jax.random.PRNGKey(0), JD.WanDiTConfig(**cfg), jnp.float32)
    keep = ("head", "modulation", "time_embedding")
    for kw in (dict(), dict(min_size=1 << 15), dict(min_size=(1 << 15) + 1),
               dict(predicate=lambda path, leaf: not any(k in path for k in keep)),
               dict(min_dim=256)):
        want = _quantized_paths(jq.quantize_params(jp, mode=mode, **kw))
        dit = from_jax_params("dit", _tree(jp), TD.WanDiTConfig(**cfg), device="cpu")
        assert tq.quantize_params(dit, mode=mode, **kw) is dit
        got = {name: m for name, m in dit.named_modules() if isinstance(m, tq.QuantLinear)}
        assert {_strip_index(n) for n in got} == set(want), kw
        assert all(m.mode == mode for m in got.values())
        assert tq.quantized_fraction(dit) == pytest.approx(
            jq.quantized_fraction(jq.quantize_params(jp, mode=mode, **kw)), abs=1e-9)
        for name, m in got.items():
            leaf = want[_strip_index(name)]
            idx = [int(p) for p in name.split(".") if p.isdigit()]
            key = "w_q4" if mode == "int4" else "w_q"
            jw = np.asarray(leaf[key])[idx[0]] if idx else np.asarray(leaf[key])
            np.testing.assert_array_equal(getattr(m, key).numpy(), jw)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize_params(dit, mode="int3")


def test_dequantize_params_and_fraction():
    torch.manual_seed(0)
    net = nn.Sequential(TD.Linear(256, 384), nn.ModuleList([TD.Linear(384, 128)]))
    want = [p.detach().clone() for p in net.parameters()]
    assert tq.quantized_fraction(net) == 0.0
    tq.quantize_params(net, mode="int4_g128", min_size=0)
    assert isinstance(net[0], tq.QuantLinear) and net[0].mode == "int4_g128"
    assert tq.quantized_fraction(net) == 0.0       # packed int4 is not counted (as in JAX)
    w = tq.dequant_leaf(net[0], torch.float32)
    jw = jq.dequant_leaf({"w_q4": jnp.asarray(net[0].w_q4.numpy()),
                          "w_scale": jnp.asarray(net[0].w_scale.numpy())}, jnp.float32)["w"]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    tq.dequantize_params(net, torch.float32)
    assert type(net[0]) is TD.Linear and type(net[1][0]) is TD.Linear
    for got, ref in zip(net.parameters(), want):
        # int4 with group scales: half a step of 1/7 of the group's absmax
        assert (got - ref).abs().max() <= ref.abs().max() / 14 + 1e-6
    tq.quantize_params(net, mode="int8", min_size=0)
    assert tq.quantized_fraction(net) == 1.0
    assert tq.dequant_leaf(net[0]).dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Quantised trees and models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quantized_dit_forward_matches_jax(mode, monkeypatch):
    """The DiT quantised once in JAX and carried over: same integers on both
    sides, int8 and int4 through the fused QKV product."""
    jcfg = JD.WanDiTConfig(**DIT)
    jp = jq.quantize_params(JD.init_wan_dit(jax.random.PRNGKey(0), jcfg, jnp.float32),
                            mode=mode)
    dit = from_jax_params("dit", _tree(jp), TD.WanDiTConfig(**DIT), device="cpu")
    q_layer = dit.blocks[1].self_attn.q
    assert isinstance(q_layer, tq.QuantLinear) and q_layer.mode == mode
    leaf = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["self_attn"]["q"])
    key = "w_q4" if mode.startswith("int4") else "w_q"
    np.testing.assert_array_equal(_np(getattr(q_layer, key)), _np(leaf[key]))
    np.testing.assert_array_equal(q_layer.w_scale.numpy(), np.asarray(leaf["w_scale"]))
    assert isinstance(dit.patch_embedding, nn.Linear)       # 16 inputs: kept
    assert tq.quantized_fraction(dit) == pytest.approx(jq.quantized_fraction(jp), abs=1e-9)

    calls = []
    orig = tq.fused_qkv_int8
    monkeypatch.setattr(tq, "fused_qkv_int8",
                        lambda *a: calls.append(1) or orig(*a))
    x, ctx = _rand(30, (1, 4, 3, 8, 8)), _rand(31, (1, 12, 64))
    t = np.array([500.0], np.float32)
    want = JD.wan_dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = TD.wan_dit_forward(dit, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx))
    assert len(calls) == (2 if mode in ("int8", "int4") else 0)
    # fp32 activations on identical quantised weights: an activation that
    # rounds to a neighbouring integer (or e4m3 value) on one side moves its
    # row's products by 1/127 of one term (measured: up to 1.6e-3, int4)
    rel = np.linalg.norm(got.numpy() - np.asarray(want)) / np.linalg.norm(np.asarray(want))
    assert rel < 5e-3, rel


def _use_flash_on_cpu(monkeypatch):
    """Send the JAX DiT's attention through its flash kernels (interpret
    mode) as a TPU backend would, instead of the off-TPU sdpa."""
    orig = jfa.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", interp_call)
    attention = JD.attention
    monkeypatch.setattr(JD, "attention",
                        lambda q, k, v, **kw: attention(q, k, v, use_flash=True, **kw))


def test_quantized_pipeline_matches_jax(monkeypatch, float_attention):
    """The whole smoke pipeline after quantize("int8",
    quantize_attention=True): int8 linears and int8 attention (K6's plain
    version against the Pallas kernel in interpret mode) on both sides."""
    _use_flash_on_cpu(monkeypatch)
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.quantize("int8", quantize_attention=True)
    tp.quantize("int8", quantize_attention=True)
    assert tatt._QUANTIZED_ATTENTION
    for model in (tp.dit, tp.vace):
        assert tq.quantized_fraction(model) > 0.5
        assert isinstance(model.blocks[0].ffn.fc1, tq.QuantLinear)
    assert isinstance(tp.dit.head.head, nn.Linear)
    assert isinstance(tp.dit.time_embedding.fc1, nn.Linear)
    assert tq.quantized_fraction(tp.dit) == pytest.approx(
        jq.quantized_fraction(jp.dit_params), abs=1e-9)
    # each side quantised its own copy of the same fp32 weights: same integers
    np.testing.assert_array_equal(
        tp.vace.blocks[1].cross_attn.k.w_q.numpy(),
        np.asarray(jp.vace_params["blocks"]["cross_attn"]["k"]["w_q"])[1])

    video = _frames()
    want = np.asarray(jnp.asarray(jp(vace_video=video, return_latents=True, **REQUEST),
                                  jnp.float32))
    got = tp(vace_video=video, return_latents=True, **REQUEST).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # the int8 attention returns bfloat16-rounded values on both sides and
    # quantises activations per call: a value that rounds the other way on
    # one side moves the result by a bf16 ULP or 1/127 of a term; through 2
    # steps x 2 CFG passes (the CFG difference amplified by 5). Measured
    # 2.9%, the level of the bf16 pipeline test (2.6%, bound 5%)
    assert rel < 5e-2, rel
    frames_j = np.stack([np.asarray(im) for im in jp(vace_video=video, **REQUEST)])
    frames_t = tp(vace_video=video, **REQUEST)
    diff = np.abs(frames_t.astype(np.int16) - frames_j.astype(np.int16))
    assert diff.mean() <= 2.0, diff.mean()
    with pytest.raises(KeyError, match="after LoRA merging"):
        tp.load_lora("vace", state_dict={
            "vace_blocks.0.self_attn.q.lora_A.weight": torch.zeros(4, 256),
            "vace_blocks.0.self_attn.q.lora_B.weight": torch.zeros(256, 4)})


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_cli_quantize_on_cpu(tmp_path, mode):
    from video_styler_tpu_torch.infer_ditto import main, parse_args
    out = tmp_path / "edit.mp4"
    frames = main(["--smoke", "--prompt", "a cat in the rain", "--device", "cpu",
                   "--num_inference_steps", "2", "--quantize", mode,
                   "--output_path", str(out)])
    assert frames.shape == (9, 32, 32, 3) and frames.dtype == np.uint8
    assert out.exists() and out.stat().st_size > 0
    assert not tatt._QUANTIZED_ATTENTION      # the CLI leaves attention alone
    with pytest.raises(SystemExit):
        parse_args(["--prompt", "x", "--quantize", "int4"])   # the JAX CLI's choices
