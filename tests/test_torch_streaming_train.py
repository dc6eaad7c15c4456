"""The port's streamed-trunk LoRA trainer (`trainers/streaming_train.py`)
against JAX's `jax.grad` through the resident model (`wan_dit_forward` with
`apply_lora`), as `tests/test_streaming_train.py` holds the JAX trainer.

Widths: the smoke models of `test_torch_pipeline.py` (DiT/VACE dim 256, 2
heads of 128, 2 layers, VACE after layers 0 and 1), weights from the JAX
init through `from_jax_params`, fp32. Each setup's JAX reference is
computed once (module-scoped fixtures); the cases run the trainer across
resident blocks 0 and 1, the "host" and "device" checkpoints (segments of
1, 2 and 3 over the 4-item interleaved schedule), `sub_remat` on and off,
the serial walk, and int8 / int4 stores against the reference on the
dequantised weights. Tolerances: the loss within 1e-5 relative, every A/B
gradient within 1e-4 of its largest magnitude (the same fp32 arithmetic in
other orders; JAX's exact-softmax `sdpa` against the port's capped plain
attention).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vace as JV
from video_styler_tpu.ops.quant import dequantize_params, quantize_params
from video_styler_tpu.trainers.lora_train import apply_lora as j_apply_lora
from video_styler_tpu.trainers.lora_train import init_lora as j_init_lora

import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
from video_styler_tpu_torch.convert import from_jax_lora, from_jax_params
from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
from video_styler_tpu_torch.trainers.streaming_train import StreamingTrainer

from test_torch_pipeline import DIT, VACE, _tree, cpu_share  # noqa: F401
from test_torch_training import _close_scaled

VACE_SCALE = 0.7
TRUNK_TARGETS = ("blocks.self_attn.q", "blocks.self_attn.k", "blocks.cross_attn.q",
                 "blocks.ffn.fc1")
VACE_TARGETS = ("blocks.self_attn.q", "blocks.self_attn.v", "blocks.cross_attn.k",
                "blocks.cross_attn.v", "blocks.ffn.fc2")


def _inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32),
            np.array([321.0], np.float32),
            rng.standard_normal((1, 16, 64)).astype(np.float32),
            rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32),
            rng.standard_normal((1, 72, 3, 8, 8)).astype(np.float32))


def _lora(params, targets, seed):
    lora = j_init_lora(jax.random.PRNGKey(seed), params, rank=4, targets=targets)
    # B off zero, so that A's gradients are not zero by construction
    return jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), lora)


def _ref_loss(jp, jcfg, lora, lat, ts, ctx, target, jv=None, jvcfg=None, vctx=None,
              vace_lora=None):
    p = dict(jp)
    if lora:
        p["blocks"] = j_apply_lora(jp["blocks"], {k.split(".", 1)[1]: v
                                                  for k, v in lora.items()})
    vp = jv
    if vace_lora:
        vp = dict(jv)
        vp["blocks"] = j_apply_lora(jv["blocks"], {k.split(".", 1)[1]: v
                                                   for k, v in vace_lora.items()})
    v = JD.wan_dit_forward(p, jcfg, lat, ts, ctx, vace_params=vp, vace_cfg=jvcfg,
                           vace_context=vctx, vace_scale=VACE_SCALE)
    return jnp.mean(jnp.square(v.astype(jnp.float32) - target))


def _models(quant=None):
    """(JAX DiT, JAX VACE, port DiT, port VACE) in fp32; with `quant`, the
    JAX trees hold the dequantised values of that store (every linear
    quantised, as the streamer's min sizes of 0 make it)."""
    jcfg, jvcfg = JD.WanDiTConfig(**DIT), JV.VaceConfig(**VACE)
    jp = JD.init_wan_dit(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jv = JV.init_vace(jax.random.PRNGKey(1), jvcfg, jnp.float32)
    dit = from_jax_params("dit", _tree(jp), TD.WanDiTConfig(**DIT), device="cpu")
    vace = from_jax_params("vace", _tree(jv), TV.VaceConfig(**VACE), device="cpu")
    if quant:
        jp = dict(jp, blocks=dequantize_params(quantize_params(
            jp["blocks"], mode=quant, min_size=0, min_dim=0), jnp.float32))
        jv = dict(jv, **{k: dequantize_params(quantize_params(
            jv[k], mode=quant, min_size=0, min_dim=0), jnp.float32)
            for k in ("blocks", "after_proj")})
    return (jcfg, jp, jvcfg, jv), (dit, vace)


def _reference(kind, quant=None):
    (jcfg, jp, jvcfg, jv), models = _models(quant)
    lat, ts, ctx, target, vctx = _inputs()
    args = tuple(jnp.asarray(a) for a in (lat, ts, ctx, target))
    if kind == "trunk":
        lora = _lora(jp, TRUNK_TARGETS, 7)
        fn = jax.jit(jax.value_and_grad(lambda l: _ref_loss(jp, jcfg, l, *args)))
    else:
        lora = _lora(jv, VACE_TARGETS, 9)
        fn = jax.jit(jax.value_and_grad(lambda l: _ref_loss(
            jp, jcfg, None, *args, jv=jv, jvcfg=jvcfg, vctx=jnp.asarray(vctx),
            vace_lora=l)))
    loss, grads = fn(lora)
    return dict(models=models, lora=_tree(lora), loss=float(loss),
                grads=from_jax_lora(_tree(grads)))


@pytest.fixture(scope="module")
def trunk_ref():
    return _reference("trunk")


@pytest.fixture(scope="module")
def vace_ref():
    return _reference("vace")


def _check(ref, kind, streamer_kw, trainer_kw):
    dit, vace = ref["models"]
    lat, ts, ctx, target, vctx = (torch.from_numpy(a) for a in _inputs())
    streamer = WanBlockStreamer(dit, vace if kind == "vace" else None, prefetch_depth=2,
                                **{"mode": "f32", **streamer_kw})
    trainer = StreamingTrainer(streamer, **trainer_kw)
    lora = from_jax_lora(ref["lora"])
    kw = (dict(trunk_lora=lora) if kind == "trunk" else
          dict(vace_context=vctx, vace_scale=VACE_SCALE, vace_lora=lora))
    loss, g_trunk, g_vace = trainer.loss_and_grads(lat, ts, ctx, target, **kw)
    grads = g_trunk if kind == "trunk" else g_vace
    assert (g_vace if kind == "trunk" else g_trunk) is None
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    assert set(grads) == set(ref["grads"]) == set(lora)
    for name, ab in grads.items():
        for k in ("A", "B"):
            _close_scaled(ab[k], ref["grads"][name][k].detach(), 1e-4)
    return trainer


@pytest.mark.parametrize("sub_remat", [True, False])
@pytest.mark.parametrize("ckpt", ["host", "device"])
@pytest.mark.parametrize("resident", [0, 1])
def test_trunk_lora_grads_match_jax(trunk_ref, resident, ckpt, sub_remat):
    trainer = _check(trunk_ref, "trunk", dict(resident_blocks=resident),
                     dict(activation_ckpt=ckpt, segment=1, sub_remat=sub_remat))
    assert trainer.last_ckpt == (ckpt, 1)


@pytest.mark.parametrize("ckpt,segment,resident", [("host", None, 1), ("device", 3, 1),
                                                   ("device", 2, 0), ("auto", None, 0)])
def test_vace_lora_grads_match_jax(vace_ref, ckpt, segment, resident):
    """segment 3 splits the schedule [trunk0, vace0, trunk1, vace1] inside
    the hint chain (a hint recomputed inside a segment, the VACE backward
    across a segment boundary); segment 2 puts the boundary at an injection
    point; "auto" picks "device" (the tiny stash fits the budget)."""
    trainer = _check(vace_ref, "vace", dict(resident_blocks=resident),
                     dict(activation_ckpt=ckpt, segment=segment))
    assert trainer.last_ckpt[0] == ("device" if ckpt == "auto" else ckpt)
    if resident == 0:
        assert trainer.bytes_copied > 0


@pytest.mark.parametrize("ckpt", ["host", "device"])
def test_serial_walk_grads_match_jax(vace_ref, ckpt):
    _check(vace_ref, "vace", dict(resident_blocks=0, overlap=False),
           dict(activation_ckpt=ckpt, segment=3))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_store_grads_match_dequantized_reference(mode):
    """The QLoRA contract: gradients over an int8 / int4 store equal those
    through the resident model on the dequantised values (the JAX
    `quantize_params` integers, which the streamer's quantiser
    reproduces)."""
    _check(_reference("vace", quant=mode), "vace",
           dict(mode=mode, resident_blocks=0, quant_min_size=0, quant_min_dim=0),
           dict(activation_ckpt="device", segment=2))


def test_frozen_vace_chain_not_walked_back(vace_ref):
    """VACE inputs with neither LoRA: no walk back, and the loss of the
    streamer's own forward."""
    dit, vace = vace_ref["models"]
    lat, ts, ctx, target, vctx = (torch.from_numpy(a) for a in _inputs())
    streamer = WanBlockStreamer(dit, vace, mode="f32", resident_blocks=2, prefetch_depth=2)
    trainer = StreamingTrainer(streamer, activation_ckpt="device", segment=2)
    loss, g_trunk, g_vace = trainer.loss_and_grads(lat, ts, ctx, target, vace_context=vctx,
                                                   vace_scale=VACE_SCALE)
    assert g_trunk is None and g_vace is None
    out = streamer.forward(lat, ts, ctx, vctx, VACE_SCALE)[0]
    np.testing.assert_allclose(float(loss), float(torch.mean(torch.square(out - target))),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="activation_ckpt"):
        StreamingTrainer(streamer, activation_ckpt="disk")
