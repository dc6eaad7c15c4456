"""Step1x and Nexus-Gen against the JAX package: the Step1x connector (fp32,
bf16), the Nexus-Gen generation adapter, the editing merger (with and
without a reference grid) and its RoPE tables (bit-equal), FLUX's Step1x
and Nexus-Gen paths (with the fake embedders the JAX tests use), and
`NexusGenARModel` on the port's Qwen2.5-VL modules.

Weights: reference-named state dicts drawn from a numpy seed (biases and
norm weights off their init), read by both packages' converters. Widths:
`STEP1X_CONNECTOR_TINY` (16 -> 32, 2 heads of 16, 2 blocks),
`NEXUS_GEN_MERGER_TINY` (32 wide, 2 heads over 1 k/v head, out 24); on
FLUX, the JAX tests' connector and merger widths over the tiny FLUX
pipelines of `test_torch_flux` (64x64, 3 steps). The connector's and the
merger's attention is the exact `sdpa` in both packages: fp32 within 2e-5
relative L2, bf16 within 2e-2.
"""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.nexus_gen as JN
import video_styler_tpu.models.step1x as JS

import video_styler_tpu_torch.models.llm_decoder as TL
import video_styler_tpu_torch.models.nexus_gen as TN
import video_styler_tpu_torch.models.qwen_vl_vision as TV
import video_styler_tpu_torch.models.step1x as TS
from video_styler_tpu_torch.utils.ckpt import build_module

from test_torch_flux import BASE, pipes  # noqa: F401
from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401
from test_torch_qwen_vl import (TEXT, VISION, stub_tokenizer, synthetic_image, token_ids,
                                vl_state_dict)

TOL_F32 = 2e-5
TOL_BF16 = 2e-2


def _draw(shapes, seed: int):
    """{name: shape} -> float32 arrays: 2-D weights N(0, 1/in), norm weights
    near 1, the rest small."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif "norm" in name and name.endswith("weight"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        out[name] = v.astype(np.float32)
    return out


def connector_state_dict(cfg, seed: int = 0):
    """The reference's Qwen2Connector names (under `connector.`)."""
    d, c = cfg.hidden_size, cfg.in_channels
    shapes = {}

    def lin(name, o, i):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (o, i), (o,)
    lin("S.input_embedder", d, c)
    lin("S.t_embedder.mlp.0", d, cfg.time_freq_dim)
    lin("S.t_embedder.mlp.2", d, d)
    lin("S.c_embedder.linear_1", d, c)
    lin("S.c_embedder.linear_2", d, d)
    lin("global_proj_out", cfg.pooled_dim, c)
    for i in range(cfg.depth):
        b = f"S.individual_token_refiner.blocks.{i}"
        for n in ("norm1", "norm2"):
            shapes[f"{b}.{n}.weight"], shapes[f"{b}.{n}.bias"] = (d,), (d,)
        lin(f"{b}.self_attn_qkv", 3 * d, d)
        lin(f"{b}.self_attn_proj", d, d)
        lin(f"{b}.mlp.fc1", 4 * d, d)
        lin(f"{b}.mlp.fc2", d, 4 * d)
        lin(f"{b}.adaLN_modulation.1", 2 * d, d)
    sd = _draw(shapes, seed)
    sd["scale_factor"] = np.array([-0.91], np.float32)
    return {f"connector.{k}": v for k, v in sd.items()}


def torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def port_connector(sd, cfg, dtype=torch.float32):
    return build_module(TS.Step1xConnector, cfg, TS.convert_step1x_connector(torch_sd(sd), cfg),
                        "cpu", dtype)


def adapter_state_dict(in_dim: int, out_dim: int, seed: int = 1):
    return _draw({n: tuple(p.shape) for n, p in TN.NexusGenAdapter(
        in_dim, out_dim, device="meta").state_dict().items()}, seed)


def merger_state_dict(cfg, seed: int = 2):
    return _draw({n: tuple(p.shape) for n, p in TN.NexusGenMerger(
        cfg, device="meta").state_dict().items()}, seed)


def port_merger(sd, cfg, dtype=torch.float32):
    return build_module(TN.NexusGenMerger, cfg, TN.convert_nexus_gen_merger(torch_sd(sd), cfg),
                        "cpu", dtype)


def port_adapter(sd, dtype=torch.float32):
    out_dim, in_dim = sd["adapter.0.weight"].shape
    return build_module(lambda cfg, dtype: TN.NexusGenAdapter(in_dim, out_dim, dtype=dtype),
                        None, TN.convert_nexus_gen_adapter(torch_sd(sd)), "cpu", dtype)


# ------------------------------------------------------------ Step1x

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step1x_connector(dtype):
    jcfg, tcfg = JS.STEP1X_CONNECTOR_TINY, TS.STEP1X_CONNECTOR_TINY
    sd = connector_state_dict(tcfg)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = JS.convert_step1x_connector(sd, jcfg, dtype=jdt)
    model = port_connector(sd, tcfg, tdt)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, tcfg.in_channels)).astype(np.float32)
    t = np.asarray([0.5, 0.9], np.float32)
    mask = np.ones((2, 9), np.int64)
    mask[1, 5:] = 0
    want_ctx, want_pool = JS.step1x_connector_forward(jp, jcfg, jnp.asarray(x, jdt),
                                                      jnp.asarray(t), jnp.asarray(mask))
    with torch.no_grad():
        ctx, pool = TS.step1x_connector_forward(model, torch.from_numpy(x).to(tdt),
                                                torch.from_numpy(t), torch.from_numpy(mask))
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert ctx.shape == (2, 9, tcfg.hidden_size) and pool.shape == (2, tcfg.pooled_dim)
    assert _rel(ctx.float(), np.asarray(want_ctx, np.float32)) < tol
    assert _rel(pool.float(), np.asarray(want_pool, np.float32)) < tol


# ------------------------------------------------------------ Nexus-Gen

def test_nexus_gen_adapter():
    sd = adapter_state_dict(16, 24)
    jp = JN.convert_nexus_gen_adapter(sd, dtype=jnp.float32)
    model = port_adapter(sd)
    x = np.random.default_rng(0).standard_normal((1, 5, 16)).astype(np.float32)
    want = JN.nexus_gen_adapter_forward(jp, jnp.asarray(x))
    with torch.no_grad():
        got = TN.nexus_gen_adapter_forward(model, torch.from_numpy(x))
    assert _rel(got, want) < TOL_F32


def test_merger_rope_tables_bit_equal():
    for jcfg, tcfg, grids in ((JN.NEXUS_GEN_MERGER_TINY, TN.NEXUS_GEN_MERGER_TINY,
                               ([[1, 4, 4]], [[1, 8, 8]])),
                              (JN.NEXUS_GEN_MERGER, TN.NEXUS_GEN_MERGER,
                               ([[1, 18, 18]], [[1, 74, 74]]))):
        for g in grids:
            jpos = JN.merger_position_ids(jcfg, np.asarray(g))
            tpos = TN.merger_position_ids(tcfg, np.asarray(g))
            np.testing.assert_array_equal(tpos, jpos)
            for a, b in zip(TN.mrope_tables(tcfg, tpos), JN.mrope_tables(jcfg, jpos)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_ref", [False, True])
def test_nexus_gen_merger(with_ref):
    jcfg, tcfg = JN.NEXUS_GEN_MERGER_TINY, TN.NEXUS_GEN_MERGER_TINY
    sd = merger_state_dict(tcfg)
    jp = JN.convert_nexus_gen_merger(sd, jcfg, dtype=jnp.float32)
    model = port_merger(sd, tcfg)
    rng = np.random.default_rng(2)
    grid = np.asarray([[1, 4, 4]], np.int64)
    embeds = rng.standard_normal((1, 4, tcfg.hidden_size)).astype(np.float32)
    ref, ref_grid = None, None
    if with_ref:
        ref_grid = np.asarray([[1, 8, 8]], np.int64)
        ref = rng.standard_normal((1, 16, tcfg.hidden_size)).astype(np.float32)
    want = JN.nexus_gen_merger_forward(jp, jcfg, jnp.asarray(embeds), grid,
                                       None if ref is None else jnp.asarray(ref), ref_grid)
    with torch.no_grad():
        got = TN.nexus_gen_merger_forward(model, torch.from_numpy(embeds), grid,
                                          None if ref is None else torch.from_numpy(ref),
                                          ref_grid)
    assert got.shape == (1, 20 if with_ref else 4, tcfg.out_channel)
    assert _rel(got, want) < TOL_F32


# ------------------------------------------------------------ FLUX's paths

NEXUS_HIDDEN = 16


def _fake_qwenvl(caps, refs):
    """The JAX test's Step1x embedder stand-in."""
    return (np.random.default_rng(0).standard_normal((1, 6, 16)).astype(np.float32),
            np.ones((1, 6), np.int64))


def _fake_ar(prompt, ref_image=None):
    """The JAX test's Nexus-Gen AR stand-in."""
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((4, NEXUS_HIDDEN)).astype(np.float32)
    if ref_image is None:
        return embed, None, np.asarray([[1, 4, 4]])
    ref = rng.standard_normal((4, NEXUS_HIDDEN)).astype(np.float32)
    return embed, ref, np.asarray([[1, 4, 4], [1, 4, 4]])


def with_step1x_and_nexus(jp, tp, nexus: bool):
    """Copies of the JAX and port FLUX pipelines with the JAX tests'
    connector (1 block, FLUX's context and pooled widths) and embedder
    stand-in, and with `nexus`, the Nexus-Gen adapter and merger and the AR
    stand-in; the same weights on both sides."""
    jp, tp = copy.copy(jp), copy.copy(tp)
    d = jp.dit_cfg
    jc = JS.Step1xConnectorConfig(in_channels=16, hidden_size=d.context_dim, num_heads=2,
                                  depth=1, pooled_dim=d.pooled_dim)
    tc = TS.Step1xConnectorConfig(**jc.__dict__)
    sd = connector_state_dict(tc, seed=3)
    jp.step1x_connector_params, jp.step1x_connector_cfg = \
        JS.convert_step1x_connector(sd, jc, dtype=jnp.float32), jc
    tp.step1x_connector = port_connector(sd, tc)
    jp.qwenvl = tp.qwenvl = _fake_qwenvl
    if nexus:
        mk = dict(hidden_size=NEXUS_HIDDEN, num_heads=2, num_kv_heads=1, intermediate_size=24,
                  out_channel=d.context_dim, mrope_section=(2, 1, 1), base_grid=(1, 8, 8))
        jm, tm = JN.NexusGenMergerConfig(**mk), TN.NexusGenMergerConfig(**mk)
        asd, msd = adapter_state_dict(NEXUS_HIDDEN, d.context_dim, 4), merger_state_dict(tm, 5)
        jp.nexus_gen_generation_adapter = JN.convert_nexus_gen_adapter(asd, dtype=jnp.float32)
        jp.nexus_gen_editing_adapter = (JN.convert_nexus_gen_merger(msd, jm, dtype=jnp.float32),
                                        jm)
        tp.nexus_gen_generation_adapter = port_adapter(asd)
        tp.nexus_gen_editing_adapter = port_merger(msd, tm)
        jp.nexus_gen = tp.nexus_gen = _fake_ar
    return jp, tp


def _image(seed, h=64, w=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


FLUX_CASES = {
    "step1x": (False, dict(step1x_reference_image=_image(3))),
    "step1x_cfg": (False, dict(step1x_reference_image=_image(3), cfg_scale=2.0,
                               negative_prompt="blurry")),
    "nexus_gen": (True, {}),
    "nexus_gen_edit": (True, dict(nexus_gen_reference_image=_image(4))),
}


@pytest.mark.parametrize("name", sorted(FLUX_CASES))
def test_flux_paths_match_jax(pipes, name):  # noqa: F811
    nexus, req = FLUX_CASES[name]
    jp, tp = with_step1x_and_nexus(*pipes, nexus)
    kw = {**BASE, **req}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    plain = tp.__class__.__call__(pipes[1], return_latents=True, **BASE).numpy()
    assert np.abs(got - plain).mean() > 1e-4


# ------------------------------------------------------------ the AR model

class _Processor:
    """A test-side stand-in for the Qwen2.5-VL processor the JAX class
    takes: the chat template, the image preprocessing at the processor's
    default pixel budget (the JAX package's `preprocess_image`), the pad
    expansion and the stand-in tokenizer."""

    def __init__(self, tok):
        self.tok = tok

    @staticmethod
    def apply_chat_template(messages, tokenize=False, add_generation_prompt=False):
        return "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages)

    def __call__(self, text, images, padding=True, return_tensors="pt"):
        from video_styler_tpu.models.qwen_vl_vision import QwenVLVisionConfig, preprocess_image
        vcfg = QwenVLVisionConfig(**VISION)
        pats, grids = zip(*[preprocess_image(im, vcfg, 56 * 56, 28 * 28 * 1280)
                            for im in images])
        out, rest = [], text[0]
        for t, h, w in grids:
            head, _, rest = rest.partition("<|image_pad|>")
            out.append(head + "<|image_pad|>" * (t * h * w // 4))
        ids = self.tok("".join(out) + rest, return_tensors="np")["input_ids"]
        return {"input_ids": torch.from_numpy(np.asarray(ids, np.int64)),
                "attention_mask": torch.ones(ids.shape, dtype=torch.long),
                "pixel_values": torch.from_numpy(np.concatenate(pats, 0)),
                "image_grid_thw": torch.tensor(grids)}


class _HFShim:
    """The JAX class reads `model.model.embed_tokens`, which transformers
    4.57's Qwen2_5_VLModel keeps under `language_model`; this exposes the
    same modules under the names the class uses."""

    def __init__(self, hf):
        self.visual, self.config = hf.model.visual, hf.config
        inner = hf.model

        class _Inner:
            embed_tokens = inner.language_model.embed_tokens
            get_rope_index = staticmethod(inner.get_rope_index)

            def __call__(self, **kw):
                return inner(**kw)
        self.model = _Inner()


def _hf_vl(tok):
    """A tiny `Qwen2_5_VLForConditionalGeneration` (the widths of
    `test_torch_qwen_vl`) holding `vl_state_dict()`'s weights."""
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration
    s = tok.special_ids
    cfg = Qwen2_5_VLConfig(
        vocab_size=TEXT["vocab_size"], hidden_size=TEXT["hidden"],
        intermediate_size=TEXT["ffn"], num_hidden_layers=TEXT["num_layers"],
        num_attention_heads=TEXT["num_heads"], num_key_value_heads=TEXT["num_kv_heads"],
        rms_norm_eps=TEXT["eps"], rope_theta=TEXT["rope_theta"],
        rope_scaling={"type": "default", "mrope_section": [16, 24, 24]},
        image_token_id=s["<|image_pad|>"], video_token_id=s["<|video_pad|>"],
        vision_start_token_id=s["<|vision_start|>"], vision_end_token_id=s["<|vision_end|>"],
        vision_config=dict(depth=VISION["depth"], hidden_size=VISION["hidden"],
                           num_heads=VISION["num_heads"], intermediate_size=VISION["intermediate"],
                           out_hidden_size=VISION["out_hidden"], in_channels=3,
                           patch_size=VISION["patch"], temporal_patch_size=VISION["temporal_patch"],
                           spatial_merge_size=VISION["merge"], window_size=VISION["window"],
                           fullatt_block_indexes=list(VISION["fullatt"]), hidden_act="silu"),
        attn_implementation="eager")
    hf = Qwen2_5_VLForConditionalGeneration(cfg).eval()
    sd = {("model.language_model." + k[len("model."):] if k.startswith("model.")
           else "model." + k): torch.from_numpy(v) for k, v in vl_state_dict().items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {"lm_head.weight"}, (missing, unexpected)
    return hf


@pytest.mark.parametrize("with_ref", [False, True])
def test_nexus_gen_ar_model(with_ref):
    """The port's `NexusGenARModel` on its own Qwen2.5-VL modules against the
    JAX class over `transformers`' Qwen2.5-VL (built from a config here) on
    the same weights, vision head and prefill embeds, with the stand-in
    tokenizer and a test-side processor."""
    tok = stub_tokenizer()
    rng = np.random.default_rng(7)
    hid = TEXT["hidden"]
    vh_w = (rng.standard_normal((VISION["out_hidden"], hid)) / np.sqrt(hid)).astype(np.float32)
    vh_b = (0.05 * rng.standard_normal(VISION["out_hidden"])).astype(np.float32)
    prefill = rng.standard_normal((TN.NUM_IMG_TOKENS, hid)).astype(np.float32)
    jm = JN.NexusGenARModel(_HFShim(_hf_vl(tok)), _Processor(tok), vh_w.T, vh_b, prefill)
    sd = {**torch_sd(vl_state_dict()), "vision_head.weight": torch.from_numpy(vh_w),
          "vision_head.bias": torch.from_numpy(vh_b),
          "image_prefill_embeds.weight": torch.from_numpy(prefill)}
    tcfg, vcfg = TL.DecoderLMConfig(**TEXT), TV.QwenVLVisionConfig(**VISION)
    tm = TN.NexusGenARModel.from_state_dict(sd, tok, device="cpu", dtype=torch.float32,
                                            text_cfg=tcfg, vision_cfg=vcfg, **token_ids(tok))
    ref = synthetic_image(11, 64, 48) if with_ref else None
    want = jm("a watercolor fox", ref)
    got = tm("a watercolor fox", ref)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == (TN.NUM_IMG_TOKENS, VISION["out_hidden"])
    assert _rel(got[0], want[0]) < TOL_F32, _rel(got[0], want[0])
    if with_ref:
        assert _rel(got[1], want[1]) < TOL_F32
    else:
        assert got[1] is None and want[1] is None


def test_jax_ar_model_fault_with_transformers_457():
    """The JAX `NexusGenARModel` reads `model.model.embed_tokens`, which
    transformers 4.57's `Qwen2_5_VLModel` keeps under `language_model`: on
    the model as `from_pretrained` builds it, the JAX class raises an
    AttributeError (ROADMAP Queue 3); the port's class needs no
    `transformers`."""
    tok = stub_tokenizer()
    hid = TEXT["hidden"]
    jm = JN.NexusGenARModel(_hf_vl(tok), _Processor(tok),
                            np.zeros((hid, VISION["out_hidden"]), np.float32),
                            np.zeros(VISION["out_hidden"], np.float32),
                            np.zeros((TN.NUM_IMG_TOKENS, hid), np.float32))
    with pytest.raises(AttributeError, match="embed_tokens"):
        jm("a watercolor fox")
