"""The Qwen2.5-VL stack against the JAX package: the decoder tower in both
families (Qwen2 with q/k/v biases and pad-key masking, LLaMA stopped a
layer early without the final norm; fp32 and bf16), `mrope_tables`, the
vision tower on one grid and on two images, `preprocess_image` and
`smart_resize` (bit-equal), `get_rope_index` (bit-equal), `QwenVL`
(`encode_ids`, and an edit prompt with one image and with two),
`_split_string` and `QwenVLStep1xEmbedder`.

Weights: HF-named state dicts drawn from a numpy seed, read by both
packages' converters. Widths: a text tower of 2 layers, 2 heads of 128 and
one k/v head over a 128-token vocabulary (heads of 128 so that both
packages' `detect_decoder_lm_config` read it), a vision tower of 8 blocks,
160 wide (2 heads of 80: both `detect_vision_config`s read it), patch 14
and the release's merge and window; `StubQwenTokenizer` gives the ids, its
special tokens at the vocabulary's top. fp32 within 2e-5 relative L2 (the
JAX tests' rtol); bf16 within the bound stated at the test.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.llm_decoder as JL
import video_styler_tpu.models.qwen_vl_embedder as JE
import video_styler_tpu.models.qwen_vl_vision as JV

import video_styler_tpu_torch.models.llm_decoder as TL
import video_styler_tpu_torch.models.qwen_vl_embedder as TE
import video_styler_tpu_torch.models.qwen_vl_vision as TV
from video_styler_tpu_torch.utils.ckpt import build_module

from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401

TOL_F32 = 2e-5
TOL_BF16 = 3e-2

TEXT = dict(vocab_size=128, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, ffn=128,
            rope_theta=1000000.0, eps=1e-6, qkv_bias=True)
LLAMA = dict(TEXT, rope_theta=500000.0, eps=1e-5, qkv_bias=False, num_layers=3)
VISION = dict(depth=8, hidden=160, num_heads=2, intermediate=96, out_hidden=256, patch=14,
              temporal_patch=2, merge=2, window=112, fullatt=(7,))


def text_cfgs(fields=TEXT):
    return JL.DecoderLMConfig(**fields), TL.DecoderLMConfig(**fields)


def vision_cfgs():
    return JV.QwenVLVisionConfig(**VISION), TV.QwenVLVisionConfig(**VISION)


def hf_text_sd(fields=TEXT, seed: int = 0, prefix: str = "model."):
    """An HF Qwen2 / Llama state dict drawn from a numpy seed (norm scales
    and biases perturbed)."""
    rng = np.random.default_rng(seed)
    cfg = TL.DecoderLMConfig(**fields)
    kv = cfg.num_kv_heads * cfg.head_dim

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def n(d):
        return (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)

    sd = {"embed_tokens.weight": (0.5 * rng.standard_normal((cfg.vocab_size, cfg.hidden))
                                  ).astype(np.float32), "norm.weight": n(cfg.hidden)}
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        sd[f"{b}.input_layernorm.weight"] = n(cfg.hidden)
        sd[f"{b}.post_attention_layernorm.weight"] = n(cfg.hidden)
        for name, o, i_ in (("self_attn.q_proj", cfg.hidden, cfg.hidden),
                            ("self_attn.k_proj", kv, cfg.hidden),
                            ("self_attn.v_proj", kv, cfg.hidden),
                            ("self_attn.o_proj", cfg.hidden, cfg.hidden),
                            ("mlp.gate_proj", cfg.ffn, cfg.hidden),
                            ("mlp.up_proj", cfg.ffn, cfg.hidden),
                            ("mlp.down_proj", cfg.hidden, cfg.ffn)):
            sd[f"{b}.{name}.weight"] = w(o, i_)
            if cfg.qkv_bias and name[-6:] in ("q_proj", "k_proj", "v_proj"):
                sd[f"{b}.{name}.bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
    return {prefix + k: v for k, v in sd.items()}


def hf_vision_sd(seed: int = 1):
    """An HF `visual.*` state dict drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfg = TV.QwenVLVisionConfig(**VISION)
    h, mu = cfg.hidden, cfg.merge_unit

    def lin(name, o, i):
        return {f"{name}.weight": (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32),
                f"{name}.bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    sd = {"patch_embed.proj.weight": (rng.standard_normal(
        (h, 3, cfg.temporal_patch, cfg.patch, cfg.patch)) / np.sqrt(cfg.patch_dim)
    ).astype(np.float32), "merger.ln_q.weight": (1 + 0.1 * rng.standard_normal(h)
                                                 ).astype(np.float32)}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for nm in ("norm1", "norm2"):
            sd[f"{b}.{nm}.weight"] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
        sd.update(lin(f"{b}.attn.qkv", 3 * h, h))
        sd.update(lin(f"{b}.attn.proj", h, h))
        sd.update(lin(f"{b}.mlp.gate_proj", cfg.intermediate, h))
        sd.update(lin(f"{b}.mlp.up_proj", cfg.intermediate, h))
        sd.update(lin(f"{b}.mlp.down_proj", h, cfg.intermediate))
    sd.update(lin("merger.mlp.0", mu * h, mu * h))
    sd.update(lin("merger.mlp.2", cfg.out_hidden, mu * h))
    return {"visual." + k: v for k, v in sd.items()}


def vl_state_dict():
    return {**hf_text_sd(), **hf_vision_sd()}


def torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def stub_tokenizer():
    return TE.StubQwenTokenizer(TEXT["vocab_size"])


def token_ids(tok):
    s = tok.special_ids
    return dict(image_token_id=s["<|image_pad|>"], video_token_id=s["<|video_pad|>"],
                vision_end_token_id=s["<|vision_end|>"])


def both_vl(dtype=np.float32):
    """The JAX and the port's QwenVL on one checkpoint (configs detected)."""
    sd = vl_state_dict()
    tok = stub_tokenizer()
    jvl = JE.QwenVL(sd, tok, dtype=jnp.dtype(dtype), **token_ids(tok))
    tvl = TE.QwenVL.from_state_dict(torch_sd(sd), tok, device="cpu",
                                    dtype=getattr(torch, np.dtype(dtype).name), **token_ids(tok))
    return jvl, tvl


def test_configs_detected_alike():
    sd = vl_state_dict()
    jt, tt = text_cfgs()
    text = {k: v for k, v in sd.items() if "visual" not in k}
    assert JL.detect_decoder_lm_config(text, "qwen") == jt
    assert dataclasses.asdict(TL.detect_decoder_lm_config(text, "qwen")) == dataclasses.asdict(jt)
    vis = {k: v for k, v in sd.items() if "visual" in k}
    jv, tv = vision_cfgs()
    assert JV.detect_vision_config(vis) == jv
    assert dataclasses.asdict(TV.detect_vision_config(vis)) == dataclasses.asdict(jv)


# ------------------------------------------------------------ decoder

@pytest.mark.parametrize("family,dtype", [("qwen", "float32"), ("llama", "float32"),
                                          ("qwen", "bfloat16")])
def test_decoder_parity(family, dtype):
    """Qwen2 (biases, pad keys masked, final norm) and LLaMA (no biases, one
    layer skipped, no final norm, as HunyuanVideo reads it)."""
    fields = TEXT if family == "qwen" else LLAMA
    jcfg, tcfg = text_cfgs(fields)
    sd = hf_text_sd(fields, seed=3, prefix="model." if family == "qwen" else "")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, fields["vocab_size"], (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[1, 8:] = 0
    skip = 1 if family == "llama" else 0
    jp = JL.convert_decoder_lm(sd, jcfg, dtype=jnp.dtype(dtype))
    want = np.asarray(JL.decoder_lm_forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                            stop_skip_layers=skip), np.float32)
    tdt = getattr(torch, dtype)
    model = build_module(TL.DecoderLM, tcfg, TL.convert_decoder_lm(torch_sd(sd), tcfg), "cpu",
                         tdt)
    with torch.no_grad():
        got = TL.decoder_lm_forward(model, torch.from_numpy(ids).long(),
                                    torch.from_numpy(mask), stop_skip_layers=skip
                                    ).float().numpy()
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert _rel(got, want) < tol, _rel(got, want)


def test_mrope_tables():
    jcfg, tcfg = text_cfgs()
    rng = np.random.default_rng(5)
    pos = np.stack([np.arange(40), rng.integers(0, 9, 40), rng.integers(0, 9, 40)])
    for (jc, js), (tc, ts) in [
            (JL.mrope_tables(jcfg, pos, JE.MROPE_SECTION),
             TL.mrope_tables(tcfg, pos, TE.MROPE_SECTION)),
            (JL.rope_tables(jcfg, 40), TL.rope_tables(tcfg, 40))]:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    # text only: the three streams equal, the plain RoPE
    same = np.broadcast_to(np.arange(40), (3, 40))
    np.testing.assert_allclose(TL.mrope_tables(tcfg, same, TE.MROPE_SECTION)[0].numpy(),
                               TL.rope_tables(tcfg, 40)[0].numpy(), rtol=0, atol=2e-6)


# ------------------------------------------------------------ vision

@pytest.mark.parametrize("grids", [[(1, 12, 20)], [(1, 12, 20), (1, 8, 8)]])
def test_vision_tower(grids):
    jcfg, tcfg = vision_cfgs()
    sd = hf_vision_sd()
    jplan, tplan = JV.vision_plan(grids, jcfg), TV.vision_plan(grids, tcfg)
    assert sorted(jplan) == sorted(tplan)
    for k in jplan:
        np.testing.assert_array_equal(tplan[k], jplan[k], err_msg=k)
    n = sum(t * h * w for t, h, w in grids)
    patches = np.random.default_rng(6).standard_normal((n, tcfg.patch_dim)).astype(np.float32)
    jp = JV.convert_qwen_vl_vision(sd, jcfg, dtype=jnp.float32)
    want = np.asarray(JV.vision_forward(jp, jcfg, jnp.asarray(patches), jplan))
    model = build_module(TV.QwenVLVision, tcfg, TV.convert_qwen_vl_vision(torch_sd(sd), tcfg),
                         "cpu", torch.float32)
    with torch.no_grad():
        got = TV.vision_forward(model, torch.from_numpy(patches), tplan).numpy()
    assert got.shape == (n // 4, VISION["out_hidden"])
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def synthetic_image(seed: int, w: int, h: int):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("size,pixels", [((64, 48), (56 * 56, 28 * 28 * 1280)),
                                         ((700, 300), (256 * 28 * 28, 1280 * 28 * 28)),
                                         ((1500, 1400), (56 * 56, 320 * 28 * 28))])
def test_preprocess_image_bit_equal(size, pixels):
    img = synthetic_image(7, *size)
    jflat, jgrid = JV.preprocess_image(img, JV.QWEN25_VL_7B_VISION, *pixels)
    tflat, tgrid = TV.preprocess_image(img, TV.QWEN25_VL_7B_VISION, *pixels)
    assert tgrid == jgrid
    np.testing.assert_array_equal(tflat, jflat)
    for hw in ((20, 3000), (333, 777), (2000, 2000), (28, 28)):
        assert TV.smart_resize(*hw) == JV.smart_resize(*hw)
    for mod in (JV, TV):
        with pytest.raises(ValueError, match="aspect ratio"):
            mod.smart_resize(10, 2500)


def test_get_rope_index():
    tok = stub_tokenizer()
    pad = tok.special_ids["<|image_pad|>"]
    ids = np.array([5, 6, 7] + [pad] * 6 + [8, 9] + [pad] * 4 + [10, 11, 12])
    grids = [(1, 4, 6), (1, 4, 4)]
    kw = dict(merge=2, tokens_per_second=2, image_token_id=pad)
    np.testing.assert_array_equal(TV.get_rope_index(ids, grids, **kw),
                                  JV.get_rope_index(ids, grids, **kw))
    np.testing.assert_array_equal(TV.get_rope_index(ids[:3], [], **kw),
                                  JV.get_rope_index(ids[:3], [], **kw))


# ------------------------------------------------------------ QwenVL

@pytest.fixture(scope="module")
def vls():
    return both_vl()


def test_encode_ids_text(vls):
    jvl, tvl = vls
    ids = np.asarray(stub_tokenizer()("a lighthouse on a cliff at dawn")["input_ids"][0])
    want = jvl.encode_ids(ids)
    got = tvl.encode_ids(ids).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < TOL_F32, _rel(got, want)


@pytest.mark.parametrize("n_images", [1, 2])
def test_encode_with_images(vls, n_images):
    """One image in the edit template's block, or two as "Picture i:"
    blocks (each resized by the pipeline's `_resize_vl` in the edit)."""
    jvl, tvl = vls
    images = [synthetic_image(8 + i, 64 + 32 * i, 64) for i in range(n_images)]
    text = (TE.CHAT_PREFIX + "".join(f"Picture {i + 1}: " + TE.IMG_BLOCK
                                     for i in range(n_images)) + "make it snow" + TE.CHAT_SUFFIX)
    want, jids = jvl.encode(text, images)
    got, tids = tvl.encode(text, images)
    np.testing.assert_array_equal(tids, jids)
    assert (tids == tvl.image_token_id).sum() > 0
    assert _rel(got.numpy(), want) < TOL_F32, _rel(got.numpy(), want)


@pytest.mark.parametrize("s", [
    "short, no quotes",
    "x" * 150 + ' then a "quoted span" and “curly” and \'single\' quotes',
    "y" * 200 + ' "open without close'])
def test_split_string(s):
    assert TE._split_string(s) == JE._split_string(s)


def test_step1x_embedder(vls):
    jvl, tvl = vls
    captions = ["add a red hat", "x" * 120 + ' write "HELLO" on the wall']
    refs = [synthetic_image(11, 64, 64), synthetic_image(12, 96, 64)]
    want_e, want_m = JE.QwenVLStep1xEmbedder(jvl, max_length=640)(captions, refs)
    got_e, got_m = TE.QwenVLStep1xEmbedder(tvl, max_length=640)(captions, refs)
    np.testing.assert_array_equal(got_m, want_m)
    assert want_m.sum() > 0
    assert _rel(got_e, want_e) < TOL_F32, _rel(got_e, want_e)


def test_stub_tokenizer_specials():
    tok = stub_tokenizer()
    out = tok(["<|im_start|>user\nhi, there<|im_end|>"], max_length=4, padding=True,
              truncation=True, return_tensors="np")
    ids = out["input_ids"][0]
    assert ids[0] == tok.special_ids["<|im_start|>"] and len(ids) == 4
    assert max(tok.encode("plain words only")) < tok.n_words
    assert TE.StubQwenTokenizer(152064).special_ids == TE.SPECIAL_TOKENS
