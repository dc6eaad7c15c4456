"""OmniGen and Omost against the JAX package: the 2-D position table and
its crop, the LongRoPE tables (with Phi-3's su factors), the prompter
(placeholder runs, masks, positions), `crop_arr_size`, the transformer in
fp32 and bf16 with a reference image spliced in, `convert.from_jax_params`,
`OmnigenImagePipeline` (text CFG, image CFG with a reference image,
image-to-image), `load_model` on an OmniGen file, `image_gen --family
omnigen` (its smoke, and the tokenizer it needs beside the JAX runner's);
then Omost's `Canvas` and `OmostPrompter`, and the SD pipeline driven by
the Omost extender (port side; its extension of the request against the
JAX prompter's).

Weights: the release's names drawn from a numpy seed, read by both
packages' converters. Widths: `OMNIGEN_TINY` (32 wide, 4 heads of 8, 2
layers; its heads are too narrow for the 48 su factors, so the pipelines
run without them, as the smoke does), the stand-in Phi-3 tokenizer, the
SDXL VAE at its release widths at 32x32 (its JAX functions jitted), the
SD smoke pipeline of `image_gen` for Omost. Tolerances: fp32 within 2e-5
relative L2 (the pipelines through the VAE encoder 1e-4), bf16 within
2e-2.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.omnigen as JO
import video_styler_tpu.models.sd as JS
import video_styler_tpu.pipelines.omnigen_image as JP
import video_styler_tpu.prompters.omnigen_prompter as JPR
import video_styler_tpu.prompters.omost as JOM

import video_styler_tpu_torch.models.omnigen as TO
import video_styler_tpu_torch.models.sd as TS
import video_styler_tpu_torch.pipelines.omnigen_image as TP
import video_styler_tpu_torch.prompters.omnigen_prompter as TPR
import video_styler_tpu_torch.prompters.omost as TOM
from video_styler_tpu_torch import image_gen, safetensors_io
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.utils import ckpt as TC

from test_omost_local_prompts import BOT_RESPONSE
from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_hunyuan_image import draw_state_dict, to_torch
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5
TOL_PIPE = 1e-4
TOL_BF16 = 2e-2
CFG_T, CFG_J = TO.OMNIGEN_TINY, JO.OMNIGEN_TINY
TOK = TPR.StubPhi3Tokenizer(CFG_T.vocab_size)


@functools.lru_cache(maxsize=None)
def _sd(pos_embed: bool = True):
    sd = draw_state_dict(TO.OmniGen(CFG_T, device="meta"), 0)
    for name in ("x_embedder.proj.weight", "input_x_embedder.proj.weight"):
        sd[name] = sd[name].reshape(-1, CFG_T.in_channels, 2, 2)
    sd.pop("pos_embed")
    if pos_embed:
        sd["pos_embed"] = TO.get_2d_sincos_pos_embed(CFG_T)[None]
    return sd


def port_model(dtype=torch.float32, pos_embed: bool = True):
    return TC.build_module(TO.OmniGen, CFG_T, TO.convert_omnigen(to_torch(_sd(pos_embed)), CFG_T),
                           "cpu", dtype)


def jax_model(dtype=jnp.float32):
    return JO.convert_omnigen(to_torch(_sd()), CFG_J, dtype=dtype)


# ------------------------------------------------------------ tables, prompter

def test_position_and_rope_tables_bit_equal():
    # the release's width over a 16 x 16 table (192 x 192 holds 113 M values)
    mid_t = dataclasses.replace(TO.OMNIGEN, pos_embed_max_size=16)
    mid_j = dataclasses.replace(JO.OMNIGEN, pos_embed_max_size=16)
    for ct, cj in ((CFG_T, CFG_J), (mid_t, mid_j)):
        a, b = TO.get_2d_sincos_pos_embed(ct), JO.get_2d_sincos_pos_embed(cj)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TO.cropped_pos_embed(ct, a, 8, 12),
                                      JO.cropped_pos_embed(cj, b, 8, 12))
    pos = np.arange(40)[None]
    for ct, cj, su in ((CFG_T, CFG_J, None), (TO.OMNIGEN, JO.OMNIGEN, TO.PHI3_SU_SHORT)):
        for x, y in zip(TO.longrope_tables(ct, pos, su), JO.longrope_tables(cj, pos, su)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TO.PHI3_SU_SHORT, JO.PHI3_SU_SHORT)


@pytest.mark.parametrize("refs", [[], [(32, 32)], [(32, 48), (16, 16)]])
def test_prompter_matches_jax(refs):
    prompt = "a cat on a sofa" + "".join(f" <img><|image_{i + 1}|></img>"
                                         for i in range(len(refs)))
    got = TPR.OmniGenPrompter(TOK)(prompt, refs, 64, 64, use_img_cfg=bool(refs))
    want = JPR.OmniGenPrompter(TOK)(prompt, refs, 64, 64, use_img_cfg=bool(refs))
    assert len(got) == len(want) == (3 if refs else 2)
    for g, w in zip(got, want):
        assert g["image_sizes"] == w["image_sizes"]
        for key in ("input_ids", "attention_mask", "position_ids"):
            np.testing.assert_array_equal(g[key], w[key])
    for size in ((1000, 700), (3000, 2100), (10, 40)):
        assert TPR.crop_arr_size(*size) == JPR.crop_arr_size(*size)


# ------------------------------------------------------------ transformer

def _inputs():
    rng = np.random.default_rng(4)
    br = TPR.OmniGenPrompter(TOK)("a cat <img><|image_1|></img>", [(32, 32)], 32, 32)[0]
    x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    ref = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    return br, x, ref, np.array([0.37], np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_matches_jax(dtype):
    td, jd = (torch.float32, jnp.float32) if dtype == "fp32" else (torch.bfloat16, jnp.bfloat16)
    br, x, ref, t = _inputs()
    sizes = {0: br["image_sizes"][0]}
    jp = jax_model(jd)
    want = JO.omnigen_forward(jp, CFG_J, jnp.asarray(x, jd), jnp.asarray(t),
                              jnp.asarray(br["input_ids"]), [jnp.asarray(ref, jd)], sizes,
                              jnp.asarray(br["attention_mask"]), br["position_ids"])
    with torch.no_grad():
        got = TO.omnigen_forward(port_model(td), torch.from_numpy(x).to(td), torch.from_numpy(t),
                                 torch.from_numpy(br["input_ids"]),
                                 [torch.from_numpy(ref).to(td)], sizes,
                                 torch.from_numpy(br["attention_mask"]), br["position_ids"])
    assert got.shape == x.shape
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < (
        TOL_F32 if dtype == "fp32" else TOL_BF16)
    if dtype == "fp32":
        tree = from_jax_params("omnigen", _tree(jp), CFG_T, device="cpu").state_dict()
        for k, v in port_model().state_dict().items():
            torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)
        # a file without the position table builds the sin-cos one
        torch.testing.assert_close(port_model(pos_embed=False).pos_embed,
                                   port_model().pos_embed, rtol=0, atol=0)


# ------------------------------------------------------------ pipeline

@functools.lru_cache(maxsize=None)
def _vae():
    gen = torch.Generator().manual_seed(8)
    return (TS.init_sd_module_(TS.SDVAEEncoder(), gen).eval(),
            TS.init_sd_module_(TS.SDVAEDecoder(), gen).eval())


def _pipelines():
    enc, dec = _vae()
    tp = TP.OmnigenImagePipeline(device="cpu", dtype=torch.float32)
    tp.cfg, tp.su_factor, tp.transformer = CFG_T, None, port_model()
    tp.vae_encoder, tp.vae_decoder = enc, dec
    tp.prompter.tokenizer = TOK
    jp = JP.OmnigenImagePipeline(dtype=jnp.float32)
    jp.cfg, jp.su_factor, jp.transformer_params = CFG_J, None, jax_model()
    jp.vae_encoder_params = JS.convert_sd_module(_reference_names(enc))
    jp.vae_decoder_params = JS.convert_sd_module(_reference_names(dec))
    jp.prompter.tokenizer = TOK
    return tp, jp


def _picture(seed: int, h: int = 32, w: int = 32):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("case", ["text cfg", "image cfg", "img2img"])
def test_pipeline_matches_jax(case, monkeypatch):
    for name in ("sd_vae_encoder_forward", "sd_vae_decoder_forward"):
        monkeypatch.setattr(JS, name, jax.jit(getattr(JS, name)))
    tp, jp = _pipelines()
    kw = dict(prompt="a cat on a sofa", height=32, width=32, num_inference_steps=2, seed=3,
              return_latents=True)
    if case == "image cfg":
        kw.update(prompt="the cat <img><|image_1|></img> in the snow",
                  reference_images=[_picture(5)])
    if case == "img2img":
        kw.update(input_image=_picture(6), denoising_strength=0.6)
    want, got = jp(**kw), tp(**kw)
    assert got.shape == (1, 4, 4, 4)
    assert _rel(got.numpy(), want) < (TOL_F32 if case == "text cfg" else TOL_PIPE)


def test_load_model_and_cli(tmp_path, monkeypatch, capsys):
    """`load_model` builds OmniGen; the smoke runs; without a tokenizer
    the CLI names it, where the JAX runner's prompter calls None."""
    monkeypatch.setattr(TO, "OMNIGEN", CFG_T)
    path = str(tmp_path / "omnigen.safetensors")
    safetensors_io.save_file(to_torch(_sd()), path)
    kind, model = TC.load_model(path, device="cpu", dtype=torch.float32)
    assert kind == "omnigen" and isinstance(model, TO.OmniGen)
    for k, v in port_model().state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    out = tmp_path / "o.png"
    assert image_gen.main(["--family", "omnigen", "--smoke", "--device", "cpu",
                           "--height", "32", "--width", "32", "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="--vae_path, --tokenizer_path"):
        image_gen.main(["--family", "omnigen", "--dit_path", "d", "--device", "cpu"])
    with pytest.raises(TypeError, match="NoneType"):
        JPR.OmniGenPrompter()("x", [], 32, 32)


# ------------------------------------------------------------ Omost

def test_canvas_and_prompter_match_jax():
    got = TOM.Canvas.from_bot_response(BOT_RESPONSE).process()
    want = JOM.Canvas.from_bot_response(BOT_RESPONSE).process()
    np.testing.assert_array_equal(got["initial_latent"], want["initial_latent"])
    assert len(got["bag_of_conditions"]) == len(want["bag_of_conditions"]) == 3
    for g, w in zip(got["bag_of_conditions"], want["bag_of_conditions"]):
        np.testing.assert_array_equal(g["mask"], w["mask"])
        assert (g["prefixes"], g["suffixes"], g["location"]) == (
            w["prefixes"], w["suffixes"], w["location"])
    llm = lambda messages: BOT_RESPONSE  # noqa: E731
    pg, pw = TOM.OmostPrompter(llm)({"prompt": "x"}), JOM.OmostPrompter(llm)({"prompt": "x"})
    assert pg["prompt"] == pw["prompt"] and pg["prompts"] == pw["prompts"]
    for a, b in zip(pg["masks"], pw["masks"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        TOM.Canvas.from_bot_response("no code here")


def test_sd_pipeline_with_omost_extender():
    """The SD pipelines take the Omost prompter as their `prompt_extender`:
    its global prompt replaces the prompt and its regional prompts and
    masks join the masked blending at scale 100, as the JAX pipeline
    extends them (`pipelines/sd_image.py:222-227`); the request changes."""
    tp = image_gen.build_sd_smoke_pipeline(False, device="cpu")
    llm = lambda messages: BOT_RESPONSE  # noqa: E731
    prompt, local, masks, scales = tp.extend_prompt("a meadow", ["a red roof"], [None], [2.0],
                                                    TOM.OmostPrompter(llm))
    want = JOM.OmostPrompter(llm)({"prompt": "a meadow"})
    assert prompt == want["prompt"] and local == ["a red roof"] + want["prompts"]
    assert scales == [2.0] + [100.0] * len(want["masks"])
    for a, b in zip(masks[1:], want["masks"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    base = dict(prompt="a meadow", negative_prompt="blurry", cfg_scale=7.5, height=64,
                width=64, num_inference_steps=1, seed=3, return_latents=True)
    got = tp(**base, prompt_extender=TOM.OmostPrompter(llm))
    assert bool(torch.isfinite(got).all()) and _rel(tp(**base).numpy(), got.numpy()) > 1e-3
