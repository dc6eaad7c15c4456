"""StepVideo against the JAX package: the RoPE tables (bit-equal) and their
half rotation, the Step-1 LLM, the DiT forward in fp32 and bf16, the VAE's
decoder and encoder, `convert.from_jax_params` of the three trees,
`StepVideoPipeline` (CFG 1 and 9, the text encoders of
`fetch_text_encoders`, the decode), `load_model` on a Step-1 LLM file, and
`video_gen --family step_video` (its smoke, and the files it needs beside
the JAX runner's fault).

Weights: the reference's names drawn from a numpy seed, read by both
packages' converters. Widths: `STEP_VIDEO_TINY` (4 heads of 32, 2 blocks,
RoPE split (16, 8, 8)) on a 96-wide Step-1 LLM (`STEP1_LLM_TINY` otherwise)
and `HUNYUAN_BERT_TINY` as the bilingual CLIP; `STEP_VAE_TINY` keeps the
release's 512-channel widths (GroupNorm's 32 groups), so the VAE runs at
its smallest sizes: 17 frames of 16x16, 3 latent frames of 1x1. On the
CPU the port's attention is K1's plain version (the capped softmax) and the
JAX DiT takes the exact `sdpa` (heads of 32). Tolerances: fp32 within 2e-5
relative L2 (the VAE 1e-4: fp32 convolutions over many layers sum in
another order), bf16 within 2e-2.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.stepvideo_dit as JD
import video_styler_tpu.models.stepvideo_llm as JL
import video_styler_tpu.models.stepvideo_vae as JV
import video_styler_tpu.pipelines.step_video as JP

import video_styler_tpu_torch.models.stepvideo_dit as TD
import video_styler_tpu_torch.models.stepvideo_llm as TL
import video_styler_tpu_torch.models.stepvideo_vae as TV
import video_styler_tpu_torch.pipelines.step_video as TP
from video_styler_tpu_torch import safetensors_io, video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.pipelines.hunyuan_image import StubBertTokenizer
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_fun import _rel
from test_torch_hunyuan_image import BERT, draw_state_dict, jax_bert, port_bert, to_torch
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5
TOL_VAE = 1e-4
TOL_BF16 = 2e-2
CFG_T = dataclasses.replace(TD.STEP_VIDEO_TINY, clip_dim=BERT.dim)
CFG_J = dataclasses.replace(JD.STEP_VIDEO_TINY, clip_dim=BERT.dim)
LLM_T = dataclasses.replace(TL.STEP1_LLM_TINY, hidden_size=CFG_T.caption_dim)
LLM_J = dataclasses.replace(JL.STEP1_LLM_TINY, hidden_size=CFG_T.caption_dim)
VAE_T, VAE_J = TV.STEP_VAE_TINY, JV.STEP_VAE_TINY


# ------------------------------------------------------------ weights

@functools.lru_cache(maxsize=None)
def _dit_sd():
    sd = draw_state_dict(TD.StepVideoDiT(CFG_T, device="meta"), 0)
    for name in list(sd):
        if name.endswith("scale_shift_table"):
            sd[name] = (np.random.default_rng(1).standard_normal(sd[name].shape)
                        / np.sqrt(CFG_T.dim)).astype(np.float32)
    w = sd["pos_embed.proj.weight"]
    sd["pos_embed.proj.weight"] = w.reshape(*w.shape, 1, 1)
    return sd


def port_dit(dtype=torch.float32):
    return TC.build_module(TD.StepVideoDiT, CFG_T, TD.convert_step_video_dit(
        to_torch(_dit_sd()), CFG_T), "cpu", dtype)


@functools.lru_cache(maxsize=None)
def _llm_sd():
    return draw_state_dict(TL.Step1LLM(LLM_T, device="meta"), 2)


def port_llm():
    return TC.build_module(TL.Step1LLM, LLM_T, TL.convert_step1_llm(to_torch(_llm_sd()), LLM_T),
                           "cpu", torch.float32)


def jax_llm():
    return JL.convert_step1_llm(to_torch(_llm_sd()), LLM_J, dtype=jnp.float32)


def reference_vae_names(sd):
    """The port's VAE names -> the reference's: the patchify convolution is
    a causal convolution under a module of its own (`conv.conv`)."""
    return {k.replace("conv_patchify.conv.", "conv_patchify.conv.conv."): v
            for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _vae_sd(z: int = VAE_T.z_channels):
    cfg = dataclasses.replace(VAE_T, z_channels=z)
    return reference_vae_names(draw_state_dict(TV.StepVideoVAE(cfg, device="meta"), 3))


def port_vae(z: int = VAE_T.z_channels):
    cfg = dataclasses.replace(VAE_T, z_channels=z)
    return TC.build_module(TV.StepVideoVAE, cfg, TV.convert_step_vae(to_torch(_vae_sd(z))),
                           "cpu", torch.float32)


def jax_vae(z: int = VAE_T.z_channels):
    return JV.convert_step_vae(to_torch(_vae_sd(z)))


# ------------------------------------------------------------ DiT and LLM

@pytest.mark.parametrize("cfg_t,cfg_j,grid", [(CFG_T, CFG_J, (3, 4, 6)),
                                              (TD.STEP_VIDEO, JD.STEP_VIDEO, (3, 34, 62))])
def test_rope_tables_and_rotation(cfg_t, cfg_j, grid):
    tt, tj = TD.step_rope_tables(cfg_t, *grid), JD.step_rope_tables(cfg_j, *grid)
    for (a, b), (c, d) in zip(tt, tj):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    if cfg_t is CFG_T:
        x = np.random.default_rng(4).standard_normal((1, int(np.prod(grid)), 2, 32))
        x = x.astype(np.float32)
        got = TD.step_rope_apply(torch.from_numpy(x), TD._rope_on(cfg_t, *grid, torch.device(
            "cpu")), cfg_t.rope_split)
        want = JD.step_rope_apply(jnp.asarray(x), [(jnp.asarray(c), jnp.asarray(s))
                                                   for c, s in tj], cfg_j.rope_split)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step1_llm_matches_jax():
    ids = np.random.default_rng(5).integers(0, LLM_T.vocab_size, (1, 14))
    want = JL.step1_llm_forward(jax_llm(), LLM_J, jnp.asarray(ids))
    with torch.no_grad():
        got = TL.step1_llm_forward(port_llm(), torch.from_numpy(ids))
    assert _rel(got.numpy(), want) < TOL_F32
    tree = from_jax_params("step1_llm", _tree(jax_llm()), LLM_T, device="cpu").state_dict()
    for k, v in port_llm().state_dict().items():
        torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)


def _dit_inputs(seed: int = 6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 3, 64, 4, 6)).astype(np.float32)
    cap = rng.standard_normal((1, 10, CFG_T.caption_dim)).astype(np.float32)
    clip = rng.standard_normal((1, 5, CFG_T.clip_dim)).astype(np.float32)
    mask = np.ones((1, 15), np.int64)
    mask[:, 12:] = 0
    return x, np.array([0.62], np.float32), cap, clip, mask


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dit_forward_matches_jax(dtype):
    td, jd = (torch.float32, jnp.float32) if dtype == "fp32" else (torch.bfloat16, jnp.bfloat16)
    x, t, cap, clip, mask = _dit_inputs()
    jp = JD.convert_step_video_dit(to_torch(_dit_sd()), CFG_J, dtype=jd)
    want = jax.jit(JD.step_video_dit_forward, static_argnums=1)(
        jp, CFG_J, jnp.asarray(x, jd), jnp.asarray(t), jnp.asarray(cap, jd),
        jnp.asarray(clip, jd), jnp.asarray(mask))
    with torch.no_grad():
        got = TD.step_video_dit_forward(port_dit(td), torch.from_numpy(x).to(td),
                                        torch.from_numpy(t), torch.from_numpy(cap).to(td),
                                        torch.from_numpy(clip).to(td), torch.from_numpy(mask))
    assert got.shape == x.shape
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < (
        TOL_F32 if dtype == "fp32" else TOL_BF16)
    if dtype == "fp32":
        tree = from_jax_params("step_video_dit", _tree(jp), CFG_T, device="cpu").state_dict()
        for k, v in port_dit().state_dict().items():
            torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ VAE

def test_vae_decoder_matches_jax():
    z = np.random.default_rng(7).standard_normal((1, 3, VAE_T.z_channels, 1, 1))
    z = z.astype(np.float32)
    want = jax.jit(JV.vae_decode, static_argnums=2)(jax_vae(), jnp.asarray(z), VAE_J)
    with torch.no_grad():
        got = TV.vae_decode(port_vae(), torch.from_numpy(z))
    assert got.shape == (1, 3, 17, 16, 16)
    assert _rel(got.numpy(), want) < TOL_VAE


def test_vae_encoder_matches_jax_and_from_jax_params():
    x = np.random.default_rng(8).standard_normal((1, 17, 3, 16, 16)).astype(np.float32)
    want = jax.jit(JV.vae_encode, static_argnums=2)(jax_vae(), jnp.asarray(x), VAE_J)
    port = port_vae()
    with torch.no_grad():
        got = TV.vae_encode(port, torch.from_numpy(x))
    assert got.shape == (1, 3, VAE_T.z_channels, 1, 1)
    assert _rel(got.numpy(), want) < TOL_VAE
    tree = from_jax_params("step_vae", _tree(jax_vae()), VAE_T, device="cpu").state_dict()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)


def test_vae_attention_rows_in_blocks():
    """The mid attention by blocks of query rows equals one block."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 8)).astype(np.float32))
               for _ in range(3))
    torch.testing.assert_close(TV._causal_softmax_attention(q, k, v, rows=7),
                               TV._causal_softmax_attention(q, k, v, rows=40),
                               rtol=0, atol=0)


# ------------------------------------------------------------ pipeline

def _pipelines():
    tok = StubBertTokenizer(BERT.vocab)
    tokenize = TL.stub_stepchat_tokenize(LLM_T.vocab_size)
    tp = TP.StepVideoPipeline(device="cpu", dtype=torch.float32)
    tp.dit_cfg, tp.dit = CFG_T, port_dit()
    tp.fetch_text_encoders(port_bert(), tok, port_llm(), tokenize, llm_max_length=24)
    jp = JP.StepVideoPipeline(dtype=jnp.float32)
    jp.dit_cfg = CFG_J
    jp.dit_params = JD.convert_step_video_dit(to_torch(_dit_sd()), CFG_J, dtype=jnp.float32)
    jp.fetch_text_encoders(jax_bert(), tok, jax_llm(), LLM_J, tokenize, llm_max_length=24,
                           clip_num_heads=BERT.num_heads)
    return tp, jp


@pytest.mark.parametrize("cfg_scale", [1.0, 9.0])
def test_pipeline_matches_jax(cfg_scale):
    """The latents (the decode: `test_vae_decoder_matches_jax`)."""
    tp, jp = _pipelines()
    kw = dict(prompt="a red fox in the snow", negative_prompt="blurry", cfg_scale=cfg_scale,
              height=32, width=32, num_frames=17, num_inference_steps=2, seed=4,
              return_latents=True)
    want, got = jp(**kw), tp(**kw)
    assert got.shape == (1, 3, 64, 2, 2)
    assert _rel(got.numpy(), want) < TOL_F32
    llm, clip, mask = tp.text_encoder("a red fox")
    assert mask.shape == (1, 77 + 24) and int(mask[0, :77].min()) == 1


# ------------------------------------------------------------ loaders, CLI

def test_load_model_builds_step1_llm(tmp_path, monkeypatch):
    """The JAX loader converts the file at `STEP1_LLM` with its depth from
    the file; the port builds it likewise (here at the tiny width)."""
    path = str(tmp_path / "step_llm.safetensors")
    safetensors_io.save_file(to_torch(_llm_sd()), path)
    assert TC.detect_model_kind(TC.load_state_dict(path)) == "stepvideo_text_encoder"
    monkeypatch.setattr(TL, "STEP1_LLM", dataclasses.replace(LLM_T, num_layers=48))
    kind, model = TC.load_model(path, device="cpu", dtype=torch.float32)
    assert kind == "stepvideo_text_encoder" and model.cfg.num_layers == LLM_T.num_layers
    for k, v in port_llm().state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_jax_runner_fault_and_port_cli(tmp_path, capsys):
    """The JAX runner never calls `fetch_text_encoders`: its request calls
    None at the prompt. The port's CLI takes the text towers' files and
    raises naming the ones missing; its smoke runs."""
    jp = JP.StepVideoPipeline(dtype=jnp.float32)
    with pytest.raises(TypeError, match="NoneType"):
        jp(prompt="x", num_frames=17, height=32, width=32, num_inference_steps=1)
    with pytest.raises(RuntimeError, match="--clip_path, --clip_tokenizer_path, --llm_path"):
        video_gen.main(["--family", "step_video", "--dit_path", "d", "--vae_path", "v",
                        "--device", "cpu"])
    out = tmp_path / "s.mp4"
    assert video_gen.main(["--family", "step_video", "--smoke", "--device", "cpu",
                           "--height", "16", "--width", "16", "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
