"""CogVideoX against the JAX package: the RoPE tables (bit-equal), the DiT
forward in fp32 and bf16, the VAE's encode (two chunks, the caches carried)
and decode (two chunks), `convert.from_jax_params` of the DiT and the VAE
trees, `CogVideoPipeline` (CFG 1 and 7, video-to-video), the exact
attention run in pieces (bit-equal to one call), and `video_gen --family
cog_video` (its smoke, and the files it needs beside the JAX runner's
fault).

Weights: the reference's names drawn from a numpy seed, read by both
packages' converters. Widths: `COG_DIT_TINY` (96 wide, 2 heads of 48; both
packages take the exact `sdpa` at that head dim), a tiny T5 v1.1 as the
text tower (its states given to the JAX pipeline through a callable, as
its `fetch_text_encoder` reads a tokenizer directory), the VAE at its
release widths on 8x8 clips (the JAX VAE jitted: eager it takes tens of
seconds). Tolerances: fp32 within 2e-5
relative L2 (the VAE 1e-4: fp32 convolutions sum in another order), bf16
within 2e-2.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.cog_video as JC
import video_styler_tpu.models.t5 as JT
import video_styler_tpu.pipelines.cog_video as JP

import video_styler_tpu_torch.models.cog_video as TCV
import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.pipelines.cog_video as TP
from video_styler_tpu_torch import video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.ops.attention import sdpa
from video_styler_tpu_torch.prompters.flux_prompter import StubT5Tokenizer
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_fun import _rel
from test_torch_hunyuan_image import draw_state_dict, to_torch
from test_torch_pipeline import _tree, cpu_share  # noqa: F401
from test_torch_sd_vae_text import _hf_t5_state_dict

TOL_F32 = 2e-5
TOL_VAE = 1e-4
TOL_BF16 = 2e-2
CFG_T, CFG_J = TCV.COG_DIT_TINY, JC.COG_DIT_TINY


@functools.lru_cache(maxsize=None)
def _dit_sd():
    sd = draw_state_dict(TCV.CogDiT(CFG_T, device="meta"), 0)
    w = sd["patchify.proj.weight"]
    sd["patchify.proj.weight"] = w.reshape(w.shape[0], CFG_T.in_channels, 1, 2, 2)
    return sd


def port_dit(dtype=torch.float32):
    return TC.build_module(TCV.CogDiT, CFG_T, TCV.convert_cog_dit(to_torch(_dit_sd()), CFG_T),
                           "cpu", dtype)


@functools.lru_cache(maxsize=None)
def _vae_sd(which: str):
    cls = TCV.CogVAEEncoder if which == "encoder" else TCV.CogVAEDecoder
    return draw_state_dict(cls(device="meta"), 1 if which == "encoder" else 2)


def port_vae(which: str):
    cls = TCV.CogVAEEncoder if which == "encoder" else TCV.CogVAEDecoder
    return TC.build_module(cls, None, to_torch(_vae_sd(which)), "cpu", torch.float32)


def test_rope_bit_equal():
    for cfg_t, cfg_j, grid in ((CFG_T, CFG_J, (2, 3, 5)),
                               (TCV.COG_VIDEO_X, JC.COG_VIDEO_X, (4, 30, 45))):
        for a, b in zip(TCV.cog_rope(cfg_t, *grid), JC.cog_rope(cfg_j, *grid)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dit_forward_matches_jax(dtype):
    td, jd = (torch.float32, jnp.float32) if dtype == "fp32" else (torch.bfloat16, jnp.bfloat16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 2, 6, 10)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, CFG_T.text_dim)).astype(np.float32)
    t = np.array([421.0], np.float32)
    jp = JC.convert_cog_dit(to_torch(_dit_sd()), CFG_J, dtype=jd)
    want = jax.jit(JC.cog_dit_forward, static_argnums=1)(jp, CFG_J, jnp.asarray(x, jd),
                                                          jnp.asarray(t), jnp.asarray(ctx, jd))
    with torch.no_grad():
        got = TCV.cog_dit_forward(port_dit(td), torch.from_numpy(x).to(td), torch.from_numpy(t),
                                  torch.from_numpy(ctx).to(td))
    assert got.shape == x.shape
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < (
        TOL_F32 if dtype == "fp32" else TOL_BF16)
    if dtype == "fp32":
        tree = from_jax_params("cog_dit", _tree(jp), CFG_T, device="cpu").state_dict()
        for k, v in port_dit().state_dict().items():
            torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)


def test_vae_encode_decode_match_jax():
    """The encode of 17 frames runs two chunks (0:9, 9:17) with the caches
    carried; the decode of 4 latent frames two chunks of 2."""
    rng = np.random.default_rng(4)
    video = rng.standard_normal((1, 3, 17, 8, 8)).astype(np.float32)
    video *= np.linspace(0.3, 2.0, 17, dtype=np.float32)[None, None, :, None, None]
    je, jd = (JC.convert_cog_vae(to_torch(_vae_sd(w))) for w in ("encoder", "decoder"))
    want_z = jax.jit(JC.cog_vae_encode)(je, jnp.asarray(video))
    enc, dec = port_vae("encoder"), port_vae("decoder")
    with torch.no_grad():
        got_z = TCV.cog_vae_encode(enc, torch.from_numpy(video))
    assert got_z.shape == (1, 16, 5, 1, 1)
    assert _rel(got_z.numpy(), want_z) < TOL_VAE
    z = rng.standard_normal((1, 16, 4, 1, 1)).astype(np.float32)
    z *= np.linspace(0.3, 3.0, 4, dtype=np.float32)[None, None, :, None, None]
    want = jax.jit(JC.cog_vae_decode)(jd, jnp.asarray(z))
    with torch.no_grad():
        got = TCV.cog_vae_decode(dec, torch.from_numpy(z))
    assert got.shape == (1, 3, 16, 8, 8)
    assert _rel(got.numpy(), want) < TOL_VAE
    for kind, mod, tree in (("cog_vae_encoder", enc, je), ("cog_vae_decoder", dec, jd)):
        got_sd = from_jax_params(kind, _tree(tree), None, device="cpu").state_dict()
        for k, v in mod.state_dict().items():
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=k)
    assert TCV._encode_chunks(17) == JC._encode_chunks(17)
    assert TCV._decode_chunks(5) == JC._decode_chunks(5)


@pytest.mark.parametrize("bias", [False, True])
def test_sdpa_in_pieces_is_bit_equal(bias):
    """`sdpa` by batch rows and heads under `split_bytes` gives the bits of
    one call (each row and head is the same arithmetic)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 24, 4, 16)).astype(np.float32))
               for _ in range(3))
    b = torch.from_numpy(rng.standard_normal((3, 1, 1, 24)).astype(np.float32)) if bias else None
    whole = sdpa(q, k, v, bias=b)
    for split in (4 * 24 * 24, 4 * 24 * 24 * 3, 4 * 24 * 24 * 4 * 2):
        torch.testing.assert_close(sdpa(q, k, v, bias=b, split_bytes=split), whole,
                                   rtol=0, atol=0)


# ------------------------------------------------------------ pipeline

T5 = TT.T5_V11_TINY


def _pipelines():
    t5_sd = _hf_t5_state_dict(T5, seed=6)
    tok = StubT5Tokenizer(T5.vocab)
    tp = TP.CogVideoPipeline(device="cpu", dtype=torch.float32)
    tp.dit_cfg, tp.dit = CFG_T, port_dit()
    tp.vae_encoder = port_vae("encoder")
    t5 = TC.build_module(TT.T5Encoder, T5, TT.convert_hf_t5(t5_sd, T5), "cpu", torch.float32)
    tp.fetch_text_encoder(t5, tok)
    jp = JP.CogVideoPipeline(dtype=jnp.float32)
    jp.dit_cfg = CFG_J
    jp.dit_params = JC.convert_cog_dit(to_torch(_dit_sd()), CFG_J, dtype=jnp.float32)
    jp.vae_encoder_params = JC.convert_cog_vae(to_torch(_vae_sd("encoder")))
    jt = JT.convert_hf_t5(t5_sd, JT.T5_V11_TINY, dtype=jnp.float32)

    def encode(prompt, length=TP.TEXT_LENGTH):
        ids = tok([prompt], max_length=length)["input_ids"]
        return JT.t5_encode(jt, JT.T5_V11_TINY, jnp.asarray(ids, jnp.int32))

    jp.text_encoder = encode
    return tp, jp


@pytest.mark.parametrize("case", ["cfg 1", "cfg 7", "v2v"])
def test_pipeline_matches_jax(case, monkeypatch):
    monkeypatch.setattr(JC, "cog_vae_encode", jax.jit(JC.cog_vae_encode))
    tp, jp = _pipelines()
    kw = dict(prompt="a red fox in the snow", negative_prompt="blurry", num_frames=9,
              height=16, width=16, num_inference_steps=2, seed=4, return_latents=True,
              cfg_scale=1.0 if case == "cfg 1" else 7.0)
    if case == "v2v":
        from PIL import Image
        rng = np.random.default_rng(8)
        kw.update(input_video=[Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8))
                               for _ in range(9)], denoising_strength=0.7)
    want, got = jp(**kw), tp(**kw)
    assert got.shape == (1, 16, 3, 2, 2)
    assert _rel(got.numpy(), want) < (TOL_VAE if case == "v2v" else TOL_F32)


def test_jax_runner_fault_and_port_cli(tmp_path, capsys):
    """The JAX runner loads the DiT alone: no VAE, no text encoder, and its
    request calls None at the prompt. The port's CLI raises naming the
    files it lacks; its smoke runs."""
    jp = JP.CogVideoPipeline(dtype=jnp.float32)
    with pytest.raises(TypeError, match="NoneType"):
        jp(prompt="x", num_frames=5, height=16, width=16, num_inference_steps=1)
    with pytest.raises(RuntimeError, match="--vae_path, --t5_path, --tokenizer_path"):
        video_gen.main(["--family", "cog_video", "--dit_path", "d", "--device", "cpu"])
    out = tmp_path / "c.mp4"
    assert video_gen.main(["--family", "cog_video", "--smoke", "--device", "cpu",
                           "--height", "16", "--width", "16", "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
