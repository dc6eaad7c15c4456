"""Stable Video Diffusion against the JAX package: the continuous ODE
scheduler, ExVideo's position map, the spatio-temporal UNet (and ExVideo's,
with its trained position table and positional convolution), the temporal
VAE decoder, `convert.from_jax_params` of the UNet, decoder and image
encoder trees, `load_model` on an SVD file beside the JAX loader's (which
nests it through its SD converter: the tree its UNet reads),
`SVDVideoPipeline` (image-to-video with the frame-wise CFG ramp, mask
frames, video-to-video), and `video_gen --family svd` (its smoke, and the
files it needs beside the JAX runner's fault).

Weights: the reference's names (as `sd.convert_sd_module` renames them)
drawn from a numpy seed, read by both packages' converters. Widths:
`SVD_UNET_TINY` (160 at every level: the program's fixed heads 5, 10 and
20 and GroupNorm's 32 groups), a 2-layer CLIP-H image tower at 224x224
(the JAX pipeline calls it with 32 layers of 16 heads whatever the tower,
so the tests partial it), the SD VAE encoder and the SVD decoder at their
release widths, 3 frames of 64x64 (the pipeline's size divisor). The JAX
UNet and VAE functions are jitted through monkeypatches. Tolerances: fp32
within 2e-5 relative L2 (the VAE and the pipelines, whose image condition
goes through the VAE encoder, 1e-4: fp32 convolutions sum in another
order).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.svd as JS
import video_styler_tpu.pipelines.svd_video as JP
from video_styler_tpu.schedulers.continuous_ode import ContinuousODEScheduler as JODE
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.models.sd as TSD
import video_styler_tpu_torch.models.svd as TS
import video_styler_tpu_torch.pipelines.svd_video as TP
from video_styler_tpu_torch import safetensors_io, video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.schedulers.continuous_ode import ContinuousODEScheduler
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_hunyuan_image import draw_state_dict, to_torch
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5
TOL_VAE = 1e-4
UNET = TS.SVD_UNET_TINY
IMAGE = TS.SVD_IMAGE_ENCODER_TINY_224


@functools.lru_cache(maxsize=None)
def _unet_sd(exvideo: bool = False):
    sd = draw_state_dict(TS.SVDUNet(UNET, device="meta", exvideo=exvideo), 0)
    return {k: (np.float32(1.5) * v if k.endswith("mix_factor") else v) for k, v in sd.items()}


def port_unet(exvideo: bool = False):
    return TC.build_module(lambda cfg, dtype: TS.SVDUNet(cfg, dtype=dtype, exvideo=exvideo),
                           UNET, to_torch(_unet_sd(exvideo)), "cpu", torch.float32)


def jax_tree(sd):
    """The JAX tree of a port state dict (norm `scale` back to `weight`)."""
    return JS.convert_svd_module({k[:-len("scale")] + "weight" if k.endswith(".scale") else k: v
                                  for k, v in sd.items()})


@functools.lru_cache(maxsize=None)
def _models():
    """(image encoder, SD VAE encoder, SVD VAE decoder), fp32."""
    gen = torch.Generator().manual_seed(3)
    return tuple(TS.init_svd_module_(m, gen).eval() for m in (
        TS.SVDImageEncoder(IMAGE), TSD.SDVAEEncoder(), TS.SVDVAEDecoder()))


@functools.lru_cache(maxsize=None)
def _jitted():
    """The JAX UNet and VAE functions, jitted once for the module (a compile
    of the UNet takes ~12 s; eager, its first call ~50 s)."""
    return {"svd_unet_forward": jax.jit(JS.svd_unet_forward),
            "sd_vae_encoder_forward": jax.jit(JS.sd_vae_encoder_forward),
            "svd_vae_decode": jax.jit(JS.svd_vae_decode),
            "svd_image_encoder_forward": functools.partial(
                JS.svd_image_encoder_forward, num_layers=IMAGE.num_layers,
                num_heads=IMAGE.num_heads)}


@pytest.fixture
def jit_jax(monkeypatch):
    for name, fn in _jitted().items():
        monkeypatch.setattr(JS, name, fn)


# ------------------------------------------------------------ scheduler

def test_continuous_ode_matches_jax():
    t, j = ContinuousODEScheduler(), JODE()
    for steps, strength in ((20, 1.0), (7, 0.6)):
        t.set_timesteps(steps, denoising_strength=strength)
        j.set_timesteps(steps, denoising_strength=strength)
        np.testing.assert_array_equal(t.sigmas, j.sigmas)
        np.testing.assert_array_equal(t.timesteps, j.timesteps)
    rng = np.random.default_rng(1)
    x, v = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) for _ in range(2))
    for i in (0, len(t.timesteps) - 1):
        ts = t.timesteps[i]
        np.testing.assert_allclose(t.step(torch.from_numpy(v), ts, torch.from_numpy(x)).numpy(),
                                   j.step(v, ts, x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.add_noise(torch.from_numpy(x), torch.from_numpy(v),
                                               ts).numpy(), j.add_noise(x, v, ts), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(TS.positional_id_map(128), JS.positional_id_map(128))


# ------------------------------------------------------------ UNet and VAE

def _unet_inputs(seed: int = 2):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    emb = rng.standard_normal((1, UNET.text_dim)).astype(np.float32)
    return sample, emb, np.asarray([6, 127, 0.02], np.float32)


def test_unet_matches_jax(jit_jax):
    sample, emb, ids = _unet_inputs()
    jp = jax_tree(_unet_sd())
    want = JS.svd_unet_forward(jp, jnp.asarray(sample), 500.0, jnp.asarray(emb), ids)
    port = port_unet()
    with torch.no_grad():
        got = TS.svd_unet_forward(port, torch.from_numpy(sample), 500.0, torch.from_numpy(emb),
                                  ids)
    assert got.shape == (3, 4, 8, 8)
    assert _rel(got.numpy(), want) < TOL_F32
    tree = from_jax_params("svd_unet", _tree(jp), UNET, device="cpu").state_dict()
    assert sorted(tree) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(tree[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("hw", [(1, 1), (3, 4)])
def test_exvideo_temporal_attention_matches_jax(hw):
    """ExVideo's temporal attention: the trained position table and the
    reflect-padded positional convolution (an axis of length 1 repeats, as
    numpy pads); its UNet builds from a file (`from_jax_params` below)."""
    i = next(i for i, (kind, _) in enumerate(TS.SVD_UNET_PROGRAM) if kind == "tattn")
    sd = _unet_sd(True)
    prefix = f"blocks.{i}."
    block = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    jp = jax_tree(block)
    port = TS.TemporalAttention(UNET.channels[0], UNET.text_dim, True)
    port.load_state_dict(to_torch(block), strict=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, UNET.channels[0]) + hw).astype(np.float32)
    emb = rng.standard_normal((1, 1, UNET.text_dim)).astype(np.float32)
    want = JS.temporal_attention_block(jp, jnp.asarray(x), jnp.asarray(emb), 5)
    with torch.no_grad():
        got = TS.temporal_attention_block(port, torch.from_numpy(x), torch.from_numpy(emb), 5)
    assert _rel(got.numpy(), want) < TOL_F32
    tree = from_jax_params("svd_unet", _tree(jax_tree(sd)), UNET, device="cpu")
    assert hasattr(tree.blocks[i], "positional_conv")


def test_vae_decoder_and_image_encoder_match_jax(jit_jax):
    image, _, dec = _models()
    z = np.random.default_rng(4).standard_normal((4, 2, 4, 4)).astype(np.float32)
    jd = JS.convert_svd_module(_reference_names(dec))
    want = JS.svd_vae_decode(jd, jnp.asarray(z))
    with torch.no_grad():
        got = TS.svd_vae_decode(dec, torch.from_numpy(z))
    assert got.shape == (3, 2, 32, 32)
    assert _rel(got.numpy(), want) < TOL_VAE
    ji = JS.convert_svd_module(_reference_names(image))
    for kind, mod, tree, cfg in (("svd_vae_decoder", dec, jd, None),
                                 ("svd_image_encoder", image, ji, IMAGE)):
        got_sd = from_jax_params(kind, _tree(tree), cfg, device="cpu").state_dict()
        for k, v in mod.state_dict().items():
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=k)


def test_load_model_svd_unet_beside_jax(tmp_path, monkeypatch, jit_jax):
    """Both loaders detect `svd_unet`; the JAX one nests the file through
    `convert_sd_module`, which is the tree its `svd_unet_forward` reads, so
    its UNet works, and the port's matches it."""
    monkeypatch.setattr(TS, "SVD_UNET", UNET)
    sd = {k[:-len("scale")] + "weight" if k.endswith(".scale") else k: v
          for k, v in _unet_sd().items()}
    path = str(tmp_path / "svd.safetensors")
    safetensors_io.save_file(to_torch(sd), path)
    kind, model = TC.load_model(path, device="cpu", dtype=torch.float32)
    jkind, jparams = JCK.load_model(path, dtype=jnp.float32)
    assert kind == jkind == "svd_unet"
    sample, emb, ids = _unet_inputs(5)
    want = JS.svd_unet_forward(jparams, jnp.asarray(sample), 300.0, jnp.asarray(emb), ids)
    with torch.no_grad():
        got = TS.svd_unet_forward(model, torch.from_numpy(sample), 300.0,
                                  torch.from_numpy(emb), ids)
    assert _rel(got.numpy(), want) < TOL_F32


# ------------------------------------------------------------ pipeline

def _pipelines():
    image, enc, dec = _models()
    tp = TP.SVDVideoPipeline(device="cpu")
    tp.unet, tp.image_encoder, tp.vae_encoder, tp.vae_decoder = port_unet(), image, enc, dec
    jp = JP.SVDVideoPipeline(dtype=jnp.float32)
    jp.unet_params = jax_tree(_unet_sd())
    jp.image_encoder_params = JS.convert_svd_module(_reference_names(image))
    jp.vae_encoder_params = JS.convert_svd_module(_reference_names(enc))
    jp.vae_decoder_params = JS.convert_svd_module(_reference_names(dec))
    # the module's one jitted UNet (the pipeline would jit a new one a call)
    jp._fwd = lambda: _jitted()["svd_unet_forward"]
    return tp, jp


def _image(seed: int):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (64, 64, 3), np.uint8))


@pytest.mark.parametrize("case", ["i2v", "mask frames", "v2v"])
def test_pipeline_matches_jax(case, jit_jax):
    tp, jp = _pipelines()
    kw = dict(input_image=_image(6), num_frames=3, height=64, width=64, num_inference_steps=2,
              seed=4, min_cfg_scale=1.0, max_cfg_scale=3.0, return_latents=True)
    if case == "mask frames":
        kw.update(mask_frames=[_image(7)], mask_frame_ids=[1])
    if case == "v2v":
        kw.update(input_video=[_image(8 + i) for i in range(3)], denoising_strength=0.6)
    want, got = jp(**kw), tp(**kw)
    assert got.shape == (3, 4, 8, 8)
    assert _rel(got.numpy(), want) < TOL_VAE
    if case == "i2v":
        frames = tp.decode_video(got)
        assert len(frames) == 3 and frames[0].size == (64, 64)


def test_jax_runner_fault_and_port_cli(tmp_path, capsys):
    """The JAX runner loads the UNet alone: no VAE and no image encoder, so
    its request fails at the image embedding. The port's CLI raises naming
    the files it lacks; its smoke runs."""
    jp = JP.SVDVideoPipeline(dtype=jnp.float32)
    with pytest.raises(TypeError):
        jp(input_image=_image(1), num_frames=2, height=64, width=64, num_inference_steps=1)
    with pytest.raises(RuntimeError, match="--vae_path, --vae_encoder_path, "
                                           "--image_encoder_path, --input_image"):
        video_gen.main(["--family", "svd", "--dit_path", "d", "--device", "cpu"])
    tp = TP.SVDVideoPipeline(device="cpu")
    with pytest.raises(RuntimeError, match="no unet, vae_encoder, image_encoder"):
        tp(input_image=_image(1), num_frames=2, height=64, width=64, num_inference_steps=1)
    out = tmp_path / "v.mp4"
    assert video_gen.main(["--family", "svd", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
