"""PyTorch port vs JAX package: the Wan2.2 VAE (z=48 family), whole-clip
and streaming, encode and decode.

The JAX package has no random init for this VAE (its own tests build the
reference `VideoVAE38_` and convert its state dict). Here the weights are
drawn from a numpy seed into the port's `WanVAE38` and written out under the
checkpoint's names (`export_wan_vae`); that state dict goes through the JAX
`convert_wan_vae`, so both packages run the same numbers. The test config is
the JAX tests': dim 16, dec_dim 16, z 8, dim_mult (1, 2, 4, 4), one residual
block, temporal downsampling (False, True, True), unit latent statistics.
Inputs are time-ramped (`test_torch_vae._ramp_video`). fp32 on both sides:
the tolerance is the stated 2e-5 relative L2 (fp32 convolutions summed in
other orders over ~40 layers).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_vae as JV

import video_styler_tpu_torch.models.wan_vae as TV
from video_styler_tpu_torch.utils.convert import export_wan_vae

from test_torch_vae import _ramp_video

CFG = dict(dim=16, dec_dim=16, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
           temperal_downsample=(False, True, True), latent_mean=(0.0,) * 8,
           latent_std=(1.0,) * 8)
REL = 2e-5


def random_vae38(cfg: TV.WanVAE38Config, seed: int = 0) -> TV.WanVAE38:
    """A `WanVAE38` with conv weights N(0, 1/fan_in) from a numpy seed,
    biases N(0, 0.01^2) and gammas 1 + N(0, 0.1^2) (so every parameter
    matters), fp32 on the CPU."""
    rng = np.random.default_rng(seed)
    model = TV.WanVAE38(cfg)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("weight"):
                std = 1.0 / np.sqrt(p[0].numel())
                v = std * rng.standard_normal(tuple(p.shape))
            elif name.endswith("bias"):
                v = 0.01 * rng.standard_normal(tuple(p.shape))
            else:
                v = 1.0 + 0.1 * rng.standard_normal(tuple(p.shape))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model.eval()


@pytest.fixture(scope="module")
def vaes():
    """The JAX whole-clip functions run jitted (the same functions; eager
    dispatch of ~40 layers takes seconds a call)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JV, "vae38_encode", jax.jit(JV.vae38_encode, static_argnums=(2,)))
    mp.setattr(JV, "vae38_decode", jax.jit(JV.vae38_decode, static_argnums=(2, 3)))
    model = random_vae38(TV.WanVAE38Config(**CFG))
    params = JV.convert_wan_vae({k: v.numpy() for k, v in export_wan_vae(model).items()},
                                dtype=jnp.float32)
    yield JV.WanVAE38Config(**CFG), params, model
    mp.undo()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("frames", [1, 9])
def test_encode_matches_jax(vaes, frames):
    jcfg, jp, model = vaes
    video = _ramp_video(frames, 32, 32)
    want = np.asarray(JV.vae38_encode(jp, jnp.asarray(video), jcfg))
    with torch.no_grad():
        got = TV.vae38_encode(model, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, 8, (frames - 1) // 4 + 1, 2, 2)
    assert _rel(got, want) < REL


@pytest.mark.parametrize("frames", [1, 3])
def test_decode_matches_jax(vaes, frames):
    jcfg, jp, model = vaes
    z = _ramp_video(frames, 4, 4, channels=8) * 2.0
    want = np.asarray(JV.vae38_decode(jp, jnp.asarray(z), jcfg, False))
    with torch.no_grad():
        got = TV.vae38_decode(model, torch.from_numpy(z), clamp=False).numpy()
    assert got.shape == want.shape == (1, 3, 4 * frames - 3, 64, 64)
    assert _rel(got, want) < REL


def test_encode_stream_matches_jax(vaes):
    """9 frames: the first frame, then two 4-frame chunks, against the JAX
    streaming encode and against the whole-clip one."""
    jcfg, jp, model = vaes
    video = _ramp_video(9, 32, 32)
    want = np.asarray(JV.vae38_encode_stream(jp, jnp.asarray(video), jcfg))
    with torch.no_grad():
        got = TV.vae38_encode_stream(model, torch.from_numpy(video)).numpy()
        whole = TV.vae38_encode(model, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, 8, 3, 2, 2)
    assert _rel(got, want) < REL
    assert _rel(got, whole) < REL


@pytest.mark.parametrize("chunk", [1, 2])
def test_decode_stream_matches_jax(vaes, chunk):
    jcfg, jp, model = vaes
    z = _ramp_video(3, 4, 4, channels=8) * 2.0
    want = np.asarray(JV.vae38_decode_stream(jp, jnp.asarray(z), jcfg, chunk_size=chunk,
                                             clamp=False))
    with torch.no_grad():
        got = TV.vae38_decode_stream(model, torch.from_numpy(z), chunk_size=chunk,
                                     clamp=False).numpy()
        whole = TV.vae38_decode(model, torch.from_numpy(z), clamp=False).numpy()
    assert got.shape == want.shape == (1, 3, 9, 64, 64)
    assert _rel(got, want) < REL
    assert _rel(got, whole) < REL


def test_public_dispatch_matches_jax(vaes):
    """`encode`/`decode` pick the Wan2.2 functions from the model, as the
    JAX dispatch does from the config: tiled=True streams, streaming=False
    runs the whole clip (no spatial tiling for this VAE)."""
    jcfg, jp, model = vaes
    video = torch.from_numpy(_ramp_video(5, 32, 32))
    z = torch.from_numpy(_ramp_video(2, 4, 4, channels=8))
    with torch.no_grad():
        for kw in (dict(tiled=True), dict(tiled=True, streaming=False), dict()):
            want = np.asarray(JV.encode(jp, jnp.asarray(video.numpy()), jcfg, **kw))
            assert _rel(TV.encode(model, video, **kw).numpy(), want) < REL
            want = np.asarray(JV.decode(jp, jnp.asarray(z.numpy()), jcfg, **kw))
            assert _rel(TV.decode(model, z, **kw).numpy(), want) < REL


def test_patchify_and_shortcuts_match_jax():
    """The layout pieces alone, exact: pixel (un)patchify and the averaging
    and duplicating shortcuts (the JAX ones are channels-last)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 3, 5, 8, 12)).astype(np.float32)
    jp = np.asarray(JV.pixel_patchify(jnp.asarray(x)))                   # b f h w c
    tp = TV.pixel_patchify(torch.from_numpy(x)).numpy()                  # b c f h w
    np.testing.assert_array_equal(tp, jp.transpose(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(TV.pixel_unpatchify(torch.from_numpy(tp)).numpy(), x)
    y = rng.standard_normal((1, 8, 5, 4, 6)).astype(np.float32)
    ycl = jnp.asarray(y.transpose(0, 2, 3, 4, 1))
    for ft, fs, out_c in ((2, 2, 16), (1, 2, 8), (2, 1, 4)):
        want = np.asarray(JV.avg_down3d(ycl, out_c, ft, fs)).transpose(0, 4, 1, 2, 3)
        np.testing.assert_allclose(TV.avg_down3d(torch.from_numpy(y), out_c, ft, fs).numpy(),
                                   want, rtol=1e-6, atol=1e-7)
        for first in (False, True):
            want = np.asarray(JV.dup_up3d(ycl, out_c, ft, fs, first)).transpose(0, 4, 1, 2, 3)
            np.testing.assert_array_equal(
                TV.dup_up3d(torch.from_numpy(y), out_c, ft, fs, first).numpy(), want)
