"""PyTorch port vs JAX package: the Wan2.1 VAE, whole-clip and streaming.

Inputs are time-ramped (each frame a shifted copy of a smooth pattern plus
a per-frame offset), not random: a chunking fault that mixes up frames
shows on such data, where random frames can hide it. Weights come from the
JAX init (the 16-wide, z=4 test config) through `from_jax_params`. The VAE
runs in fp32 on both sides; the tolerance covers fp32 convolution
reassociation over ~30 layers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_vae as JV

import video_styler_tpu_torch.models.wan_vae as TV
from video_styler_tpu_torch.convert import from_jax_params

from test_torch_pipeline import cpu_share  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def vaes():
    jcfg = JV.WAN_VAE_TINY
    jp = jax.jit(JV.init_wan_vae, static_argnums=(1,))(jax.random.PRNGKey(3), jcfg)
    tcfg = TV.WanVAEConfig(dim=jcfg.dim, z_dim=jcfg.z_dim, dim_mult=jcfg.dim_mult,
                           num_res_blocks=jcfg.num_res_blocks,
                           temperal_downsample=jcfg.temperal_downsample,
                           latent_mean=jcfg.latent_mean, latent_std=jcfg.latent_std)
    model = from_jax_params("vae", jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            device="cpu")
    return jcfg, jp, model


def _ramp_video(t, h, w, channels=3):
    """(1, C, T, H, W) in [-1, 1]: a pattern that drifts and brightens with t."""
    tt = np.arange(t, dtype=np.float32)[:, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    chans = [np.sin(6.0 * (xx + 0.5 * c * yy) + 0.7 * tt) * 0.6 + 0.05 * tt - 0.2
             for c in range(channels)]
    return np.clip(np.stack(chans)[None], -1, 1).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vae_encode_decode_match_jax(vaes):
    jcfg, jp, model = vaes
    video = _ramp_video(9, 32, 32)
    want = JV.vae_encode(jp, jnp.asarray(video), jcfg)
    with torch.no_grad():
        got = TV.vae_encode(model, torch.from_numpy(video))
    assert got.shape == (1, 4, 3, 4, 4)
    _close(got, want)
    z = _ramp_video(3, 4, 4, channels=4) * 2.0
    want = JV.vae_decode(jp, jnp.asarray(z), jcfg)
    with torch.no_grad():
        got = TV.vae_decode(model, torch.from_numpy(z))
    assert got.shape == (1, 3, 9, 32, 32)
    _close(got, want)


def test_vae_encode_stream_matches_jax_and_whole_clip(vaes):
    jcfg, jp, model = vaes
    video = _ramp_video(13, 16, 24)   # 1 + 4 + 4 + 4 frames -> 4 latent frames
    want = JV.vae_encode_stream(jp, jnp.asarray(video), jcfg)
    with torch.no_grad():
        got = TV.vae_encode_stream(model, torch.from_numpy(video))
        whole = TV.vae_encode(model, torch.from_numpy(video))
        public = TV.encode(model, torch.from_numpy(video), tiled=True)
    assert got.shape == (1, 4, 4, 2, 3)
    _close(got, want)
    torch.testing.assert_close(got, whole, **TOL)
    torch.testing.assert_close(public, got, rtol=0, atol=0)


@pytest.mark.parametrize("chunk_size", [1, 2])
def test_vae_decode_stream_matches_jax_and_whole_clip(vaes, chunk_size):
    jcfg, jp, model = vaes
    z = _ramp_video(5, 4, 6, channels=4) * 2.0
    want = JV.vae_decode_stream(jp, jnp.asarray(z), jcfg, chunk_size=chunk_size)
    with torch.no_grad():
        got = TV.vae_decode_stream(model, torch.from_numpy(z), chunk_size=chunk_size)
        whole = TV.vae_decode(model, torch.from_numpy(z))
    assert got.shape == (1, 3, 17, 32, 48)
    _close(got, want)
    torch.testing.assert_close(got, whole, **TOL)


def test_vae_public_decode_uses_auto_chunk(vaes):
    jcfg, jp, model = vaes
    z = _ramp_video(3, 4, 4, channels=4)
    want = JV.decode(jp, jnp.asarray(z), jcfg, tiled=True)
    with torch.no_grad():
        got = TV.decode(model, torch.from_numpy(z), tiled=True)
    assert TV._auto_chunk(torch.from_numpy(z)) == JV._auto_chunk(z)
    _close(got, want)
