"""The pipeline's remaining options against the JAX package: the spatially
tiled VAE, skip-layer guidance (two-pass and cfg_merge), the temporal
sliding window with VACE, the multistep schedulers in the denoise loop and
the second expert's `switch_DiT_boundary`; and one DiT block at the full
14B width (5120 wide, 40 heads, ffn 13824) in fp32.

The pipelines are those of `test_torch_pipeline.py` (smoke widths, the
same weights through `from_jax_params`, the same CPU noise).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vae as JVAE
from video_styler_tpu.ops.rope import assemble_freqs_grid as j_freqs
from video_styler_tpu.schedulers.flow_dpm import FlowDPMSolverMultistepScheduler as JDPM
from video_styler_tpu.schedulers.flow_unipc import FlowUniPCMultistepScheduler as JUniPC

import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vae as TVAE
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.ops.rope import assemble_freqs_grid as t_freqs
from video_styler_tpu_torch.schedulers.flow_dpm import FlowDPMSolverMultistepScheduler as TDPM
from video_styler_tpu_torch.schedulers.flow_unipc import FlowUniPCMultistepScheduler as TUniPC

from test_torch_pipeline import (DIT, REQUEST, _frames, _jax_vae_params, _pipelines, _tree,
                                cpu_share)  # noqa: F401


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _latents(jp, tp, **kw):
    want = np.asarray(jnp.asarray(jp(return_latents=True, **kw), jnp.float32))
    got = tp(return_latents=True, **kw).float().numpy()
    assert got.shape == want.shape
    return got, want


@pytest.fixture(scope="module")
def fp32_pipelines():
    return _pipelines(jnp.float32, torch.float32)


# ------------------------------------------------------------ tiled VAE

def _ramped_video(t, h, w):
    """(1, 3, t, h, w) in [-1, 1], ramped in time and in both spatial axes
    (random data hid a chunking divergence once)."""
    tt = np.linspace(-0.8, 0.8, t, dtype=np.float32)[:, None, None]
    yy = np.linspace(-1, 1, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(-1, 1, w, dtype=np.float32)[None, None, :]
    chans = [0.6 * yy + 0.3 * tt + 0.1 * xx, 0.5 * xx - 0.4 * tt * yy,
             0.4 * np.sin(3 * xx + 2 * yy + 4 * tt)]
    return np.stack([np.broadcast_to(c, (t, h, w)) for c in chans])[None].astype(np.float32)


@pytest.fixture(scope="module")
def vaes():
    jparams = _jax_vae_params()
    tvae = from_jax_params("vae", _tree(jparams), TVAE.WanVAEConfig(
        dim=16, z_dim=4, num_res_blocks=1, latent_mean=(0.0,) * 4,
        latent_std=(1.0,) * 4), device="cpu")
    return jparams, tvae


@pytest.mark.parametrize("shape", [(48, 64, 24, 32, 16, 24), (40, 56, 24, 32, 16, 24),
                                   (6, 8, 3, 4, 2, 3), (5, 7, 3, 4, 2, 3),
                                   (60, 104, 30, 52, 15, 26)])
def test_tile_tasks_match_jax(shape):
    """Tile grids with a ragged last tile in both directions, and grids
    whose second tile already reaches the edge (the third is skipped)."""
    assert TVAE._tile_tasks(*shape) == JVAE._tile_tasks(*shape)
    H, W, sh, sw, th, tw = shape
    for bound in [(True, False, False, True), (False, False, False, False)]:
        np.testing.assert_array_equal(TVAE._build_mask(sh, sw, bound, (sh - th, sw - tw)),
                                      JVAE._build_mask(sh, sw, bound, (sh - th, sw - tw)))


def test_tiled_encode_decode_match_jax(vaes, monkeypatch):
    """Spatial tiles of 24x24 pixels (3x3 latents) every 16 over a 32x32
    clip of 5 frames: 2x2 overlapping tiles whose last row and column are
    ragged (16 pixels, 2 latents), each way. Through `encode`/`decode` with
    streaming=False."""
    jparams, tvae = vaes
    # the JAX package's tiles run its eager whole-clip functions: jitted here
    # (the same functions) to keep the test to seconds
    monkeypatch.setattr(JVAE, "vae_encode", jax.jit(JVAE.vae_encode, static_argnums=(2,)))
    monkeypatch.setattr(JVAE, "vae_decode", jax.jit(JVAE.vae_decode,
                                                    static_argnums=(2, 3)))
    video = _ramped_video(5, 32, 32)
    tile = dict(tile_size=(3, 3), tile_stride=(2, 2))
    assert TVAE._tile_tasks(32, 32, 24, 24, 16, 16) == [
        (0, 24, 0, 24), (0, 24, 16, 32), (16, 32, 0, 24), (16, 32, 16, 32)]
    want = np.asarray(JVAE.encode(jparams, jnp.asarray(video), JVAE.WAN_VAE_TINY,
                                  tiled=True, streaming=False, **tile))
    with torch.no_grad():
        got = TVAE.encode(tvae, torch.from_numpy(video), tiled=True, streaming=False,
                          **tile).numpy()
        whole = TVAE.encode(tvae, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, 4, 2, 4, 4)
    # fp32, the same tile sums in the same order: measured 9.4e-7
    assert _rel(got, want) < 2e-5
    # the tiles blend into something else than the whole-clip encode
    assert _rel(got, whole) > 1e-3

    z = want.copy()
    assert TVAE._tile_tasks(4, 4, 3, 3, 2, 2) == [(0, 3, 0, 3), (0, 3, 2, 4),
                                                  (2, 4, 0, 3), (2, 4, 2, 4)]
    want_v = np.asarray(JVAE.decode(jparams, jnp.asarray(z), JVAE.WAN_VAE_TINY,
                                    tiled=True, streaming=False, **tile))
    with torch.no_grad():
        got_v = TVAE.decode(tvae, torch.from_numpy(z), tiled=True, streaming=False,
                            **tile).numpy()
    assert got_v.shape == want_v.shape == (1, 3, 5, 32, 32)
    # measured 1.3e-6
    assert _rel(got_v, want_v) < 2e-5


def test_tiled_dispatch_keeps_streaming(vaes):
    """tiled=True with streaming unset stays the streaming form (exact
    against the whole clip), as in the JAX package."""
    _, tvae = vaes
    video = torch.from_numpy(_ramped_video(5, 32, 32))
    with torch.no_grad():
        stream = TVAE.encode(tvae, video, tiled=True)
        whole = TVAE.encode(tvae, video)
    assert _rel(stream.numpy(), whole.numpy()) < 1e-5


# ------------------------------------------------------------ SLG

@pytest.mark.parametrize("mode", ["two_pass", "cfg_merge"])
def test_slg_matches_jax(fp32_pipelines, mode):
    """Blocks 0 and 5 skipped on the unconditional rows over the first half
    of 3 steps; block 5 lies past the 2-layer stack and is ignored."""
    jp, tp = fp32_pipelines
    kw = dict(REQUEST, vace_video=_frames(), num_inference_steps=3,
              slg_blocks=(0, 5), slg_start=0.0, slg_end=0.5,
              cfg_merge=mode == "cfg_merge")
    got, want = _latents(jp, tp, **kw)
    # fp32: measured 1.6e-6 (two-pass) and 1.9e-6 (cfg_merge)
    assert _rel(got, want) < 2e-5
    plain = tp(return_latents=True, **dict(kw, slg_blocks=None)).float().numpy()
    assert _rel(got, plain) > 1e-3
    # an index past the stack alone gates nothing: the gated form
    # x + 1 * (block(x) - x) rounds once more than block(x) (measured 1.5e-6)
    only_past = tp(return_latents=True, **dict(kw, slg_blocks=(5,))).float().numpy()
    assert _rel(only_past, plain) < 2e-5


def test_slg_bf16_matches_jax():
    jp, tp = _pipelines(jnp.bfloat16, torch.bfloat16)
    kw = dict(REQUEST, vace_video=_frames(), num_inference_steps=3,
              slg_blocks=(1,), slg_end=0.5)
    got, want = _latents(jp, tp, **kw)
    # bf16 rounds at each side's own points: measured 2.3%
    assert _rel(got, want) < 5e-2


def test_layer_gate_per_row():
    """A gate of 0 makes a block an identity for that batch row only."""
    torch.manual_seed(0)
    cfg = TD.WanDiTConfig(**DIT)
    dit = from_jax_params("dit", _tree(JD.init_wan_dit(jax.random.PRNGKey(0),
                                                       JD.WanDiTConfig(**DIT))),
                          cfg, device="cpu")
    x = torch.randn(2, 4, 1, 4, 4)
    t = torch.tensor([500.0])
    ctx = torch.randn(2, 16, 64)
    with torch.no_grad():
        gate = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
        gated = TD.wan_dit_forward(dit, x, t, ctx, layer_gate=gate)
        plain = TD.wan_dit_forward(dit, x, t, ctx)
        t_, t_mod = TD.time_embed(dit, t)
        tokens, grid = TD.patchify(dit.patch_embedding, x[1:], cfg.patch_size)
        skipped = TD.unpatchify(TD.head(dit, tokens, t_), grid, cfg.patch_size,
                                cfg.out_dim)
    torch.testing.assert_close(gated[:1], plain[:1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gated[1:], skipped, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ sliding window

def test_sliding_window_with_vace_matches_jax(fp32_pipelines):
    """17 frames (5 latent frames) in windows of 3 every 2: windows [0, 3)
    and [2, 5), one frame of ramp; the VACE context is sliced per window."""
    jp, tp = fp32_pipelines
    video = np.concatenate([_frames(), _frames()[:8]])
    kw = dict(REQUEST, vace_video=video, num_frames=17,
              sliding_window_size=3, sliding_window_stride=2)
    got, want = _latents(jp, tp, **kw)
    assert got.shape == (1, 4, 5, 4, 4)
    # fp32: measured 1.6e-6
    assert _rel(got, want) < 2e-5
    np.testing.assert_array_equal(tp._temporal_ramp(3, True, False, 1),
                                  jp._temporal_ramp(3, True, False, 1))


# ------------------------------------------------------------ schedulers

@pytest.mark.parametrize("sched", ["unipc", "dpm"])
def test_pipeline_with_multistep_scheduler_matches_jax(sched):
    """The denoise loop's multistep branch: UniPC and DPM++ in place of the
    flow-match Euler step, 4 steps, the history on the device in fp32."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    if sched == "unipc":
        jp.scheduler, tp.scheduler = JUniPC(shift=1.0), TUniPC(shift=1.0)
    else:
        jp.scheduler, tp.scheduler = JDPM(shift=1.0), TDPM(shift=1.0)
    kw = dict(REQUEST, vace_video=_frames(), num_inference_steps=4)
    got, want = _latents(jp, tp, **kw)
    # fp32: measured 1.7e-6 (UniPC), 1.4e-6 (DPM++)
    assert _rel(got, want) < 2e-5


# ------------------------------------------------------------ second expert

def test_switch_dit_boundary_matches_jax():
    """A distinct second expert takes over once the timestep falls below
    0.875 * 1000: at 4 steps of shift 5 (1000, 937.5, 833, 625) that is
    from step 2 on; the VACE of `dit` serves it (no vace2)."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.dit2_cfg = JD.WanDiTConfig(**DIT)
    jp.dit2_params = JD.init_wan_dit(jax.random.PRNGKey(5), jp.dit2_cfg, jnp.float32)
    tp.dit2 = from_jax_params("dit", _tree(jp.dit2_params),
                              TD.WanDiTConfig(**DIT), device="cpu")
    kw = dict(REQUEST, vace_video=_frames(), num_inference_steps=4)
    got, want = _latents(jp, tp, **kw)
    # fp32: measured 1.4e-6
    assert _rel(got, want) < 2e-5
    one_expert = tp.dit2
    tp.dit2 = None
    single = tp(return_latents=True, **kw).float().numpy()
    tp.dit2 = one_expert
    assert _rel(got, single) > 1e-3
    # a boundary below every timestep keeps `dit` throughout
    never = tp(return_latents=True, switch_DiT_boundary=0.0, **kw).float().numpy()
    np.testing.assert_array_equal(never, single)


# ------------------------------------------------------------ full width

def test_full_width_block_matches_jax():
    """One DiT block at the 14B width (dim 5120, 40 heads of 128, ffn
    13824: 351M weights) in fp32 on the CPU, 64 tokens and a 16-token
    context, the same numpy weights in both packages. Measured on an
    8-core CPU host: 13.5 s, and a peak RSS of 3.4 GB for the pytest
    process (the weights once in numpy, shared with torch, and once in
    JAX)."""
    dim, heads, ffn = 5120, 40, 13824
    rng = np.random.default_rng(0)

    def lin(n_in, n_out):
        w = rng.standard_normal((n_out, n_in), dtype=np.float32)
        w *= np.float32(1.0 / np.sqrt(n_in))
        b = rng.standard_normal((n_out,), dtype=np.float32) * np.float32(0.02)
        return w, b

    def norm():
        return 1.0 + 0.1 * rng.standard_normal((dim,), dtype=np.float32)

    sd, jtree = {}, {}
    for attn in ("self_attn", "cross_attn"):
        jtree[attn] = {}
        for name in ("q", "k", "v", "o"):
            w, b = lin(dim, dim)
            sd[f"{attn}.{name}.weight"], sd[f"{attn}.{name}.bias"] = w, b
            jtree[attn][name] = {"w": w.T, "b": b}
        for name in ("norm_q", "norm_k"):
            s = norm()
            sd[f"{attn}.{name}.scale"] = s
            jtree[attn][name] = {"scale": s}
    s3, b3 = norm(), 0.1 * rng.standard_normal((dim,), dtype=np.float32)
    sd["norm3.scale"], sd["norm3.bias"] = s3, b3
    jtree["norm3"] = {"scale": s3, "bias": b3}
    jtree["ffn"] = {}
    for name, (n_in, n_out) in (("fc1", (dim, ffn)), ("fc2", (ffn, dim))):
        w, b = lin(n_in, n_out)
        sd[f"ffn.{name}.weight"], sd[f"ffn.{name}.bias"] = w, b
        jtree["ffn"][name] = {"w": w.T, "b": b}
    mod = rng.standard_normal((1, 6, dim), dtype=np.float32) / np.float32(np.sqrt(dim))
    sd["modulation"] = mod
    jtree["modulation"] = mod
    assert sum(v.size for v in sd.values()) > 350e6

    cfg_kw = dict(dim=dim, in_dim=16, ffn_dim=ffn, out_dim=16, num_heads=heads,
                  num_layers=1)
    tcfg = TD.WanDiTConfig(**cfg_kw)
    with torch.device("meta"):
        block = TD.DiTBlock(tcfg)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True, assign=True)
    x = rng.standard_normal((1, 64, dim), dtype=np.float32)
    ctx = rng.standard_normal((1, 16, dim), dtype=np.float32)
    t_mod = 0.1 * rng.standard_normal((1, 6, dim), dtype=np.float32)
    f, h, w = 1, 8, 8
    with torch.no_grad():
        cos, sin = t_freqs(128, f, h, w)
        got = TD.dit_block(block, torch.from_numpy(x), torch.from_numpy(ctx),
                           torch.from_numpy(t_mod), cos, sin, tcfg).numpy()
    del block
    jcos, jsin = j_freqs(128, f, h, w)
    want = np.asarray(JD.dit_block(jax.tree_util.tree_map(jnp.asarray, jtree),
                                   jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t_mod),
                                   jcos, jsin, JD.WanDiTConfig(**cfg_kw)))
    assert got.shape == want.shape == (1, 64, dim)
    assert np.isfinite(got).all()
    # fp32 sums of 5120 and 13824 terms in other orders: measured 3.3e-7
    assert _rel(got, want) < 2e-5
