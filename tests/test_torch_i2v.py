"""The image-conditioned Wan path against the JAX package: the I2V and FLF2V
DiT forwards (image cross-attention, CLIP rows before the text, y before
patchify), the per-token modulation of a separated timestep, the I2V,
FLF2V and dual-expert I2V pipelines, cfg_merge, TeaCache and the sliding
window with y, the TI2V pinned first frame on a Wan2.2-family VAE, and the
`wan_video_gen` CLI.

Widths: the port's smoke DiT (dim 256, 2 heads of 128, ffn 512, 2 blocks,
umT5 64 wide, the 16-wide z=4 VAE of `test_torch_pipeline`) with the
channel math of the JAX runner's smoke pipelines
(`examples/wanvideo/_runner.py:58-100`): I2V in_dim 2z + 4 with the
257-token CLIP tower (112x112 in 7-pixel patches, 1280 wide, 4 heads, 2
blocks), FLF2V with the CLIP position table, the dual expert from another
seed. TI2V: z 8 on the tiny Wan2.2-family VAE of `test_torch_vae38`.
Request: 9 frames of 32x32 (TI2V 64x64), 2 steps, two-pass CFG 5, streaming
VAE. Both sides draw the same CPU noise. fp32 within 2e-5 relative L2 (the
same arithmetic in other summation orders); bf16 within 5% (each side
rounds at its own points).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.clip_vit as JC
import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vae as JVAE

import video_styler_tpu_torch.models.clip_vit as TC
import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vae as TVAE
from video_styler_tpu_torch import wan_video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.utils.convert import export_wan_vae

from test_torch_pipeline import DIT, REPO, _frames, _pipelines, _tree, cpu_share  # noqa: F401
from test_torch_vae38 import CFG as VAE38, random_vae38

Z = 4
I2V = dict(DIT, in_dim=2 * Z + 4, has_image_input=True)
FLF2V = dict(I2V, has_image_pos_emb=True)
CLIP = dict(image_size=112, patch_size=7, dim=1280, num_heads=4, num_layers=2)
REQUEST = dict(prompt="a cat walks into the light", negative_prompt="blurry",
               num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
               num_inference_steps=2, tiled=True)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _image(seed, h=40, w=48):
    """A PIL image of another size than the request's (both pipelines
    resize it with PIL)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    base = 127 + 100 * np.sin(6 * xx + 4 * yy * np.array([1.0, 1.3, 1.7]))
    return Image.fromarray(np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255)
                           .astype(np.uint8))


def _i2v_pipelines(jd, td, dit: dict, dual: bool = False):
    """The smoke pipelines of `test_torch_pipeline` without VACE, with an
    image-conditioned DiT (and a second one from seed 5), and the CLIP
    tower, the same weights on both sides."""
    jp, tp = _pipelines(jd, td)
    jp.vace_cfg = jp.vace_params = None
    tp.vace = None
    jp.dit_cfg = JD.WanDiTConfig(**dit)
    jp.dit_params = JD.init_wan_dit(jax.random.PRNGKey(0), jp.dit_cfg, jd)
    tp.dit = from_jax_params("dit", _tree(jp.dit_params), TD.WanDiTConfig(**dit),
                             device="cpu")
    if dual:
        jp.dit2_cfg = jp.dit_cfg
        jp.dit2_params = JD.init_wan_dit(jax.random.PRNGKey(5), jp.dit_cfg, jd)
        tp.dit2 = from_jax_params("dit", _tree(jp.dit2_params), TD.WanDiTConfig(**dit),
                                  device="cpu")
    jp.image_encoder_cfg = JC.ClipVitConfig(**CLIP)
    jp.image_encoder_params = JC.init_clip_vit(jax.random.PRNGKey(6), jp.image_encoder_cfg, jd)
    tp.image_encoder = from_jax_params("clip", _tree(jp.image_encoder_params),
                                       TC.ClipVitConfig(**CLIP), device="cpu")
    return jp, tp


def _run_both(jp, tp, **kw):
    kw = dict(REQUEST, **kw)
    want = np.asarray(jnp.asarray(jp(return_latents=True, **kw), jnp.float32))
    got = tp(return_latents=True, **kw)
    return got, want


# ------------------------------------------------------------------ DiT

def _dit_inputs(cfg, clip_rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, Z, 3, 4, 4)).astype(np.float32)
    y = rng.standard_normal((1, Z + 4, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, cfg["text_dim"])).astype(np.float32)
    clip = rng.standard_normal((1, clip_rows, 1280)).astype(np.float32)
    return x, y, ctx, clip


@pytest.mark.parametrize("case", ["i2v", "flf2v"])
def test_image_dit_forward_matches_jax(case):
    """One forward of the I2V (257 CLIP rows) and FLF2V (514 rows: the end
    image's 257 land in the text branch of the split) DiT in fp32, with a
    random FLF2V position table."""
    cfg = {"i2v": I2V, "flf2v": FLF2V}[case]
    jcfg = JD.WanDiTConfig(**cfg)
    params = JD.init_wan_dit(jax.random.PRNGKey(1), jcfg)
    if case == "flf2v":
        params["img_emb"]["emb_pos"] = jax.random.normal(jax.random.PRNGKey(2),
                                                         (1, 514, 1280)) * 0.1
    model = from_jax_params("dit", _tree(params), TD.WanDiTConfig(**cfg), device="cpu")
    x, y, ctx, clip = _dit_inputs(cfg, 257 if case == "i2v" else 514)
    t = np.array([700.0], np.float32)
    want = np.asarray(JD.wan_dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(t),
                                         jnp.asarray(ctx), clip_feature=jnp.asarray(clip),
                                         y=jnp.asarray(y)))
    with torch.no_grad():
        got = TD.wan_dit_forward(model, *(torch.from_numpy(a) for a in (x, t, ctx)),
                                 clip_feature=torch.from_numpy(clip),
                                 y=torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (1, Z, 3, 4, 4)
    assert _rel(got, want) < 2e-5
    assert model.blocks[0].cross_attn.k_img.weight.shape == (256, 256)


def test_per_token_timestep_matches_jax():
    """A (B, S) timestep: per-token t_mod (B, S, 6, D) through `_split_mod`
    and a per-token head (TI2V's separated timestep; the first frame's
    tokens at t = 0), in fp32, against the JAX functions."""
    cfg = dict(DIT, seperated_timestep=True)
    jcfg = JD.WanDiTConfig(**cfg)
    params = JD.init_wan_dit(jax.random.PRNGKey(3), jcfg)
    model = from_jax_params("dit", _tree(params), TD.WanDiTConfig(**cfg), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, Z, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 64)).astype(np.float32)
    t = np.full((1, 3 * 2 * 2), 800.0, np.float32)
    t[:, :4] = 0.0
    _, jmod = JD.time_embed(params, jcfg, jnp.asarray(t))
    with torch.no_grad():
        _, tmod = TD.time_embed(model, torch.from_numpy(t))
        assert tmod.shape == (1, 12, 6, 256)
        assert _rel(tmod.numpy(), np.asarray(jmod)) < 2e-5
        want_terms = JD._split_mod(params["blocks"]["modulation"][0], jmod, 6)
        got_terms = TD._split_mod(model.blocks[0].modulation, tmod, 6)
        for g, w in zip(got_terms, want_terms):
            assert g.shape == (1, 12, 256)
            assert _rel(g.numpy(), np.asarray(w)) < 2e-5
        want = np.asarray(JD.wan_dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(t),
                                             jnp.asarray(ctx)))
        got = TD.wan_dit_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx)).numpy()
        flat = TD.wan_dit_forward(model, torch.from_numpy(x), torch.tensor([800.0]),
                                  torch.from_numpy(ctx)).numpy()
    assert _rel(got, want) < 2e-5
    # the first frame's tokens at t = 0 change the output
    assert _rel(got, flat) > 1e-3


# ------------------------------------------------------------- pipelines

PIPE_CASES = {"i2v-fp32": (I2V, "fp32", False), "i2v-bf16": (I2V, "bf16", False),
              "flf2v-fp32": (FLF2V, "fp32", False), "flf2v-bf16": (FLF2V, "bf16", False),
              "dual-i2v-fp32": (I2V, "fp32", True), "dual-i2v-bf16": (I2V, "bf16", True)}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_i2v_pipeline_matches_jax(case):
    """I2V (first image), FLF2V (and an end image: two CLIP features, the
    mask's last frame set), and the Wan2.2 A14B-style dual expert (the
    first step at t = 1000 on `dit`, the second at t = 833 on `dit2`)."""
    dit, which, dual = PIPE_CASES[case]
    jp, tp = _i2v_pipelines(*DTYPES[which], dit, dual)
    kw = dict(input_image=_image(1))
    if dit.get("has_image_pos_emb"):
        kw["end_image"] = _image(2)
    got, want = _run_both(jp, tp, **kw)
    assert got.shape == (1, Z, 3, 4, 4) and got.dtype == DTYPES[which][1]
    rel = _rel(got.float().numpy(), want)
    # fp32: measured ~1e-6 over 2 steps x 2 CFG passes; bf16: each side
    # rounds at its own points (the CFG difference amplifies it 5x)
    assert rel < (2e-5 if which == "fp32" else 5e-2), rel
    assert [name for name, _ in tp.stage_times][:4] == [
        "t5", "vae_encode", "clip_encode", "vae_encode_image"]
    if dual:
        # the second expert changes the result
        dit2, tp.dit2 = tp.dit2, None
        try:
            one = tp(return_latents=True, **dict(REQUEST, **kw))
        finally:
            tp.dit2 = dit2
        assert _rel(one.float().numpy(), got.float().numpy()) > 1e-3


@pytest.fixture(scope="module")
def fp32_i2v():
    return _i2v_pipelines(jnp.float32, torch.float32, I2V)


OPTIONS = {
    "cfg_merge": dict(cfg_merge=True),
    # this threshold replays the residual on every step but the first and last
    "tea_cache": dict(num_inference_steps=4, tea_cache_l1_thresh=10.0,
                      tea_cache_model_id="Wan2.1-I2V-14B-480P"),
    # 17 frames: 5 latent frames in windows of 3 every 2, y sliced with them
    "sliding_window": dict(num_frames=17, sliding_window_size=3, sliding_window_stride=2),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_i2v_options_match_jax(fp32_i2v, option):
    jp, tp = fp32_i2v
    got, want = _run_both(jp, tp, input_image=_image(1), **OPTIONS[option])
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 2e-5


def _ti2v_pipelines():
    """A TI2V smoke DiT (z 8 channels, fused first frame) on the tiny
    Wan2.2-family VAE, fp32, the same weights on both sides."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.vace_cfg = jp.vace_params = None
    tp.vace = None
    cfg = dict(DIT, in_dim=8, out_dim=8, seperated_timestep=True,
               require_vae_embedding=False, fuse_vae_embedding_in_latents=True)
    jp.dit_cfg = JD.WanDiTConfig(**cfg, require_clip_embedding=False)
    jp.dit_params = JD.init_wan_dit(jax.random.PRNGKey(4), jp.dit_cfg)
    tp.dit = from_jax_params("dit", _tree(jp.dit_params), TD.WanDiTConfig(**cfg),
                             device="cpu")
    tp.vae = random_vae38(TVAE.WanVAE38Config(**VAE38))
    jp.vae_cfg = JVAE.WanVAE38Config(**VAE38)
    jp.vae_params = JVAE.convert_wan_vae(
        {k: v.numpy() for k, v in export_wan_vae(tp.vae).items()}, dtype=jnp.float32)
    return jp, tp


def test_ti2v_first_frame_pinned_matches_jax():
    """Wan2.2 TI2V: the image's latent is written into the noise and pinned
    after every step (JAX `tests/test_pipeline.py:212`); the latents match
    the JAX pipeline's, and the first frame equals the image's own encode
    bit for bit. Both pipelines give every token the one (1,) timestep
    (ROADMAP Queue 3: the reference gives the first frame's tokens t = 0;
    `test_per_token_timestep_matches_jax` holds that path)."""
    jp, tp = _ti2v_pipelines()
    img = _image(3, 64, 64)
    got, want = _run_both(jp, tp, input_image=img, height=64, width=64)
    assert got.shape == (1, 8, 3, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    from video_styler_tpu_torch.pipelines.wan_video import _preprocess_images
    z0 = tp.encode_video(_preprocess_images([np.asarray(img)]), tiled=True)
    assert torch.equal(got[:, :, 0:1], z0)
    np.testing.assert_allclose(want[:, :, 0:1], z0.numpy(), rtol=2e-5, atol=2e-6)
    assert [n for n, _ in tp.stage_times][:3] == ["t5", "vae_encode", "vae_encode_image"]
    # the Wan2.2 VAE's 16x factor: sizes round up to multiples of 32
    assert tp.check_resize(40, 70, 47) == jp.check_resize(40, 70, 47) == (64, 96, 49)


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("recipe", ["Wan2.1-I2V-14B-480P", "Wan2.2-TI2V-5B"])
def test_cli_smoke_on_cpu(recipe, capsys):
    out = wan_video_gen.main(["--recipe", recipe, "--smoke", "--device", "cpu"])
    assert bool(torch.isfinite(out.float()).all())
    z = 8 if recipe == "Wan2.2-TI2V-5B" else Z
    assert out.shape == (1, z, 2, 4, 4)
    assert "finite=True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wan_video_gen.main(["--recipe", recipe, "--smoke"])


def _jax_runner():
    path = os.path.join(REPO, "examples", "wanvideo", "_runner.py")
    spec = importlib.util.spec_from_file_location("_wan_runner_under_test", path)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    return runner


class _Recorder:
    """A stand-in pipeline that records what a CLI passes it."""

    def __init__(self, zeros):
        self.zeros = zeros
        self.kwargs = None

    def __call__(self, prompt, **kwargs):
        self.kwargs = kwargs
        return self.zeros((1, 4, 2, 4, 4))

    def load_lora(self, *a, **k):
        pass


def test_runner_drops_the_image_outside_smoke(tmp_path, monkeypatch):
    """The JAX runner's real mode calls the pipeline with no image (it sets
    `kw = {}`, `_runner.py:238-244`), so an I2V recipe on files never sees
    `input_image`; the port's CLI passes --input_image and --end_image
    (ROADMAP Queue 3)."""
    runner = _jax_runner()
    rec = _Recorder(jnp.zeros)
    monkeypatch.setattr(runner, "build_real_pipe", lambda recipe, args: rec)
    runner.run("Wan2.1-FLF2V-14B-720P", ["--dit_path", "unused", "--return_latents"])
    assert rec.kwargs is not None and "input_image" not in rec.kwargs

    first, last = str(tmp_path / "first.png"), str(tmp_path / "last.png")
    _image(1).save(first)
    _image(2).save(last)
    port = _Recorder(torch.zeros)
    monkeypatch.setattr(wan_video_gen, "build_pipeline", lambda args: port)
    wan_video_gen.main(["--recipe", "Wan2.1-FLF2V-14B-720P", "--dit_path", "unused",
                        "--input_image", first, "--end_image", last, "--return_latents",
                        "--device", "cpu"])
    np.testing.assert_array_equal(port.kwargs["input_image"], np.asarray(_image(1)))
    np.testing.assert_array_equal(port.kwargs["end_image"], np.asarray(_image(2)))
    with pytest.raises(SystemExit):   # an I2V recipe without its image
        wan_video_gen.main(["--recipe", "Wan2.1-I2V-14B-480P", "--dit_path", "unused",
                            "--device", "cpu"])
