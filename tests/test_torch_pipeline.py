"""The slice as a whole: the port's Wan VACE edit pipeline against the JAX
`WanVideoPipeline` built with the same weights, plus the port's import
isolation, its refusal to run on the CPU unasked, and its CLI.

Widths: DiT/VACE dim 256 with 2 heads of 128, 2 layers; umT5 64 wide; the
16-wide z=4 VAE. Request: 9 frames of 32x32, 2 steps, two-pass CFG 5,
streaming VAE (tiled=True). Both sides draw the same CPU noise.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.t5 as JT
import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vace as JV
import video_styler_tpu.models.wan_vae as JVAE
from video_styler_tpu.pipelines.wan_video import WanVideoPipeline as JPipe

import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
import video_styler_tpu_torch.models.wan_vae as TVAE
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.device import resolve_device
from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline as TPipe
from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
           num_layers=2, text_dim=64, freq_dim=32)
VACE = dict(vace_layers=(0, 1), vace_in_dim=72, dim=256, num_heads=2, ffn_dim=512)
T5 = dict(vocab=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
          num_layers=2, num_buckets=8)
TEXT_LEN = 16
REQUEST = dict(prompt="make it a watercolor painting", negative_prompt="blurry",
               num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
               num_inference_steps=2, tiled=True)


@pytest.fixture(autouse=True, scope="module")
def cpu_share():
    """Torch's intra-op threads held to this process's share of the cores
    while a module's tests run, and restored after it. Under pytest-xdist
    each worker process would start a thread per core; the workers' threads
    then wait on each other at every parallel region. Imported by every
    CPU test module of the port."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, max(1, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(before)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _frames():
    t = np.arange(9, dtype=np.float32)[:, None, None, None]
    y = np.linspace(0, 1, 32, dtype=np.float32)[None, :, None, None]
    x = np.linspace(0, 1, 32, dtype=np.float32)[None, None, :, None]
    c = np.array([0.0, 0.3, 0.6], np.float32)[None, None, None, :]
    return (127.5 + 120 * np.sin(5 * x + 3 * y * (1 + c) + 0.4 * t)).astype(np.uint8)


_VAE_PARAMS = {}


def _jax_vae_params():
    """The JAX VAE init, jitted (3x quicker than eager) and kept per module."""
    if not _VAE_PARAMS:
        init = jax.jit(JVAE.init_wan_vae, static_argnums=(1,))
        _VAE_PARAMS["p"] = init(jax.random.PRNGKey(3), JVAE.WAN_VAE_TINY)
    return _VAE_PARAMS["p"]


def _pipelines(jd, td):
    jvae_cfg = JVAE.WAN_VAE_TINY
    jp = JPipe(dtype=jd)
    jp.vae_cfg = jvae_cfg
    jp.vae_params = _jax_vae_params()
    jp.dit_cfg = JD.WanDiTConfig(**DIT)
    jp.dit_params = JD.init_wan_dit(jax.random.PRNGKey(0), jp.dit_cfg, jd)
    jp.vace_cfg = JV.VaceConfig(**VACE)
    jp.vace_params = JV.init_vace(jax.random.PRNGKey(1), jp.vace_cfg, jd)
    t5_cfg = JT.T5Config(**T5)
    jp.t5_cfg = t5_cfg
    jp.text_encoder_params = JT.init_t5(jax.random.PRNGKey(2), t5_cfg)
    jp.prompter.cfg = t5_cfg
    jp.prompter.text_len = TEXT_LEN
    jp.prompter.tokenizer = StubTokenizer(TEXT_LEN)
    jp.prompter.fetch_models(jp.text_encoder_params)

    tp = TPipe(device="cpu", dtype=td)
    tp.dit = from_jax_params("dit", _tree(jp.dit_params), TD.WanDiTConfig(**DIT),
                             device="cpu")
    tp.vace = from_jax_params("vace", _tree(jp.vace_params), TV.VaceConfig(**VACE),
                              device="cpu")
    tp.vae = from_jax_params("vae", _tree(jp.vae_params), TVAE.WanVAEConfig(
        dim=16, z_dim=4, num_res_blocks=1, latent_mean=(0.0,) * 4,
        latent_std=(1.0,) * 4), device="cpu")
    t5 = from_jax_params("t5", _tree(jp.text_encoder_params), TT.T5Config(**T5),
                         device="cpu")
    tp.prompter = WanPrompter(StubTokenizer(TEXT_LEN), TEXT_LEN, t5)
    return jp, tp


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_pipeline_matches_jax(which):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[which]
    jp, tp = _pipelines(jd, td)
    video = _frames()
    want = np.asarray(jnp.asarray(jp(vace_video=video, return_latents=True,
                                     **REQUEST), jnp.float32))
    got = tp(vace_video=video, return_latents=True, **REQUEST)
    assert got.shape == (1, 4, 3, 4, 4) and got.dtype == td
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # fp32: the same arithmetic summed in other orders, through 2 steps x 2
    # CFG passes (the CFG difference amplifies by 5): measured 1.8e-6.
    # bf16: each side rounds to bf16 at its own points: measured 2.6%,
    # about the distance between bf16 and fp32 on this run (2.1%)
    assert rel < (2e-5 if which == "fp32" else 5e-2), rel

    frames_j = np.stack([np.asarray(im) for im in jp(vace_video=video, **REQUEST)])
    frames_t = tp(vace_video=video, **REQUEST)
    assert frames_t.shape == (9, 32, 32, 3) and frames_t.dtype == np.uint8
    diff = np.abs(frames_t.astype(np.int16) - frames_j.astype(np.int16))
    # uint8 frames: fp32 latents agree to a rounding level (measured max 1);
    # the random 16-wide VAE turns the bf16 latents' 2.6% into a mean of
    # ~2 levels with isolated pixels up to ~24 (measured)
    assert diff.max() <= (2 if which == "fp32" else 40), diff.max()
    assert diff.mean() <= (0.01 if which == "fp32" else 4.0), diff.mean()
    assert [name for name, _ in tp.stage_times] == [
        "t5", "vae_encode", "denoise_step_0", "denoise_step_1", "vae_decode"]


OPTIONS = {
    "cfg_merge": dict(cfg_merge=True),
    # a threshold this high makes TeaCache replay the trunk residual on every
    # step but the first and last
    "tea_cache": dict(num_inference_steps=4, tea_cache_l1_thresh=10.0,
                      tea_cache_model_id="Wan2.1-T2V-1.3B"),
    "input_video": dict(input_video="frames", denoising_strength=0.7),
    "reference_image": dict(vace_reference_image="frame0"),
    "video_mask": dict(vace_video_mask="left_half"),
}


@pytest.fixture(scope="module")
def fp32_pipelines():
    return _pipelines(jnp.float32, torch.float32)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_pipeline_options_match_jax(fp32_pipelines, option):
    """cfg_merge, TeaCache, V2V input, a VACE reference image and a VACE
    mask, in fp32."""
    jp, tp = fp32_pipelines
    video = _frames()
    kw = dict(REQUEST, **OPTIONS[option])
    if kw.get("input_video") == "frames":
        kw["input_video"] = video
    if kw.get("vace_reference_image") == "frame0":
        kw["vace_reference_image"] = video[0]
    if kw.get("vace_video_mask") == "left_half":
        mask = np.zeros_like(video)
        mask[:, :, :16] = 255
        kw["vace_video_mask"] = mask
    want = np.asarray(jnp.asarray(jp(vace_video=video, return_latents=True, **kw),
                                  jnp.float32))
    got = tp(vace_video=video, return_latents=True, **kw).float().numpy()
    assert got.shape == want.shape == (1, 4, 3, 4, 4)
    # same arithmetic in other summation orders (see test_pipeline_matches_jax)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, rel


def test_port_imports_no_jax():
    """Importing every module of the port (and its CLIs) pulls in neither
    JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_styler_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for cli in ('infer_ditto', 'train', 'step2_video_editing', 'enhance_video',\n"
        "            'wan_video_gen'):\n"
        "    assert 'video_styler_tpu_torch.' + cli in sys.modules, cli\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'video_styler_tpu' or m.startswith('video_styler_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50


def test_entry_points_refuse_cpu_unless_asked(tmp_path):
    """With no GPU, the default device raises; device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPipe()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_smoke_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--prompt", "x", "--output_path", str(tmp_path / "a.mp4")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params("vae", {}, TVAE.WanVAEConfig())
    assert resolve_device("cpu").type == "cpu"


def test_cli_smoke_on_cpu(tmp_path):
    from video_styler_tpu_torch.infer_ditto import main
    out = tmp_path / "edit.mp4"
    frames = main(["--smoke", "--prompt", "a cat in the rain", "--device", "cpu",
                   "--num_inference_steps", "2", "--output_path", str(out)])
    assert frames.shape == (9, 32, 32, 3) and frames.dtype == np.uint8
    assert out.exists() and out.stat().st_size > 0
    # --dit_path goes through from_pretrained: a missing file is named
    with pytest.raises(FileNotFoundError, match="dit.safetensors"):
        main(["--prompt", "x", "--dit_path", str(tmp_path / "dit.safetensors"),
              "--device", "cpu"])
