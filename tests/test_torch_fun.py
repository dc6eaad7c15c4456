"""The Wan Fun units and speed control against the JAX package, through the
JAX runner's smoke pipelines (`examples/wanvideo/_runner.py:build_smoke_pipe`,
loaded from its file as `tests/test_torch_i2v.py` loads it) and the same
weights in the port: Fun InP (first and last image), Control (control
latents in front of y, zero CLIP rows and y), V1.1 Control with a
reference image (`ref_conv`, an extra leading RoPE frame), Camera (the
SimpleAdapter's features on the tokens; y = the image's latent on frame 0,
and on an InP-config DiT the I2V mask and latent), speed control (the
motion controller's term in t_mod; its zero-initialised fc3 replaced by a
random one, else every id gives the same output), and the Wan2.2 Fun A14B
dual-expert Camera pipeline (each expert with its own adapter); each with
cfg_merge, TeaCache and the temporal sliding window. Also the units'
ValueError and RuntimeError, and the `wan_video_gen` CLI's smoke recipes.

Widths: the JAX runner's smoke (dim 96, 2 heads of 48, 2 layers, umT5 64
wide, the 16-wide z=4 VAE, the 257-token CLIP tower; the VAE's weights
drawn by the port's init, read by the JAX converter). Request: 9 frames of
32x32, CFG 5 two-pass, 2 steps, streaming VAE; both sides draw the same CPU
noise. fp32 within 2e-5 relative L2 (the same arithmetic summed in other
orders), bf16 within 5% (each side rounds at its own points).
"""
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_vae as JVAE
from video_styler_tpu.models.wan_controllers import init_simple_adapter

import video_styler_tpu_torch.models.clip_vit as TC
import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vae as TVAE
from video_styler_tpu_torch import wan_video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline as TPipe
from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter

from test_torch_pipeline import REPO, _tree, cpu_share  # noqa: F401

REQUEST = dict(prompt="a cat walks into the light", negative_prompt="blurry",
               num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
               num_inference_steps=2, tiled=True, return_latents=True)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_RUNNER = {}
_VAE = {}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def jax_runner():
    if not _RUNNER:
        path = os.path.join(REPO, "examples", "wanvideo", "_runner.py")
        spec = importlib.util.spec_from_file_location("_wan_runner_fun", path)
        runner = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(runner)
        _RUNNER["r"] = runner
    return _RUNNER["r"]


def jax_vae_params():
    """The tiny z=4 VAE's weights for the JAX runner's smoke pipelines: the
    port's init (a millisecond, where the JAX init compiles for seconds)
    through the JAX converter; drawn once per process."""
    if not _VAE:
        cfg = TVAE.WanVAEConfig(**{k: getattr(JVAE.WAN_VAE_TINY, k)
                                   for k in TVAE.WanVAEConfig.__dataclass_fields__})
        with torch.device("meta"):
            vae = TVAE.WanVAE(cfg)
        vae = TVAE.init_wan_vae_(vae.to_empty(device="cpu"), torch.Generator().manual_seed(3))
        _VAE["p"] = JVAE.convert_wan_vae({k: v.numpy() for k, v in vae.state_dict().items()},
                                         dtype=jnp.float32)
    return _VAE["p"]


def jax_smoke_pipe(recipe: str, dtype: str = "fp32", camera_on_inp: bool = False):
    """The JAX runner's smoke pipeline of `recipe` (its tiny VAE from
    `jax_vae_params`); a speed controller's fc3 made random; bf16: the
    DiTs, CLIP and controller cast (umT5 and the VAE stay fp32, as in the
    other parity tests). camera_on_inp: a camera adapter added to an
    InP-config DiT (in_dim 2z + 4, so the camera unit builds the I2V y)."""
    runner = jax_runner()
    vae_params = jax_vae_params()
    orig = JVAE.init_wan_vae
    JVAE.init_wan_vae = lambda key, cfg, *a: vae_params
    try:
        jp = runner.build_smoke_pipe(runner.RECIPES[recipe])
    finally:
        JVAE.init_wan_vae = orig
    if camera_on_inp:
        jp.dit_params["control_adapter"] = init_simple_adapter(
            jax.random.PRNGKey(7), in_dim=24, out_dim=jp.dit_cfg.dim)
    if jp.motion_controller_params is not None:
        fc3 = jp.motion_controller_params["fc3"]
        fc3["w"] = jax.random.normal(jax.random.PRNGKey(8), fc3["w"].shape) * 0.05
    jd = DTYPES[dtype][0]
    if jd != jnp.float32:
        jp.dtype = jd
        for name in ("dit_params", "dit2_params", "image_encoder_params",
                     "motion_controller_params"):
            tree = getattr(jp, name)
            if tree is not None:
                setattr(jp, name, jax.tree_util.tree_map(lambda a: a.astype(jd), tree))
    return jp


def _port_cfg(cls, jcfg):
    return cls(**{k: getattr(jcfg, k) for k in cls.__dataclass_fields__ if hasattr(jcfg, k)})


def _port_dit(cfg, params):
    """The port's DiT of a JAX smoke DiT: the runner adds `ref_conv` and
    `control_adapter` to the parameters without a config flag (the JAX
    forward goes by its inputs); the port's config names both."""
    tcfg = _port_cfg(TD.WanDiTConfig, cfg)
    tcfg = TD.WanDiTConfig(**{**tcfg.__dict__, "has_ref_conv": "ref_conv" in params,
                              "has_control_adapter": "control_adapter" in params})
    return from_jax_params("dit", _tree(params), tcfg, device="cpu")


def port_pipe(jp, dtype: str = "fp32") -> TPipe:
    """The port's pipeline holding the JAX smoke pipeline's weights."""
    tp = TPipe(device="cpu", dtype=DTYPES[dtype][1])
    tp.dit = _port_dit(jp.dit_cfg, jp.dit_params)
    if jp.dit2_params is not None:
        tp.dit2 = _port_dit(jp.dit2_cfg, jp.dit2_params)
    tp.vae = from_jax_params("vae", _tree(jp.vae_params), _port_cfg(
        TVAE.WanVAEConfig, jp.vae_cfg), device="cpu")
    t5 = from_jax_params("t5", _tree(jp.text_encoder_params),
                         _port_cfg(TT.T5Config, jp.t5_cfg), device="cpu")
    tp.prompter = WanPrompter(StubTokenizer(jp.prompter.text_len), jp.prompter.text_len, t5)
    if jp.image_encoder_params is not None:
        tp.image_encoder = from_jax_params("clip", _tree(jp.image_encoder_params),
                                           _port_cfg(TC.ClipVitConfig, jp.image_encoder_cfg),
                                           device="cpu")
    if jp.motion_controller_params is not None:
        tp.motion_controller = from_jax_params(
            "motion_controller", _tree(jp.motion_controller_params), None, device="cpu")
    return tp


def recipe_inputs(recipe: str, num_frames: int = 9):
    """The JAX runner's smoke inputs of `recipe` (its PIL frames, seeds and
    motion id) for a clip of `num_frames`."""
    runner = jax_runner()
    return runner.smoke_call_kwargs(runner.RECIPES[recipe], 32, 32, num_frames)


# (recipe, InP-config camera)
PIPES = {"inp": ("Wan2.1-Fun-1.3B-InP", False),
         "control": ("Wan2.1-Fun-1.3B-Control", False),
         "control-ref": ("Wan2.1-Fun-V1.1-1.3B-Control", False),
         "camera": ("Wan2.1-Fun-V1.1-1.3B-Control-Camera", False),
         "camera-inp-y": ("Wan2.1-Fun-1.3B-InP", True),
         "speed": ("Wan2.1-1.3b-speedcontrol-v1", False),
         "a14b-camera": ("Wan2.2-Fun-A14B-Control-Camera", False)}
OPTIONS = {
    "two-pass": {},
    "cfg_merge": dict(cfg_merge=True),
    # this threshold replays the residual on every step but the first and last
    "tea_cache": dict(num_inference_steps=4, tea_cache_l1_thresh=10.0,
                      tea_cache_model_id="Wan2.1-T2V-1.3B"),
    # 17 frames: 5 latent frames in windows of 3 every 2
    "sliding_window": dict(num_frames=17, sliding_window_size=3, sliding_window_stride=2),
}
_PIPES = {}


def _pipes(case):
    if case not in _PIPES:
        recipe, camera_on_inp = PIPES[case]
        jp = jax_smoke_pipe(recipe, camera_on_inp=camera_on_inp)
        _PIPES.clear()
        _PIPES[case] = (jp, port_pipe(jp))
    return _PIPES[case]


def _inputs(case, num_frames):
    kw = recipe_inputs(PIPES[case][0], num_frames)
    if case == "camera-inp-y":
        kw["camera_control_direction"] = "Left Up"
    return kw


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("case", list(PIPES))
def test_fun_pipeline_matches_jax(case, option):
    jp, tp = _pipes(case)
    kw = dict(REQUEST, **OPTIONS[option])
    kw.update(_inputs(case, kw["num_frames"]))
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    got = tp(**kw)
    assert got.shape == want.shape == (1, 4, (kw["num_frames"] - 1) // 4 + 1, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    if option == "two-pass":
        stages = [name for name, _ in tp.stage_times]
        unit = {"control": "vae_encode_control", "control-ref": "vae_encode_reference",
                "camera": "camera_control", "camera-inp-y": "camera_control",
                "a14b-camera": "camera_control"}.get(case)
        assert unit is None or unit in stages


@pytest.mark.parametrize("case", ["control-ref", "camera", "speed"])
def test_fun_pipeline_bf16_matches_jax(case):
    recipe, camera_on_inp = PIPES[case]
    jp = jax_smoke_pipe(recipe, "bf16", camera_on_inp)
    tp = port_pipe(jp, "bf16")
    kw = dict(REQUEST, **_inputs(case, 9))
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    got = tp(**kw)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < 5e-2


def test_units_change_the_result():
    """The camera direction, the reference image and the motion id each
    move the latents (the port alone, fp32)."""
    _, tp = _pipes("speed")
    base = dict(REQUEST, **_inputs("speed", 9))
    a = tp(**base)
    b = tp(**dict(base, motion_bucket_id=10.0))
    assert _rel(a.numpy(), b.numpy()) > 1e-3
    _, tp = _pipes("control-ref")
    base = dict(REQUEST, **_inputs("control-ref", 9))
    a = tp(**base)
    b = tp(**dict(base, reference_image=_inputs("camera", 9)["input_image"]))
    assert _rel(a.numpy(), b.numpy()) > 1e-3
    # the reference frame: one more leading RoPE frame, dropped after the head
    assert a.shape == (1, 4, 3, 4, 4)


def test_unit_errors_match_jax():
    """Camera control without an input image (ValueError) and a motion id
    without a controller (RuntimeError), in both packages."""
    jp, tp = _pipes("camera")
    kw = dict(REQUEST, **_inputs("camera", 9))
    kw.pop("input_image")
    for pipe in (jp, tp):
        with pytest.raises(ValueError, match="camera control requires input_image"):
            pipe(**kw)
        with pytest.raises(RuntimeError, match="no motion controller"):
            pipe(**dict(REQUEST, motion_bucket_id=5.0))


CLI_RECIPES = ["Wan2.1-Fun-V1.1-14B-Control", "Wan2.1-Fun-V1.1-14B-Control-Camera",
               "Wan2.1-1.3b-speedcontrol-v1", "Wan2.2-Fun-A14B-Control",
               "Wan2.2-Animate-14B"]


@pytest.mark.parametrize("recipe", CLI_RECIPES)
def test_cli_smoke_on_cpu(recipe, capsys):
    out = wan_video_gen.main(["--recipe", recipe, "--smoke", "--device", "cpu"])
    assert out.shape == (1, 4, 2, 4, 4)
    assert bool(torch.isfinite(out.float()).all())
    assert "finite=True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wan_video_gen.main(["--recipe", recipe, "--smoke"])


def test_cli_passes_the_unit_inputs(tmp_path, monkeypatch):
    """On files the flags reach the pipeline under its argument names; an
    Animate recipe reads the --dit_path files as its DiT and its adapter,
    speed control takes its controller's file with the kind named; a recipe
    without its inputs, or speed control without its controller, is
    refused."""
    from types import SimpleNamespace
    from PIL import Image
    ref = str(tmp_path / "ref.png")
    Image.fromarray(np.full((40, 48, 3), 90, np.uint8)).save(ref)
    seen = {}
    build_pipeline = wan_video_gen.build_pipeline

    def record(prompt, **kw):
        seen.update(kw)
        return torch.zeros((1, 4, 2, 4, 4))
    monkeypatch.setattr(wan_video_gen, "build_pipeline", lambda args: record)
    common = ["--dit_path", "unused", "--return_latents", "--device", "cpu"]
    wan_video_gen.main(["--recipe", "Wan2.1-Fun-V1.1-14B-Control-Camera", "--input_image", ref,
                        "--camera_control_direction", "Left Up",
                        "--camera_control_speed", "0.05"] + common)
    assert seen["camera_control_direction"] == "Left Up"
    assert seen["camera_control_speed"] == 0.05
    np.testing.assert_array_equal(seen["input_image"], np.asarray(Image.open(ref)))
    wan_video_gen.main(["--recipe", "Wan2.1-1.3b-speedcontrol-v1", "--motion_bucket_id", "20",
                        "--motion_controller_path", "model.safetensors"] + common)
    assert seen["motion_bucket_id"] == 20.0
    with pytest.raises(SystemExit):   # no controller file
        wan_video_gen.main(["--recipe", "Wan2.1-1.3b-speedcontrol-v1",
                            "--motion_bucket_id", "20"] + common)
    with pytest.raises(SystemExit):   # no control video, no reference image
        wan_video_gen.main(["--recipe", "Wan2.1-Fun-V1.1-14B-Control"] + common)

    configs = []

    def from_pretrained(cls, model_configs, **kw):
        configs.extend(model_configs)
        return SimpleNamespace(dit2=None)
    monkeypatch.setattr(TPipe, "from_pretrained", classmethod(from_pretrained))
    for recipe, extra in (("Wan2.2-Animate-14B", []),
                          ("Wan2.1-1.3b-speedcontrol-v1",
                           ["--motion_controller_path", "model.safetensors"])):
        _, args = wan_video_gen.parse_args(["--recipe", recipe, "--dit_path", "a|b"] + extra)
        build_pipeline(args)
    assert [(c.path, c.model_kind) for c in configs] == [
        (["a", "b"], "dit"), (["a", "b"], "animate"),
        (["a", "b"], "dit"), ("model.safetensors", "motion_controller")]
