"""SD video (AnimateDiff, Diffutoon) against the JAX package: the motion
modules (`temporal_block`, and the UNet with them after its mapped
blocks, SD and SDXL), `dance_long_video`'s triangle blend,
`SDVideoPipeline` over 2 steps (two overlapping windows, img2img with the
smoother hook at step 1, per-frame ControlNet residuals),
`SDXLVideoPipeline` (motion modules, the IP-Adapter under InstantStyle),
the Diffutoon runner end to end on one JSON config with the pipelines
handed in, the JAX runner's four faults (each shown, then the port's
runner loading the same files), `load_model` on `motion_modules`, and the
`video_gen --family sd_animatediff --smoke` and `diffutoon --smoke` CLIs.

Weights drawn by the port, read by the JAX converters under the
reference's names. The motion models follow the tiny UNets' widths (21
modules for SD, 15 for SDXL), one transformer each, 32 position rows.
Clips of 6 frames at 128x128 in windows of 4 every 2 (SDXL: 4 frames, one
window). fp32 within 2e-5 relative L2 (the smoother hook: `TOL_SMOOTHER`);
frames within one level. The JAX UNets run jitted (`jit_jax_unets`).
"""
import copy
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.controlnets as JCN
import video_styler_tpu.models.controlnet as JCtl
import video_styler_tpu.models.motion as JM
import video_styler_tpu.models.sd as JS
import video_styler_tpu.models.sdxl as JX
from video_styler_tpu.pipelines import pipeline_runner as JR
from video_styler_tpu.pipelines.sd_video import SDVideoPipeline as JVideo
from video_styler_tpu.pipelines.sd_video import dance_long_video as j_dance
from video_styler_tpu.pipelines.sdxl_video import SDXLVideoPipeline as JXVideo

import video_styler_tpu_torch.controlnets as TCN
import video_styler_tpu_torch.models.motion as TM
import video_styler_tpu_torch.models.sd as TS
import video_styler_tpu_torch.models.sdxl as TX
from video_styler_tpu_torch import diffutoon, video_gen
from video_styler_tpu_torch.pipelines import pipeline_runner as TR
from video_styler_tpu_torch.pipelines.sd_video import SDVideoPipeline as TVideo
from video_styler_tpu_torch.pipelines.sd_video import dance_long_video
from video_styler_tpu_torch.pipelines.sdxl_video import SDXLVideoPipeline as TXVideo
from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401
from test_torch_sd import SIZE, TOL_F32, civitai_file, draw, jit_jax_vae, jparams, \
    picture, sd_models  # noqa: F401
from test_torch_sd_adapters import controlnet, ipadapter
from test_torch_sdxl import xl_models

FRAMES, WINDOW, STRIDE = 6, 4, 2
# the smoother hook's frames are uint8: a float a hair either side of a level
# rounds to neighbouring levels in the two packages, and the re-encoded
# target carries that
TOL_SMOOTHER = 2e-3


def _jitted(forward, n_args: int):
    """`forward` under jax.jit, the motion call map (a dict of Python ints
    that the forward turns into keys) closed over rather than traced."""
    cache = {}

    def run(*args, motion=None, **kw):
        args = args[:n_args]
        call = None if motion is None else tuple(sorted(motion[1].items()))
        if call not in cache:
            cmap = None if call is None else dict(call)
            cache[call] = jax.jit(lambda a, mp, k: forward(
                *a, motion=None if mp is None else (mp, cmap), **k))
        return cache[call](args, None if motion is None else motion[0], kw)
    return run


@pytest.fixture(autouse=True, scope="module")
def jit_jax_unets():
    """The JAX UNets and the SD ControlNet jitted (eager, their first run at
    a window's batch takes tens of seconds); the pipelines read them from
    the modules."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "sd_unet_forward", _jitted(JS.sd_unet_forward, 4))
    mp.setattr(JX, "sdxl_unet_forward", _jitted(JX.sdxl_unet_forward, 6))
    mp.setattr(JCtl, "sd_controlnet_forward", jax.jit(JCtl.sd_controlnet_forward,
                                                      static_argnames="global_pool"))
    yield
    mp.undo()


@functools.lru_cache(maxsize=None)
def motion(xl: bool):
    cfg = TX.SDXL_UNET_TINY if xl else TS.SD_UNET_TINY
    return draw((TM.sdxl_motion_model if xl else TM.sd_motion_model)(cfg), 61 + xl)


def jmotion(model):
    return jparams(model)["motion_modules"]


def clip(frames: int = FRAMES, size: int = SIZE, seed: int = 62):
    return [np.asarray(picture(seed + i, size)) for i in range(frames)]


def test_temporal_block_matches_jax():
    model = motion(False)
    x = np.random.default_rng(63).standard_normal((FRAMES, 64, 4, 4)).astype(np.float32)
    want = np.asarray(JM.temporal_block(jmotion(model)["6"], jnp.asarray(x)))
    with torch.no_grad():
        got = TM.temporal_block(model.motion_modules[6], torch.from_numpy(x)).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


@pytest.mark.parametrize("xl", [False, True])
def test_unet_with_motion_matches_jax(xl):
    unet = xl_models()[0] if xl else sd_models()[0]
    mm = motion(xl)
    rng = np.random.default_rng(64)
    x = rng.standard_normal((WINDOW, 4, SIZE // 8, SIZE // 8)).astype(np.float32)
    t = np.array([501.0], np.float32)
    ctx = rng.standard_normal((1, 77, unet.cfg.text_dim)).astype(np.float32)
    call = TM.SDXL_MOTION_CALL_BLOCK_ID if xl else TM.SD_MOTION_CALL_BLOCK_ID
    jcall = JM.SDXL_MOTION_CALL_BLOCK_ID if xl else JM.SD_MOTION_CALL_BLOCK_ID
    assert call == jcall
    if xl:
        extra = (np.array([SIZE, SIZE, 0, 0, SIZE, SIZE], np.float32),
                 rng.standard_normal((1, 40)).astype(np.float32))
        want = JX.sdxl_unet_forward(jparams(unet), jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), *map(jnp.asarray, extra),
                                    motion=(jmotion(mm), jcall))
        with torch.no_grad():
            got = TX.sdxl_unet_forward(unet, torch.from_numpy(x), torch.from_numpy(t),
                                       torch.from_numpy(ctx), *map(torch.from_numpy, extra),
                                       motion=(mm, call))
    else:
        want = JS.sd_unet_forward(jparams(unet), jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx), motion=(jmotion(mm), jcall))
        with torch.no_grad():
            got = TS.sd_unet_forward(unet, torch.from_numpy(x), torch.from_numpy(t),
                                     torch.from_numpy(ctx), motion=(mm, call))
    assert _rel(got.numpy(), np.asarray(want)) < TOL_F32, _rel(got.numpy(), np.asarray(want))


def test_motion_release_widths():
    """mm_sd_v15_v2's 21 modules (454 M) and the SDXL motion model's 15
    (237 M) at the UNets' widths."""
    for build, cfg, n, m in ((TM.sd_motion_model, TS.SD_UNET, 454.4, 21),
                             (TM.sdxl_motion_model, TX.SDXL_UNET, 237.5, 15)):
        with torch.device("meta"):
            model = build(cfg)
        assert len(model.motion_modules) == m
        assert round(sum(p.numel() for p in model.parameters()) / 1e6, 1) == n


def test_dance_long_video_matches_jax():
    """The windows' triangle weights, bit for bit: a UNet that returns ten
    times its window's frames plus the window's first frame, the frames
    being their own indices."""
    import video_styler_tpu.pipelines.sd_video as JSV
    rows = np.arange(FRAMES, dtype=np.float32)[:, None, None, None] * np.ones((1, 1, 2, 2),
                                                                               np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(JSV.SD, "sd_unet_forward", lambda p, s, *a, **k: s * 10 + s[:1])
    try:
        want = np.asarray(j_dance(None, None, jnp.asarray(rows), None, None,
                                  animatediff_batch_size=WINDOW, animatediff_stride=STRIDE))
    finally:
        mp.undo()
    r = torch.from_numpy(rows)
    got = dance_long_video(lambda b0, b1: r[b0:b1] * 10 + r[b0:b0 + 1], r, WINDOW, STRIDE)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ pipelines

@functools.lru_cache(maxsize=None)
def video_text_encoder():
    """CLIP-L of 12 layers (48 wide): the JAX video pipeline runs
    `sd_text_encoder_forward` at its default depth."""
    import dataclasses
    from video_styler_tpu_torch.models.sd3_text_encoder import ClipTextEncoder
    return draw(ClipTextEncoder(dataclasses.replace(TX.CLIP_L_TINY_12, num_layers=12)), 67)


@functools.lru_cache(maxsize=None)
def video_pipes():
    """The JAX and port AnimateDiff pipelines on the same weights, fp32,
    one stand-in tokenizer; the port's VAE and towers those of
    `test_torch_sd`."""
    unet, _, enc, dec = sd_models()
    te = video_text_encoder()
    jp = JVideo(dtype=jnp.float32)
    jp.unet_params, jp.text_encoder_params = jparams(unet), jparams(te)
    jp.vae_encoder_params, jp.vae_decoder_params = jparams(enc), jparams(dec)
    jp.motion_params = jmotion(motion(False))
    jp.tokenizer = StubClipTokenizer(128)
    import video_styler_tpu.pipelines.sd_video as JSV
    tp = TVideo(device="cpu", dtype=torch.float32)
    tp.unet, tp.text_encoder, tp.vae_encoder, tp.vae_decoder = unet, te, enc, dec
    tp.motion_modules, tp.tokenizer = motion(False), StubClipTokenizer(128)
    return jp, tp, JSV


class Smoother:
    """A stand-in for FastBlend: each frame averaged with the one before
    (PIL frames in and out for JAX, arrays for the port)."""

    def __call__(self, frames, original_frames=None, **kw):
        arr = [np.asarray(f, np.int32) for f in frames]
        out = [((a + arr[max(i - 1, 0)]) // 2).astype(np.uint8) for i, a in enumerate(arr)]
        return [Image.fromarray(o) for o in out] if isinstance(frames[0], Image.Image) else out


def _pil(frames):
    return [Image.fromarray(f) for f in frames]


REQUESTS = {
    "t2v": dict(),
    "v2v_smoother": dict(denoising_strength=0.8, smoother_progress_ids=[1], input=True),
    "controlnet": dict(controlnet=True),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_sd_video_pipeline_matches_jax(name):
    jp, tp, _ = video_pipes()
    spec = dict(REQUESTS[name])
    frames = clip()
    base = dict(prompt="a fox in snow", negative_prompt="blurry", cfg_scale=6.0,
                num_frames=FRAMES, height=SIZE, width=SIZE, num_inference_steps=2, seed=7,
                animatediff_batch_size=WINDOW, animatediff_stride=STRIDE, return_latents=True)
    jkw, tkw = dict(base), dict(base)
    if spec.pop("input", False):
        jkw["input_frames"], tkw["input_frames"] = _pil(frames), frames
        jkw["smoother"], tkw["smoother"] = Smoother(), Smoother()
    jp, tp = copy.copy(jp), copy.copy(tp)
    if spec.pop("controlnet", False):
        cn = controlnet(False)
        jp.controlnet_manager = JCN.MultiControlNetManager(
            [JCN.ControlNetUnit(JCN.Annotator("tile"), jparams(cn), scale=0.9)])
        tp.controlnet_manager = TCN.MultiControlNetManager(
            [TCN.ControlNetUnit(TCN.Annotator("tile"), cn, 0.9)])
        jkw["controlnet_frames"], tkw["controlnet_frames"] = _pil(frames), frames
    want = np.asarray(jp(**jkw, **spec))
    got = tp(**tkw, **spec).numpy()
    assert got.shape == (FRAMES, 4, SIZE // 8, SIZE // 8)
    tol = TOL_SMOOTHER if "smoother" in name else TOL_F32
    assert _rel(got, want) < tol, _rel(got, want)


def test_sdxl_video_pipeline_matches_jax():
    """SDXL AnimateDiff, the IP-Adapter under InstantStyle (the negative
    pass at scale 1, as in JAX)."""
    from test_torch_sdxl import pipes
    jb, tb = pipes()
    jp, tp = JXVideo(dtype=jnp.float32), TXVideo(device="cpu", dtype=torch.float32)
    for src, dst in ((jb, jp), (tb, tp)):
        dst.__dict__.update({k: v for k, v in src.__dict__.items() if k != "scheduler"})
    jp.motion_params, tp.motion_modules = jmotion(motion(True)), motion(True)
    ip = ipadapter(True)
    jp.ipadapter_params, tp.ipadapter = jparams(ip), ip
    embeds = np.random.default_rng(65).standard_normal((1, 20)).astype(np.float32)
    request = dict(prompt="a fox in snow", negative_prompt="blurry", cfg_scale=6.0,
                   num_frames=WINDOW, height=SIZE, width=SIZE, num_inference_steps=2, seed=8,
                   animatediff_batch_size=WINDOW, animatediff_stride=STRIDE,
                   ipadapter_scale=0.7, ipadapter_use_instant_style=True, return_latents=True)
    want = np.asarray(jp(**request, ipadapter_image_embeds=jnp.asarray(embeds)))
    got = tp(**request, ipadapter_image_embeds=torch.from_numpy(embeds)).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ Diffutoon runner

def write_folder(path, frames):
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(path, f"{i:03d}.png"))


def runner_config(tmp_path, name: str, controlnet_frames: bool = False) -> dict:
    folder = str(tmp_path / "input")
    write_folder(folder, clip(6, 160, seed=70))
    data = {"input_frames": {"image_folder": folder, "height": SIZE, "width": SIZE,
                             "start_frame_id": 0, "end_frame_id": 6},
            "output_folder": str(tmp_path / name), "fps": 8}
    if controlnet_frames:
        data["controlnet_frames"] = [dict(data["input_frames"])]
    return {"models": {"model_list": []}, "data": data,
            "smoother_configs": [{"processor_type": "contrast", "rate": 1.2}],
            "pipeline": {"seed": 9, "pipeline_inputs": {
                "prompt": "a toon fox", "negative_prompt": "blurry", "cfg_scale": 5.0,
                "clip_skip": 1, "denoising_strength": 0.8, "num_inference_steps": 2,
                "animatediff_batch_size": 4, "animatediff_stride": 2,
                "smoother_progress_ids": [1]}}}


def test_runner_matches_jax_end_to_end(tmp_path):
    """One config through both runners with the pipelines handed in (the
    JAX runner cannot load its own models: below): frames within one level,
    the saved frames, video and config."""
    jp, tp, _ = video_pipes()
    outs = {}
    for name, runner, pipe in (("jax", JR.SDVideoPipelineRunner(), jp),
                               ("port", TR.SDVideoPipelineRunner(device="cpu"), tp)):
        cfg = runner_config(tmp_path, name)
        outs[name] = [np.asarray(f, np.int32) for f in runner.run(cfg, pipe=pipe)]
        folder = tmp_path / name
        assert sorted(os.listdir(folder / "frames")) == [f"{i}.png" for i in range(6)]
        with open(folder / "config.json") as f:
            saved = json.load(f)
        assert "input_frames" not in saved["pipeline"]["pipeline_inputs"]
        assert saved["pipeline"]["pipeline_inputs"]["num_frames"] == 6
    assert len(outs["port"]) == len(outs["jax"]) == 6
    for g, w in zip(outs["port"], outs["jax"]):
        assert g.shape == w.shape == (SIZE, SIZE, 3)
        assert np.abs(g - w).max() <= 1, np.abs(g - w).max()


@functools.lru_cache(maxsize=None)
def model_files(tmp: str):
    """A civitai SD file, a motion-module file, a LoRA of two UNet linears
    and a tile ControlNet file, under the reference's names."""
    unet, te, enc, dec = sd_models()
    paths = {}
    paths["sd"] = os.path.join(tmp, "sd15.safetensors")
    save_file({k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in civitai_file(unet, te, enc, dec).items()}, paths["sd"])
    paths["motion"] = os.path.join(tmp, "motion.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in _reference_names(motion(False)).items()},
              paths["motion"])
    gen = torch.Generator().manual_seed(66)
    lora = {}
    for target, (o, i) in (("blocks.1.transformer_blocks.0.attn1.to_q", (32, 32)),
                           ("blocks.66.transformer_blocks.0.ff", (32, 128))):
        lora[f"{target}.lora_A.weight"] = torch.randn(4, i, generator=gen) * 0.1
        lora[f"{target}.lora_B.weight"] = torch.randn(o, 4, generator=gen) * 0.1
    paths["lora"] = os.path.join(tmp, "lora.safetensors")
    save_file(lora, paths["lora"])
    paths["controlnet"] = os.path.join(tmp, "controlnet.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in _reference_names(controlnet(False)).items()},
              paths["controlnet"])
    return paths, lora


def test_runner_loads_files_where_jax_fails(tmp_path):
    """The JAX runner's faults (ROADMAP Queue 3), each shown: (1) the
    civitai state dicts stored flat as params, which its UNet cannot read;
    (2) the motion file's whole tree as `motion_params`, one level too
    high; (3) a LoRA on the UNet's blocks, which its LoRA walk cannot
    enter; (4) the per-unit ControlNet frames handed to the annotator as
    one image. The port's runner loads the same files (the LoRA merged as
    the port's `merge_lora` merges it) and renders with ControlNet frames."""
    paths, lora = model_files(str(tmp_path))
    unet = sd_models()[0]
    runner = JR.SDVideoPipelineRunner()
    jp = runner.load_pipeline([paths["sd"], paths["motion"]])
    assert "blocks.0.norm1.weight" in jp.unet_params                       # (1)
    with pytest.raises(KeyError):
        JS.sd_unet_forward(jp.unet_params, jnp.zeros((1, 4, 16, 16)), jnp.asarray([1.0]),
                           jnp.zeros((1, 77, 48)))
    assert set(jp.motion_params) == {"motion_modules"}                      # (2)
    with pytest.raises(KeyError):
        JM.temporal_block(jp.motion_params["0"], jnp.zeros((2, 32, 4, 4)))
    from video_styler_tpu.lora import merge_lora as j_merge_lora
    with pytest.raises(KeyError, match="cannot resolve LoRA target"):     # (3)
        j_merge_lora(jparams(unet), lora)
    with pytest.raises(KeyError):
        runner.load_pipeline([paths["sd"], paths["lora"]])
    jv, _, _ = video_pipes()
    jv = copy.copy(jv)
    jv.controlnet_manager = JCN.MultiControlNetManager(
        [JCN.ControlNetUnit(JCN.Annotator("tile"), jparams(controlnet(False)))])
    with pytest.raises(AttributeError):                                     # (4)
        jv(prompt="x", num_frames=2, height=SIZE, width=SIZE, num_inference_steps=1,
           controlnet_frames=[_pil(clip(2))])

    tr = TR.SDVideoPipelineRunner(device="cpu")
    tp = tr.load_pipeline([paths["sd"], paths["motion"], paths["lora"]], lora_alphas=[0.5],
                          controlnet_units=[{"processor_id": "tile",
                                             "model_path": paths["controlnet"], "scale": 0.9}])
    assert tp.dtype == torch.bfloat16
    want = copy.deepcopy(unet).to(torch.bfloat16)
    from video_styler_tpu_torch.lora import merge_lora
    merge_lora(want, lora, alpha=0.5)
    for k, v in want.state_dict().items():
        torch.testing.assert_close(tp.unet.state_dict()[k], v, rtol=0, atol=0, msg=k)
    for k, v in motion(False).state_dict().items():
        torch.testing.assert_close(tp.motion_modules.state_dict()[k], v.bfloat16(), rtol=0,
                                   atol=0, msg=k)
    tp.tokenizer = StubClipTokenizer(128)     # no tokenizer files here
    cfg = runner_config(tmp_path, "port_files", controlnet_frames=True)
    cfg["pipeline"]["pipeline_inputs"].update(num_inference_steps=1, smoother_progress_ids=[])
    frames = tr.run(cfg, pipe=tp)
    assert len(frames) == 6 and all(f.shape == (SIZE, SIZE, 3) for f in frames)


def test_load_model_motion_modules(tmp_path):
    paths, _ = model_files(str(tmp_path))
    kind, model = TC.load_model(paths["motion"], device="cpu", dtype=torch.float32)
    assert kind == "motion_modules" and isinstance(model, TM.MotionModel)
    for k, v in motion(False).state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ CLIs

def test_video_gen_smoke_cli(tmp_path, capsys):
    out = tmp_path / "sdv.mp4"
    assert video_gen.main(["--family", "sd_animatediff", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 11e"):
        video_gen.main(["--family", "hunyuan_video", "--dit_path", "x", "--device", "cpu"])


def test_video_gen_wan_t2v_loads_three_files(monkeypatch, tmp_path):
    """`--family wan_t2v` builds `WanVideoPipeline.from_pretrained` on the
    DiT, VAE and T5 files and requests a tiled T2V clip, as the JAX runner
    does (the pipeline itself: `test_torch_pipeline.py`)."""
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    seen = {}

    class Pipe:
        def __call__(self, **kw):
            seen["call"] = kw
            return [np.zeros((8, 8, 3), np.uint8)] * 2

    def build(cls, model_configs, tokenizer_path=None, device=None):
        seen["paths"] = [mc.path for mc in model_configs]
        seen["tokenizer"], seen["device"] = tokenizer_path, device
        return Pipe()
    monkeypatch.setattr(WanVideoPipeline, "from_pretrained", classmethod(build))
    out = tmp_path / "wan.mp4"
    assert video_gen.main(["--family", "wan_t2v", "--dit_path", "dit.safetensors",
                           "--vae_path", "vae.pth", "--t5_path", "t5.pth", "--tokenizer_path",
                           "tok", "--device", "cpu", "--num_frames", "5",
                           "--output", str(out)]) == 0
    assert seen["paths"] == ["dit.safetensors", "vae.pth", "t5.pth"]
    assert seen["tokenizer"] == "tok" and seen["device"] == "cpu"
    assert seen["call"]["tiled"] is True and seen["call"]["num_frames"] == 5


def test_diffutoon_smoke_cli(tmp_path, capsys):
    cfg = runner_config(tmp_path, "toon", controlnet_frames=True)
    cfg["pipeline"]["pipeline_inputs"]["num_inference_steps"] = 1
    path = tmp_path / "diffutoon.json"
    path.write_text(json.dumps(cfg))
    assert diffutoon.main(["--config", str(path), "--smoke", "--device", "cpu"]) == 0
    assert "saved 6 frames" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "toon" / "frames")) == 6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diffutoon.main(["--config", str(path), "--smoke"])
