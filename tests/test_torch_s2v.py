"""Wan2.2 S2V against the JAX package: the segment RoPE tables (bit-equal),
the causal audio encoder, one audio injection at the 14B width (5120, 40
heads, AdaLN), the frame-pack motioner through the forward, the forward,
and `WanVideoPipeline.s2v` at 8 and 12 frames with and without a pose
video; the JAX reference's faults that the port mirrors, one test each;
the `wan_video_gen` CLI's S2V and VACE smoke recipes.

The JAX package has no S2V init, so the port draws the model
(`init_wan_s2v_`, a torch seed, biases made non-zero), and its state dict
under the reference's names (`export_wan_s2v`) goes to both converters.
Widths: `WAN_S2V_TINY` (dim 96, 2 heads of 48, 2 blocks, an injection
after each, 2 audio tokens a frame, 3 wav2vec states of 16); the
pipelines on the JAX runner's S2V smoke pipeline (its umT5 64 wide and
the 16-wide z=4 VAE, weights drawn by the port's init) with that model.
Request: 32x32, CFG 4.5 two-pass, 2 steps; both sides draw the same CPU
noise. fp32 within 2e-5 relative L2, bf16 within 5%. The JAX functions
are jitted (eager, the tiny forward takes ~13 s here).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.wan_s2v as JS
from video_styler_tpu.pipelines.wan_video import WanVideoPipeline as JPipe
from video_styler_tpu.utils.convert import _attn, _lin

import video_styler_tpu_torch.models.wan_s2v as TS
import video_styler_tpu_torch.models.wan_vace as TV
from video_styler_tpu_torch import wan_video_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline as TPipe
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_fun import _rel, jax_smoke_pipe, port_pipe
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TINY = TS.WAN_S2V_TINY
REQUEST = dict(prompt="a woman sings on a rooftop", negative_prompt="blurry",
               height=32, width=32, seed=42, cfg_scale=4.5, num_inference_steps=2,
               return_latents=True)
_MODELS = {}
_PIPES = {}


def _model(cfg=TINY, seed=0):
    """A random port S2V model (fp32, biases non-zero) and its state dict
    under the reference's names; kept per config."""
    if cfg not in _MODELS:
        with torch.device("meta"):
            m = TS.WanS2V(cfg)
        m = TS.init_wan_s2v_(m.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        _MODELS[cfg] = m.eval(), {k: v.clone() for k, v in TS.export_wan_s2v(m).items()}
    return _MODELS[cfg]


def _jax_params(sd, dtype=jnp.float32, cfg=JS.WAN_S2V_TINY):
    return JS.convert_wan_s2v({k: v.float().numpy() for k, v in sd.items()}, cfg, dtype=dtype)


def _inputs(frames, hw=8, seed=0, cfg=TINY):
    """latents (1, 4, 1 + F_lat, hw, hw), timestep, context, audio columns."""
    rng = np.random.default_rng(seed)
    f_lat = (frames - 1) // 4 + 1
    return (rng.standard_normal((1, cfg.in_dim, 1 + f_lat, hw, hw)).astype(np.float32),
            np.array([700.0], np.float32),
            rng.standard_normal((1, 7, cfg.text_dim)).astype(np.float32),
            rng.standard_normal((1, cfg.num_audio_layers, cfg.audio_dim, frames)
                                ).astype(np.float32))


def _jax_forward(params, *args, **kw):
    fwd = jax.jit(lambda p, lat, t, ctx, audio: JS.wan_s2v_forward(
        p, JS.WAN_S2V_TINY, lat, t, ctx, audio, **kw))
    return np.asarray(jnp.asarray(fwd(params, *map(jnp.asarray, args)), jnp.float32))


def _port_forward(model, *args, **kw):
    with torch.no_grad():
        return TS.wan_s2v_forward(model, *map(torch.from_numpy, args), **kw).float().numpy()


def test_config_constants_match_jax():
    for name in ("WAN_S2V_14B", "WAN_S2V_TINY"):
        assert dataclasses.asdict(getattr(TS, name)) == dataclasses.asdict(getattr(JS, name))
    assert TS.WAN_S2V_14B.dit_cfg().head_dim == 128


def test_segment_rope_tables_bit_equal():
    """The video grid, the reference frame at index 30, a linspace-sampled
    segment (total != tokens) and the motioner's three conjugated ones."""
    segments = TS.video_segments(3, 4, 6, 4, 6) + [
        {"start": (2, 1, 0), "end": (6, 3, 5), "total": (9, 7, 11)},
        {"start": (-1, 0, 0), "end": (0, 8, 8), "total": (1, 8, 8)},
        {"start": (-3, 0, 0), "end": (-2, 4, 4), "total": (2, 8, 8)},
        {"start": (-19, 0, 0), "end": (-15, 2, 2), "total": (16, 8, 8)}]
    for head_dim in (48, 128):
        got = TS.s2v_rope_segments(head_dim, segments)
        want = JS.s2v_rope_segments(head_dim, segments)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_causal_audio_encoder_matches_jax():
    """`cal_audio_emb` on 12 audio columns: 73 copies of the first in front,
    two stride-2 causal convs, the first 19 frames dropped -> 3 frames of
    2 local tokens + the padding token, and the global track; fp32."""
    m, sd = _model()
    params = _jax_params(sd)
    audio = _inputs(12)[3]
    want = jax.jit(lambda p, a: JS.cal_audio_emb(p, a, TINY.num_audio_token, True))(
        params, jnp.asarray(audio))
    with torch.no_grad():
        got = TS.cal_audio_emb(m.casual_audio_encoder, torch.from_numpy(audio),
                               TINY.num_audio_token, True)
    assert got[0].shape == want[0].shape == (1, 3, 1, 96)
    assert got[1].shape == want[1].shape == (1, 3, 3, 96)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < 2e-5


def test_audio_injection_14b_width_matches_jax():
    """One audio injection at the 14B width (5120, 40 heads of 128, the
    AdaLN): 3 frames of 24 tokens (and 24 reference tokens left alone),
    each frame's tokens attending to its 5 audio tokens; fp32."""
    cfg = dataclasses.replace(TS.WAN_S2V_14B, audio_inject_layers=(0,))
    jcfg = dataclasses.replace(JS.WAN_S2V_14B, audio_inject_layers=(0,))
    with torch.device("meta"):
        inj = TS.AudioInjector(cfg)
    inj = inj.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in inj.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, 1.0 / 5120 ** 0.5, generator=gen)
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
    sd = {k.replace(".scale", ".weight"): v.numpy() for k, v in inj.state_dict().items()}
    params = {"injector": {"0": _attn(sd, "injector.0", jnp.float32)},
              "injector_adain_layers": {"0": {"linear": _lin(
                  sd, "injector_adain_layers.0.linear", jnp.float32)}}}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4 * 24, 5120)).astype(np.float32)
    emb_global = rng.standard_normal((1, 3, 1, 5120)).astype(np.float32)
    emb = rng.standard_normal((1, 3, 5, 5120)).astype(np.float32)
    want = np.asarray(JS.audio_inject(params, 0, jnp.asarray(x), jnp.asarray(emb_global),
                                      jnp.asarray(emb), 72, jcfg))
    with torch.no_grad():
        got = TS.audio_inject(inj, 0, torch.from_numpy(x), torch.from_numpy(emb_global),
                              torch.from_numpy(emb), 72, cfg).numpy()
    assert got.shape == want.shape == (1, 96, 5120)
    np.testing.assert_array_equal(got[:, 72:], x[:, 72:])
    assert _rel(got, want) < 2e-5


def test_frame_pack_motion_through_forward_matches_jax():
    """drop_motion_frames=False: the motioner's 1x/2x/4x tokens (16-channel
    motion latents of 5 frames, 16x16, zero-padded to 19) join the
    sequence with conjugated RoPE rows; the default drops them."""
    m, sd = _model()
    params = _jax_params(sd)
    args = _inputs(8, hw=16, seed=1)
    mot = np.random.default_rng(2).standard_normal((16, 5, 16, 16)).astype(np.float32)
    want = _jax_forward(params, *args, motion_latents=mot, drop_motion_frames=False)
    got = _port_forward(m, *args, motion_latents=mot, drop_motion_frames=False)
    assert got.shape == want.shape == (1, 4, 3, 16, 16)
    assert _rel(got, want) < 2e-5
    tokens, cos, sin = TS.frame_pack_motion(m.frame_packer, mot, TINY)
    assert tokens.shape == (1, 64 + 16 + 16, 96) and cos.shape == (96, 24)
    assert _rel(_port_forward(m, *args), got) > 1e-3
    np.testing.assert_array_equal(_port_forward(m, *args, motion_latents=mot),
                                  _port_forward(m, *args))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_matches_jax(dtype):
    """12 frames (3 latent frames after the reference), a pose condition:
    frame 0 passes through, the rest is the model's velocity."""
    m, sd = _model()
    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = _jax_params(sd, jd)
    tm = m if dtype == "fp32" else TC.build_module(TS.WanS2V, TINY, TS.convert_wan_s2v(
        sd, TINY), "cpu", td)
    lat, t, ctx, audio = _inputs(12, seed=3)
    pose = np.random.default_rng(4).standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    cast = (lambda a: a) if dtype == "fp32" else (
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    lat, ctx, audio, pose = map(cast, (lat, ctx, audio, pose))
    fwd = jax.jit(lambda p, *a: JS.wan_s2v_forward(p, JS.WAN_S2V_TINY, *a[:4],
                                                    pose_cond=a[4]))
    want = np.asarray(jnp.asarray(fwd(params, *(jnp.asarray(a, jd) if a is not t
                                                else jnp.asarray(a) for a in
                                                (lat, t, ctx, audio, pose))), jnp.float32))
    with torch.no_grad():
        got = TS.wan_s2v_forward(tm, torch.from_numpy(lat).to(td), torch.from_numpy(t),
                                 torch.from_numpy(ctx).to(td), torch.from_numpy(audio).to(td),
                                 pose_cond=torch.from_numpy(pose).to(td))
    assert got.shape == want.shape == (1, 4, 4, 8, 8) and got.dtype == td
    np.testing.assert_array_equal(got[:, :, :1].float().numpy(), lat[:, :, :1])
    assert _rel(got.float().numpy(), want) < (5e-2 if dtype == "bf16" else 2e-5)


def _pipes(dtype="fp32"):
    """The JAX runner's S2V smoke pipeline with the tiny S2V model attached,
    and the port's pipeline holding the same weights."""
    if dtype not in _PIPES:
        jp = jax_smoke_pipe("Wan2.2-S2V-14B", dtype)
        tp = port_pipe(jp, dtype)
        _, sd = _model()
        jp.s2v_cfg = JS.WAN_S2V_TINY
        jp.s2v_params = _jax_params(sd, jp.dtype)
        tp.s2v_model = TC.build_module(TS.WanS2V, TINY, TS.convert_wan_s2v(sd, TINY), "cpu",
                                       tp.dtype)
        _PIPES.clear()
        _PIPES[dtype] = jp, tp
    return _PIPES[dtype]


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)) for _ in range(n)]


def _request(frames, pose=False, **kw):
    audio = _inputs(frames, seed=frames)[3]
    out = dict(REQUEST, ref_image=_frames(1, 2)[0], audio_input=audio, num_frames=frames,
               **kw)
    if pose:
        out["pose_video"] = _frames(frames, 3)
    return out


@pytest.mark.parametrize("frames,pose", [(8, False), (8, True), (12, False), (12, True)])
def test_s2v_pipeline_matches_jax(frames, pose):
    """`s2v` with the reference pinned at frame 0, the pose video through
    the VAE, two-pass CFG 4.5, 2 steps, fp32."""
    jp, tp = _pipes()
    kw = _request(frames, pose)
    want = np.asarray(jnp.asarray(jp.s2v(**kw), jnp.float32))
    got = tp.s2v(**kw)
    assert got.shape == want.shape == (1, 4, (frames - 1) // 4 + 1, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    stages = [name for name, _ in tp.stage_times]
    assert stages[:1] == ["vae_encode_reference"] and ("vae_encode_pose" in stages) == pose


def test_s2v_pipeline_bf16_matches_jax():
    jp, tp = _pipes("bf16")
    kw = _request(12, pose=True)
    want = np.asarray(jnp.asarray(jp.s2v(**kw), jnp.float32))
    got = tp.s2v(**kw)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < 5e-2


def test_s2v_decodes_frames_and_needs_a_model():
    _, tp = _pipes()
    video = tp.s2v(**dict(_request(8), return_latents=False))
    assert video.shape == (5, 32, 32, 3) and video.dtype == np.uint8
    with pytest.raises(RuntimeError, match="no S2V model attached"):
        TPipe(device="cpu").s2v(**_request(8))


# ------------------------------------------ faults of the JAX reference, mirrored

def test_audio_frame_mismatch_is_mirrored():
    """Nothing checks the audio frames against the latent frames. At 9
    frames the encoder gives 2 audio frames for 3 latent frames, and each
    injection regroups the 12 tokens as 2 frames of 6: both packages run,
    agree, and differ from the audio-per-frame grouping. At 13 frames (3
    audio frames, 4 latent frames of 4 tokens) the regrouping fails in
    both."""
    m, _ = _model()
    audio = torch.from_numpy(_inputs(9)[3])
    with torch.no_grad():
        _, local = TS.cal_audio_emb(m.casual_audio_encoder, audio, 2, True)
    assert local.shape[1] == 2 and (9 - 1) // 4 + 1 == 3
    jp, tp = _pipes()
    kw = _request(9)
    want = np.asarray(jnp.asarray(jp.s2v(**kw), jnp.float32))
    got = tp.s2v(**kw)
    assert got.shape == want.shape == (1, 4, 3, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    kw = _request(13)
    with pytest.raises(Exception):
        jp.s2v(**kw)
    with pytest.raises(RuntimeError, match="invalid for input of size"):
        tp.s2v(**kw)


def test_motion_latents_have_no_effect_is_mirrored():
    """`s2v(motion_latents=...)` reaches a forward that drops them by
    default, and `s2v` never passes the flag: the same latents."""
    jp, tp = _pipes()
    mot = np.random.default_rng(5).standard_normal((16, 5, 8, 8)).astype(np.float32)
    kw = _request(8)
    want = np.asarray(jp.s2v(**kw))
    np.testing.assert_array_equal(np.asarray(jp.s2v(motion_latents=mot, **kw)), want)
    np.testing.assert_array_equal(tp.s2v(motion_latents=mot, **kw).numpy(),
                                  tp.s2v(**kw).numpy())


def test_attach_s2v_builds_the_default_config_is_mirrored(monkeypatch):
    """`_attach("s2v")` builds `WanS2VConfig()` (the 14B) whatever the file:
    the tiny model's state dict fails to convert in both packages (its
    third block is missing); with the default config pointed at the tiny
    one, both load it, equal to `from_jax_params` of the JAX tree."""
    _, sd = _model()
    jpipe, tpipe = JPipe(dtype=jnp.float32), TPipe(device="cpu", dtype=torch.float32)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    for pipe, d in ((jpipe, sd_np), (tpipe, sd)):
        with pytest.raises(KeyError, match=r"\.2\."):
            pipe._attach("s2v", d)
    monkeypatch.setattr(JS, "WanS2VConfig", lambda: JS.WAN_S2V_TINY)
    monkeypatch.setattr(TS, "WanS2VConfig", lambda: TINY)
    jpipe._attach("s2v", sd_np)
    tpipe._attach("s2v", sd)
    want = from_jax_params("s2v", _tree(jpipe.s2v_params), TINY, device="cpu").state_dict()
    got = tpipe.s2v_model.state_dict()
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_wav2vec_file_in_from_pretrained_raises_is_mirrored():
    """Detection calls a wav2vec2 file `wav2vec`; neither pipeline's
    `_attach` knows the kind (the tower loads through `load_model` or the
    audio front end)."""
    sd = {"wav2vec2.feature_extractor.conv_layers.0.conv.weight": torch.zeros(8, 1, 10)}
    assert TC.detect_model_kind(sd) == "wav2vec"
    for pipe, d in ((JPipe(dtype=jnp.float32), {k: v.numpy() for k, v in sd.items()}),
                    (TPipe(device="cpu"), sd)):
        with pytest.raises(ValueError, match="unknown model kind wav2vec"):
            pipe._attach("wav2vec", d)


def test_vace_fun_a14b_high_noise_vace_is_mirrored():
    """No `_attach` kind fills the second expert's VACE: a high-noise
    DiT+VACE file attached as `dit2` keeps its DiT and drops its VACE in
    both packages, so the `dit2` steps run the other expert's VACE. The
    VACE-Fun A14B smoke (one VACE, two experts, a request crossing
    `switch_DiT_boundary`) matches JAX."""
    jp = jax_smoke_pipe("Wan2.2-VACE-Fun-A14B")
    tp = port_pipe(jp)
    vcfg = TV.VaceConfig(**{k: getattr(jp.vace_cfg, k) for k in TV.VaceConfig.__dataclass_fields__})
    tp.vace = from_jax_params("vace", _tree(jp.vace_params), vcfg, device="cpu")
    assert jp.vace2_params is None and tp.vace2 is None and tp.dit2 is not None
    kw = dict(REQUEST, cfg_scale=5.0, num_inference_steps=4, num_frames=5,
              vace_video=_frames(5, 6), vace_reference_image=_frames(1, 7)[0])
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    got = tp(**kw)
    assert got.shape == want.shape == (1, 4, 2, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    # a high-noise file of one block (detection keeps text_dim 4096 and
    # freq_dim 256, so the file has them)
    from video_styler_tpu_torch.models import wan_dit as TD
    from video_styler_tpu_torch.utils.convert import export_vace, export_wan_dit
    dcfg = TD.WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
                           num_layers=1)
    with torch.device("meta"):
        dit, vace = TD.WanDiT(dcfg), TV.WanVace(dataclasses.replace(
            vcfg, vace_layers=(0,), dim=256, num_heads=2, ffn_dim=512))
    gen = torch.Generator().manual_seed(8)
    sd = {**export_wan_dit(TD.init_weights_(dit.to_empty(device="cpu"), gen)),
          **export_vace(TD.init_weights_(vace.to_empty(device="cpu"), gen))}
    assert TC.detect_model_kind(sd) == "dit+vace"
    jpipe, tpipe = JPipe(dtype=jnp.float32), TPipe(device="cpu", dtype=torch.float32)
    jpipe._attach("dit2", {k: v.numpy() for k, v in sd.items()})
    tpipe._attach("dit2", sd)
    assert jpipe.dit2_params is not None and tpipe.dit2 is not None
    assert jpipe.vace2_params is None and jpipe.vace_params is None
    assert tpipe.vace2 is None and tpipe.vace is None


# ------------------------------------------------------------------ CLI

CLI_RECIPES = ["Wan2.2-S2V-14B", "Wan2.1-VACE-1.3B", "Wan2.1-VACE-1.3B-Preview",
               "Wan2.1-VACE-14B", "Wan2.2-VACE-Fun-A14B"]


@pytest.mark.parametrize("recipe", CLI_RECIPES)
def test_cli_smoke_on_cpu(recipe, capsys):
    out = wan_video_gen.main(["--recipe", recipe, "--smoke", "--device", "cpu"])
    assert out.shape == (1, 4, 2, 4, 4)
    assert bool(torch.isfinite(out.float()).all())
    assert "finite=True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wan_video_gen.main(["--recipe", recipe, "--smoke"])


def test_cli_passes_the_s2v_and_vace_inputs(tmp_path, monkeypatch):
    """On files: the S2V recipe reads --dit_path as kind `s2v`, the audio
    through `load_audio` and the tower of --wav2vec_path, and calls `s2v`
    with its own defaults (80 frames of 448x832, 40 steps, CFG 4.5); a VACE
    recipe leaves its --dit_path files to detection, passes the VACE video
    and reference image, and merges --lora_path into the VACE branch."""
    from types import SimpleNamespace
    from video_styler_tpu_torch.models import audio_features as TAF
    ref = str(tmp_path / "ref.png")
    Image.fromarray(np.full((40, 48, 3), 90, np.uint8)).save(ref)
    seen = {}

    class Pipe:
        dit2 = None

        def s2v(self, prompt, ref_image, audio_input, **kw):
            seen.update(kw, ref_image=ref_image, audio_input=audio_input)
            return torch.zeros((1, 4, 2, 4, 4))

        def __call__(self, prompt, **kw):
            seen.update(kw)
            return torch.zeros((1, 4, 2, 4, 4))

        def load_lora(self, target, path, alpha):
            seen["lora"] = (target, path, alpha)
    build_pipeline = wan_video_gen.build_pipeline
    monkeypatch.setattr(wan_video_gen, "build_pipeline", lambda args: Pipe())
    monkeypatch.setattr(TAF, "load_audio", lambda path: np.zeros(16000, np.float32))
    monkeypatch.setattr(TAF, "extract_audio_features",
                        lambda wav, num_frames, model, model_path, device: (
                            num_frames, model_path, wav.shape))
    common = ["--dit_path", "unused", "--return_latents", "--device", "cpu"]
    with pytest.raises(SystemExit):   # no tower
        wan_video_gen.main(["--recipe", "Wan2.2-S2V-14B", "--input_image", ref,
                            "--s2v_audio", "a.wav"] + common)
    wan_video_gen.main(["--recipe", "Wan2.2-S2V-14B", "--input_image", ref,
                        "--s2v_audio", "a.wav", "--wav2vec_path", "w2v"] + common)
    assert seen["audio_input"] == (80, "w2v", (16000,))
    assert (seen["num_frames"], seen["height"], seen["width"], seen["num_inference_steps"],
            seen["cfg_scale"]) == (80, 448, 832, 40, 4.5)
    np.testing.assert_array_equal(seen["ref_image"], np.asarray(Image.open(ref)))
    seen.clear()
    with pytest.raises(SystemExit):   # no VACE video
        wan_video_gen.main(["--recipe", "Wan2.1-VACE-14B", "--vace_reference_image", ref]
                           + common)
    read_inputs = wan_video_gen.read_inputs
    video = np.zeros((81, 480, 832, 3), np.uint8)
    monkeypatch.setattr(wan_video_gen, "read_inputs", lambda args, h, w, n: dict(
        read_inputs(args, h, w, n), vace_video=video))
    wan_video_gen.main(["--recipe", "Wan2.1-VACE-14B", "--vace_reference_image", ref,
                        "--lora_path", "ditto.safetensors", "--lora_alpha", "0.5"] + common)
    assert seen["vace_video"] is video and seen["lora"] == ("vace", "ditto.safetensors", 0.5)
    np.testing.assert_array_equal(seen["vace_reference_image"], np.asarray(Image.open(ref)))
    assert (seen["num_frames"], seen["cfg_scale"], seen["num_inference_steps"]) == (81, 5.0, 50)

    configs = []

    def from_pretrained(cls, model_configs, **kw):
        configs.extend(model_configs)
        return SimpleNamespace(dit2=None)
    monkeypatch.setattr(TPipe, "from_pretrained", classmethod(from_pretrained))
    for recipe in ("Wan2.2-S2V-14B", "Wan2.1-VACE-14B"):
        _, args = wan_video_gen.parse_args(["--recipe", recipe, "--dit_path", "a|b"])
        build_pipeline(args)
    assert [(c.path, c.model_kind) for c in configs] == [(["a", "b"], "s2v"),
                                                         (["a", "b"], None)]
