"""Wan video generation by recipe with the PyTorch/CUDA port: text-to-video,
image-to-video (Wan2.1 I2V, FLF2V with an end image, the Wan2.2 A14B
dual-expert I2V), Wan2.2 TI2V-5B, the Wan Fun models (InP, Control, V1.1
Control with a reference image, V1.1 Control-Camera; Wan2.1 and the Wan2.2
A14B experts), speed control, Wan2.2-Animate, VACE (Wan2.1 1.3B, 1.3B
Preview and 14B, the Wan2.2 VACE-Fun A14B experts) and Wan2.2-S2V-14B
speech-to-video.

    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.1-I2V-14B-480P \
        --dit_path "shard1.safetensors|shard2.safetensors" --vae_path Wan2.1_VAE.pth \
        --t5_path models_t5_umt5-xxl-enc-bf16.pth \
        --clip_path models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \
        --input_image first.png --prompt "a cat boxing on a stage"
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.2-TI2V-5B --smoke --device cpu
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.1-Fun-V1.1-14B-Control \
        --dit_path ... --vae_path ... --t5_path ... --clip_path ... \
        --control_video depth.mp4 --reference_image ref.png --prompt "..."
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.2-S2V-14B \
        --dit_path ... --vae_path ... --t5_path ... --wav2vec_path wav2vec2-large-xlsr-53 \
        --input_image face.png --s2v_audio speech.wav --prompt "..."

The counterpart of the JAX package's per-recipe runner
(`examples/wanvideo/_runner.py`), for the recipes the port runs (its own
copy of their rows in `RECIPES`). Checkpoints come from local files only
(--dit_path, --vae_path, --t5_path, --clip_path, --tokenizer_path; a
Wan2.2 A14B high-noise expert from --high_noise_dit_path, read as model
kind `dit2` as `enhance_video` reads it, then made the expert of the steps
above `switch_DiT_boundary`, the pipeline's `dit`). --input_image and
--end_image are passed to the pipeline (the JAX runner drops them outside
smoke mode: ROADMAP Queue 3), as are the flags named after the pipeline's
other inputs: --control_video, --reference_image,
--camera_control_direction, --camera_control_speed, --motion_bucket_id,
--animate_pose_video, --animate_face_video, --vace_video and
--vace_reference_image (videos as files, read to the request's size and
frame count; face crops at their own size). The speed controller comes
from --motion_controller_path (read as kind `motion_controller`:
detection cannot tell its keys); an Animate recipe reads its adapter from
the --dit_path files, where the release keeps it; a VACE recipe's
--dit_path files hold the DiT and its VACE branch (detected), and its
--lora_path merges into the VACE branch. A Wan2.2 VACE-Fun high-noise file
loses its VACE as the JAX pipeline's loader drops it: both experts run the
low-noise file's VACE (ROADMAP Queue 3). Wan2.2-S2V-14B reads --dit_path
as the S2V model, --s2v_audio through `load_audio` and the wav2vec2 tower
of --wav2vec_path, and runs `s2v` with its own defaults (80 frames of
448x832, 40 steps, CFG 4.5). --smoke runs tiny random models shaped like
the recipe's family (head dim 128, so the CUDA kernels run too; TI2V on a
tiny z=48-family VAE; S2V with a tiny wav2vec2 tower on a 16 kHz waveform
from the seed) on 5 frames of 32x32 (TI2V 64x64; S2V 8 frames, so its 2
audio frames meet its 2 latent frames) with synthetic inputs, 2 steps
without CFG, and prints whether its latents are finite. Runs on the card
unless --device cpu.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class WanRecipe:
    name: str                            # the release it runs
    arch: str                            # t2v | i2v | ti2v | vace | animate | s2v
    extra_inputs: Tuple[str, ...] = ()
    num_frames: int = 81
    height: int = 480
    width: int = 832
    dual_expert: bool = False            # Wan2.2 A14B: high/low-noise experts
    lora_base: str = "dit"               # the model --lora_path merges into
    num_inference_steps: int = 50
    cfg_scale: float = 5.0


CAMERA = ("input_image", "camera_control_direction", "camera_control_speed")
VACE = ("vace_video", "vace_reference_image")
RECIPES = {r.name: r for r in [
    WanRecipe("Wan2.1-T2V-1.3B", "t2v"),
    WanRecipe("Wan2.1-T2V-14B", "t2v"),
    WanRecipe("Wan2.1-I2V-14B-480P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-I2V-14B-720P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-FLF2V-14B-720P", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.2-T2V-A14B", "t2v", num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-I2V-A14B", "i2v", ("input_image",), num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-TI2V-5B", "ti2v", ("input_image",), num_frames=49),
    WanRecipe("Wan2.1-VACE-1.3B", "vace", VACE, lora_base="vace"),
    WanRecipe("Wan2.1-VACE-1.3B-Preview", "vace", VACE, lora_base="vace"),
    WanRecipe("Wan2.1-VACE-14B", "vace", VACE, lora_base="vace"),
    WanRecipe("Wan2.1-1.3b-speedcontrol-v1", "t2v", ("motion_bucket_id",)),
    WanRecipe("Wan2.1-Fun-1.3B-InP", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.1-Fun-14B-InP", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.1-Fun-1.3B-Control", "i2v", ("control_video",)),
    WanRecipe("Wan2.1-Fun-14B-Control", "i2v", ("control_video",)),
    WanRecipe("Wan2.1-Fun-V1.1-1.3B-InP", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.1-Fun-V1.1-14B-InP", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.1-Fun-V1.1-1.3B-Control", "i2v", ("control_video", "reference_image")),
    WanRecipe("Wan2.1-Fun-V1.1-14B-Control", "i2v", ("control_video", "reference_image")),
    WanRecipe("Wan2.1-Fun-V1.1-1.3B-Control-Camera", "i2v", CAMERA),
    WanRecipe("Wan2.1-Fun-V1.1-14B-Control-Camera", "i2v", CAMERA),
    WanRecipe("Wan2.2-Fun-A14B-InP", "i2v", ("input_image", "end_image"), num_frames=49,
              dual_expert=True),
    WanRecipe("Wan2.2-Fun-A14B-Control", "i2v", ("control_video",), num_frames=49,
              dual_expert=True),
    WanRecipe("Wan2.2-Fun-A14B-Control-Camera", "i2v", CAMERA, num_frames=49,
              dual_expert=True),
    WanRecipe("Wan2.2-VACE-Fun-A14B", "vace", VACE, num_frames=49, dual_expert=True,
              lora_base="vace"),
    WanRecipe("Wan2.2-Animate-14B", "animate",
              ("input_image", "animate_pose_video", "animate_face_video")),
    # the pipeline's `s2v` defaults, not the JAX runner row's 81 frames (at
    # 81 the audio frames miss the latent frames and the forward fails)
    WanRecipe("Wan2.2-S2V-14B", "s2v", ("input_image", "s2v_audio"), num_frames=80,
              height=448, num_inference_steps=40, cfg_scale=4.5),
]}

SMOKE_STEPS = 2


def smoke_size(recipe: WanRecipe) -> Tuple[int, int, int]:
    """(height, width, frames) of a smoke run: 32x32 (the TI2V smoke VAE
    compresses 16x, so 64x64 there) and 5 frames (S2V 8: a multiple of 4,
    where its audio frames equal its latent frames)."""
    if recipe.arch == "ti2v":
        return 64, 64, 5
    return (32, 32, 8) if recipe.arch == "s2v" else (32, 32, 5)


def smoke_s2v_configs():
    """(S2V, wav2vec) configs of the S2V smoke: the smoke DiT's trunk
    (dim 256, 2 heads of 128, 2 blocks; z=4 latents and pose), 2 audio
    tokens a frame, an injection after each block, audio features of the
    tiny wav2vec2 tower (3 states of 32)."""
    from .infer_ditto import smoke_configs as ditto_smoke
    from .models.wan_s2v import WanS2VConfig
    from .models.wav2vec import WAV2VEC2_TINY
    dit, _, _, vae = ditto_smoke()
    s2v = WanS2VConfig(dim=dit.dim, in_dim=vae.z_dim, ffn_dim=dit.ffn_dim,
                       out_dim=vae.z_dim, text_dim=dit.text_dim, freq_dim=dit.freq_dim,
                       num_heads=dit.num_heads, num_layers=dit.num_layers,
                       cond_dim=vae.z_dim, audio_dim=WAV2VEC2_TINY.hidden_size,
                       num_audio_token=2, num_audio_layers=WAV2VEC2_TINY.num_layers + 1,
                       audio_inject_layers=(0, 1))
    return s2v, WAV2VEC2_TINY


def smoke_configs(recipe: WanRecipe):
    """(dit, vace, t5, vae, clip) configs of the recipe's smoke pipeline: the
    smoke DiT of `infer_ditto` (dim 256, 2 heads of 128, 2 blocks; a VACE
    recipe with its 2-block VACE, as the JAX runner's smoke) with the
    channel math of the JAX runner: I2V (and Animate) takes y (2z + 4 input
    channels), FLF2V also the CLIP position table; Fun Control takes the
    control latents in front of y (3z + 4, image input, no CLIP tower: zero
    CLIP rows), V1.1 Control also a reference conv; Fun Camera takes the
    image's latent as y (2z, no image input) and a camera adapter; TI2V
    fuses the image latent into z-channel latents of a tiny Wan2.2-family
    VAE (z 8). The CLIP tower gives 257 rows (112x112 in 7-pixel patches,
    1280 wide, 2 blocks)."""
    import dataclasses
    from .infer_ditto import smoke_configs as ditto_smoke
    from .models.clip_vit import ClipVitConfig
    from .models.wan_vae import WanVAE38Config
    dit, vace, t5, vae = ditto_smoke()
    vace = vace if recipe.arch == "vace" else None
    clip = None
    z = vae.z_dim
    if "camera_control_direction" in recipe.extra_inputs:
        dit = dataclasses.replace(dit, in_dim=2 * z, has_control_adapter=True)
    elif "control_video" in recipe.extra_inputs:
        dit = dataclasses.replace(dit, in_dim=3 * z + 4, has_image_input=True,
                                  has_ref_conv="reference_image" in recipe.extra_inputs)
    elif recipe.arch in ("i2v", "animate"):
        dit = dataclasses.replace(dit, in_dim=2 * z + 4, has_image_input=True,
                                  has_image_pos_emb="end_image" in recipe.extra_inputs)
        clip = ClipVitConfig(image_size=112, patch_size=7, dim=1280, num_heads=4,
                             num_layers=2)
    elif recipe.arch == "ti2v":
        vae = WanVAE38Config(dim=16, dec_dim=16, z_dim=8, num_res_blocks=1,
                             latent_mean=(0.0,) * 8, latent_std=(1.0,) * 8)
        dit = dataclasses.replace(dit, in_dim=vae.z_dim, out_dim=vae.z_dim,
                                  seperated_timestep=True, require_vae_embedding=False,
                                  fuse_vae_embedding_in_latents=True)
    return dit, vace, t5, vae, clip


# the smoke Animate adapter: one face block (after layer 0 of 2), face
# crops of 64x64, the face encoder's convs 32 wide, pose latents of z 4
SMOKE_ANIMATE = dict(num_face_blocks=1, face_size=64, face_conv_dim=32, pose_in_dim=4)


def build_smoke_pipeline(recipe: WanRecipe, device=None, seed: int = 0):
    """Random smoke models of `smoke_configs` from `seed` (a second expert
    from seed + 1 for a dual-expert recipe, which shares the one VACE as
    in the JAX runner's smoke; a speed controller, with a random last layer
    in place of the reference's zeros so the id acts, from seed + 2; an
    Animate adapter from seed + 3; S2V: the S2V model of
    `smoke_s2v_configs` from seed + 4 and no DiT), bf16, on `device`."""
    import torch
    from .infer_ditto import SMOKE_TEXT_LEN
    from .models import wan_animate as A
    from .models import wan_s2v as S
    from .models.wan_controllers import MotionController, init_motion_controller_
    from .models.wan_dit import WanDiT, init_weights_
    from .pipelines.wan_video import WanVideoPipeline
    from .prompters.wan_prompter import StubTokenizer
    dit, vace, t5, vae, clip = smoke_configs(recipe)
    s2v = recipe.arch == "s2v"
    pipe = WanVideoPipeline.from_configs(
        None if s2v else dit, vace, t5, vae, StubTokenizer(SMOKE_TEXT_LEN),
        text_len=SMOKE_TEXT_LEN, seed=seed, device=device, dtype=torch.bfloat16,
        clip_cfg=clip)
    if s2v:
        with torch.device("meta"):
            model = S.WanS2V(smoke_s2v_configs()[0], dtype=pipe.dtype)
        gen = torch.Generator(pipe.device).manual_seed(seed + 4)
        pipe.s2v_model = S.init_wan_s2v_(model.to_empty(device=pipe.device), gen).eval()
        return pipe
    with torch.device("meta"):
        dit2 = WanDiT(dit, dtype=pipe.dtype) if recipe.dual_expert else None
        mc = (MotionController(dit.dim, dit.freq_dim, dtype=pipe.dtype)
              if "motion_bucket_id" in recipe.extra_inputs else None)
        adapter = (A.WanAnimateAdapter(A.AnimateConfig(dim=dit.dim, **SMOKE_ANIMATE),
                                       dit.head_dim, dtype=pipe.dtype)
                   if recipe.arch == "animate" else None)
    if dit2 is not None:
        gen = torch.Generator(pipe.device).manual_seed(seed + 1)
        pipe.dit2 = init_weights_(dit2.to_empty(device=pipe.device), gen).eval()
    if mc is not None:
        gen = torch.Generator(pipe.device).manual_seed(seed + 2)
        pipe.motion_controller = init_motion_controller_(mc.to_empty(device=pipe.device),
                                                         gen).eval()
        with torch.no_grad():
            w = pipe.motion_controller.fc3.weight
            w.normal_(0.0, 1.0 / w.shape[1] ** 0.5, generator=gen)
    if adapter is not None:
        gen = torch.Generator(pipe.device).manual_seed(seed + 3)
        pipe.animate = A.init_wan_animate_(adapter.to_empty(device=pipe.device), gen).eval()
    return pipe


def animate_clip(frames):
    """An Animate request's pose or face video cut from a clip of 4k + 1
    frames: its last 4k - 3, which the VAE encodes to one latent frame per
    latent frame of the clip after the first (the pose tokens' frames) and
    the face encoder's two stride-2 convs take to one motion frame each."""
    return frames[4:]


SMOKE_SAMPLE_RATE = 16000


def smoke_waveform(num_frames: int, fps: int = 16, seed: int = 9) -> np.ndarray:
    """A synthetic 16 kHz float32 waveform from a numpy seed, one second
    longer than `num_frames` at `fps`: two tones under noise."""
    n = int((num_frames / fps + 1.0) * SMOKE_SAMPLE_RATE)
    t = np.arange(n, dtype=np.float32) / SMOKE_SAMPLE_RATE
    noise = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 587 * t * (1 + t))
            + 0.1 * noise).astype(np.float32)


def smoke_inputs(recipe: WanRecipe, height: int, width: int, num_frames: int):
    """The smoke call's inputs as the JAX runner draws them: uint8 (H, W, 3)
    images from numpy seeds 2 (input image), 3 (end image), 5 (reference
    image), 1 (VACE reference image), frames from seeds 0 (VACE video) and
    4 (control video), the camera moving left at the reference's speed,
    motion id 50; Animate's pose and face videos cut from clips of seeds 7
    and 8 (faces at the smoke adapter's 64x64); S2V's waveform
    (`smoke_waveform`) as `s2v_audio`."""
    kw = {}
    ei = recipe.extra_inputs

    def frames(seed, n, h=height, w=width):
        return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3), np.uint8)
    for name, seed in (("input_image", 2), ("end_image", 3), ("reference_image", 5),
                       ("vace_reference_image", 1)):
        if name in ei:
            kw[name] = frames(seed, 1)[0]
    if "vace_video" in ei:
        kw["vace_video"] = frames(0, num_frames)
    if "s2v_audio" in ei:
        kw["s2v_audio"] = smoke_waveform(num_frames)
    if "control_video" in ei:
        kw["control_video"] = frames(4, num_frames)
    if "camera_control_direction" in ei:
        kw["camera_control_direction"] = "Left"
    if "motion_bucket_id" in ei:
        kw["motion_bucket_id"] = 50.0
    if "animate_pose_video" in ei:
        size = SMOKE_ANIMATE["face_size"]
        kw["animate_pose_video"] = animate_clip(frames(7, num_frames))
        kw["animate_face_video"] = animate_clip(frames(8, num_frames, size, size))
    return kw



def build_pipeline(args):
    """The pipeline from local checkpoint files on --device."""
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    arch = RECIPES[args.recipe].arch
    # a VACE release's files hold the DiT and its VACE branch (detected)
    main_kind = {"s2v": "s2v", "vace": None}.get(arch, "dit")
    configs = [ModelConfig(path=args.dit_path.split("|"), model_kind=main_kind)]
    if arch == "animate":
        configs.append(ModelConfig(path=args.dit_path.split("|"), model_kind="animate"))
    if args.motion_controller_path:
        configs.append(ModelConfig(path=args.motion_controller_path,
                                   model_kind="motion_controller"))
    if args.high_noise_dit_path:
        configs.append(ModelConfig(path=args.high_noise_dit_path.split("|"),
                                   model_kind="dit2"))
    for path, kind in ((args.vae_path, "vae"), (args.t5_path, "t5"),
                       (args.clip_path, "clip")):
        if path:
            configs.append(ModelConfig(path=path, model_kind=kind))
    pipe = WanVideoPipeline.from_pretrained(configs, tokenizer_path=args.tokenizer_path,
                                            device=args.device)
    if pipe.dit2 is not None:
        # the high-noise expert takes the steps above switch_DiT_boundary
        pipe.dit, pipe.dit2 = pipe.dit2, pipe.dit
    return pipe


def read_inputs(args, height: int, width: int, num_frames: int):
    """The request's inputs from the flags: images read at their own size
    (the pipeline resizes them), control and pose videos cropped and resized
    to the request (the control video's first `num_frames` frames, the pose
    and face videos' first `num_frames - 4`: one latent or motion frame per
    latent frame after the first), face crops at their own size."""
    from .data.video import VideoData, read_image

    def video(path, n, h=None, w=None):
        data = VideoData(path, h, w)
        try:
            return np.stack([data[i] for i in range(min(n, len(data)))])
        finally:
            data.close()
    kw = {name: read_image(getattr(args, name)) for name in
          ("input_image", "end_image", "reference_image", "vace_reference_image")
          if getattr(args, name)}
    if args.control_video:
        kw["control_video"] = video(args.control_video, num_frames, height, width)
    if args.vace_video:
        kw["vace_video"] = video(args.vace_video, num_frames, height, width)
    if args.s2v_audio:
        from .models.audio_features import load_audio
        kw["s2v_audio"] = load_audio(args.s2v_audio)
    if args.animate_pose_video:
        kw["animate_pose_video"] = video(args.animate_pose_video, num_frames - 4, height,
                                         width)
    if args.animate_face_video:
        kw["animate_face_video"] = list(video(args.animate_face_video, num_frames - 4))
    if args.camera_control_direction:
        kw.update(camera_control_direction=args.camera_control_direction,
                  camera_control_speed=args.camera_control_speed)
    if args.motion_bucket_id is not None:
        kw["motion_bucket_id"] = args.motion_bucket_id
    return kw


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Wan video generation by recipe (PyTorch/CUDA)")
    p.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    p.add_argument("--smoke", action="store_true",
                   help="tiny random models, no checkpoints")
    p.add_argument("--prompt", default="a cat boxing on a stage")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--cfg_scale", type=float, default=None,
                   help="default: the recipe's (5.0; S2V 4.5)")
    p.add_argument("--input_image", default=None, help="first frame (image file)")
    p.add_argument("--end_image", default=None, help="last frame (FLF2V)")
    p.add_argument("--control_video", default=None, help="Fun Control: control video file")
    p.add_argument("--reference_image", default=None,
                   help="Fun V1.1 Control: reference image file")
    p.add_argument("--camera_control_direction", default=None,
                   help="Fun Camera: Left, Right, Up, Down, In, Out (combined, e.g. 'Left Up')")
    p.add_argument("--camera_control_speed", type=float, default=1 / 54)
    p.add_argument("--motion_bucket_id", type=float, default=None,
                   help="speed control: the motion bucket id")
    p.add_argument("--animate_pose_video", default=None,
                   help="Animate: pose video file (num_frames - 4 frames are read)")
    p.add_argument("--animate_face_video", default=None, help="Animate: face crop video file")
    p.add_argument("--motion_controller_path", default=None,
                   help="the speed controller's model.safetensors (kind motion_controller)")
    p.add_argument("--vace_video", default=None, help="VACE: the video file to edit")
    p.add_argument("--vace_reference_image", default=None,
                   help="VACE: reference image file")
    p.add_argument("--s2v_audio", default=None,
                   help="S2V: speech audio file (soundfile or ffmpeg decodes it)")
    p.add_argument("--wav2vec_path", default=None,
                   help="S2V: wav2vec2-large-xlsr-53 checkpoint file or directory")
    p.add_argument("--output", default=None)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--lora_path", default=None,
                   help="LoRA to merge into the DiT (a VACE recipe: its VACE branch)")
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--dit_path", default=None,
                   help="DiT safetensors, '|'-separated shards (Wan2.2 A14B: the "
                        "low-noise expert)")
    p.add_argument("--high_noise_dit_path", default=None,
                   help="Wan2.2 A14B high-noise expert, read as model kind dit2")
    p.add_argument("--vae_path", default=None)
    p.add_argument("--t5_path", default=None)
    p.add_argument("--clip_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--return_latents", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def s2v_audio_input(args, waveform, num_frames: int, smoke: bool):
    """The S2V request's (1, layers, dim, num_frames) wav2vec features: the
    tiny tower from the seed on --smoke, else the --wav2vec_path tower, on
    --device."""
    from .models.audio_features import extract_audio_features
    model = None
    if smoke:
        import torch
        from .device import resolve_device
        from .models import wav2vec as W
        device = resolve_device(args.device)
        with torch.device("meta"):
            model = W.Wav2Vec2(smoke_s2v_configs()[1])
        model = W.init_wav2vec_(model.to_empty(device=device),
                                torch.Generator(device).manual_seed(5)).eval()
    return extract_audio_features(waveform, num_frames=num_frames, model=model,
                                  model_path=args.wav2vec_path, device=args.device)


def main(argv=None):
    p, args = parse_args(argv)
    recipe = RECIPES[args.recipe]
    if args.smoke:
        pipe = build_smoke_pipeline(recipe, device=args.device)
        h, w, n = smoke_size(recipe)
        steps, cfg_scale = SMOKE_STEPS, 1.0
        kw = smoke_inputs(recipe, h, w, n)
    else:
        if not args.dit_path:
            p.error("--dit_path is required (or use --smoke)")
        h = args.height or recipe.height
        w = args.width or recipe.width
        n = args.num_frames or recipe.num_frames
        kw = read_inputs(args, h, w, n)
        # the speed has a default; a camera recipe needs its direction;
        # a VACE reference image is optional
        missing = [name for name in recipe.extra_inputs
                   if name not in kw and name not in ("camera_control_speed",
                                                      "vace_reference_image")]
        if missing:
            p.error(f"recipe {recipe.name} needs --{' --'.join(missing)}")
        if "motion_bucket_id" in recipe.extra_inputs and not args.motion_controller_path:
            p.error(f"recipe {recipe.name} needs --motion_controller_path")
        if recipe.arch == "s2v" and not args.wav2vec_path:
            p.error(f"recipe {recipe.name} needs --wav2vec_path")
        pipe = build_pipeline(args)
        steps = args.num_inference_steps or recipe.num_inference_steps
        cfg_scale = recipe.cfg_scale if args.cfg_scale is None else args.cfg_scale
    if args.lora_path:
        pipe.load_lora(recipe.lora_base, args.lora_path, alpha=args.lora_alpha)
    latents_only = args.smoke or args.return_latents
    common = dict(negative_prompt=args.negative_prompt, height=h, width=w, num_frames=n,
                  seed=args.seed, num_inference_steps=steps, cfg_scale=cfg_scale,
                  tiled=not args.smoke, return_latents=latents_only)
    if recipe.arch == "s2v":
        audio = s2v_audio_input(args, kw.pop("s2v_audio"), n, args.smoke)
        out = pipe.s2v(args.prompt, kw.pop("input_image"), audio, **common)
    else:
        out = pipe(args.prompt, **common, **kw)
    if latents_only:
        import torch
        ok = bool(torch.isfinite(out.float()).all())
        print(f"[{recipe.name}] latents {tuple(out.shape)} finite={ok}")
        if not ok:
            raise SystemExit(1)
        return out
    from .data.video import save_video
    dest = args.output or f"video_{recipe.name}.mp4"
    save_video(out, dest, fps=args.fps)
    print(f"[{recipe.name}] saved {dest}")
    return out


if __name__ == "__main__":
    main()
