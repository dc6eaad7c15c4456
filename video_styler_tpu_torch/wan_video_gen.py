"""Wan video generation by recipe with the PyTorch/CUDA port: text-to-video,
image-to-video (Wan2.1 I2V, FLF2V with an end image, the Wan2.2 A14B
dual-expert I2V), Wan2.2 TI2V-5B, the Wan Fun models (InP, Control, V1.1
Control with a reference image, V1.1 Control-Camera; Wan2.1 and the Wan2.2
A14B experts), speed control and Wan2.2-Animate.

    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.1-I2V-14B-480P \
        --dit_path "shard1.safetensors|shard2.safetensors" --vae_path Wan2.1_VAE.pth \
        --t5_path models_t5_umt5-xxl-enc-bf16.pth \
        --clip_path models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \
        --input_image first.png --prompt "a cat boxing on a stage"
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.2-TI2V-5B --smoke --device cpu
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.1-Fun-V1.1-14B-Control \
        --dit_path ... --vae_path ... --t5_path ... --clip_path ... \
        --control_video depth.mp4 --reference_image ref.png --prompt "..."

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
--animate_pose_video and --animate_face_video (videos as files, read to
the request's size and frame count; face crops at their own size). The
speed controller comes from --motion_controller_path (read as kind
`motion_controller`: detection cannot tell its keys); an Animate recipe
reads its adapter from the --dit_path files, where the release keeps it.
--smoke runs tiny random models shaped like the recipe's family (head dim
128, so the CUDA kernels run too; TI2V on a tiny z=48-family VAE) on 5
frames of 32x32 (TI2V 64x64) with synthetic inputs, 2 steps without CFG,
and prints whether its latents are finite. Runs on the card unless
--device cpu.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class WanRecipe:
    name: str                            # the release it runs
    arch: str                            # t2v | i2v | ti2v | animate
    extra_inputs: Tuple[str, ...] = ()
    num_frames: int = 81
    height: int = 480
    width: int = 832
    dual_expert: bool = False            # Wan2.2 A14B: high/low-noise experts


CAMERA = ("input_image", "camera_control_direction", "camera_control_speed")
RECIPES = {r.name: r for r in [
    WanRecipe("Wan2.1-T2V-1.3B", "t2v"),
    WanRecipe("Wan2.1-T2V-14B", "t2v"),
    WanRecipe("Wan2.1-I2V-14B-480P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-I2V-14B-720P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-FLF2V-14B-720P", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.2-T2V-A14B", "t2v", num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-I2V-A14B", "i2v", ("input_image",), num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-TI2V-5B", "ti2v", ("input_image",), num_frames=49),
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
    WanRecipe("Wan2.2-Animate-14B", "animate",
              ("input_image", "animate_pose_video", "animate_face_video")),
]}

SMOKE_STEPS = 2


def smoke_size(recipe: WanRecipe) -> Tuple[int, int, int]:
    """(height, width, frames) of a smoke run: 32x32 (the TI2V smoke VAE
    compresses 16x, so 64x64 there) and 5 frames."""
    return (64, 64, 5) if recipe.arch == "ti2v" else (32, 32, 5)


def smoke_configs(recipe: WanRecipe):
    """(dit, t5, vae, clip) configs of the recipe's smoke pipeline: the
    smoke DiT of `infer_ditto` (dim 256, 2 heads of 128, 2 blocks) with the
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
    dit, _, t5, vae = ditto_smoke()
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
    return dit, t5, vae, clip


# the smoke Animate adapter: one face block (after layer 0 of 2), face
# crops of 64x64, the face encoder's convs 32 wide, pose latents of z 4
SMOKE_ANIMATE = dict(num_face_blocks=1, face_size=64, face_conv_dim=32, pose_in_dim=4)


def build_smoke_pipeline(recipe: WanRecipe, device=None, seed: int = 0):
    """Random smoke models of `smoke_configs` from `seed` (a second expert
    from seed + 1 for a dual-expert recipe; a speed controller, with a
    random last layer in place of the reference's zeros so the id acts,
    from seed + 2; an Animate adapter from seed + 3), bf16, on `device`."""
    import torch
    from .infer_ditto import SMOKE_TEXT_LEN
    from .models import wan_animate as A
    from .models.wan_controllers import MotionController, init_motion_controller_
    from .models.wan_dit import WanDiT, init_weights_
    from .pipelines.wan_video import WanVideoPipeline
    from .prompters.wan_prompter import StubTokenizer
    dit, t5, vae, clip = smoke_configs(recipe)
    pipe = WanVideoPipeline.from_configs(
        dit, None, t5, vae, StubTokenizer(SMOKE_TEXT_LEN), text_len=SMOKE_TEXT_LEN,
        seed=seed, device=device, dtype=torch.bfloat16, clip_cfg=clip)
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


def smoke_inputs(recipe: WanRecipe, height: int, width: int, num_frames: int):
    """The smoke call's inputs as the JAX runner draws them: uint8 (H, W, 3)
    images from numpy seeds 2 (input image), 3 (end image), 5 (reference
    image), frames from seed 4 (control video), the camera moving left at
    the reference's speed, motion id 50; Animate's pose and face videos cut
    from clips of seeds 7 and 8 (faces at the smoke adapter's 64x64)."""
    kw = {}
    ei = recipe.extra_inputs

    def frames(seed, n, h=height, w=width):
        return np.random.default_rng(seed).integers(0, 255, (n, h, w, 3), np.uint8)
    for name, seed in (("input_image", 2), ("end_image", 3), ("reference_image", 5)):
        if name in ei:
            kw[name] = frames(seed, 1)[0]
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
    configs = [ModelConfig(path=args.dit_path.split("|"), model_kind="dit")]
    if RECIPES[args.recipe].arch == "animate":
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
          ("input_image", "end_image", "reference_image") if getattr(args, name)}
    if args.control_video:
        kw["control_video"] = video(args.control_video, num_frames, height, width)
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
    p.add_argument("--cfg_scale", type=float, default=5.0)
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
    p.add_argument("--output", default=None)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--lora_path", default=None, help="LoRA to merge into the DiT")
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
        # the speed has a default; a camera recipe needs its direction
        missing = [name for name in recipe.extra_inputs
                   if name not in kw and name != "camera_control_speed"]
        if missing:
            p.error(f"recipe {recipe.name} needs --{' --'.join(missing)}")
        if "motion_bucket_id" in recipe.extra_inputs and not args.motion_controller_path:
            p.error(f"recipe {recipe.name} needs --motion_controller_path")
        pipe = build_pipeline(args)
        steps = args.num_inference_steps or 50
        cfg_scale = args.cfg_scale
    if args.lora_path:
        pipe.load_lora("dit", args.lora_path, alpha=args.lora_alpha)
    latents_only = args.smoke or args.return_latents
    out = pipe(args.prompt, negative_prompt=args.negative_prompt, height=h, width=w,
               num_frames=n, seed=args.seed, num_inference_steps=steps,
               cfg_scale=cfg_scale, tiled=not args.smoke, return_latents=latents_only,
               **kw)
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
