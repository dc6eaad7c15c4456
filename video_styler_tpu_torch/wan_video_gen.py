"""Wan video generation by recipe with the PyTorch/CUDA port: text-to-video,
image-to-video (Wan2.1 I2V, FLF2V with an end image, the Wan2.2 A14B
dual-expert I2V) and Wan2.2 TI2V-5B.

    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.1-I2V-14B-480P \
        --dit_path "shard1.safetensors|shard2.safetensors" --vae_path Wan2.1_VAE.pth \
        --t5_path models_t5_umt5-xxl-enc-bf16.pth \
        --clip_path models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth \
        --input_image first.png --prompt "a cat boxing on a stage"
    python -m video_styler_tpu_torch.wan_video_gen --recipe Wan2.2-TI2V-5B --smoke --device cpu

The counterpart of the JAX package's per-recipe runner
(`examples/wanvideo/_runner.py`), for the recipes the port runs (its own
copy of their rows in `RECIPES`). Checkpoints come from local files only
(--dit_path, --vae_path, --t5_path, --clip_path, --tokenizer_path; a
Wan2.2 A14B high-noise expert from --high_noise_dit_path, read as model
kind `dit2` as `enhance_video` reads it, then made the expert of the steps
above `switch_DiT_boundary`, the pipeline's `dit`). --input_image and
--end_image are passed to the pipeline (the JAX runner drops them outside
smoke mode: ROADMAP Queue 3). --smoke runs tiny random models shaped like
the recipe's family (head dim 128, so the CUDA kernels run too; TI2V on a
tiny z=48-family VAE) on 5 frames of 32x32 (TI2V 64x64) with synthetic
images, 2 steps without CFG, and prints whether its latents are finite.
Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class WanRecipe:
    name: str                            # the Wan-AI release it runs
    arch: str                            # t2v | i2v | ti2v
    extra_inputs: Tuple[str, ...] = ()
    num_frames: int = 81
    height: int = 480
    width: int = 832
    dual_expert: bool = False            # Wan2.2 A14B: high/low-noise experts


RECIPES = {r.name: r for r in [
    WanRecipe("Wan2.1-T2V-1.3B", "t2v"),
    WanRecipe("Wan2.1-T2V-14B", "t2v"),
    WanRecipe("Wan2.1-I2V-14B-480P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-I2V-14B-720P", "i2v", ("input_image",)),
    WanRecipe("Wan2.1-FLF2V-14B-720P", "i2v", ("input_image", "end_image")),
    WanRecipe("Wan2.2-T2V-A14B", "t2v", num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-I2V-A14B", "i2v", ("input_image",), num_frames=49, dual_expert=True),
    WanRecipe("Wan2.2-TI2V-5B", "ti2v", ("input_image",), num_frames=49),
]}

SMOKE_STEPS = 2


def smoke_size(recipe: WanRecipe) -> Tuple[int, int, int]:
    """(height, width, frames) of a smoke run: 32x32 (the TI2V smoke VAE
    compresses 16x, so 64x64 there) and 5 frames."""
    return (64, 64, 5) if recipe.arch == "ti2v" else (32, 32, 5)


def smoke_configs(recipe: WanRecipe):
    """(dit, t5, vae, clip) configs of the recipe's smoke pipeline: the
    smoke DiT of `infer_ditto` (dim 256, 2 heads of 128, 2 blocks) with the
    channel math of the JAX runner: I2V takes y (2z + 4 input channels),
    FLF2V also the CLIP position table; TI2V fuses the image latent into
    z-channel latents of a tiny Wan2.2-family VAE (z 8). The I2V CLIP tower
    gives 257 rows (112x112 in 7-pixel patches, 1280 wide, 2 blocks)."""
    import dataclasses
    from .infer_ditto import smoke_configs as ditto_smoke
    from .models.clip_vit import ClipVitConfig
    from .models.wan_vae import WanVAE38Config
    dit, _, t5, vae = ditto_smoke()
    clip = None
    if recipe.arch == "i2v":
        z = vae.z_dim
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


def build_smoke_pipeline(recipe: WanRecipe, device=None, seed: int = 0):
    """Random smoke models of `smoke_configs` from `seed` (a second expert
    from seed + 1 for a dual-expert recipe), bf16, on `device`."""
    import torch
    from .infer_ditto import SMOKE_TEXT_LEN
    from .models.wan_dit import WanDiT, init_weights_
    from .pipelines.wan_video import WanVideoPipeline
    from .prompters.wan_prompter import StubTokenizer
    dit, t5, vae, clip = smoke_configs(recipe)
    pipe = WanVideoPipeline.from_configs(
        dit, None, t5, vae, StubTokenizer(SMOKE_TEXT_LEN), text_len=SMOKE_TEXT_LEN,
        seed=seed, device=device, dtype=torch.bfloat16, clip_cfg=clip)
    if recipe.dual_expert:
        with torch.device("meta"):
            dit2 = WanDiT(dit, dtype=pipe.dtype)
        gen = torch.Generator(pipe.device).manual_seed(seed + 1)
        pipe.dit2 = init_weights_(dit2.to_empty(device=pipe.device), gen).eval()
    return pipe


def smoke_images(recipe: WanRecipe, height: int, width: int):
    """The smoke call's images as the JAX runner draws them: uint8 (H, W, 3)
    from numpy seeds 2 (input image) and 3 (end image)."""
    kw = {}
    for name, seed in (("input_image", 2), ("end_image", 3)):
        if name in recipe.extra_inputs:
            rng = np.random.default_rng(seed)
            kw[name] = rng.integers(0, 255, (height, width, 3), np.uint8)
    return kw


def build_pipeline(args):
    """The pipeline from local checkpoint files on --device."""
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    configs = [ModelConfig(path=args.dit_path.split("|"), model_kind="dit")]
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
        kw = smoke_images(recipe, h, w)
    else:
        if not args.dit_path:
            p.error("--dit_path is required (or use --smoke)")
        from .data.video import read_image
        kw = {name: read_image(path) for name, path in
              (("input_image", args.input_image), ("end_image", args.end_image)) if path}
        missing = [name for name in recipe.extra_inputs if name not in kw]
        if missing:
            p.error(f"recipe {recipe.name} needs --{' --'.join(missing)}")
        pipe = build_pipeline(args)
        h = args.height or recipe.height
        w = args.width or recipe.width
        n = args.num_frames or recipe.num_frames
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
