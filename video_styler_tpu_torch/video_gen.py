"""Video generation with the PyTorch/CUDA port, by family.

    python -m video_styler_tpu_torch.video_gen --family sd_animatediff \\
        --prompt "a red fox" --dit_path v1-5-pruned-emaonly.safetensors \\
        --motion_path mm_sd_v15_v2.safetensors --tokenizer_path clip_tokenizer \\
        --num_frames 16 --height 512 --width 512 --output out.mp4
    python -m video_styler_tpu_torch.video_gen --family sd_animatediff --smoke --device cpu
    python -m video_styler_tpu_torch.video_gen --family wan_t2v --prompt "a red fox" \\
        --dit_path wan_t2v_1.3b.safetensors --vae_path Wan2.1_VAE.pth \\
        --t5_path models_t5_umt5-xxl-enc-bf16.pth --tokenizer_path umt5_tokenizer

The counterpart of the JAX package's `examples/video_gen.py`:
`sd_animatediff` (`SDVideoPipeline`: the UNet, CLIP-L and VAE of a civitai
SD 1.5 file, the motion modules of --motion_path (kind `motion_modules`),
--cfg_scale two-pass CFG over windows of 16 frames, DDIM) and `wan_t2v`
(`WanVideoPipeline.from_pretrained` on the three files, tiled VAE). SD
video needs a CLIP tokenizer (--tokenizer_path), as the JAX pipeline does.
--smoke runs sd_animatediff on tiny random models (UNet, motion modules,
CLIP-L) with the SD VAE and a stand-in tokenizer: 8 frames at 64x64, 2
steps. hunyuan_video, cog_video, step_video and svd raise
`NotImplementedError` naming their ROADMAP Queue 1 item. The Ditto edit,
the other Wan recipes, the editor and the enhancer have their own CLIs
(`infer_ditto`, `wan_video_gen`, `step2_video_editing`, `enhance_video`);
the Diffutoon runner is `diffutoon`. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse

SMOKE_SIZE = 64
SMOKE_FRAMES = 8
SMOKE_STEPS = 2


def build_sd_video_smoke_pipeline(device=None, seed: int = 0):
    """An SD 1.5 AnimateDiff pipeline of tiny random models (weights from
    `seed`), fp32, with a stand-in CLIP tokenizer."""
    import torch
    from .models import motion as M
    from .models import sd as SD
    from .models.sdxl import CLIP_L_TINY_12
    from .pipelines.sd_video import SDVideoPipeline
    from .prompters.flux_prompter import StubClipTokenizer
    base = SDVideoPipeline.from_configs(SD.SD_UNET_TINY, CLIP_L_TINY_12,
                                        StubClipTokenizer(CLIP_L_TINY_12.vocab), seed=seed,
                                        device=device, dtype=torch.float32)
    gen = torch.Generator(base.device).manual_seed(seed + 1)
    with torch.device("meta"):
        motion = M.sd_motion_model(SD.SD_UNET_TINY, dtype=torch.float32)
    base.motion_modules = SD.init_sd_module_(motion.to_empty(device=base.device), gen).eval()
    return base


def run_sd_animatediff(a):
    from .pipelines.sd_video import SDVideoPipeline
    from .utils.ckpt import load_model
    if a.smoke:
        pipe = build_sd_video_smoke_pipeline(device=a.device, seed=a.seed)
    else:
        pipe = SDVideoPipeline.from_civitai_file(a.dit_path, tokenizer_path=a.tokenizer_path,
                                                 device=a.device)
        kind, pipe.motion_modules = load_model(a.motion_path, device=a.device)
        if kind != "motion_modules":
            raise ValueError(f"--motion_path holds a {kind!r} model, not motion modules")
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, num_frames=a.num_frames,
                height=a.height, width=a.width, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, seed=a.seed)


def run_wan_t2v(a):
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    pipe = WanVideoPipeline.from_pretrained(
        model_configs=[ModelConfig(path=a.dit_path), ModelConfig(path=a.vae_path),
                       ModelConfig(path=a.t5_path)],
        tokenizer_path=a.tokenizer_path, device=a.device)
    return pipe(prompt=a.prompt, negative_prompt=a.negative_prompt, num_frames=a.num_frames,
                height=a.height, width=a.width, cfg_scale=a.cfg_scale,
                num_inference_steps=a.steps, seed=a.seed, tiled=True)


def _unported(family: str, item: str):
    def run(a):
        raise NotImplementedError(f"video family {family!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item {item})")
    return run


RUNNERS = {"sd_animatediff": run_sd_animatediff, "wan_t2v": run_wan_t2v,
           "hunyuan_video": _unported("hunyuan_video", "11e"),
           "cog_video": _unported("cog_video", "11f"),
           "step_video": _unported("step_video", "11f"), "svd": _unported("svd", "11f")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", required=True, choices=sorted(RUNNERS))
    p.add_argument("--prompt", default="a red fox running through snow")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--dit_path")
    p.add_argument("--vae_path")
    p.add_argument("--t5_path")
    p.add_argument("--motion_path")
    p.add_argument("--tokenizer_path")
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--steps", type=int)
    p.add_argument("--num_frames", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="out.mp4")
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--smoke", action="store_true",
                   help="sd_animatediff on tiny random models: 8 frames at 64x64, 2 steps")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if not a.smoke and not a.dit_path:
        p.error("--dit_path is required (or use --smoke)")
    if a.smoke and a.family != "sd_animatediff":
        p.error("--smoke runs the sd_animatediff family")
    a.steps = a.steps or (SMOKE_STEPS if a.smoke else 30)
    a.num_frames = a.num_frames or (SMOKE_FRAMES if a.smoke else 81)
    a.height = a.height or (SMOKE_SIZE if a.smoke else 480)
    a.width = a.width or (SMOKE_SIZE if a.smoke else 832)
    return a


def main(argv=None):
    a = parse_args(argv)
    frames = RUNNERS[a.family](a)
    from .data.video import save_video
    save_video(frames, a.output, fps=a.fps)
    print(f"saved {a.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
