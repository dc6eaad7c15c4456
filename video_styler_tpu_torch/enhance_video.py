"""Wan2.2 dual-expert temporal enhancer with the PyTorch/CUDA port.

    python -m video_styler_tpu_torch.enhance_video --input_video in.mp4 \
        --low_noise_dit_path "low-1.safetensors|..." \
        --high_noise_dit_path "high-1.safetensors|..." \
        --vae_path Wan2.1_VAE.pth --t5_path models_t5_umt5-xxl-enc-bf16.pth
    python -m video_styler_tpu_torch.enhance_video --smoke --device cpu

Same flags as inference/enhance_video.py without --mesh, plus --device
(default cuda). Enhances each video of --video_list (one path per line) or
--input_video, writes it to --output_dir under its own name and appends
its seconds to `enhancing_time.txt` there. --high_noise_dit_path loads as
model kind `dit2`. --smoke runs two distinct tiny random experts (head dim
128, so the CUDA kernels run too) on 5 synthetic frames of 32x32.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Wan2.2 temporal enhancer (PyTorch/CUDA)")
    p.add_argument("--video_list", type=str, default=None,
                   help="txt file: one input video path per line")
    p.add_argument("--input_video", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="enhanced")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--forward_step", type=int, default=4)
    p.add_argument("--skip_backward_step", type=int, default=4)
    p.add_argument("--sampling_steps", type=int, default=50)
    p.add_argument("--sample_shift", type=float, default=5.0)
    p.add_argument("--boundary", type=float, default=0.875)
    p.add_argument("--guide_scale_low", type=float, default=3.0)
    p.add_argument("--guide_scale_high", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--low_noise_dit_path", type=str, default=None)
    p.add_argument("--high_noise_dit_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--t5_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--tiled", action="store_true")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--smoke", action="store_true",
                   help="two tiny random experts, no checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def build_pipeline(args):
    from .pipelines.wan_enhancer import WanEnhancerPipeline
    from .utils.model_config import ModelConfig
    model_configs = []
    if args.low_noise_dit_path:
        model_configs.append(ModelConfig(path=args.low_noise_dit_path.split("|"),
                                         model_kind="dit"))
    if args.high_noise_dit_path:
        model_configs.append(ModelConfig(path=args.high_noise_dit_path.split("|"),
                                         model_kind="dit2"))
    for path in (args.vae_path, args.t5_path):
        if path:
            model_configs.append(ModelConfig(path=path))
    return WanEnhancerPipeline.from_pretrained(
        model_configs, tokenizer_path=args.tokenizer_path, device=args.device)


def build_smoke_pipeline(device=None, seed: int = 0):
    """The smoke models of `infer_ditto` without VACE, as the low-noise
    expert, and a second DiT of the same shape from seed + 1 as the
    high-noise expert."""
    import torch
    from .infer_ditto import SMOKE_TEXT_LEN, smoke_configs
    from .models.wan_dit import WanDiT, init_weights_
    from .pipelines.wan_enhancer import WanEnhancerPipeline
    from .prompters.wan_prompter import StubTokenizer
    dit, _, t5, vae = smoke_configs()
    pipe = WanEnhancerPipeline.from_configs(
        dit, None, t5, vae, StubTokenizer(SMOKE_TEXT_LEN), text_len=SMOKE_TEXT_LEN,
        seed=seed, device=device, dtype=torch.bfloat16)
    with torch.device("meta"):
        dit2 = WanDiT(dit, dtype=pipe.dtype)
    gen = torch.Generator(pipe.device).manual_seed(seed + 1)
    pipe.dit2 = init_weights_(dit2.to_empty(device=pipe.device), gen).eval()
    return pipe


def _videos(args):
    if args.video_list:
        with open(args.video_list) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if args.input_video:
        return [args.input_video]
    return [None] if args.smoke else []


def main(argv=None):
    p, args = parse_args(argv)
    from .data.video import VideoData, save_video
    from .infer_ditto import smoke_frames

    if args.smoke:
        pipe = build_smoke_pipeline(device=args.device)
        args.height, args.width, args.num_frames = 32, 32, 5
    elif not args.low_noise_dit_path:
        p.error("--low_noise_dit_path is required (or use --smoke)")
    else:
        pipe = build_pipeline(args)
    videos = _videos(args)
    if not videos:
        p.error("give --video_list or --input_video")

    os.makedirs(args.output_dir, exist_ok=True)
    timing_log = os.path.join(args.output_dir, "enhancing_time.txt")
    outputs = []
    for vid_path in videos:
        t0 = time.time()
        if vid_path is None:
            frames = smoke_frames(args.num_frames, args.height, args.width)
            out_name = "synthetic.mp4"
        else:
            vd = VideoData(vid_path, height=args.height, width=args.width)
            frames = [vd[i] for i in range(min(len(vd), args.num_frames))]
            vd.close()
            out_name = os.path.basename(vid_path)
        enhanced = pipe.enhance(
            frames, prompt=args.prompt, negative_prompt=args.negative_prompt,
            forward_step=args.forward_step,
            skip_backward_step=args.skip_backward_step,
            sampling_steps=args.sampling_steps, shift=args.sample_shift,
            guide_scale=(args.guide_scale_low, args.guide_scale_high),
            boundary=args.boundary, seed=args.seed, tiled=args.tiled)
        out_path = os.path.join(args.output_dir, out_name)
        save_video(enhanced, out_path, fps=args.fps)
        dt = time.time() - t0
        with open(timing_log, "a") as f:
            f.write(f"{out_name}\t{dt:.2f}s\n")
        print(f"enhanced {vid_path or '<synthetic>'} -> {out_path} in {dt:.1f}s "
              f"(experts {[w for _, w in pipe.experts]})")
        outputs.append(enhanced)
    return outputs


if __name__ == "__main__":
    main()
