"""Step 2 of the keyframe pipeline: keyframe-guided video editing with the
PyTorch/CUDA port.

    python -m video_styler_tpu_torch.step2_video_editing --video in.mp4 \
        --keyframe_info out/keyframe_info.json --dit_path ... --vae_path ... \
        --t5_path ...
    python -m video_styler_tpu_torch.step2_video_editing --video in.mp4 \
        --keyframe_info out/keyframe_info.json --smoke --device cpu

Same flags as inference/step2_video_editing.py, plus --device (default
cuda). Reads step 1's `keyframe_info.json` (`generated_frames`: styled
keyframe images; `keyframe_timestamp` with `source_fps`: where each one
sits in the source), maps each timestamp to a source frame, drops repeated
frames keeping the first, and runs `WanVideoEditorPipeline`. With
--tea_cache_l1_thresh and no --tea_cache_model_id, the TeaCache
coefficients are those of the loaded DiT's size (`tea_cache_model_id_for`).
--smoke runs tiny random models (head dim 128, so the CUDA kernels run
too) on 5 frames of 32x32 with 2 keyframes and 3 steps.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Sequence, Tuple


def tea_cache_model_id_for(dit_cfg) -> str:
    """The TeaCache coefficient id of a DiT's size: 5120 wide and up is the
    14B's, anything narrower the 1.3B's."""
    return "Wan2.1-T2V-14B" if dit_cfg.dim >= 5120 else "Wan2.1-T2V-1.3B"


def keyframes_from_info(info: dict, num_source_frames: int) -> Tuple[List[int], List[str]]:
    """(source frame indices, image paths) of step 1's keyframes: timestamp
    x source fps, clipped to the clip, repeated frames dropped in order."""
    indices = [min(int(t * info["source_fps"]), num_source_frames - 1)
               for t in info["keyframe_timestamp"]]
    seen, kf_idx, kf_paths = set(), [], []
    for i, path in zip(indices, info["generated_frames"]):
        if i not in seen:
            seen.add(i)
            kf_idx.append(i)
            kf_paths.append(path)
    return kf_idx, kf_paths


def _load_images(paths: Sequence[str], height: int, width: int):
    import numpy as np
    from PIL import Image
    return [np.asarray(Image.open(p).convert("RGB").resize((width, height)))
            for p in paths]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Keyframe-guided video editing "
                                            "(PyTorch/CUDA)")
    p.add_argument("--video", type=str, required=True)
    p.add_argument("--keyframe_info", type=str, required=True,
                   help="keyframe_info.json from step 1")
    p.add_argument("--prompt", type=str, default=None,
                   help="override the consistent edit prompt")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--output_path", type=str, default="edited.mp4")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--alpha", type=float, default=10.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dit_path", type=str, default=None,
                   help="DiT safetensors, '|'-separated shards")
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--t5_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--tea_cache_l1_thresh", type=float, default=None,
                   help="enable TeaCache on the joint [main|edit] forward")
    p.add_argument("--tea_cache_model_id", type=str, default=None,
                   help="default: from the loaded DiT's size")
    p.add_argument("--smoke", action="store_true",
                   help="tiny random models, no checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def build_pipeline(args):
    from .pipelines.wan_video_editor import WanVideoEditorPipeline
    from .utils.model_config import ModelConfig
    model_configs = [ModelConfig(path=x.split("|")) for x in
                     (args.dit_path, args.vae_path, args.t5_path) if x]
    return WanVideoEditorPipeline.from_pretrained(
        model_configs, tokenizer_path=args.tokenizer_path, device=args.device)


def build_smoke_pipeline(device=None, seed: int = 0):
    """The smoke models of `infer_ditto` as an editor (its VACE unused)."""
    from .infer_ditto import build_smoke_pipeline as base_pipeline
    from .pipelines.wan_video_editor import WanVideoEditorPipeline
    base = base_pipeline(device=device, seed=seed)
    pipe = WanVideoEditorPipeline(device=base.device, dtype=base.dtype)
    pipe.__dict__.update(base.__dict__)
    return pipe


def main(argv=None):
    p, args = parse_args(argv)
    from .data.video import VideoData, save_video

    if args.smoke:
        pipe = build_smoke_pipeline(device=args.device)
    elif not args.dit_path:
        p.error("--dit_path is required (or use --smoke)")
    else:
        pipe = build_pipeline(args)

    with open(args.keyframe_info) as f:
        info = json.load(f)
    height, width, num_frames = args.height, args.width, args.num_frames
    steps = args.num_inference_steps
    if args.smoke:
        height = width = 32
        num_frames, steps = min(num_frames, 5), 3
    vd = VideoData(args.video, height=height, width=width)
    n = min(len(vd), num_frames)
    source_frames = [vd[i] for i in range(n)]
    vd.close()
    kf_idx, kf_paths = keyframes_from_info(info, n)
    if args.smoke:
        kf_idx, kf_paths = kf_idx[:2], kf_paths[:2]
    kf_imgs = _load_images(kf_paths, height, width)

    tea_id = args.tea_cache_model_id
    if args.tea_cache_l1_thresh is not None and tea_id is None:
        tea_id = tea_cache_model_id_for(pipe.dit.cfg)
    frames = pipe(prompt=args.prompt or info.get("consistent_edit_prompt", ""),
                  negative_prompt=args.negative_prompt,
                  source_video=source_frames, edited_keyframes=kf_imgs,
                  keyframe_indices=kf_idx, seed=args.seed, height=height,
                  width=width, num_frames=len(source_frames),
                  cfg_scale=args.cfg_scale, num_inference_steps=steps,
                  alpha=args.alpha, beta=args.beta, tiled=not args.smoke,
                  verbose=True, tea_cache_l1_thresh=args.tea_cache_l1_thresh,
                  tea_cache_model_id=tea_id or "")
    save_video(frames, args.output_path, fps=args.fps)
    print(f"step2 done: saved {len(frames)} frames to {args.output_path}")
    return frames


if __name__ == "__main__":
    main()
