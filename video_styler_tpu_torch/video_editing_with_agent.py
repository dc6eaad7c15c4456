"""Integrated video editing: the step 1 agent, then the keyframe-guided
editor, in one process.

    python -m video_styler_tpu_torch.video_editing_with_agent --video in.mp4 \
        --style "Van Gogh oil painting" --dit_path ... --vae_path ... \
        --t5_path ... --output_path out.mp4
    python -m video_styler_tpu_torch.video_editing_with_agent --smoke \
        --style "sketch" --device cpu

Counterpart of inference/video_editing_with_agent.py: runs
`step1_generate_keyframes` (on the host) and feeds its keyframe_info.json
to `step2_video_editing` (the editor, on the card unless --device cpu),
with the flags of both. --smoke runs step 1 with the mock provider (on a
synthetic clip without --video) and step 2 on tiny random models.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Agent keyframes, then the editor")
    # step 1
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--style", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="agent_out")
    p.add_argument("--max_frames", type=int, default=10)
    p.add_argument("--image_provider", type=str, default="mock")
    p.add_argument("--config", type=str, default=None)
    # step 2
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--output_path", type=str, default="edited.mp4")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--alpha", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dit_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--t5_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def main(argv=None):
    from . import step1_generate_keyframes as step1
    from . import step2_video_editing as step2
    p, a = parse_args(argv)
    video = a.video
    if video is None:
        if not a.smoke:
            p.error("--video is required (or use --smoke)")
        os.makedirs(a.output_dir, exist_ok=True)
        video = step1.smoke_video(os.path.join(a.output_dir, "smoke_input.mp4"))

    step1_args = ["--video", video, "--style", a.style, "--output_dir", a.output_dir,
                  "--max_frames", str(a.max_frames), "--image_provider", a.image_provider]
    if a.config:
        step1_args += ["--config", a.config]
    if a.smoke:
        step1_args += ["--smoke"]
    step1.main(step1_args)

    step2_args = ["--video", video,
                  "--keyframe_info", os.path.join(a.output_dir, "keyframe_info.json"),
                  "--negative_prompt", a.negative_prompt, "--output_path", a.output_path,
                  "--height", str(a.height), "--width", str(a.width),
                  "--num_frames", str(a.num_frames), "--cfg_scale", str(a.cfg_scale),
                  "--num_inference_steps", str(a.num_inference_steps),
                  "--alpha", str(a.alpha), "--fps", str(a.fps), "--device", a.device]
    if a.prompt:
        step2_args += ["--prompt", a.prompt]
    if a.seed is not None:
        step2_args += ["--seed", str(a.seed)]
    for flag, val in (("--dit_path", a.dit_path), ("--vae_path", a.vae_path),
                      ("--t5_path", a.t5_path), ("--tokenizer_path", a.tokenizer_path)):
        if val:
            step2_args += [flag, val]
    if a.smoke:
        step2_args += ["--smoke"]
    frames = step2.main(step2_args)
    print(f"integrated edit done: {a.output_path}")
    return frames


if __name__ == "__main__":
    main()
