"""Step 1 of the keyframe pipeline: agentic keyframe stylization.

    python -m video_styler_tpu_torch.step1_generate_keyframes --video in.mp4 \
        --style "van gogh oil painting" --output_dir agent_out
    python -m video_styler_tpu_torch.step1_generate_keyframes --smoke \
        --style "sketch" --output_dir agent_out

Counterpart of inference/step1_generate_keyframes.py: the video-styling
agent (`agent.build_video_styling_app`: frame extraction at ~1 fps, style
analysis, one image edit per keyframe with checkpoint and resume, the
styled keyframes combined) runs on the host and writes the
`keyframe_info.json` that `step2_video_editing` reads
(`generated_frames`, `keyframe_timestamp`, `keyframe_fps`, `source_fps`,
`consistent_edit_prompt`). --image_provider picks the edit service (the
offline `mock` by default; the others need their API keys). --smoke uses
the mock provider and, without --video, writes a synthetic 30-frame clip
to <output_dir>/smoke_input.mp4 first.
"""
from __future__ import annotations

import argparse
import json
import os

PROVIDERS = ["mock", "gemini", "openai", "qwen", "doubao"]


def smoke_video(path: str, n_frames: int = 30, fps: int = 10):
    """A synthetic 64x48 clip: a flat shade rising with the frame and a
    patch of one seeded colour."""
    import numpy as np
    from .data.video import save_video
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n_frames):
        frame = np.full((48, 64, 3), (i * 8) % 255, np.uint8)
        frame[10:20, 10:30] = rng.integers(0, 255, 3, np.uint8)
        frames.append(frame)
    save_video(frames, path, fps=fps)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Agentic keyframe stylization")
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--style", type=str, required=True,
                   help="style instruction, e.g. 'van gogh oil painting'")
    p.add_argument("--output_dir", type=str, default="agent_out")
    p.add_argument("--max_frames", type=int, default=10)
    p.add_argument("--image_provider", type=str, default="mock", choices=PROVIDERS)
    p.add_argument("--config", type=str, default=None, help="agent YAML config")
    p.add_argument("--smoke", action="store_true",
                   help="the mock provider; a synthetic clip without --video")
    return p, p.parse_args(argv)


def main(argv=None) -> dict:
    p, args = parse_args(argv)
    if args.smoke:
        args.image_provider = "mock"
        if args.video is None:
            os.makedirs(args.output_dir, exist_ok=True)
            args.video = smoke_video(os.path.join(args.output_dir, "smoke_input.mp4"))
    elif args.video is None:
        p.error("--video is required (or use --smoke)")

    from .agent import build_video_styling_app
    if args.config:
        from .agent.config import ConfigManager
        ConfigManager(config_path=args.config)  # validates, expands ${ENV}

    app = build_video_styling_app(llm_fn=None, image_provider=args.image_provider)
    state = app.invoke({"video_url": args.video, "output_dir": args.output_dir,
                        "style_instruction": args.style, "max_frames": args.max_frames})
    info = {
        "generated_frames": [f["stylized_image_path"] for f in state["frames"]],
        "keyframe_timestamp": [f["timestamp"] for f in state["frames"]],
        "keyframe_fps": 1.0,
        "source_fps": state["video_metadata"]["fps"],
        "consistent_edit_prompt": state.get("consistent_edit_prompt", ""),
    }
    info_path = os.path.join(args.output_dir, "keyframe_info.json")
    with open(info_path, "w") as f:
        json.dump(info, f, indent=2)
    print(f"step1 done: {len(state['frames'])} styled keyframes, info at {info_path}")
    return info


if __name__ == "__main__":
    main()
