"""Diffutoon toon shading of a video with the PyTorch/CUDA port: the
runner's JSON config in, frames, a video and the config out.

    python -m video_styler_tpu_torch.diffutoon --config diffutoon.json
    python -m video_styler_tpu_torch.diffutoon --config diffutoon.json --smoke --device cpu

The config is the JAX runner's (`pipelines/pipeline_runner.py`):
{"models": {"model_list": [civitai SD 1.5 file, motion modules, LoRAs...],
"lora_alphas": [...], "controlnet_units": [{"processor_id": "tile",
"model_path": ..., "scale": ...}, ...], "tokenizer_path": ...}, "data":
{"input_frames": {"video_file" or "image_folder", "height", "width",
"start_frame_id", "end_frame_id"}, "controlnet_frames": [one such dict a
unit], "output_folder": ..., "fps": ...}, "smoother_configs": [...],
"pipeline": {"seed": ..., "pipeline_inputs": {"prompt", "cfg_scale",
"num_inference_steps", "denoising_strength", "animatediff_batch_size",
"animatediff_stride", "smoother_progress_ids", ...}}}. --smoke swaps the
config's models for tiny random ones (the UNet, motion modules, CLIP-L
with a stand-in tokenizer, one tile ControlNet per unit of the config's
data, the SD VAE; fp32). Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json


def build_smoke_pipeline(units: int = 1, device=None, seed: int = 0):
    """`video_gen`'s tiny AnimateDiff pipeline with `units` tile ControlNets
    of the tiny UNet's widths."""
    import torch
    from .controlnets import Annotator, ControlNetUnit, MultiControlNetManager
    from .models import sd as SD
    from .models.controlnet import ControlNet, ControlNetConfig
    from .video_gen import build_sd_video_smoke_pipeline
    pipe = build_sd_video_smoke_pipeline(device=device, seed=seed)
    gen = torch.Generator(pipe.device).manual_seed(seed + 2)
    cn = []
    for _ in range(units):
        with torch.device("meta"):
            model = ControlNet(ControlNetConfig(SD.SD_UNET_TINY), dtype=torch.float32)
        model = SD.init_sd_module_(model.to_empty(device=pipe.device), gen).eval()
        cn.append(ControlNetUnit(Annotator("tile"), model, scale=1.0))
    pipe.controlnet_manager = MultiControlNetManager(cn)
    return pipe


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, help="the runner's JSON config")
    p.add_argument("--smoke", action="store_true", help="tiny random models")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="the --smoke weights' seed")
    a = p.parse_args(argv)
    from .pipelines.pipeline_runner import SDVideoPipelineRunner
    with open(a.config) as f:
        config = json.load(f)
    pipe = None
    if a.smoke:
        pipe = build_smoke_pipeline(len(config["data"].get("controlnet_frames") or []) or 1,
                                    device=a.device, seed=a.seed)
    frames = SDVideoPipelineRunner(device=a.device).run(config, pipe=pipe)
    print(f"saved {len(frames)} frames to {config['data']['output_folder']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
