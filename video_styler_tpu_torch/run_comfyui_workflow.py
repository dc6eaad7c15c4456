"""Run the Ditto ComfyUI workflow with the PyTorch/CUDA port.

    python -m video_styler_tpu_torch.run_comfyui_workflow --workflow wf.json \
        --input_video in.mp4 --dit_path ... --vae_path ... --t5_path ...
    python -m video_styler_tpu_torch.run_comfyui_workflow --workflow wf.json \
        --smoke --device cpu

Counterpart of inference/run_comfyui_workflow.py. The reference ships the
ComfyUI graph behind its published edit (fp8 Wan2.1-T2V-14B, a distill
LoRA and the Ditto VACE module, VACE strength 0.975, WanVideoSampler with
4 steps, cfg 1.2, shift 2 and the unipc scheduler, block swap, tiled
decode). `parse_workflow` reads that graph, or any with the same node
types, into a recipe, which runs through `WanVideoPipeline`: a recipe
whose model is fp8 runs `quantize("int8")`, one with WanVideoBlockSwap
runs `enable_block_streaming(mode="int8")` (both on checkpoint files, as
in the JAX CLI), the unipc scheduler becomes
`FlowUniPCMultistepScheduler`, the VACE strength `vace_scale`, and
WanVideoSLG skip-layer guidance (which runs in the streamed walk too).
Runs on the card unless --device cpu. --smoke runs the recipe, its
quantisation and block swap included, on `infer_ditto`'s tiny random
pipeline with a synthetic 32x32 clip of at most 9 frames; there block
swap takes a budget of 0 GB, so every block streams.
"""
from __future__ import annotations

import argparse
import json


def parse_workflow(path: str) -> dict:
    """The recipe of a ComfyUI graph's typed nodes (the JAX CLI's reading:
    the decode's pixel tile sizes become latent ones, divided by 8)."""
    with open(path) as f:
        graph = json.load(f)
    r = {"unsupported": []}
    for node in graph.get("nodes", []):
        t = node.get("type")
        w = node.get("widgets_values") or []
        if t == "WanVideoSampler":
            r["steps"] = int(w[0])
            r["cfg_scale"] = float(w[1])
            r["shift"] = float(w[2])
            r["seed"] = int(w[3])
            r["scheduler"] = str(w[6])
        elif t == "WanVideoTextEncode":
            r["prompt"] = str(w[0])
            r["negative_prompt"] = str(w[1])
        elif t == "WanVideoVACEEncode":
            r["width"] = int(w[0])
            r["height"] = int(w[1])
            r["num_frames"] = int(w[2])
            r["vace_scale"] = float(w[3])
        elif t == "WanVideoModelLoader":
            r["dit_file"] = str(w[0])
            r["quantized"] = "fp8" in str(w[0]).lower() or "fp8" in str(w[2]).lower()
        elif t == "WanVideoLoraSelect":
            r["lora_file"] = str(w[0])
            r["lora_alpha"] = float(w[1])
        elif t == "WanVideoVACEModelSelect":
            r["vace_file"] = str(w[0])
        elif t == "WanVideoVAELoader":
            r["vae_file"] = str(w[0])
        elif t == "LoadWanVideoT5TextEncoder":
            r["t5_file"] = str(w[0])
        elif t == "WanVideoBlockSwap":
            r["blocks_to_swap"] = int(w[0])
        elif t == "WanVideoDecode":
            r["tile_size"] = (max(int(w[1]) // 8, 8), max(int(w[2]) // 8, 8))
            r["tile_stride"] = (max(int(w[3]) // 8, 4), max(int(w[4]) // 8, 4))
        elif t == "WanVideoSLG":
            # skip the listed blocks on the unconditional rows for the steps
            # in [start_percent, end_percent) of the progress
            r["slg_blocks"] = tuple(int(b) for b in str(w[0]).split(",") if b.strip())
            r["slg_start"] = float(w[1])
            r["slg_end"] = float(w[2])
        elif t == "WanVideoTorchCompileSettings":
            pass  # nothing to compile: the kernels are built ahead
    return r


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="ComfyUI workflow runner (PyTorch/CUDA)")
    ap.add_argument("--workflow", required=True)
    ap.add_argument("--input_video", default=None)
    ap.add_argument("--output_path", default="workflow_output.mp4")
    ap.add_argument("--prompt", default=None, help="override the workflow's prompt")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--dit_path")
    ap.add_argument("--vae_path")
    ap.add_argument("--t5_path")
    ap.add_argument("--lora_path")
    ap.add_argument("--tokenizer_path")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny random models; a synthetic input clip")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    recipe = parse_workflow(args.workflow)
    for msg in recipe["unsupported"]:
        print(f"[workflow] NOTE: {msg}")
    print(f"[workflow] recipe: steps={recipe.get('steps')} cfg={recipe.get('cfg_scale')} "
          f"shift={recipe.get('shift')} scheduler={recipe.get('scheduler')} "
          f"vace_scale={recipe.get('vace_scale')} slg={recipe.get('slg_blocks')}"
          f"@[{recipe.get('slg_start')},{recipe.get('slg_end')}) "
          f"{recipe.get('width')}x{recipe.get('height')}x{recipe.get('num_frames')}")

    from .infer_ditto import build_pipeline, build_smoke_pipeline, smoke_frames
    from .schedulers.flow_unipc import FlowUniPCMultistepScheduler

    if args.smoke:
        pipe = build_smoke_pipeline(device=args.device)
        h = w = 32
        n = min(recipe.get("num_frames", 9), 9)
        vace_video = smoke_frames(n, h, w)
        tiled = False
    else:
        if not args.dit_path:
            ap.error(f"--dit_path is required (or --smoke); the workflow names "
                     f"{recipe.get('dit_file')} + {recipe.get('vace_file')}")
        if not args.input_video:
            ap.error("--input_video is required (or --smoke)")
        pipe = build_pipeline(args)
        if args.lora_path:
            pipe.load_lora(target="vace" if pipe.vace is not None else "dit",
                           path=args.lora_path, alpha=recipe.get("lora_alpha", 1.0))
        import numpy as np
        from .data.video import VideoData
        h, w = recipe.get("height", 480), recipe.get("width", 832)
        vd = VideoData(args.input_video, height=h, width=w)
        n = min(len(vd), recipe.get("num_frames", 33))
        vace_video = np.stack([vd[i] for i in range(n)])
        vd.close()
        tiled = True
    if recipe.get("quantized"):
        pipe.quantize(mode="int8")      # the recipe's fp8 model
    if recipe.get("blocks_to_swap"):
        budget = {"hbm_budget_gb": 0.0} if args.smoke else {}
        plan = pipe.enable_block_streaming(mode="int8", **budget)
        print(f"[workflow] block streaming: {plan}")

    if recipe.get("scheduler", "unipc").startswith("unipc"):
        pipe.scheduler = FlowUniPCMultistepScheduler(shift=recipe.get("shift", 2.0))

    frames = pipe(prompt=args.prompt or recipe.get("prompt", ""),
                  negative_prompt=recipe.get("negative_prompt", ""),
                  vace_video=vace_video, vace_scale=recipe.get("vace_scale", 1.0),
                  num_frames=n, height=h, width=w,
                  seed=args.seed if args.seed is not None else recipe.get("seed", 0),
                  cfg_scale=recipe.get("cfg_scale", 1.2),
                  num_inference_steps=recipe.get("steps", 4),
                  sigma_shift=recipe.get("shift", 2.0), tiled=tiled,
                  tile_size=recipe.get("tile_size", (30, 52)),
                  tile_stride=recipe.get("tile_stride", (15, 26)),
                  slg_blocks=recipe.get("slg_blocks"),
                  slg_start=recipe.get("slg_start", 0.0), slg_end=recipe.get("slg_end", 1.0))
    from .data.video import save_video
    save_video(frames, args.output_path, fps=16)
    print(f"[workflow] saved {len(frames)} frames to {args.output_path}")
    return frames


if __name__ == "__main__":
    main()
