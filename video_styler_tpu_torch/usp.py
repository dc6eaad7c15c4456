"""Sequence-parallel generation (unified sequence parallelism) with the
PyTorch/CUDA port.

Counterpart of examples/wanvideo/acceleration/unified_sequence_parallel.py:
a recipe of `wan_video_gen` on a dp x fsdp x sp mesh, one process per rank,

    torchrun --nproc_per_node 2 -m video_styler_tpu_torch.usp --smoke --sp 2
    torchrun --nproc_per_node 4 -m video_styler_tpu_torch.usp \\
        --model Wan2.1-T2V-1.3B --sp 4 --dit_path ... --vae_path ... --t5_path ...

(`--device cpu` runs the ranks on the CPU over gloo). The DiT and VACE are
FSDP-sharded over fsdp, the sequence split over sp (Ulysses); every rank
runs umT5, CLIP and the VAE whole. --smoke runs the recipe's tiny random
models on a 5-frame 32x32 request with 2 steps and no CFG and prints the
mesh, as the JAX example does; otherwise rank 0 writes video_usp.mp4.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    from .wan_video_gen import RECIPES
    ap = argparse.ArgumentParser(description="Sequence-parallel Wan generation")
    ap.add_argument("--model", default="Wan2.1-T2V-1.3B", choices=sorted(RECIPES))
    ap.add_argument("--prompt", default="a cat boxing on a stage")
    ap.add_argument("--sp", type=int, default=2, help="sequence-parallel degree")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dit_path")
    ap.add_argument("--high_noise_dit_path")
    ap.add_argument("--vae_path")
    ap.add_argument("--t5_path")
    ap.add_argument("--clip_path")
    ap.add_argument("--motion_controller_path")
    ap.add_argument("--tokenizer_path")
    ap.add_argument("--output_path", default="video_usp.mp4")
    ap.add_argument("--device", default="cuda", help="cuda (default: cuda:LOCAL_RANK) or cpu")
    return ap, ap.parse_args(argv)


def main(argv=None):
    ap, args = parse_args(argv)
    from .parallel import initialize, is_main_process, make_mesh, process_count
    from .wan_video_gen import RECIPES, build_pipeline, build_smoke_pipeline
    recipe = RECIPES[args.model]
    if not args.smoke and not args.dit_path:
        ap.error("--dit_path is required (or use --smoke)")
    args.device = initialize(device=args.device)
    mesh = make_mesh(args.dp, args.fsdp, args.sp, device_type=args.device.type)
    if args.smoke:
        pipe = build_smoke_pipeline(recipe, device=args.device)
    else:
        args.recipe = args.model
        pipe = build_pipeline(args)
    pipe.shard(mesh)
    kw = (dict(height=32, width=32, num_frames=5, num_inference_steps=2, cfg_scale=1.0,
               tiled=False, return_latents=True) if args.smoke else dict(tiled=True))
    out = pipe(args.prompt, seed=1, **kw)
    if args.smoke:
        if not bool(out.float().isfinite().all()):
            raise FloatingPointError("USP smoke latents are not finite")
        print(f"USP smoke OK on mesh dp={args.dp} fsdp={args.fsdp} sp={args.sp} "
              f"({process_count()} ranks)")
    elif is_main_process():
        from .data.video import save_video
        save_video(out, args.output_path, fps=15, quality=5)
    return out


if __name__ == "__main__":
    main()
