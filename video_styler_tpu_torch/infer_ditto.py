"""Ditto instruction-based video editing with the PyTorch/CUDA port.

    python -m video_styler_tpu_torch.infer_ditto --smoke --prompt "x"
    python -m video_styler_tpu_torch.infer_ditto --input_video in.mp4 \
        --prompt "make it a watercolor" --dit_path ...

Same flags as inference/infer_ditto.py, without --streaming, plus
--device (default cuda). --mesh dp,fsdp,sp runs one rank of a multi-GPU
edit: launch `torchrun --nproc_per_node N -m video_styler_tpu_torch.infer_ditto
--mesh dp,fsdp,sp ...` with N = dp*fsdp*sp (`parallel.initialize` reads
torchrun's variables; each rank takes cuda:LOCAL_RANK, or the CPU with
--device cpu over gloo). The DiT and VACE are FSDP-sharded over fsdp and
run sequence-parallel over sp; every rank runs umT5 and the VAE whole, and
only rank 0 writes the mp4. --dit_path ('|'-separated shards of the DiT
and VACE), --vae_path, --t5_path and --tokenizer_path go through
`WanVideoPipeline.from_pretrained` (the official Wan2.1-VACE-14B files:
`diffusion_pytorch_model-0000{1..7}-of-00007.safetensors`, `Wan2.1_VAE.pth`,
`models_t5_umt5-xxl-enc-bf16.pth`, the `google/umt5-xxl` tokenizer, found
beside the checkpoints when --tokenizer_path is not given). --quantize
int8|fp8 quantizes the DiT and VACE linears after any LoRA merge
(`WanVideoPipeline.quantize`). --smoke runs the same pipeline code on tiny
random models (head dim 128, so the CUDA kernels run too). --lora_path
merges a LoRA (e.g. one that `python -m video_styler_tpu_torch.train`
saved) into the VACE branch before the loop.
"""
from __future__ import annotations

import argparse

import numpy as np

SMOKE_TEXT_LEN = 16


def smoke_configs():
    """(dit, vace, t5, vae) configs of the smoke pipeline. The tiny VAE has
    z_dim 4: DiT in/out 4 channels, VACE context 2*4+64 = 72."""
    from .models.t5 import T5Config
    from .models.wan_dit import WanDiTConfig
    from .models.wan_vace import VaceConfig
    from .models.wan_vae import WanVAEConfig
    dit = WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
                       num_layers=2, text_dim=64, freq_dim=32)
    vace = VaceConfig(vace_layers=(0, 1), vace_in_dim=72, dim=256,
                      num_heads=2, ffn_dim=512)
    t5 = T5Config(vocab=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
                  num_layers=2, num_buckets=8)
    vae = WanVAEConfig(dim=16, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                       latent_mean=(0.0,) * 4, latent_std=(1.0,) * 4)
    return dit, vace, t5, vae


def build_smoke_pipeline(device=None, seed: int = 0):
    import torch
    from .pipelines.wan_video import WanVideoPipeline
    from .prompters.wan_prompter import StubTokenizer
    dit, vace, t5, vae = smoke_configs()
    return WanVideoPipeline.from_configs(
        dit, vace, t5, vae, StubTokenizer(SMOKE_TEXT_LEN),
        text_len=SMOKE_TEXT_LEN, seed=seed, device=device, dtype=torch.bfloat16)


def build_pipeline(args):
    """The pipeline from checkpoint files (--dit_path, --vae_path, --t5_path,
    --tokenizer_path), on --device, as inference/infer_ditto.py builds it."""
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    model_configs = [ModelConfig(path=args.dit_path.split("|"))]
    for path in (args.vae_path, args.t5_path):
        if path:
            model_configs.append(ModelConfig(path=path))
    return WanVideoPipeline.from_pretrained(model_configs,
                                            tokenizer_path=args.tokenizer_path,
                                            device=args.device)


def smoke_frames(num_frames: int, height: int, width: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (num_frames, height, width, 3), np.uint8)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Ditto video editing (PyTorch/CUDA)")
    p.add_argument("--input_video", type=str, default=None)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--output_path", type=str, default="output.mp4")
    p.add_argument("--num_frames", type=int, default=73)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cfg_scale", type=float, default=5.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--sigma_shift", type=float, default=5.0)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--dit_path", type=str, default=None,
                   help="DiT(+VACE) safetensors, '|'-separated shards")
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--t5_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--lora_alpha", type=float, default=1.0)
    p.add_argument("--tea_cache_l1_thresh", type=float, default=None)
    p.add_argument("--tea_cache_model_id", type=str, default="Wan2.1-T2V-14B")
    p.add_argument("--no_tiled", action="store_true")
    p.add_argument("--quantize", type=str, default=None, choices=["int8", "fp8"],
                   help="quantize the DiT linears (the analogue of the "
                        "reference's fp8 baseline)")
    p.add_argument("--cfg_merge", action="store_true",
                   help="batch posi+nega in one DiT pass")
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,sp mesh sizes (e.g. 1,1,4), one process per rank")
    p.add_argument("--smoke", action="store_true",
                   help="tiny random models, no checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    mesh = None
    if args.mesh:
        from .parallel import initialize, make_mesh, parse_mesh
        sizes = parse_mesh(args.mesh)
        if args.quantize and sizes[1] > 1:
            p.error("--quantize with fsdp > 1 is not supported yet (ROADMAP item 8)")
        args.device = initialize(device=args.device)
        mesh = make_mesh(*sizes, device_type=args.device.type)
    if args.smoke:
        pipe = build_smoke_pipeline(device=args.device)
        args.height, args.width = 32, 32
        args.num_frames = min(args.num_frames, 9)
        args.num_inference_steps = min(args.num_inference_steps, 4)
    elif not args.dit_path:
        p.error("--dit_path is required (or use --smoke)")
    else:
        pipe = build_pipeline(args)
    if args.lora_path:
        pipe.load_lora(target="vace" if pipe.vace is not None else "dit",
                       path=args.lora_path, alpha=args.lora_alpha)
    if args.quantize:
        pipe.quantize(mode=args.quantize)
    if mesh is not None:
        pipe.shard(mesh)

    vace_video = None
    if args.input_video:
        from .data.video import VideoData
        vd = VideoData(args.input_video, height=args.height, width=args.width)
        n = min(len(vd), args.num_frames)
        vace_video = np.stack([vd[i] for i in range(n)])
        vd.close()
        args.num_frames = n
    elif args.smoke:
        vace_video = smoke_frames(args.num_frames, args.height, args.width)

    frames = pipe(prompt=args.prompt, negative_prompt=args.negative_prompt,
                  vace_video=vace_video, num_frames=args.num_frames,
                  height=args.height, width=args.width, seed=args.seed,
                  cfg_scale=args.cfg_scale,
                  num_inference_steps=args.num_inference_steps,
                  sigma_shift=args.sigma_shift, cfg_merge=args.cfg_merge,
                  tiled=not args.no_tiled and not args.smoke,
                  tea_cache_l1_thresh=args.tea_cache_l1_thresh,
                  tea_cache_model_id=args.tea_cache_model_id)
    from .parallel import is_main_process
    if is_main_process():
        from .data.video import save_video
        save_video(frames, args.output_path, fps=args.fps)
        print(f"saved {len(frames)} frames to {args.output_path}")
    return frames


if __name__ == "__main__":
    main()
