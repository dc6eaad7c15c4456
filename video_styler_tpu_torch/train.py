"""LoRA training CLI of the PyTorch/CUDA port (the train.sh surface).

    python -m video_styler_tpu_torch.train --smoke --device cpu --max_steps 2
    python -m video_styler_tpu_torch.train --smoke --save_steps 1 --output_path out

Counterpart of examples/train.py: the same units as inference prepare each
sample (umT5 prompt encode, the VACE context from a VAE encode), the
flow-match loss on a random training timestep with rematerialised DiT
blocks, AdamW with optax.adamw's defaults, LoRA safetensors every
`--save_steps` (or per epoch), and full train-state checkpoints for
`--resume`. The Ditto recipe is `--lora_base_model vace --lora_rank 128
--lora_target_modules q,k,v,o,ffn.0,ffn.2`.

--smoke trains on the tiny random pipeline of `infer_ditto --smoke` with
synthetic samples. Checkpoint loading (--dit_path and its siblings), the
CSV video dataset, the latent cache (--task data_process, --cache_path)
are not ported yet and raise. Runs on `cuda` unless --device cpu.
The inputs keep the pipeline's dtype (bf16, what the kernels take), where
examples/train.py casts them to fp32.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA training (PyTorch/CUDA)")
    p.add_argument("--dataset_metadata_path", type=str, default=None)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--dit_path", type=str, default=None)
    p.add_argument("--model_id_with_origin_paths", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--t5_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--output_path", type=str, default="./models/train")
    p.add_argument("--save_steps", type=int, default=None)
    p.add_argument("--lora_base_model", type=str, default="dit",
                   choices=["dit", "vace"])
    p.add_argument("--lora_target_modules", type=str, default="q,k,v,o,ffn.0,ffn.2")
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--lora_checkpoint", type=str, default=None,
                   help="start from the LoRA in this safetensors file")
    p.add_argument("--max_timestep_boundary", type=float, default=1.0)
    p.add_argument("--min_timestep_boundary", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task", type=str, default="train",
                   choices=["train", "data_process"])
    p.add_argument("--cache_path", type=str, default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny random models and synthetic samples")
    p.add_argument("--resume", action="store_true",
                   help="resume the full train state (LoRA, AdamW, step, "
                        "generator) from the newest state-<step>.pt in "
                        "--output_path")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def load_lora_checkpoint(lora, state_dict):
    """Fill a LoRA's A/B from a reference-style state dict (the logger's
    files), in place."""
    import torch
    from .lora import extract_lora_pairs, module_path
    pairs = {module_path(t): ab for t, ab in extract_lora_pairs(state_dict).items()}
    if set(pairs) != set(lora):
        raise KeyError("the LoRA checkpoint's targets differ from the model's")
    with torch.no_grad():
        for path, (a, b) in pairs.items():
            lora[path]["A"].copy_(a)
            lora[path]["B"].copy_(b)


def main(argv=None):
    p, args = parse_args(argv)
    if args.task == "data_process" or args.cache_path or args.dataset_metadata_path:
        raise NotImplementedError("the video dataset and the latent cache "
                                  "(--dataset_metadata_path, --task data_process, "
                                  "--cache_path) are not yet ported; use --smoke")
    if (args.dit_path or args.vae_path or args.t5_path or args.tokenizer_path
            or args.model_id_with_origin_paths):
        raise NotImplementedError("checkpoint loading (--dit_path, --vae_path, "
                                  "--t5_path, --tokenizer_path, "
                                  "--model_id_with_origin_paths) is not yet "
                                  "ported; use --smoke")
    if not args.smoke:
        p.error("--dit_path is required (or use --smoke)")

    import torch
    from .infer_ditto import build_smoke_pipeline
    from .pipelines.wan_video import _preprocess_images
    from .safetensors_io import load_file
    from .trainers.checkpoint import (latest_checkpoint, restore_train_state,
                                      save_train_state)
    from .trainers.logger import ModelLogger
    from .trainers.lora_train import (apply_lora, init_lora, lora_parameters,
                                      lora_targets)
    from .trainers.training import adamw, make_train_step, training_scheduler

    pipe = build_smoke_pipeline(device=args.device)
    args.height, args.width, args.num_frames = 32, 32, 5
    dataset = [{"prompt": f"sample {i}", "video": None, "vace_video": None}
               for i in range(2)]
    args.lora_base_model = "vace"
    args.max_steps = args.max_steps or 3

    for m in (pipe.dit, pipe.vace, pipe.vae, pipe.prompter.text_encoder):
        if m is not None:
            m.requires_grad_(False)
    base = pipe.vace if args.lora_base_model == "vace" else pipe.dit
    generator = torch.Generator("cpu").manual_seed(args.seed)
    lora = init_lora(base, rank=args.lora_rank,
                     targets=lora_targets(args.lora_target_modules,
                                          args.lora_base_model),
                     generator=generator)
    rename = "vace_blocks" if args.lora_base_model == "vace" else None
    if args.lora_checkpoint:
        print(f"starting from the LoRA in {args.lora_checkpoint}")
        load_lora_checkpoint(lora, load_file(args.lora_checkpoint))
    apply_lora(base, lora)
    optimizer = adamw(lora_parameters(lora), args.learning_rate)
    logger = ModelLogger(args.output_path, save_steps=args.save_steps,
                         rename_blocks_to=rename)
    step_fn = make_train_step(
        pipe.dit, optimizer, training_scheduler(),
        vace=pipe.vace, min_tid=int(args.min_timestep_boundary * 1000),
        max_tid=int(args.max_timestep_boundary * 1000), remat=True)

    def preprocess(row):
        """The same units as inference (examples/train.py preprocess)."""
        with torch.no_grad():
            context = pipe.encode_prompt(row.get("prompt", ""))
            z = pipe.vae.cfg.z_dim
            up = pipe.vae.cfg.upsampling_factor
            shape = ((args.num_frames - 1) // 4 + 1, args.height // up,
                     args.width // up)
            if row.get("video") is None:
                rng = np.random.default_rng(0)
                latents = torch.from_numpy(rng.standard_normal(
                    (1, z) + shape).astype(np.float32)).to(pipe.device, pipe.dtype)
            else:
                latents = pipe.encode_video(_preprocess_images(row["video"]),
                                            tiled=False)
            vace_context = None
            if args.lora_base_model == "vace":
                vv = row.get("vace_video") or row.get("video")
                if vv is not None:
                    vace_context = pipe.build_vace_context(
                        vv, None, None, args.height, args.width,
                        args.num_frames, tiled=False)
                else:
                    vace_context = torch.zeros((1, 2 * z + 64) + shape,
                                               device=pipe.device, dtype=pipe.dtype)
        return latents, context, vace_context

    step_count = 0
    resumed_from = None
    if args.resume:
        resumed_from = latest_checkpoint(args.output_path)
        if resumed_from:
            step_count = restore_train_state(resumed_from, lora, optimizer,
                                             generator)
            # the LoRA files keep counting from the restored step (the JAX
            # CLI restarts the logger's count at 0 and overwrites step-1...)
            logger.num_steps = step_count
            print(f"resumed full train state at step {step_count} from "
                  f"{resumed_from}")
    losses = []
    for epoch in range(args.num_epochs):
        for row in dataset:
            if args.max_steps and step_count >= args.max_steps:
                break
            latents, context, vace_context = preprocess(row)
            loss = float(step_fn(latents, context, vace_context,
                                 generator=generator))
            step_count += 1
            losses.append(loss)
            print(f"epoch {epoch} step {step_count} loss {loss:.4f}")
            logger.on_step_end(lora)
            if args.save_steps and step_count % args.save_steps == 0:
                save_train_state(os.path.join(args.output_path,
                                              f"state-{step_count}.pt"),
                                 step_count, lora, optimizer, generator)
        logger.on_epoch_end(lora, epoch)
        if args.max_steps and step_count >= args.max_steps:
            break
    print(f"training done: {step_count} steps, checkpoints in {args.output_path}")
    return {"steps": step_count, "losses": losses, "resumed_from": resumed_from,
            "lora": lora}


if __name__ == "__main__":
    main()
