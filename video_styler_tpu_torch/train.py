"""LoRA training CLI of the PyTorch/CUDA port (the train.sh surface).

    python -m video_styler_tpu_torch.train --smoke --device cpu --max_steps 2
    python -m video_styler_tpu_torch.train \\
        --dit_path "diffusion_pytorch_model-00001-of-00007.safetensors|..." \\
        --vae_path Wan2.1_VAE.pth --t5_path models_t5_umt5-xxl-enc-bf16.pth \\
        --dataset_base_path data --dataset_metadata_path data/metadata_vace.csv \\
        --extra_inputs vace_video --height 480 --width 832 --num_frames 41 \\
        --lora_base_model vace --lora_rank 128 --output_path out
    (the same) --task data_process --output_path cache   # encode once
    (the same) --cache_path cache --output_path out      # train from it

Counterpart of examples/train.py, with its flags. The models come from
checkpoint files: --dit_path ('|'-separated shards), --vae_path, --t5_path,
--tokenizer_path, or --model_id_with_origin_paths "id:pattern,..." found
under $VIDEO_STYLER_MODEL_DIR (fetched there when missing, unless
VIDEO_STYLER_OFFLINE=1: `utils.model_config`). Samples come from
CSV/JSON/JSONL metadata through `UnifiedDataset`: the `video` column and
the --extra_inputs columns are loaded as frames, the rows repeated
--dataset_repeat times. The same units as inference prepare each sample
(umT5 prompt encode, VAE encode of the video, the VACE context);
`--task data_process` writes those inputs to a latent cache under
--output_path, and `--cache_path` trains from one. While it trains, umT5
waits on the host between prompt encodes (from a cache, umT5 and the VAE
are not needed at all and stay there), so that their device memory goes to
the steps. Then the flow-match loss on a random training timestep with
rematerialised DiT blocks, AdamW with optax.adamw's defaults, LoRA
safetensors every `--save_steps` (or per epoch), and full train-state
checkpoints for `--resume`. The Ditto recipe
is `--lora_base_model vace --lora_rank 128 --lora_target_modules
q,k,v,o,ffn.0,ffn.2`.

--smoke trains on the tiny random pipeline of `infer_ditto --smoke` with
synthetic samples. Runs on `cuda` unless --device cpu. As examples/train.py
(:236-239, :281-282), the step's latents, context and VACE context are
fp32 on the pipeline's (bf16) weights, each linear casting its weight to
fp32: on the card attention, RMSNorm+RoPE and RMSNorm run their float32
kernels (K1f, K3f/K3q-f, K4f, K5f), on the CPU their plain versions.
At that precision one 80 GB card fits the step up to 41 frames of 480x832
(73 and 57 run out of its memory, and the CLI says so); a longer clip
trains on the streamed trunk (`trainers/streaming_train.py`,
`StreamingTrainer`, bf16 activations).
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np

# the most frames of 480x832 whose fp32 LoRA step fits one 80 GB card (73
# and 57 run out of memory)
ONE_CARD_FRAMES = 41


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA training (PyTorch/CUDA)")
    p.add_argument("--dataset_base_path", type=str, default="")
    p.add_argument("--dataset_metadata_path", type=str, default=None)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81,
                   help="frames (4k+1) of each clip. The step runs the recipe's fp32 "
                        f"activations: one 80 GB card fits at most {ONE_CARD_FRAMES} "
                        "frames of 480x832; longer clips train on the streamed trunk "
                        "(trainers/streaming_train.py: StreamingTrainer, bf16 "
                        "activations)")
    p.add_argument("--dataset_repeat", type=int, default=1)
    p.add_argument("--dit_path", type=str, default=None)
    p.add_argument("--model_id_with_origin_paths", type=str, default=None,
                   help='"id:pattern,id:pattern", resolved under '
                        '$VIDEO_STYLER_MODEL_DIR, fetched when missing')
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
    p.add_argument("--extra_inputs", type=str, default=None,
                   help="more file columns of the metadata to load as frames "
                        "(vace_video)")
    p.add_argument("--max_timestep_boundary", type=float, default=1.0)
    p.add_argument("--min_timestep_boundary", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task", type=str, default="train",
                   choices=["train", "data_process"],
                   help="data_process: run the encoders once and write each "
                        "sample's inputs as .npz under --output_path")
    p.add_argument("--cache_path", type=str, default=None,
                   help="train from a latent cache that --task data_process "
                        "wrote (no VAE or umT5 encode)")
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


def build_pipeline(args):
    """The pipeline from --dit_path/--vae_path/--t5_path and
    --model_id_with_origin_paths, on --device."""
    from .pipelines.wan_video import WanVideoPipeline
    from .utils.model_config import ModelConfig
    mcs = [ModelConfig(path=p.split("|")) for p in
           (args.dit_path, args.vae_path, args.t5_path) if p]
    if args.model_id_with_origin_paths:
        for spec in args.model_id_with_origin_paths.split(","):
            mid, pat = spec.split(":", 1)
            mcs.append(ModelConfig(model_id=mid, origin_file_pattern=pat))
    return WanVideoPipeline.from_pretrained(mcs, tokenizer_path=args.tokenizer_path,
                                            device=args.device)


def build_dataset(args):
    """`UnifiedDataset` over --dataset_metadata_path: the `video` and
    --extra_inputs columns loaded as frames at --height x --width."""
    from .trainers.unified_dataset import UnifiedDataset
    keys = ["video"] + (args.extra_inputs.split(",") if args.extra_inputs else [])
    op = UnifiedDataset.default_video_operator(
        args.dataset_base_path, num_frames=args.num_frames, height=args.height,
        width=args.width)
    return UnifiedDataset(base_path=args.dataset_base_path,
                          metadata_path=args.dataset_metadata_path,
                          repeat=args.dataset_repeat, data_file_keys=tuple(keys),
                          main_data_operator=op)


def preprocess(pipe, row, args, text_encoder=contextlib.nullcontext()):
    """One dataset row's training inputs {"latents", "context",
    "vace_context"} by the same units as inference (examples/train.py
    preprocess): the umT5 prompt encode (inside `text_encoder`, the context
    that puts umT5 on the device), the VAE encode of `video` and, for a VACE
    LoRA, the VACE context of `vace_video` (else `video`). A row without
    video gets seeded fp32 noise latents and a zero fp32 VACE context, as
    examples/train.py makes them.

    The VAE encodes stream (`tiled=True`: frame 0, then 4-frame chunks with
    the causal caches carried, exact against the whole-clip encode), where
    examples/train.py encodes the whole clip at once (`tiled=False`): at
    480x832x73 that form's activations do not fit one 80 GB card beside
    the DiT and VACE (one conv's padded input alone is 21.4 GiB)."""
    import torch
    from .pipelines.wan_video import _preprocess_images
    with torch.no_grad():
        with text_encoder:
            context = pipe.encode_prompt(row.get("prompt", ""))
        z = pipe.vae.cfg.z_dim
        up = pipe.vae.cfg.upsampling_factor
        shape = ((args.num_frames - 1) // 4 + 1, args.height // up, args.width // up)
        if row.get("video") is None:
            rng = np.random.default_rng(0)
            latents = torch.from_numpy(rng.standard_normal(
                (1, z) + shape).astype(np.float32)).to(pipe.device)
        else:
            latents = pipe.encode_video(_preprocess_images(row["video"]), tiled=True)
        vace_context = None
        if args.lora_base_model == "vace":
            vv = row.get("vace_video") or row.get("video")
            if vv is not None:
                vace_context = pipe.build_vace_context(
                    vv, None, None, args.height, args.width, args.num_frames,
                    tiled=True)
            else:
                vace_context = torch.zeros((1, 2 * z + 64) + shape,
                                           device=pipe.device, dtype=torch.float32)
    return {"latents": latents, "context": context, "vace_context": vace_context}


def fp32_inputs(inputs):
    """The step's inputs cast to fp32 (None stays None), as
    examples/train.py:281-282 casts them: the one cast of the CLI's inputs
    (a row's encodes come in the pipeline's dtype, a cache's arrays and the
    seeded noise in fp32)."""
    return {k: None if v is None else v.float() for k, v in inputs.items()}


def cached_inputs(pipe, row):
    """A latent cache sample's fp32 arrays as tensors on the pipeline's
    device."""
    import torch
    return {k: None if row.get(k) is None else torch.from_numpy(row[k]).to(pipe.device)
            for k in ("latents", "context", "vace_context")}


class HostParked:
    """A frozen module whose weights wait on the host and come to the device
    only inside `with parked:`, so that between uses its device memory
    (umT5-XXL's ~10.6 GiB) goes to the training steps. The host copy is
    taken once, pinned beside a card: leaving the block drops the device
    copy and copies nothing back. On the CPU it does nothing."""

    def __init__(self, module):
        import torch
        self.tensors = list(module.parameters()) + list(module.buffers())
        self.device = self.tensors[0].device
        if self.device.type == "cpu":
            self.host = [t.data for t in self.tensors]
            return
        self.host = []
        for t in self.tensors:
            self.host.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            self.host[-1].copy_(t.data)
        self.__exit__()
        torch.cuda.empty_cache()

    def __enter__(self):
        for t, h in zip(self.tensors, self.host):
            t.data = h.to(self.device, non_blocking=True)
        return self

    def __exit__(self, *exc):
        for t, h in zip(self.tensors, self.host):
            t.data = h


def park_encoders(pipe, cache_fed: bool):
    """Give the encoders' device memory to the training steps. Fed from a
    latent cache, neither umT5 nor the VAE runs again: both go to the host.
    Else umT5 waits on the host between prompt encodes, and the returned
    context brings it back for one; the VAE (~0.5 GB) stays."""
    import torch
    if not cache_fed:
        t5 = pipe.prompter.text_encoder
        return contextlib.nullcontext() if t5 is None else HostParked(t5)
    for m in (pipe.prompter.text_encoder, pipe.vae):
        if m is not None:
            m.to("cpu")
    if torch.device(pipe.device).type == "cuda":
        torch.cuda.empty_cache()
    return contextlib.nullcontext()


def main(argv=None):
    p, args = parse_args(argv)
    import torch
    from .trainers.checkpoint import (latest_checkpoint, restore_train_state,
                                      save_train_state)
    from .trainers.latent_cache import CachedLatentDataset, launch_data_process_task
    from .trainers.logger import ModelLogger
    from .trainers.lora_train import (apply_lora, init_lora, lora_parameters,
                                      lora_targets)
    from .trainers.training import adamw, make_train_step, training_scheduler
    from .utils.ckpt import load_state_dict

    if args.smoke:
        from .infer_ditto import build_smoke_pipeline
        pipe = build_smoke_pipeline(device=args.device)
        args.height, args.width, args.num_frames = 32, 32, 5
        dataset = [{"prompt": f"sample {i}", "video": None, "vace_video": None}
                   for i in range(2)]
        args.lora_base_model = "vace"
        args.max_steps = args.max_steps or 3
    elif not (args.dit_path or args.model_id_with_origin_paths):
        p.error("--dit_path is required (or use --smoke)")
    elif not (args.dataset_metadata_path or (args.cache_path and args.task == "train")):
        p.error("--dataset_metadata_path is required (or --cache_path to train "
                "from a latent cache)")
    else:
        pipe = build_pipeline(args)
        dataset = build_dataset(args) if args.dataset_metadata_path else None

    if args.task == "data_process":
        written = launch_data_process_task(dataset, lambda row: preprocess(pipe, row, args),
                                           args.output_path)
        print(f"data process done: {len(written)} samples cached in {args.output_path}")
        return {"written": written}

    if args.cache_path:
        dataset = CachedLatentDataset(args.cache_path, repeat=args.dataset_repeat)

    for m in (pipe.dit, pipe.vace, pipe.vae, pipe.prompter.text_encoder):
        if m is not None:
            m.requires_grad_(False)
    text_encoder = park_encoders(pipe, cache_fed=bool(args.cache_path))
    base = pipe.vace if args.lora_base_model == "vace" else pipe.dit
    generator = torch.Generator("cpu").manual_seed(args.seed)
    lora = init_lora(base, rank=args.lora_rank,
                     targets=lora_targets(args.lora_target_modules,
                                          args.lora_base_model),
                     generator=generator)
    rename = "vace_blocks" if args.lora_base_model == "vace" else None
    if args.lora_checkpoint:
        print(f"starting from the LoRA in {args.lora_checkpoint}")
        load_lora_checkpoint(lora, load_state_dict(args.lora_checkpoint))
    apply_lora(base, lora)
    optimizer = adamw(lora_parameters(lora), args.learning_rate)
    logger = ModelLogger(args.output_path, save_steps=args.save_steps,
                         rename_blocks_to=rename)
    step_fn = make_train_step(
        pipe.dit, optimizer, training_scheduler(),
        vace=pipe.vace, min_tid=int(args.min_timestep_boundary * 1000),
        max_tid=int(args.max_timestep_boundary * 1000), remat=True)

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
        for i in range(len(dataset)):
            if args.max_steps and step_count >= args.max_steps:
                break
            row = dataset[i]
            inputs = fp32_inputs(cached_inputs(pipe, row) if args.cache_path else
                                 preprocess(pipe, row, args, text_encoder))
            try:
                loss = float(step_fn(inputs["latents"], inputs["context"],
                                     inputs["vace_context"], generator=generator))
            except torch.cuda.OutOfMemoryError as e:
                raise torch.cuda.OutOfMemoryError(
                    f"the fp32 LoRA step of {args.num_frames} frames of {args.height}x"
                    f"{args.width} does not fit the card: one 80 GB card fits at most "
                    f"{ONE_CARD_FRAMES} frames of 480x832 at the recipe's fp32 "
                    "activations; give fewer --num_frames, or train the clip on the "
                    "streamed trunk (trainers/streaming_train.py: StreamingTrainer, "
                    "bf16 activations)") from e
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
