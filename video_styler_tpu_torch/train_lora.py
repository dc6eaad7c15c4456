"""LoRA training recipes of the image families (FLUX, SD3, Qwen-Image, SD,
SDXL) in the PyTorch/CUDA port.

    python -m video_styler_tpu_torch.train_lora --family flux --smoke --device cpu
    python -m video_styler_tpu_torch.train_lora --family sdxl --smoke --steps 4 \\
        --rank 8 --lr 1e-3 --output_path sdxl_lora.safetensors

Counterpart of the JAX package's `examples/families/<family>/train_lora.py`
recipes. `--smoke` trains a LoRA on a tiny random model for `--steps`
Adam steps at `--lr` and saves it as safetensors under the reference's
names (`blocks.{i}.attn.a_to_qkv.lora_A.weight`, ...):

  - flux, sd3, qwen_image: the family's tiny DiT (FLUX_DIT_TINY,
    SD3_DIT_TINY, QWEN_IMAGE_TINY) with a LoRA of `--rank` on every linear,
    trained with the flow-match objective (`trainers.image_training`) on
    random latents and conditioning. Qwen-Image's DiT gets the timestep
    divided by 1000, as its pipeline passes it (the JAX recipe passes the
    training timestep itself, which the DiT then embeds at up to 10^6);
  - sd, sdxl: a stand-in attention block of four 8x8 projections (`to_q`,
    `to_k`, `to_v`, `to_out`) with the UNet LoRA's targets, trained with
    the DDIM epsilon objective (`trainers.sd_training`); the real UNets
    train through the same step.

Without `--smoke` it prints how a real run goes and exits. Runs on `cuda`
unless `--device cpu`. The models and inputs are fp32, as in the JAX
recipes (on the card FLUX and Qwen-Image attend through K1f and K3f). On
the card the tiny DiTs take heads of 128 (FLUX and Qwen-Image: dim 256, 2
heads), since the attention kernels take a head dim of 128 only; on the
CPU they keep the JAX recipe's widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

FAMILIES = ("flux", "sd3", "qwen_image", "sd", "sdxl")
STANDIN_DIM = 8          # the SD stand-in's width
TEXT_ROWS = 8            # the DiT smoke's context rows


class SDStandIn(nn.Module):
    """The SD recipes' stand-in UNet: one block of four bias-free d x d
    projections, out = ((h q + h k + h v) o) + 0.01 mean(ctx) on the
    latents' rows of d."""

    def __init__(self, d: int = STANDIN_DIM):
        super().__init__()
        self.d = d
        block = nn.ModuleDict({n: nn.Linear(d, d, bias=False)
                               for n in ("to_q", "to_k", "to_v", "to_out")})
        self.blocks = nn.ModuleList([block])

    def forward(self, sample, timestep, ctx):
        del timestep
        b = self.blocks[0]
        h = sample.reshape(sample.shape[0], -1, self.d)
        h = b["to_out"](b["to_q"](h) + b["to_k"](h) + b["to_v"](h))
        return (h + 0.01 * ctx.mean()).reshape(sample.shape)


def _randn(seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale


def card_config(cfg):
    """A tiny FLUX or Qwen-Image config widened to heads of 128 (dim 256, 2
    heads, FLUX's RoPE axes), what the card's attention kernel takes."""
    return dataclasses.replace(cfg, dim=256, num_heads=2, axes_dim=(16, 56, 56))


def smoke_pack(family: str, device="cpu", dtype=torch.float32, card_widths: bool = False,
               remat: bool = False) -> Tuple[nn.Module, Callable, torch.Tensor, object]:
    """(model, forward_fn(noisy, timestep, context), latents, context) of a
    family's tiny training loop: seeded random weights (drawn on the CPU in
    fp32, then moved), the model frozen. card_widths: FLUX and Qwen-Image
    at heads of 128 (`card_config`)."""
    from .models import flux_dit as FD
    from .models import qwen_image_dit as QD
    from .models import sd3_dit as SD
    gen = torch.Generator().manual_seed(0)
    if family in ("sd", "sdxl"):
        model = SDStandIn()
        with torch.no_grad():
            for lin in model.blocks[0].values():
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.1)
        latents = _randn(4, (2, 4, STANDIN_DIM, STANDIN_DIM), 0.1)
        ctx = torch.zeros((2, 7, STANDIN_DIM))
        fwd = model
    elif family == "flux":
        cfg = card_config(FD.FLUX_DIT_TINY) if card_widths else FD.FLUX_DIT_TINY
        model = FD.init_flux_dit_(FD.FluxDiT(cfg), gen)
        ctx = {"emb": _randn(1, (1, TEXT_ROWS, cfg.context_dim)),
               "pooled": _randn(2, (1, cfg.pooled_dim))}
        text_ids = np.zeros((TEXT_ROWS, 3))

        def fwd(x, t, c):
            return FD.flux_dit_forward(model, x, t, c["emb"], c["pooled"], text_ids=text_ids,
                                       remat=remat)
        latents = _randn(3, (1, 16, 8, 8), 0.3)
    elif family == "sd3":
        cfg = SD.SD3_DIT_TINY
        model = SD.init_sd3_dit_(SD.SD3DiT(cfg), gen)
        ctx = {"emb": _randn(1, (1, TEXT_ROWS, cfg.context_dim)),
               "pooled": _randn(2, (1, cfg.pooled_dim))}

        def fwd(x, t, c):
            return SD.sd3_dit_forward(model, x, t, c["emb"], c["pooled"], remat=remat)
        latents = _randn(3, (1, 16, 8, 8), 0.3)
    elif family == "qwen_image":
        cfg = card_config(QD.QWEN_IMAGE_TINY) if card_widths else QD.QWEN_IMAGE_TINY
        model = FD.init_flux_dit_(QD.QwenImageDiT(cfg), gen)
        ctx = {"emb": _randn(1, (1, TEXT_ROWS, cfg.text_dim))}

        def fwd(x, t, c):
            # the DiT takes the timestep / 1000, as the pipeline passes it
            return QD.qwen_image_dit_forward(model, x, t / 1000.0, c["emb"], remat=remat)
        latents = _randn(3, (1, 16, 8, 8), 0.3)
    else:
        raise KeyError(family)
    model = model.to(device, dtype).requires_grad_(False)
    latents = latents.to(device, dtype)
    ctx = (ctx.to(device, dtype) if isinstance(ctx, torch.Tensor)
           else {k: v.to(device, dtype) for k, v in ctx.items()})
    return model, fwd, latents, ctx


def lora_setup(family: str, model: nn.Module, rank: int, seed: int = 1):
    """The family's LoRA (every linear of a DiT, the attention projections
    of an SD UNet), drawn from `seed` and put on `model`."""
    from .trainers.lora_train import apply_lora, init_lora
    from .trainers.sd_training import SD_TARGETS
    targets = SD_TARGETS if family in ("sd", "sdxl") else ("*",)
    lora = init_lora(model, rank=rank, targets=targets,
                     generator=torch.Generator().manual_seed(seed))
    apply_lora(model, lora)
    return lora


def make_step(family: str, fwd: Callable, optimizer: torch.optim.Optimizer) -> Callable:
    """The family's train step: DDIM epsilon for sd/sdxl, flow match else."""
    if family in ("sd", "sdxl"):
        from .trainers.sd_training import make_sd_lora_train_step
        return make_sd_lora_train_step(fwd, optimizer)
    from .trainers.image_training import make_image_lora_train_step
    return make_image_lora_train_step(fwd, optimizer)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="image-family LoRA training (PyTorch/CUDA)")
    ap.add_argument("--family", required=True, choices=FAMILIES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Optional[list]:
    args = parse_args(argv)
    family = args.family
    if not args.smoke:
        print(f"real runs: load the {family} checkpoint through its pipeline "
              f"(image_gen --family ...), cache latents with trainers/latent_cache.py, "
              f"then train with this recipe's step once paths are wired; --smoke runs "
              f"the whole loop on a tiny model")
        return None
    from .device import resolve_device
    from .trainers.lora_train import lora_parameters, save_lora_safetensors
    device = resolve_device(args.device)
    model, fwd, latents, ctx = smoke_pack(family, device, card_widths=device.type == "cuda")
    lora = lora_setup(family, model, args.rank)
    step = make_step(family, fwd, torch.optim.Adam(lora_parameters(lora), lr=args.lr))
    gen = torch.Generator().manual_seed(10)
    losses = [float(step(latents, ctx, generator=gen)) for _ in range(args.steps)]
    print(f"[{family}] {args.steps} LoRA steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"{family}: non-finite training loss {losses}")
    out = args.output_path or os.path.join(tempfile.gettempdir(),
                                           f"{family}_lora_smoke.safetensors")
    save_lora_safetensors(lora, out)
    print(f"saved LoRA -> {out}")
    return losses


if __name__ == "__main__":
    main()
