"""SD / SDXL LoRA training: the text-to-image trainer's objective.

Counterpart of `video_styler_tpu/trainers/sd_training.py` (the reference's
LightningModelForT2ILoRA): a random training timestep of the DDIM
schedule, `add_noise`, the MSE of the UNet's output against the noise
(epsilon) or against sqrt(a) * noise - sqrt(1 - a) * x (v-prediction),
gradients into the LoRA only. The LoRA is put on the UNet beforehand
(`init_sd_lora`, then `trainers.lora_train.apply_lora` with the scale);
`tid` and the noise come from an explicit CPU `torch.Generator` (tid
first, then the fp32 noise), or from the caller.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..schedulers.ddim import EnhancedDDIMScheduler
from .lora_train import LoRA, init_lora

SD_TARGETS = ("*to_q", "*to_k", "*to_v", "*to_out*")


def make_sd_lora_train_step(unet_forward: Callable, optimizer: torch.optim.Optimizer,
                            scheduler: Optional[EnhancedDDIMScheduler] = None) -> Callable:
    """(latents, ctx, generator=None, tid=None, noise=None) -> loss: one
    loss, backward and optimizer step. unet_forward(sample, timestep, ctx)
    is the SD or SDXL forward with its extra conditioning bound; the
    timestep it gets is float(tid), shape (1,)."""
    if scheduler is None:
        scheduler = EnhancedDDIMScheduler()
    alphas = scheduler.alphas_cumprod
    n_train = scheduler.num_train_timesteps
    v_pred = scheduler.prediction_type == "v_prediction"

    def step(latents, ctx, generator: Optional[torch.Generator] = None,
             tid: Optional[int] = None, noise: Optional[torch.Tensor] = None):
        if tid is None:
            tid = int(torch.randint(0, n_train, (), generator=generator))
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32)
        dev = latents.device
        noise = noise.to(dev, torch.float32)
        optimizer.zero_grad(set_to_none=True)
        a = torch.tensor(alphas[tid], dtype=torch.float32, device=dev)
        lat_f = latents.float()
        noisy = torch.sqrt(a) * lat_f + torch.sqrt(1 - a) * noise
        target = torch.sqrt(a) * noise - torch.sqrt(1 - a) * lat_f if v_pred else noise
        pred = unet_forward(noisy.to(latents.dtype),
                            torch.tensor([float(tid)], dtype=torch.float32, device=dev), ctx)
        loss = torch.mean(torch.square(pred.float() - target))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def init_sd_lora(unet: nn.Module, rank: int = 4, targets: Tuple[str, ...] = SD_TARGETS,
                 generator: Optional[torch.Generator] = None) -> LoRA:
    """LoRA factors over the UNet's attention projections (the reference's
    `to_q,to_k,to_v,to_out` defaults)."""
    return init_lora(unet, rank=rank, targets=targets, generator=generator)
