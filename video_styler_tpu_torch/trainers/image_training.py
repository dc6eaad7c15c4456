"""Image-family LoRA training: the flow-match objective over any DiT
forward (FLUX, SD3, Qwen-Image).

Counterpart of `video_styler_tpu/trainers/image_training.py`. The step is
the Wan trainer's objective (`training.flow_match_loss`) over an opaque
`forward_fn(noisy_latents, timestep, context) -> velocity`: a random
training timestep, noisy = (1 - sigma) * x + sigma * noise, the MSE of the
velocity against (noise - x) times the timestep's weight. The LoRA is put
on the model beforehand (`trainers.lora_train.apply_lora`, every
`nn.Linear` with `targets=("*",)`), so the optimizer's parameters are its A
and B factors only. The JAX step draws `tid` and the noise from a
`jax.random` key; here they come from an explicit CPU `torch.Generator`
(tid first, then the fp32 noise), or from the caller.

SD / SDXL (epsilon or v-prediction UNets) train through
`trainers.sd_training.make_sd_lora_train_step`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..schedulers.flow_match import FlowMatchScheduler


def make_image_lora_train_step(forward_fn: Callable, optimizer: torch.optim.Optimizer,
                               scheduler: Optional[FlowMatchScheduler] = None) -> Callable:
    """(latents, context, generator=None, tid=None, noise=None) -> loss: one
    loss, backward and optimizer step over the optimizer's (LoRA)
    parameters. latents: (B, C, H, W) clean latents; context: whatever
    `forward_fn` takes as its conditioning. The default scheduler is the
    JAX step's: shift 3, 1000 training timesteps, bell weights. The
    gradients stay in `.grad` until the next step."""
    if scheduler is None:
        scheduler = FlowMatchScheduler(shift=3.0, extra_one_step=False)
        scheduler.set_timesteps(1000, training=True)
    sigmas, timesteps = scheduler.sigmas, scheduler.timesteps
    weights = scheduler.linear_timesteps_weights

    def step(latents, context, generator: Optional[torch.Generator] = None,
             tid: Optional[int] = None, noise: Optional[torch.Tensor] = None):
        if tid is None:
            tid = int(torch.randint(0, len(sigmas), (), generator=generator))
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32)
        dev = latents.device
        noise = noise.to(dev, torch.float32)
        optimizer.zero_grad(set_to_none=True)
        sigma = torch.tensor(sigmas[tid], dtype=torch.float32, device=dev)
        lat_f = latents.float()
        noisy = ((1 - sigma) * lat_f + sigma * noise).to(latents.dtype)
        timestep = torch.tensor([timesteps[tid]], dtype=torch.float32, device=dev)
        pred = forward_fn(noisy, timestep, context)
        loss = torch.mean(torch.square(pred.float() - (noise - lat_f)))
        loss = loss * torch.tensor(weights[tid], dtype=torch.float32, device=dev)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
