"""Training: the flow-match loss and a LoRA train step.

Counterpart of `video_styler_tpu/trainers/training.py`: a random training
timestep in [min_tid, max_tid), add_noise, the DiT (+VACE) forward with
rematerialised blocks, and the bell-weighted MSE against (noise - x0).
The JAX loss draws `tid` and the noise from a `jax.random` key; here they
come from an explicit CPU `torch.Generator` (the same draws on every
device), or from the caller.

The optimizer is `adamw`: torch's AdamW with optax.adamw's defaults
(betas 0.9/0.999, eps 1e-8, weight decay 1e-4; torch's default decay is
1e-2).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..models.wan_dit import WanDiT, wan_dit_forward
from ..schedulers.flow_match import FlowMatchScheduler


def adamw(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.AdamW:
    """torch AdamW with optax.adamw's defaults."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def training_scheduler() -> FlowMatchScheduler:
    """The Ditto trainer's scheduler: shift 5, 1000 training timesteps, bell
    weights (examples/train.py)."""
    sched = FlowMatchScheduler(shift=5.0, sigma_min=0.0, extra_one_step=True)
    sched.set_timesteps(1000, training=True)
    return sched


def flow_match_loss(dit: WanDiT, latents, context, sigmas: np.ndarray,
                    timesteps: np.ndarray, weights: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    tid: Optional[int] = None, noise: Optional[torch.Tensor] = None,
                    min_tid: int = 0, max_tid: Optional[int] = None,
                    vace=None, vace_context=None,
                    remat: bool = True) -> torch.Tensor:
    """One loss evaluation (0-dim fp32 tensor).

    latents: (B, C, F, H, W) clean latents; sigmas/timesteps/weights: the
    1000-entry tables of a training scheduler. tid and noise are drawn from
    `generator` (tid first, then the fp32 noise, on the CPU) unless given."""
    max_tid = max_tid if max_tid is not None else len(sigmas)
    if tid is None:
        tid = int(torch.randint(min_tid, max_tid, (), generator=generator))
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32)
    dev = latents.device
    noise = noise.to(dev, torch.float32)
    sigma = torch.tensor(sigmas[tid], dtype=torch.float32, device=dev)
    lat_f = latents.float()
    noisy = ((1 - sigma) * lat_f + sigma * noise).to(latents.dtype)
    timestep = torch.tensor([timesteps[tid]], dtype=torch.float32, device=dev)
    pred = wan_dit_forward(dit, noisy, timestep, context, vace=vace,
                           vace_context=vace_context, remat=remat)
    loss = torch.mean(torch.square(pred.float() - (noise - lat_f)))
    return loss * torch.tensor(weights[tid], dtype=torch.float32, device=dev)


def make_train_step(dit: WanDiT, optimizer: torch.optim.Optimizer,
                    scheduler: FlowMatchScheduler, vace=None,
                    min_tid: int = 0, max_tid: Optional[int] = None,
                    remat: bool = True) -> Callable:
    """(latents, context, vace_context=None, generator=None, tid=None,
    noise=None) -> loss: one loss, backward and optimizer step over the
    optimizer's (LoRA) parameters, with the tables of a training
    `scheduler`. The gradients stay in `.grad` until the next step."""
    tables = (scheduler.sigmas, scheduler.timesteps,
              scheduler.linear_timesteps_weights)

    def step(latents, context, vace_context=None, generator=None, tid=None,
             noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = flow_match_loss(dit, latents, context, *tables,
                               generator=generator, tid=tid, noise=noise,
                               min_tid=min_tid, max_tid=max_tid, vace=vace,
                               vace_context=vace_context, remat=remat)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
