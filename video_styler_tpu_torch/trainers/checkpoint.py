"""Full train-state checkpoints: LoRA, AdamW state, step and generator.

Counterpart of `video_styler_tpu/trainers/checkpoint.py`, which round-trips
the state through orbax. Here one `torch.save` file per checkpoint,
`state-<step>.pt`, written atomically; resuming continues the same
sequence of timesteps and noise, since the generator's state is in it.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .lora_train import LoRA

_NAME = re.compile(r"^state-(\d+)\.pt$")


def save_train_state(path: str, step: int, lora: LoRA,
                     optimizer: torch.optim.Optimizer,
                     generator: Optional[torch.Generator] = None) -> str:
    state = {
        "step": int(step),
        "lora": {k: {n: p.detach().cpu() for n, p in ab.items()}
                 for k, ab in lora.items()},
        "optimizer": optimizer.state_dict(),
        "generator": None if generator is None else generator.get_state(),
    }
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


@torch.no_grad()
def restore_train_state(path: str, lora: LoRA, optimizer: torch.optim.Optimizer,
                        generator: Optional[torch.Generator] = None) -> int:
    """Load a checkpoint into `lora`, `optimizer` and `generator` (in place);
    returns its step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if set(state["lora"]) != set(lora):
        raise KeyError(f"{path}: LoRA targets differ from the model's")
    for k, ab in lora.items():
        for n, p in ab.items():
            p.copy_(state["lora"][k][n])
    optimizer.load_state_dict(state["optimizer"])
    if generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
    return int(state["step"])


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The 'state-<step>.pt' file of the highest step, or None."""
    if not os.path.isdir(output_dir):
        return None
    steps = [(int(m.group(1)), n) for n in os.listdir(output_dir)
             if (m := _NAME.match(n))]
    return os.path.join(output_dir, max(steps)[1]) if steps else None
