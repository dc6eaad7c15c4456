"""Trainable LoRA adapters on the port's modules (peft-equivalent).

Counterpart of `video_styler_tpu/trainers/lora_train.py`. A LoRA is a plain
dict {module path: {"A": (r, in), "B": (out, r)}} of fp32 `nn.Parameter`s in
the torch layout its export uses (`lora_A.weight`, `lora_B.weight`).
`apply_lora` puts a parametrization on each targeted `nn.Linear.weight`, so
every forward uses W' = bf16(W.f32 + scale * (B @ A).f32), rebuilt at each
use, as the JAX package materializes W + scale * A@B each step; gradients
flow into A and B only.

Targets are matched as in the JAX package, on paths without block indices
('blocks.3.self_attn.q' matches 'blocks.self_attn.q'). Export keys are
reference-style ('vace_blocks.{i}.self_attn.q.lora_A.weight' after the
logger's rename; 'ffn.0'/'ffn.2' for the FFN linears).
"""
from __future__ import annotations

import fnmatch
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from ..safetensors_io import save_file

# Ditto recipe targets (train.sh): q k v o ffn.0 ffn.2 on every block
DEFAULT_TARGETS = ("blocks.self_attn.q", "blocks.self_attn.k",
                   "blocks.self_attn.v", "blocks.self_attn.o",
                   "blocks.cross_attn.q", "blocks.cross_attn.k",
                   "blocks.cross_attn.v", "blocks.cross_attn.o",
                   "blocks.ffn.fc1", "blocks.ffn.fc2")

_TORCH_NAME = {"ffn.fc1": "ffn.0", "ffn.fc2": "ffn.2"}

LoRA = Dict[str, Dict[str, nn.Parameter]]


def lora_targets(modules: str, base: str) -> Tuple[str, ...]:
    """`--lora_target_modules` ("q,k,v,o,ffn.0,ffn.2") -> target paths, as
    examples/train.py `lora_targets` builds them."""
    name_map = {"ffn.0": "ffn.fc1", "ffn.2": "ffn.fc2"}
    targets = []
    for m in modules.split(","):
        m = name_map.get(m.strip(), m.strip())
        if "." in m:
            targets.append(f"blocks.{m}")
        else:
            targets.append(f"blocks.self_attn.{m}")
            targets.append(f"blocks.cross_attn.{m}")
    return tuple(targets)


def _target_linears(module: nn.Module,
                    targets: Tuple[str, ...]) -> Iterator[Tuple[str, nn.Linear]]:
    for name, m in module.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        pattern = re.sub(r"\.\d+(?=\.|$)", "", name)
        if any(fnmatch.fnmatch(pattern, t) or pattern == t for t in targets):
            yield name, m


def init_lora(module: nn.Module, rank: int = 128,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> LoRA:
    """A ~ N(0, 1/r) (drawn on the generator's device, CPU by default), B = 0:
    the standard LoRA init, in fp32 on the module's device."""
    lora: LoRA = {}
    for name, lin in _target_linears(module, targets):
        dev = lin.weight.device
        gdev = generator.device if generator is not None else "cpu"
        a = torch.randn((rank, lin.in_features), generator=generator,
                        device=gdev, dtype=torch.float32) / rank
        lora[name] = {
            "A": nn.Parameter(a.to(dev)),
            "B": nn.Parameter(torch.zeros((lin.out_features, rank), device=dev)),
        }
    if not lora:
        raise ValueError(f"no LoRA targets matched {targets}")
    return lora


def lora_parameters(lora: LoRA) -> List[nn.Parameter]:
    """A and B of every target, in a fixed order (the optimizer's)."""
    return [ab[k] for ab in lora.values() for k in ("A", "B")]


class LoRAWeight(nn.Module):
    """Parametrization W -> (W.f32 + scale * (B @ A).f32).to(W.dtype)."""

    def __init__(self, a: nn.Parameter, b: nn.Parameter, scale: float):
        super().__init__()
        self.lora_A = a
        self.lora_B = b
        self.scale = scale

    def forward(self, w):
        delta = self.lora_B.float() @ self.lora_A.float()
        return (w.float() + self.scale * delta).to(w.dtype)


def apply_lora(module: nn.Module, lora: LoRA, scale: float = 1.0) -> nn.Module:
    """Freeze every parameter of `module` and put the LoRA on its targeted
    linears (in place); from then on gradients reach only A and B."""
    module.requires_grad_(False)
    for name, ab in lora.items():
        lin = module.get_submodule(name)
        if ab["A"].shape != (ab["A"].shape[0], lin.in_features) or \
                ab["B"].shape != (lin.out_features, ab["A"].shape[0]):
            raise ValueError(f"{name}: LoRA A {tuple(ab['A'].shape)} / B "
                             f"{tuple(ab['B'].shape)} do not fit {lin}")
        parametrize.register_parametrization(lin, "weight",
                                             LoRAWeight(ab["A"], ab["B"], scale))
    for p in lora_parameters(lora):
        p.requires_grad_(True)
    return module


def export_lora_state_dict(lora: LoRA, prefix: str = "") -> Dict[str, torch.Tensor]:
    """LoRA -> reference-style state dict of fp32 CPU tensors:
    '{prefix}blocks.{i}.ffn.0.lora_A.weight' (r, in), '...lora_B.weight'
    (out, r)."""
    out = {}
    for path, ab in lora.items():
        name = path
        for ours, theirs in _TORCH_NAME.items():
            name = name.replace(ours, theirs)
        out[f"{prefix}{name}.lora_A.weight"] = ab["A"].detach().float().cpu()
        out[f"{prefix}{name}.lora_B.weight"] = ab["B"].detach().float().cpu()
    return out


def save_lora_safetensors(lora: LoRA, path: str, prefix: str = ""):
    save_file(export_lora_state_dict(lora, prefix=prefix), path)
