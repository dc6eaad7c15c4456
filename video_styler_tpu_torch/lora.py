"""LoRA loading and merging into the port's modules.

Counterpart of `video_styler_tpu/lora.py` (`extract_lora_pairs` :25,
`merge_lora` :81): a LoRA state dict is resolved against a module by name
and merged in place, W += alpha * (B @ A) in fp32, cast back to W's dtype.
Reference names look like 'blocks.0.self_attn.q' or 'vace_blocks.1.ffn.0';
in the port they become 'blocks.0.self_attn.q' and 'blocks.1.ffn.fc1'.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu()
    return torch.from_numpy(np.asarray(t, dtype=np.float32))


def extract_lora_pairs(lora_sd: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Collect {target_name: (A, B)} from a LoRA state dict.

    The key styles of the JAX package: '...lora_B.weight'/'...lora_A.weight',
    the peft '...lora_B.default.weight' variant, and diffusers
    '...lora.up/down.weight'."""
    pairs = {}
    for key in lora_sd:
        for b_tag, a_tag in (("lora_B", "lora_A"), ("lora.up", "lora.down")):
            if b_tag in key:
                a_key = key.replace(b_tag, a_tag)
                if a_key not in lora_sd:
                    continue
                target = key.split(b_tag)[0].rstrip(".")
                for prefix in ("diffusion_model.", "transformer.", "model."):
                    if target.startswith(prefix):
                        target = target[len(prefix):]
                pairs[target] = (_tensor(lora_sd[a_key]), _tensor(lora_sd[key]))
    return pairs


def module_path(target: str) -> str:
    """Reference module name -> the port's ('vace_blocks.1.ffn.0' ->
    'blocks.1.ffn.fc1')."""
    path = re.sub(r"^vace_blocks\.", "blocks.", target)
    return re.sub(r"\.ffn\.(0|2)(?=\.|$)",
                  lambda m: ".ffn.fc1" if m.group(1) == "0" else ".ffn.fc2", path)


@torch.no_grad()
def merge_lora(module: nn.Module, lora_sd: Dict, alpha: float = 1.0) -> nn.Module:
    """Merge W += alpha * (B @ A) into `module`'s linears (in place)."""
    pairs = extract_lora_pairs(lora_sd)
    if not pairs:
        raise ValueError("no LoRA A/B pairs found in state dict")
    for target, (a, b) in pairs.items():
        try:
            lin = module.get_submodule(module_path(target))
        except AttributeError as e:
            raise KeyError(f"cannot resolve LoRA target '{target}'") from e
        if hasattr(lin, "w_scale"):
            # the JAX merge fails on a quantised leaf too (it has no "w")
            raise KeyError(f"LoRA target '{target}' is quantized: quantize "
                           "must run after LoRA merging")
        if not isinstance(lin, nn.Linear):
            raise KeyError(f"LoRA target '{target}' is not a linear layer")
        w = lin.weight
        delta = (b @ a) * alpha                                  # (out, in)
        w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
    return module
