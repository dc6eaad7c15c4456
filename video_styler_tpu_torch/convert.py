"""Turn the JAX package's parameter trees into the port's modules.

`from_jax_params(kind, tree, cfg)` takes a JAX parameter pytree whose
leaves were converted to numpy (`jax.tree_util.tree_map(np.asarray, p)`)
and returns the port's module for `kind`:

  "dit"  -> models.wan_dit.WanDiT       (cfg: WanDiTConfig)
  "vace" -> models.wan_vace.WanVace     (cfg: VaceConfig)
  "t5"   -> models.t5.T5Encoder         (cfg: T5Config)
  "vae"  -> models.wan_vae.WanVAE       (cfg: WanVAEConfig), or
            models.wan_vae.WanVAE38     (cfg: WanVAE38Config, the Wan2.2 VAE)
  "clip" -> models.clip_vit.ClipVit     (cfg: ClipVitConfig)

`from_jax_lora(lora)` turns a JAX LoRA pytree (`trainers.lora_train
.init_lora`: {path: {"A": (L, in, r), "B": (L, r, out)}}, stacked over
blocks) into the port's per-block factors in torch layout.

The layouts that differ: JAX linears store `w` as (in, out) and
`nn.Linear` stores `weight` as (out, in); the stacked `blocks` (and VACE
`after_proj`) trees carry a leading layer axis that becomes the index of an
`nn.ModuleList` (the CLIP tower's `blocks` are a dict keyed by index, the
same names). VAE conv weights are already OIDHW and keep their names.
bfloat16 and float8_e4m3fn leaves (ml_dtypes) keep their bits.

A tree quantised by the JAX package's `quantize_params` (linear leaves
`w_q` or `w_q4`, `w_scale`, `b`) converts too: each such leaf becomes an
`ops.quant.QuantLinear` holding the same integers and scales in the same
(in, out) layout, so both packages can run on identical quantised weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device
from .models.clip_vit import ClipVit
from .models.t5 import T5Encoder
from .models.wan_dit import WanDiT
from .models.wan_vace import WanVace
from .models.wan_vae import WanVAE, WanVAE38, WanVAE38Config
from .ops.quant import QuantLinear

_MODULES = {"dit": WanDiT, "vace": WanVace, "t5": T5Encoder, "vae": WanVAE,
            "clip": ClipVit}
_STACKED = ("blocks", "after_proj")


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _flatten(node, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def jax_tree_to_state_dict(tree, stacked: bool) -> Dict[str, torch.Tensor]:
    """Dotted torch names -> tensors. stacked: the `blocks`/`after_proj`
    subtrees carry a leading layer axis (DiT, VACE)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    quantized = {name.rsplit(".", 1)[0] for name in flat
                 if name.endswith((".w_q", ".w_q4"))}
    sd = {}
    for name, arr in flat.items():
        parts = name.split(".")
        items = [(parts, arr)]
        if stacked and parts[0] in _STACKED:
            items = [([parts[0], str(i)] + parts[1:], arr[i])
                     for i in range(arr.shape[0])]
        for p, a in items:
            if p[-1] == "w":
                p, a = p[:-1] + ["weight"], a.T
            elif p[-1] == "b" and name.rsplit(".", 1)[0] not in quantized:
                p = p[:-1] + ["bias"]
            sd[".".join(p)] = _to_tensor(a)
    return sd


def _swap_in_quant_linears(module: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """Replace each linear whose leaf arrived quantised by a `QuantLinear`
    holding that leaf's tensors."""
    for key in [k for k in sd if k.endswith((".w_q", ".w_q4"))]:
        path, kind = key.rsplit(".", 1)
        parent, _, name = path.rpartition(".")
        layer = QuantLinear(**{kind: sd.pop(key)}, w_scale=sd.pop(f"{path}.w_scale"),
                            b=sd.pop(f"{path}.b", None))
        setattr(module.get_submodule(parent) if parent else module, name, layer)
        for buf in ("w_q", "w_q4", "w_scale", "b"):
            if getattr(layer, buf) is not None:
                sd[f"{path}.{buf}"] = getattr(layer, buf)


def from_jax_params(kind: str, tree, cfg, device=None) -> torch.nn.Module:
    """The port's `kind` module holding the JAX tree's values (strict), on
    `device` (the card unless "cpu", as every entry point)."""
    device = resolve_device(device)
    if kind not in _MODULES:
        raise ValueError(f"unknown model kind {kind!r}; one of {sorted(_MODULES)}")
    sd = jax_tree_to_state_dict(tree, stacked=kind in ("dit", "vace"))
    cls = WanVAE38 if isinstance(cfg, WanVAE38Config) else _MODULES[kind]
    with torch.device("meta"):
        module = cls(cfg)
    _swap_in_quant_linears(module, sd)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device).eval()


def from_jax_lora(lora):
    """JAX LoRA pytree (numpy or jax leaves) -> the port's LoRA dict
    {'blocks.{i}.self_attn.q': {"A": (r, in), "B": (out, r)}} of fp32
    `nn.Parameter`s, ready for `trainers.lora_train.apply_lora`."""
    out = {}
    for path, ab in lora.items():
        a = np.asarray(ab["A"], np.float32)
        b = np.asarray(ab["B"], np.float32)
        if a.ndim == 3:
            head, tail = path.split("blocks.", 1)
            items = [(f"{head}blocks.{i}.{tail}", a[i], b[i]) for i in range(a.shape[0])]
        else:
            items = [(path, a, b)]
        for name, ai, bi in items:
            out[name] = {k: torch.nn.Parameter(torch.from_numpy(
                np.ascontiguousarray(x.T))) for k, x in (("A", ai), ("B", bi))}
    return out
