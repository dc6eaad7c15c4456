"""FLUX LoRA format converters.

Counterpart of `video_styler_tpu/flux_lora.py` (numpy only, as there):
public FLUX LoRAs ship in three key layouts --
  (a) DiffSynth/native: 'blocks.N.attn.a_to_qkv.lora_A.weight' (passthrough),
  (b) kohya/civitai:    'lora_unet_double_blocks_N_img_mod_lin.lora_down.weight',
  (c) diffusers:        'transformer.transformer_blocks.N.attn.to_q.lora_A.weight'
      with separate q/k/v adapters fused block-diagonally into the fused qkv
      (and qkv+mlp for single blocks).
An '.alpha' entry rescales A and B by sqrt(alpha / rank) (`_guess_alpha`).
The result names the `FluxDiT`'s linears, which `lora.merge_lora` resolves.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np


def _np(t):
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


# leaf-name maps, shared by the A and B sides
_CIVITAI_LEAF = {
    "img_mod_lin": "norm1_a.linear", "txt_mod_lin": "norm1_b.linear",
    "img_attn_qkv": "attn.a_to_qkv", "txt_attn_qkv": "attn.b_to_qkv",
    "img_attn_proj": "attn.a_to_out", "txt_attn_proj": "attn.b_to_out",
    "img_mlp_0": "ff_a.0", "img_mlp_2": "ff_a.2",
    "txt_mlp_0": "ff_b.0", "txt_mlp_2": "ff_b.2",
    "modulation_lin": "norm.linear", "linear1": "to_qkv_mlp",
    "linear2": "proj_out",
}

_DIFFUSERS_JOINT_LEAF = {
    "attn.to_q": "attn.a_to_q", "attn.to_k": "attn.a_to_k",
    "attn.to_v": "attn.a_to_v", "attn.to_out.0": "attn.a_to_out",
    "attn.add_q_proj": "attn.b_to_q", "attn.add_k_proj": "attn.b_to_k",
    "attn.add_v_proj": "attn.b_to_v", "attn.to_add_out": "attn.b_to_out",
    "ff.net.0.proj": "ff_a.0", "ff.net.2": "ff_a.2",
    "ff_context.net.0.proj": "ff_b.0", "ff_context.net.2": "ff_b.2",
    "norm1.linear": "norm1_a.linear", "norm1_context.linear": "norm1_b.linear",
}

_DIFFUSERS_SINGLE_LEAF = {
    "attn.to_q": "a_to_q", "attn.to_k": "a_to_k", "attn.to_v": "a_to_v",
    "norm.linear": "norm.linear", "proj_mlp": "proj_in_besides_attn",
    "proj_out": "proj_out",
}


def _guess_alpha(sd) -> float:
    for name, param in sd.items():
        if ".alpha" in name:
            for suffix in (".lora_down.weight", ".lora_A.weight"):
                name_ = name.replace(".alpha", suffix)
                if name_ in sd:
                    return math.sqrt(float(_np(param)) / sd[name_].shape[0])
    return 1.0


def _fuse_block_diag(parts_a, parts_b):
    """Fuse separate q/k/v(+mlp) adapters into one fused-linear adapter:
    A rows stack, B goes block-diagonal (flux_lora.py:146-206)."""
    A = np.concatenate(parts_a, axis=0)
    d_total = sum(p.shape[0] for p in parts_b)
    r_total = sum(p.shape[1] for p in parts_b)
    B = np.zeros((d_total, r_total), np.float32)
    d0 = r0 = 0
    for p in parts_b:
        d, r = p.shape
        B[d0:d0 + d, r0:r0 + r] = p
        d0 += d
        r0 += r
    return A, B


def convert_flux_lora(sd: Dict) -> Dict[str, np.ndarray]:
    """Any public FLUX LoRA layout -> {target.lora_A/B.weight: array} in the
    native (DiffSynth-module) naming, the `FluxDiT`'s."""
    keys = list(sd.keys())
    if any("lora_unet_" in k for k in keys):
        return _convert_civitai(sd)
    if any(k.startswith("transformer.") for k in keys):
        return _convert_diffusers(sd)
    return {k: _np(v) for k, v in sd.items() if ".alpha" not in k}


def _convert_civitai(sd):
    alpha = _guess_alpha(sd)
    out = {}
    pat = re.compile(r"lora_unet_(double|single)_blocks_(\d+)_(.+?)\."
                     r"(lora_down|lora_up)\.weight")
    for name, param in sd.items():
        m = pat.fullmatch(name)
        if not m:
            continue
        kind, i, leaf, ab = m.groups()
        if leaf not in _CIVITAI_LEAF:
            continue
        prefix = "blocks" if kind == "double" else "single_blocks"
        tag = "lora_A" if ab == "lora_down" else "lora_B"
        out[f"{prefix}.{i}.{_CIVITAI_LEAF[leaf]}.{tag}.weight"] = \
            _np(param) * alpha
    return out


def _convert_diffusers(sd):
    alpha = _guess_alpha(sd)
    flat = {}
    pat = re.compile(r"transformer\.(transformer_blocks|single_transformer_blocks)"
                     r"\.(\d+)\.(.+?)\.(lora_A|lora_B)\.weight")
    for name, param in sd.items():
        m = pat.fullmatch(name)
        if not m:
            continue
        which, i, leaf, ab = m.groups()
        if which == "transformer_blocks":
            if leaf not in _DIFFUSERS_JOINT_LEAF:
                continue
            flat[f"blocks.{i}.{_DIFFUSERS_JOINT_LEAF[leaf]}.{ab}"] = \
                _np(param) * alpha
        else:
            if leaf not in _DIFFUSERS_SINGLE_LEAF:
                continue
            flat[f"single_blocks.{i}.{_DIFFUSERS_SINGLE_LEAF[leaf]}.{ab}"] = \
                _np(param) * alpha

    out = {}
    consumed = set()
    for key in list(flat.keys()):
        if key in consumed:
            continue
        m = re.match(r"(single_blocks\.\d+)\.a_to_q\.(lora_A|lora_B)", key)
        if m:
            base, ab = m.groups()
            parts = [flat[f"{base}.a_to_{c}.{ab}"] for c in "qkv"]
            mlp_key = f"{base}.proj_in_besides_attn.{ab}"
            if mlp_key in flat:
                parts.append(flat[mlp_key])
                consumed.add(mlp_key)
            else:
                # zero adapter for the mlp slice (flux_lora.py:148-155):
                # A keeps the q-adapter shape, B covers the 4*dim mlp rows
                d, r = parts[0].shape
                parts.append(np.zeros_like(parts[0]) if ab == "lora_A"
                             else np.zeros((4 * d, r), np.float32))
            consumed.update(f"{base}.a_to_{c}.{ab}" for c in "qkv")
            if ab == "lora_A":
                out[f"{base}.to_qkv_mlp.lora_A.weight"] = np.concatenate(
                    parts, axis=0)
            else:
                A, B = _fuse_block_diag(parts, parts)
                out[f"{base}.to_qkv_mlp.lora_B.weight"] = B
            continue
        m = re.match(r"(blocks\.\d+\.attn)\.([ab])_to_q\.(lora_A|lora_B)", key)
        if m:
            base, stream, ab = m.groups()
            parts = [flat[f"{base}.{stream}_to_{c}.{ab}"] for c in "qkv"]
            consumed.update(f"{base}.{stream}_to_{c}.{ab}" for c in "qkv")
            if ab == "lora_A":
                out[f"{base}.{stream}_to_qkv.lora_A.weight"] = np.concatenate(
                    parts, axis=0)
            else:
                _, B = _fuse_block_diag(parts, parts)
                out[f"{base}.{stream}_to_qkv.lora_B.weight"] = B
            continue
        if re.search(r"\.[ab]_to_[kv]\.|proj_in_besides_attn", key):
            continue  # folded above
        out[key.replace(".lora_A", ".lora_A") + ".weight"
            if not key.endswith(".weight") else key] = flat[key]
    # normalize remaining keys to ....lora_X.weight form
    fixed = {}
    for k, v in out.items():
        if not k.endswith(".weight"):
            k = k + ".weight"
        fixed[k] = v
    return fixed
