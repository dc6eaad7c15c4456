"""CLIP ViT-H/14 vision tower (Wan I2V image conditioning) in PyTorch.

Counterpart of the vision path of `video_styler_tpu/models/clip_vit.py`:
a 14x14 patch embedding, the class token and position table, a pre
LayerNorm and pre-norm attention blocks with an exact-GELU MLP. Wan's
image encoder taps the features after block 31 of 32 (`use_31_block`), so
the last block and the post LayerNorm are held (the checkpoint has them)
but not run.

Its attention is the exact-softmax `ops.attention.sdpa`, as the JAX tower
runs XLA's sdpa and no Pallas kernel: 257 tokens of 16 heads of 80. The
XLM-R text tower of the same checkpoint is not on the I2V path and is not
ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .wan_dit import LayerNormAffine, Linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ClipVitConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_H_14 = ClipVitConfig()


class ClipBlock(nn.Module):
    def __init__(self, cfg: ClipVitConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = LayerNormAffine(cfg.dim, **kw)
        self.to_qkv = Linear(cfg.dim, 3 * cfg.dim, **kw)
        self.attn_proj = Linear(cfg.dim, cfg.dim, **kw)
        self.norm2 = LayerNormAffine(cfg.dim, **kw)
        self.mlp_fc1 = Linear(cfg.dim, hidden, **kw)
        self.mlp_fc2 = Linear(hidden, cfg.dim, **kw)


class ClipVit(nn.Module):
    """Parameters of the vision tower (the JAX tree of `init_clip_vit`)."""

    def __init__(self, cfg: ClipVitConfig = CLIP_VIT_H_14, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embedding = Linear(3 * cfg.patch_size ** 2, cfg.dim, bias=False, **kw)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, cfg.dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, cfg.num_patches + 1, cfg.dim, **kw))
        self.pre_norm = LayerNormAffine(cfg.dim, **kw)
        self.post_norm = LayerNormAffine(cfg.dim, **kw)
        self.blocks = nn.ModuleList(ClipBlock(cfg, **kw) for _ in range(cfg.num_layers))


@torch.no_grad()
def init_clip_vit_(model: ClipVit, generator: torch.Generator) -> ClipVit:
    """Random init with the JAX init's std: linear weights N(0, 1/in),
    biases 0, LayerNorms 1 and 0, class token and positions N(0, 1/dim)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.scale.fill_(1.0)
            m.bias.zero_()
    gain = 1.0 / math.sqrt(model.cfg.dim)
    model.cls_embedding.normal_(0.0, gain, generator=generator)
    model.pos_embedding.normal_(0.0, gain, generator=generator)
    return model


def _block(p: ClipBlock, x, cfg: ClipVitConfig):
    b, s, d = x.shape
    n = cfg.num_heads
    h = layer_norm(x, p.norm1.scale, p.norm1.bias, cfg.norm_eps)
    q, k, v = p.to_qkv(h).split(d, dim=-1)
    out = sdpa(q.reshape(b, s, n, d // n), k.reshape(b, s, n, d // n),
               v.reshape(b, s, n, d // n))
    x = x + p.attn_proj(out.reshape(b, s, d))
    h = layer_norm(x, p.norm2.scale, p.norm2.bias, cfg.norm_eps)
    h = p.mlp_fc1(h)
    return x + p.mlp_fc2(F.gelu(h.float()).to(h.dtype))


def clip_vit_forward(model: ClipVit, images, use_31_block: bool = True):
    """images (B, 3, H, W), CLIP-normalised -> (B, 1 + patches, dim), taken
    after num_layers - 1 blocks with use_31_block."""
    cfg = model.cfg
    b, ps, g = images.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
    patches = images.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = model.patch_embedding(patches.reshape(b, g * g, 3 * ps * ps))
    x = torch.cat([model.cls_embedding.to(x.dtype).expand(b, 1, cfg.dim), x], dim=1)
    x = x + model.pos_embedding.to(x.dtype)
    x = layer_norm(x, model.pre_norm.scale, model.pre_norm.bias, cfg.norm_eps)
    n = cfg.num_layers - 1 if use_31_block else cfg.num_layers
    for blk in list(model.blocks)[:n]:
        x = _block(blk, x, cfg)
    if not use_31_block:
        x = layer_norm(x, model.post_norm.scale, model.post_norm.bias, cfg.norm_eps)
    return x


def preprocess_clip_image(images, image_size: int = 224) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] (numpy or tensor) -> float32 bicubic-resized
    to image_size (align_corners=False, as the JAX package resizes with
    torch) and normalised with the CLIP mean and std, on images' device."""
    t = torch.as_tensor(np.asarray(images, np.float32) if isinstance(images, np.ndarray)
                        else images).float()
    t = F.interpolate(t, size=(image_size, image_size), mode="bicubic",
                      align_corners=False)
    t = t * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=t.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=t.device)[None, :, None, None]
    return (t - mean) / std


@torch.no_grad()
def encode_image(model: ClipVit, images, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> (B, 257, 1280) features on the model's
    device, in `dtype`."""
    dev = next(model.parameters()).device
    pre = preprocess_clip_image(torch.as_tensor(images).to(dev), model.cfg.image_size)
    return clip_vit_forward(model, pre.to(dtype))


def convert_clip_vit(sd: Dict, cfg: ClipVitConfig = CLIP_VIT_H_14) -> Dict:
    """The reference image encoder's state dict (`visual.*` keys; the
    `textual.*` tower is dropped, as the JAX converter drops it) ->
    `ClipVit` state dict. Values pass through untouched (tensors or
    `utils.ckpt.LazyTensor`s)."""
    sd = {k[len("visual."):] if k.startswith("visual.") else k: v
          for k, v in sd.items() if not k.startswith("textual.")}
    w = sd["patch_embedding.weight"]
    out = {"patch_embedding.weight": w.reshape(w.shape[0], math.prod(w.shape[1:])),
           "cls_embedding": sd["cls_embedding"], "pos_embedding": sd["pos_embedding"]}
    for norm in ("pre_norm", "post_norm"):
        out[f"{norm}.scale"] = sd[f"{norm}.weight"]
        out[f"{norm}.bias"] = sd[f"{norm}.bias"]
    names = {"norm1": "norm1", "attn.to_qkv": "to_qkv", "attn.proj": "attn_proj",
             "norm2": "norm2", "mlp.0": "mlp_fc1", "mlp.2": "mlp_fc2"}
    for i in range(cfg.num_layers):
        for src, dst in names.items():
            w_name = "scale" if src.startswith("norm") else "weight"
            out[f"blocks.{i}.{dst}.{w_name}"] = sd[f"transformer.{i}.{src}.weight"]
            out[f"blocks.{i}.{dst}.bias"] = sd[f"transformer.{i}.{src}.bias"]
    return out


def export_clip_vit(model: ClipVit) -> Dict[str, torch.Tensor]:
    """A `ClipVit`'s tensors under the reference's `visual.*` names and
    shapes (`convert_clip_vit` inverted)."""
    cfg = model.cfg
    sd = model.state_dict()
    ps = cfg.patch_size
    out = {"visual.patch_embedding.weight": sd["patch_embedding.weight"].reshape(
               cfg.dim, 3, ps, ps),
           "visual.cls_embedding": sd["cls_embedding"],
           "visual.pos_embedding": sd["pos_embedding"]}
    for norm in ("pre_norm", "post_norm"):
        out[f"visual.{norm}.weight"] = sd[f"{norm}.scale"]
        out[f"visual.{norm}.bias"] = sd[f"{norm}.bias"]
    names = {"norm1": "norm1", "to_qkv": "attn.to_qkv", "attn_proj": "attn.proj",
             "norm2": "norm2", "mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}
    for i in range(cfg.num_layers):
        for src, dst in names.items():
            w_name = "scale" if src.startswith("norm") else "weight"
            out[f"visual.transformer.{i}.{dst}.weight"] = sd[f"blocks.{i}.{src}.{w_name}"]
            out[f"visual.transformer.{i}.{dst}.bias"] = sd[f"blocks.{i}.{src}.bias"]
    return out
