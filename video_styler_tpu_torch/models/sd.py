"""The Stable Diffusion building blocks that the image VAE and the CLIP-L
text tower use, in PyTorch.

Counterpart of the parts of `video_styler_tpu/models/sd.py` that FLUX
reaches (:28-160, 245-256, 302-348): `conv2d`, `group_norm` (fp32
statistics, cast back), `attn` (exact `sdpa`: the VAE's one 512-channel
head and CLIP's causal mask are no Pallas kernel there either), the VAE's
`resnet_block`, `vae_attention_block`, `downsample` (with the encoder's
`extra_padding`: (0, 1) on each spatial axis before a stride-2 conv) and
`upsample`, the block programs `SD_VAE_{ENCODER,DECODER}_PROGRAM` over
the widths `SD_VAE_CHANNELS`, and `convert_sd_module`. The SD UNet and the
SD text encoder come with the SD slice.

Parameters live in modules named after the JAX tree: convolutions are
`nn.Conv2d` (weight OIHW, bias), norms hold `scale` and `bias`, linears are
`wan_dit.Linear` (weight (out, in)). The forwards pass stride and padding
per call, as the JAX functions do.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .wan_dit import LayerNormAffine as Affine
from .wan_dit import Linear


# ------------------------------------------------------------- primitives

def conv2d(p: nn.Conv2d, x, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p.weight.to(x.dtype),
                    None if p.bias is None else p.bias.to(x.dtype), stride, padding)


def group_norm(p: Affine, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm with fp32 statistics and affine terms, cast back."""
    return F.group_norm(x.float(), groups, p.scale.float(), p.bias.float(), eps).to(x.dtype)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


class Attention(nn.Module):
    """to_q / to_k / to_v / to_out, each with a bias."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.to_q = Linear(dim, dim, **kw)
        self.to_k = Linear(dim, dim, **kw)
        self.to_v = Linear(dim, dim, **kw)
        self.to_out = Linear(dim, dim, **kw)


def attn(p: Attention, x, num_heads: int = 8, mask: Optional[torch.Tensor] = None):
    """Self-attention (b, s, c) -> (b, s, c) through the exact `sdpa`; mask
    (s, s) is added to the fp32 logits."""
    b, s, _ = x.shape
    q, k, v = p.to_q(x), p.to_k(x), p.to_v(x)
    d = q.shape[-1] // num_heads
    bias = None if mask is None else mask[None, None].float()
    out = sdpa(q.view(b, s, num_heads, d), k.view(b, s, num_heads, d),
               v.view(b, s, num_heads, d), bias=bias)
    return p.to_out(out.reshape(b, s, num_heads * d))


# ------------------------------------------------------------- VAE blocks

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Affine(cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.norm2 = Affine(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1, **kw)


class VAEAttentionBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.norm = Affine(dim, device=device, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([Attention(dim, device=device, dtype=dtype)])


class Resample(nn.Module):
    """The stride-2 conv of a downsample, or the conv after a 2x upsample."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, device=device, dtype=dtype)


def resnet_block(p: ResnetBlock, x, eps: float = 1e-5):
    h = conv2d(p.conv1, _silu(group_norm(p.norm1, x, eps=eps)))
    h = conv2d(p.conv2, _silu(group_norm(p.norm2, h, eps=eps)))
    if hasattr(p, "conv_shortcut"):
        x = conv2d(p.conv_shortcut, x, padding=0)
    return x + h


def vae_attention_block(p: VAEAttentionBlock, x, eps: float = 1e-6):
    """One head over every position: (b, c, h, w) -> (b, c, h, w)."""
    b, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps)
    h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    for blk in p.transformer_blocks:
        h = attn(blk, h, num_heads=1)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def downsample(p: Resample, x, padding: int = 1, extra_padding: bool = False):
    if extra_padding:
        x = F.pad(x, (0, 1, 0, 1))
    return conv2d(p.conv, x, stride=2, padding=padding)


def upsample(p: Resample, x):
    return conv2d(p.conv, x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


# (kind, eps) per block of the VAE's decoder and encoder
SD_VAE_DECODER_PROGRAM = (
    [("res", 1e-6), ("vattn", 1e-6), ("res", 1e-6)]
    + ([("res", 1e-6)] * 3 + [("up", 0)]) * 3
    + [("res", 1e-6)] * 3
)

SD_VAE_ENCODER_PROGRAM = (
    ([("res", 1e-6)] * 2 + [("downx", 0)]) * 3
    + [("res", 1e-6)] * 2
    + [("res", 1e-6), ("vattn", 1e-6), ("res", 1e-6)]
)

# the width of each resolution level, outermost first (the JAX forwards
# read them from the weights)
SD_VAE_CHANNELS = (128, 256, 512, 512)


def vae_blocks(program, device=None, dtype=None) -> nn.ModuleList:
    """The program's blocks in order. The encoder walks the levels of
    `SD_VAE_CHANNELS` in, the decoder out, each resample moving to the next
    level. A level's first resnet block changes the width; the mid blocks
    sit at the innermost level."""
    kw = dict(device=device, dtype=dtype)
    encoder = any(kind == "downx" for kind, _ in program)
    levels = list(SD_VAE_CHANNELS) if encoder else list(SD_VAE_CHANNELS)[::-1]
    blocks, level = [], 0
    cin = levels[0]
    for kind, _ in program:
        if kind == "res":
            blocks.append(ResnetBlock(cin, levels[level], **kw))
            cin = levels[level]
        elif kind == "vattn":
            blocks.append(VAEAttentionBlock(cin, **kw))
        else:
            blocks.append(Resample(cin, **kw))
            level += 1
    return nn.ModuleList(blocks)


def run_vae_blocks(blocks: nn.ModuleList, program, h):
    for p, (kind, eps) in zip(blocks, program):
        if kind == "res":
            h = resnet_block(p, h, eps=eps)
        elif kind == "vattn":
            h = vae_attention_block(p, h, eps)
        elif kind == "downx":
            h = downsample(p, h, padding=0, extra_padding=True)
        else:
            h = upsample(p, h)
    return h


# ------------------------------------------------------------- converter

def convert_sd_module(sd: Dict) -> Dict:
    """A reference module's state dict -> the port's names: a norm's
    `weight` becomes `scale` (the JAX converter's rule: "norm" in the leaf
    or its parent's name); every other name and layout passes through."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        parent = parts[-2] if len(parts) > 1 else ""
        if parts[-1] == "weight" and ("norm" in parent or "norm" in parts[-1]):
            key = ".".join(parts[:-1] + ["scale"])
        out[key] = val
    return out
