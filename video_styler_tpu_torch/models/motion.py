"""AnimateDiff motion modules for SD 1.5 and SDXL in PyTorch.

Counterpart of `video_styler_tpu/models/motion.py`: a `TemporalBlock` runs
after each UNet block of a call map (`SD_MOTION_CALL_BLOCK_ID`,
`SDXL_MOTION_CALL_BLOCK_ID`), attending across the frames at every pixel:
GroupNorm (eps 1e-6), proj_in, temporal transformer blocks (two
self-attentions over the frames, each after a LayerNorm plus a learned
position table, then a GEGLU feed-forward), proj_out, the residual. The
frames are the batch of the UNet's input (one window of
`animatediff_batch_size`). Attention is the exact `sdpa` over 16 frames,
as in JAX. A module's width is that of the UNet block it follows,
`motion_widths` reads them from the UNet's program.
"""
from __future__ import annotations

from typing import Dict, Sequence

from torch import nn
import torch

from .sd import (GEGLU, SD_UNET_PROGRAM, Affine, Attention, SDUNetConfig, _ln, attn, geglu,
                 group_norm, program_widths)
from .wan_dit import Linear

SD_MOTION_CALL_BLOCK_ID = {
    1: 0, 4: 1, 9: 2, 12: 3, 17: 4, 20: 5, 24: 6, 26: 7, 29: 8, 32: 9,
    34: 10, 36: 11, 40: 12, 43: 13, 46: 14, 50: 15, 53: 16, 56: 17, 60: 18,
    63: 19, 66: 20}
SDXL_MOTION_CALL_BLOCK_ID = {
    0: 0, 2: 1, 7: 2, 10: 3, 15: 4, 18: 5, 25: 6, 28: 7, 31: 8, 35: 9,
    38: 10, 41: 11, 44: 12, 46: 13, 48: 14}
MOTION_POSITIONS = 32       # the position tables' rows (AnimateDiff v2 / v3, SDXL beta)
MOTION_HEADS = 8


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, positions: int = MOTION_POSITIONS, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Affine(dim, **kw)
        self.pe1 = nn.Parameter(torch.zeros(1, positions, dim, **kw))
        self.attn1 = Attention(dim, qkv_bias=False, **kw)
        self.norm2 = Affine(dim, **kw)
        self.pe2 = nn.Parameter(torch.zeros(1, positions, dim, **kw))
        self.attn2 = Attention(dim, qkv_bias=False, **kw)
        self.norm3 = Affine(dim, **kw)
        self.act_fn = GEGLU(dim, 4 * dim, **kw)
        self.ff = Linear(4 * dim, dim, **kw)


class TemporalBlock(nn.Module):
    def __init__(self, dim: int, positions: int = MOTION_POSITIONS, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = Affine(dim, **kw)
        self.proj_in = Linear(dim, dim, **kw)
        self.transformer_blocks = nn.ModuleList([TemporalTransformerBlock(dim, positions, **kw)])
        self.proj_out = Linear(dim, dim, **kw)


def motion_widths(program, cfg: SDUNetConfig, call_map: Dict[int, int]) -> Sequence[int]:
    """The width of each motion module: the output width of the UNet block
    it follows."""
    walk, _ = program_widths(program, cfg)
    widths = [0] * len(call_map)
    for block_id, idx in call_map.items():
        widths[idx] = walk[block_id][3]
    return widths


class MotionModel(nn.Module):
    """`motion_modules.N`, one per entry of the call map, in its order."""

    def __init__(self, widths: Sequence[int], positions: int = MOTION_POSITIONS,
                 device=None, dtype=None):
        super().__init__()
        self.motion_modules = nn.ModuleList(
            TemporalBlock(w, positions=positions, device=device, dtype=dtype) for w in widths)


def detect_motion_model(sd: Dict, device=None, dtype=None) -> MotionModel:
    """A motion model shaped by its state dict: each module's width and the
    position tables' rows."""
    n = 0
    while f"motion_modules.{n}.proj_in.weight" in sd:
        n += 1
    widths = [sd[f"motion_modules.{j}.proj_in.weight"].shape[0] for j in range(n)]
    positions = sd["motion_modules.0.transformer_blocks.0.pe1"].shape[1]
    return MotionModel(widths, positions, device=device, dtype=dtype)


def sd_motion_model(cfg: SDUNetConfig, device=None, dtype=None) -> MotionModel:
    return MotionModel(motion_widths(SD_UNET_PROGRAM, cfg, SD_MOTION_CALL_BLOCK_ID),
                       device=device, dtype=dtype)


def sdxl_motion_model(cfg: SDUNetConfig, device=None, dtype=None) -> MotionModel:
    from .sdxl import SDXL_UNET_PROGRAM
    return MotionModel(motion_widths(SDXL_UNET_PROGRAM, cfg, SDXL_MOTION_CALL_BLOCK_ID),
                       device=device, dtype=dtype)


def temporal_transformer_block(p: TemporalTransformerBlock, h, num_heads: int):
    """h (HW, T, C): the frames of each pixel as its sequence."""
    t = h.shape[1]
    h = h + attn(p.attn1, _ln(p.norm1, h) + p.pe1[:, :t].to(h.dtype), num_heads=num_heads)
    h = h + attn(p.attn2, _ln(p.norm2, h) + p.pe2[:, :t].to(h.dtype), num_heads=num_heads)
    return h + p.ff(geglu(p.act_fn, _ln(p.norm3, h)))


def temporal_block(p: TemporalBlock, x, num_heads: int = MOTION_HEADS, eps: float = 1e-6):
    """x (T, C, H, W), the frames as the batch -> (T, C, H, W)."""
    t, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps).permute(0, 2, 3, 1).reshape(t, hh * ww, c)
    h = p.proj_in(h).transpose(0, 1)
    for blk in p.transformer_blocks:
        h = temporal_transformer_block(blk, h, num_heads)
    h = p.proj_out(h.transpose(0, 1))
    return h.reshape(t, hh, ww, c).permute(0, 3, 1, 2) + x


def convert_motion_model(sd: Dict) -> Dict:
    """A reference SDMotionModel / SDXLMotionModel state dict
    (`motion_modules.N.…`) -> the port's names (norms' `weight` -> `scale`)."""
    from .sd import convert_sd_module
    return convert_sd_module(sd)
