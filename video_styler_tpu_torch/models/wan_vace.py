"""VACE control branch for the Wan DiT, in PyTorch.

Counterpart of `video_styler_tpu/models/wan_vace.py`: its own patch
embedding over the 96-channel VACE context, a chain of DiT blocks after a
`before_proj`, and one `after_proj` hint per block, added into the trunk
after the mapped layers (`models.wan_dit.run_blocks`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch.nn.functional as F
from torch import nn

from .wan_dit import DiTBlock, Linear, WanDiTConfig, block_fn, patchify


@dataclass(frozen=True)
class VaceConfig:
    vace_layers: Tuple[int, ...]
    vace_in_dim: int = 96
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    dim: int = 1536
    num_heads: int = 12
    ffn_dim: int = 8960
    eps: float = 1e-6

    def block_cfg(self) -> WanDiTConfig:
        return WanDiTConfig(dim=self.dim, in_dim=self.vace_in_dim,
                            ffn_dim=self.ffn_dim, out_dim=16,
                            num_heads=self.num_heads,
                            num_layers=len(self.vace_layers), eps=self.eps,
                            patch_size=self.patch_size)


VACE_1_3B = VaceConfig(vace_layers=tuple(range(0, 30, 2)), dim=1536,
                       num_heads=12, ffn_dim=8960)
VACE_14B = VaceConfig(vace_layers=(0, 5, 10, 15, 20, 25, 30, 35), dim=5120,
                      num_heads=40, ffn_dim=13824)


class WanVace(nn.Module):
    """Parameters of the VACE branch; `vace_forward` runs it."""

    def __init__(self, cfg: VaceConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pt, ph, pw = cfg.patch_size
        bcfg = cfg.block_cfg()
        n = len(cfg.vace_layers)
        self.cfg = cfg
        self.patch_embedding = Linear(cfg.vace_in_dim * pt * ph * pw, cfg.dim, **kw)
        self.before_proj = Linear(cfg.dim, cfg.dim, **kw)
        self.blocks = nn.ModuleList(DiTBlock(bcfg, **kw) for _ in range(n))
        self.after_proj = nn.ModuleList(Linear(cfg.dim, cfg.dim, **kw)
                                        for _ in range(n))


def vace_forward(model: WanVace, x_tokens, vace_context, context, t_mod,
                 cos, sin, remat: bool = False) -> List:
    """Per-mapped-layer hints, each (B, S, D).

    x_tokens: trunk tokens after patchify (B, S, D); vace_context:
    (B, vace_in_dim, F, H, W). The context tokens are zero-padded to the
    trunk length when shorter. remat: recompute each block in the backward
    (`models.wan_dit.block_fn`)."""
    bcfg = model.cfg.block_cfg()
    c, _ = patchify(model.patch_embedding, vace_context, model.cfg.patch_size)
    s_x, s_c = x_tokens.shape[1], c.shape[1]
    if s_c < s_x:
        c = F.pad(c, (0, 0, 0, s_x - s_c))
    c = model.before_proj(c) + x_tokens
    hints = []
    body = block_fn(remat)
    for blk, after in zip(model.blocks, model.after_proj):
        c = body(blk, c, context, t_mod, cos, sin, bcfg)
        hints.append(after(c))
    return hints
