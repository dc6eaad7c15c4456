"""3-D rotary position embedding for the Wan video DiT.

The tables are computed with numpy in float64 and kept as float32 numpy
arrays (cached); `assemble_freqs_grid` turns them into device tensors for
one (f, h, w) token grid. The head dim d splits into three bands: f
(temporal) gets d - 2*(d//3), h and w get d//3 each (d=128 -> 44/42/42).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def _freqs_1d(dim: int, end: int = 1024, theta: float = 10000.0) -> np.ndarray:
    """Angles (end, dim//2) in float64."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    return np.outer(np.arange(end, dtype=np.float64), freqs)


@lru_cache(maxsize=8)
def precompute_freqs_3d(head_dim: int, end: int = 1024, theta: float = 10000.0):
    """((cos_f, sin_f), (cos_h, sin_h), (cos_w, sin_w)) as float32 numpy
    arrays of shapes (end, band_dim//2)."""
    f_dim = head_dim - 2 * (head_dim // 3)
    hw_dim = head_dim // 3
    if f_dim % 2 or hw_dim % 2:
        raise ValueError(
            f"head_dim={head_dim} splits into odd RoPE bands ({f_dim}/{hw_dim}/"
            f"{hw_dim}); pick head_dim with even f/h/w bands (e.g. 48, 96, 128)")
    out = []
    for d in (f_dim, hw_dim, hw_dim):
        ang = _freqs_1d(d, end, theta)
        out.append((np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)))
    return tuple(out)


def assemble_freqs_grid(head_dim: int, f: int, h: int, w: int,
                        rope_indices: Optional[np.ndarray] = None,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, head_dim//2) float32 cos/sin tables for an (f, h, w) grid, in
    f-major token order. rope_indices: optional (f,) temporal indices that
    replace range(f)."""
    (cf, sf), (ch, sh), (cw, sw) = precompute_freqs_3d(head_dim)
    if rope_indices is None:
        cf_, sf_ = cf[:f], sf[:f]
    else:
        idx = np.asarray(rope_indices)
        f = idx.shape[0]
        cf_, sf_ = cf[idx], sf[idx]

    def grid(a_f, a_h, a_w):
        out = np.concatenate([
            np.broadcast_to(a_f[:, None, None, :], (f, h, w, a_f.shape[-1])),
            np.broadcast_to(a_h[None, :, None, :], (f, h, w, a_h.shape[-1])),
            np.broadcast_to(a_w[None, None, :, :], (f, h, w, a_w.shape[-1])),
        ], axis=-1)
        return torch.from_numpy(out.reshape(f * h * w, -1)).to(device)

    return grid(cf_, ch[:h], cw[:w]), grid(sf_, sh[:h], sw[:w])


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent (even, odd) pairs of the head dim in float32.

    x: (B, S, N, D); cos/sin: (S, D//2). Returns x.dtype."""
    b, s, n, d = x.shape
    xf = x.float().reshape(b, s, n, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    sn = sin[None, :, None, :]
    y0 = x0 * c - x1 * sn
    y1 = x0 * sn + x1 * c
    return torch.stack([y0, y1], dim=-1).reshape(b, s, n, d).to(x.dtype)
