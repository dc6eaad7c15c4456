"""Ulysses sequence-parallel attention over torch.distributed.

Counterpart of `video_styler_tpu/parallel/ulysses.py` (there `shard_map`
and `lax.all_to_all`; the reference's all-to-all Ulysses,
denoising_enhancing/wan/distributed/ulysses.py): each rank holds S/sp rows
of q, k and v with every head; one all-to-all over the sp group gives it
every row of N/sp heads, attention runs locally over the whole sequence
(`ops.attention.attention`: K1 on the card, its plain version on the CPU),
and a second all-to-all sends each rank its rows back.

Buffers: the send buffer is (sp, B, S/sp, N/sp, D), chunk j holding the
heads of rank j; the receive buffer in the same shape holds rank i's rows
in chunk i, which for B = 1 is already the contiguous (1, S, N/sp, D)
tensor that K1's tensor maps read (`ops.flash_attention.tma_layout`). A
batch of several rows (merged CFG) is put in that order by one copy.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import attention


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def scatter_heads(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """(B, S/sp, N, D) rows of every head -> (B, S, N/sp, D) every row of
    this rank's heads."""
    b, s_l, n, d = x.shape
    send = x.reshape(b, s_l, sp, n // sp, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = _all_to_all(send, group)                      # (sp, B, S/sp, N/sp, D)
    if b == 1:
        return recv.view(1, sp * s_l, n // sp, d)
    return recv.transpose(0, 1).reshape(b, sp * s_l, n // sp, d)


def gather_heads(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """Inverse of `scatter_heads`: (B, S, N/sp, D) -> (B, S/sp, N, D)."""
    b, s, nh, d = x.shape
    send = x.reshape(b, sp, s // sp, nh, d).transpose(0, 1)
    recv = _all_to_all(send.contiguous(), group)         # (sp, B, S/sp, N/sp, D)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * nh, d)


def ulysses_attention(q, k, v, ctx, scale: Optional[float] = None,
                      kv_valid: Optional[int] = None, axis: str = "sp"):
    """q, k, v: this rank's (B, S/sp, N, D) rows of the (padded) sequence;
    kv_valid: the count of real keys of the whole sequence. Needs
    N % sp == 0; at sp = 1 it is `attention`."""
    sp = ctx.axis_size(axis)
    if sp == 1:
        return attention(q, k, v, scale=scale, kv_valid=kv_valid)
    if q.shape[2] % sp:
        raise ValueError(f"Ulysses needs the head count ({q.shape[2]}) divisible by sp={sp}")
    group = ctx.group(axis)
    qh, kh, vh = (scatter_heads(t, sp, group) for t in (q, k, v))
    out = attention(qh, kh, vh, scale=scale, kv_valid=kv_valid)
    return gather_heads(out, sp, group)
