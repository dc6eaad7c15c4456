"""Attention entry points.

`attention` is what every DiT and VACE attention call goes through, self
and cross: it launches K1 (`ops.flash_attention`; K2 or K8 under
`FLASH_CAPPED=0` / `FLASH_DUAL=1`) on a CUDA tensor and runs the plain
version on a CPU tensor; under autograd its backward is K3 (or K3's plain
version). After `set_quantized_attention(True)` it goes through the int8
kernel K6 instead, cross-attention to the text tokens included, as in the
JAX package (`ops/attention.py:36-45, 75-77`). A kernel failure raises;
there is no quiet fallback to another attention.

`sdpa` is the exact-softmax attention the JAX package takes off the TPU,
kept as the yardstick the tests hold the capped softmax against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_int8

_QUANTIZED_ATTENTION = False


def set_quantized_attention(enabled: bool):
    """Route `attention` through the SageAttention-style int8 kernel (K6).
    Opt-in and process-wide, like the JAX package's flag: bf16 attention
    stays the default."""
    global _QUANTIZED_ATTENTION
    _QUANTIZED_ATTENTION = bool(enabled)


def sdpa(q, k, v, scale: Optional[float] = None, bias=None,
         split_bytes: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, N, D), k/v: (B, Sk, N, D) -> (B, Sq, N, D); fp32 softmax.
    bias: added to the scaled fp32 logits (B or 1, N or 1, Sq or 1, Sk).
    split_bytes: when the fp32 logits would pass this size, the call runs
    by batch rows, then by heads, in pieces under it: each row and head is
    the same arithmetic, and the whole logits never exist at once."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, n, _ = q.shape
    per_head = 4 * sq * k.shape[1]
    if split_bytes is not None and b * n * per_head > split_bytes:
        rows = max(1, split_bytes // (n * per_head))
        heads = n if rows > 1 or n * per_head <= split_bytes else max(
            1, split_bytes // per_head)
        out = torch.empty_like(q, dtype=v.dtype)
        for b0 in range(0, b, rows):
            for h0 in range(0, n, heads):
                bs, hs = slice(b0, b0 + rows), slice(h0, h0 + heads)
                piece = None if bias is None else bias[
                    bs if bias.shape[0] > 1 else slice(None),
                    hs if bias.shape[1] > 1 else slice(None)]
                out[bs, :, hs] = sdpa(q[bs, :, hs], k[bs, :, hs], v[bs, :, hs], scale, piece)
        return out
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention(q, k, v, scale: Optional[float] = None,
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """Flash attention on (B, S, N, D) tensors. kv_valid: count of real keys
    when the key sequence carries zero padding; keys past it are excluded
    exactly."""
    if kv_valid is not None and kv_valid < k.shape[1]:
        k = k[:, :kv_valid]
        v = v[:, :kv_valid]
    if _QUANTIZED_ATTENTION:
        return flash_attention_int8(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)
