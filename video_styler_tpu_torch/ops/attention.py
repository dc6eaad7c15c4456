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


def sdpa(q, k, v, scale: Optional[float] = None, bias=None) -> torch.Tensor:
    """q: (B, Sq, N, D), k/v: (B, Sk, N, D) -> (B, Sq, N, D); fp32 softmax.
    bias: added to the scaled fp32 logits (B or 1, N or 1, Sq or 1, Sk)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
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
