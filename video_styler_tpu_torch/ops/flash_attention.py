"""K1: the capped-softmax flash-attention forward, with its plain version.

Replaces the Pallas kernel `_flash_kernel_4d_capped`
(video_styler_tpu/ops/flash_attention.py:213, via `_flash_fwd_4d` :352 with
capped=True, the default of the JAX package). The kernel is hand-written
CUDA C++ in `csrc/flash_attention.cu`; its header note says what bounds it
on the H100 (the tensor cores: 4*Sq*Sk*D flops per head) and how the
mma.sync design meets that.

The capped softmax has no running max. Each query row gets an upper bound
on its base-2 logits, m2 = min(||q'|| * max_j ||k_j|| * 1.0001, 96), with q'
the scaled and downcast query; then p = exp2(q'.k - m2) <= 1 and
o = sum(bf16(p) v) / max(sum(p), 1e-37), so a fully flushed row gives 0.
The per-(batch, head) max key norm is a plain reduction outside the kernel,
as in the JAX package (:386-387).

On a CPU tensor `flash_attention` runs `flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda_build import F32, I32, I64, P, Kernel

LOG2_E = 1.4426950408889634
HEAD_DIM = 128  # the kernel's head dim (every Wan DiT config)

KERNEL = Kernel("flash_attention", "flash_attention_capped_fwd",
                [P, P, P, P, P] + [I64] * 12 + [I32, I32, I32, I32, F32, P],
                "flash_attention_error_string")


def key_norm_max(k: torch.Tensor) -> torch.Tensor:
    """(B, Sk, N, D) -> (B, N) float32 max over keys of ||k_j||."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1)


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          max_elements: int = 1 << 28) -> torch.Tensor:
    """K1's plain version: q (B, Sq, N, D), k/v (B, Sk, N, D) -> (B, Sq, N, D).

    Same rounding points as the kernel: the scaled q is downcast to q.dtype,
    both products accumulate in fp32 from exactly upcast operands, p is
    rounded to v.dtype before the PV product. Query rows are independent,
    so they are processed in chunks of at most `max_elements` logits."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kcap = key_norm_max(k) * 1.0001                              # (B, N)
    qs = (q.float() * (scale * LOG2_E)).to(q.dtype)
    kt = k.float().permute(0, 2, 3, 1)                           # (B, N, D, Sk)
    vf = v.float().permute(0, 2, 1, 3)                           # (B, N, Sk, D)
    rows = max(1, max_elements // max(1, b * n * sk))
    out = torch.empty_like(q)
    for i0 in range(0, sq, rows):
        qc = qs[:, i0:i0 + rows].float().permute(0, 2, 1, 3)     # (B, N, c, D)
        m2 = torch.clamp(torch.linalg.vector_norm(qc, dim=-1)
                         * kcap[:, :, None], max=96.0)           # (B, N, c)
        p = torch.exp2(torch.matmul(qc, kt) - m2[..., None])
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        out[:, i0:i0 + rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _check(name: str, t: torch.Tensor, device):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: K1 takes bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: need (B, S, N, {HEAD_DIM}), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned "
                         f"(strides {t.stride()})")


def _flash_cuda(q, k, v, scale: float) -> torch.Tensor:
    b, sq, n, d = q.shape
    sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n or sk == 0:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    kmax = key_norm_max(k).contiguous()
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmax.data_ptr(),
           out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], b, n, sq, sk, scale * LOG2_E,
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, N, D), k/v: (B, Sk, N, D) -> (B, Sq, N, D), non-causal."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"K1 runs on CUDA or (plain) CPU, not {q.device}")
    return _flash_cuda(q, k, v, scale)
