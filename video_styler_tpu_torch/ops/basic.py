"""Core neural-net primitives on tensors, with the JAX package's rounding.

Each function follows the rounding points of its counterpart in
`video_styler_tpu/ops/basic.py`: RMSNorm and LayerNorm statistics are taken
in float32 and cast back to the activation dtype before the weight
multiply; GELU (tanh form) is computed in float32; the sinusoidal timestep
embedding is cos-first and computed in float32.

Linear weights are stored as `nn.Linear` stores them, (out, in); quantized
ones (`ops.quant.QuantLinear`) keep the JAX layout (in, out).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias), weight (out, in), returned in x.dtype.

    The product accumulates in fp32 and the bias is added before the single
    rounding to x.dtype (the GEMM's epilogue), as the JAX linear does."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, weight.to(x.dtype), b)


def quantized_linear(x: torch.Tensor, w_q, w_q4, w_scale, bias=None) -> torch.Tensor:
    """The quantized side of the JAX `linear`'s dispatch
    (`video_styler_tpu/ops/basic.py:51-60`), on what a
    `ops.quant.QuantLinear` holds: packed int4 with group scales (one more
    scale axis) -> w4a16, packed int4 per column -> w4a8, int8 -> w8a8,
    otherwise e4m3 storage."""
    from . import quant
    if w_q4 is not None:
        if w_scale.dim() == w_q4.dim() + 1:
            return quant.linear_int4_g(x, w_q4, w_scale, bias)
        return quant.linear_int4(x, w_q4, w_scale, bias)
    if w_q.dtype == torch.int8:
        return quant.linear_int8(x, w_q, w_scale, bias)
    return quant.linear_fp8(x, w_q, w_scale, bias)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back, then the affine terms."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) in fp32, cast back, then * scale."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale.to(x.dtype)


def t5_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """T5 RMS layernorm: fp32 mean of squares; the rsqrt is cast to x.dtype
    and multiplies the input-dtype x; the weight multiplies last."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps).to(x.dtype)
    return scale.to(x.dtype) * (x * r)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                     * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: x * (1 + scale) + shift."""
    return x * (1 + scale) + shift


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] embedding of (...,) positions -> (..., dim), in float32
    (the JAX package's choice; its reference computes in float64)."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                            device=position.device) / half)
    sinusoid = position.float()[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)],
                     dim=-1).to(position.dtype)


def patchify(embed: Callable, x: torch.Tensor, patch_size: Tuple[int, int, int]):
    """(B, C, F, H, W) -> embed(tokens) (B, f*h*w, dim) and the (f, h, w)
    grid; token features flatten in (c, pt, ph, pw) order, as a Conv3d
    weight's do."""
    pt, ph, pw = patch_size
    b, c, F_, H, W = x.shape
    f, h, w = F_ // pt, H // ph, W // pw
    t = x.reshape(b, c, f, pt, h, ph, w, pw)
    t = t.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, f * h * w, c * pt * ph * pw)
    return embed(t), (f, h, w)
