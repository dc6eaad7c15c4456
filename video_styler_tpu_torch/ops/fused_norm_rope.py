"""K4 (fused RMSNorm + RoPE on the self-attention Q/K) and K5 (RMSNorm on
the cross-attention Q), with their plain PyTorch versions.

K4 replaces the Pallas kernel `_fused_kernel`
(video_styler_tpu/ops/fused_norm_rope.py:51), K5 replaces `_rms_kernel`
(:154). Both are hand-written CUDA C++ in `csrc/fused_norm_rope.cu`; its
header note says what bounds them on the H100 (bytes: one read and one
write of each row) and how the warp-per-row designs meet that (K5 holds
its row in registers and reads it once).

On a CPU tensor each wrapper runs its plain version, the composition of
`ops.basic.rms_norm` and `ops.rope.rope_apply`. On a CUDA tensor it launches
its kernel or raises; nothing falls back.

Gradients: when grad is enabled and an input requires grad, each wrapper
goes through a `torch.autograd.Function` whose forward is the kernel (or
the plain version on CPU) and whose backward recomputes the plain
composition and differentiates it, as the JAX package's custom_vjps do
(`_fused_vjp_bwd` :143-148, `_rms_vjp_bwd` :198-201). The TPU package has
no backward kernel for either, so neither has one here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .basic import rms_norm
from .cuda_build import F32, I32, P, Kernel
from .rope import rope_apply

ROPE_KERNEL = Kernel("fused_norm_rope", "fused_rmsnorm_rope_fwd",
                     [P, P, P, P, P, P, P, P, I32, I32, I32, I32, F32, P],
                     "fused_norm_rope_error_string")
RMS_KERNEL = Kernel("fused_norm_rope", "fused_rmsnorm_fwd",
                    [P, P, P, I32, I32, F32, P],
                    "fused_norm_rope_error_string")
RMS_MAX_WIDTH = 8192  # K5's widest row: 32 lanes x 32 chunks of 8


def fused_rmsnorm_rope_plain(q_proj, k_proj, wq, wk, cos, sin,
                             eps: float = 1e-6):
    """K4's plain version: q_proj/k_proj (B, S, N*D), wq/wk (N*D,),
    cos/sin (S, D/2) -> roped (B, S, N, D) q, k."""
    b, s, dm = q_proj.shape
    d = 2 * cos.shape[1]
    n = dm // d
    q = rope_apply(rms_norm(q_proj, wq, eps).reshape(b, s, n, d), cos, sin)
    k = rope_apply(rms_norm(k_proj, wk, eps).reshape(b, s, n, d), cos, sin)
    return q, k


def fused_rmsnorm_plain(x, w, eps: float = 1e-6):
    """K5's plain version: rms_norm over the last dim."""
    return rms_norm(x, w, eps)


def _check_rows(name: str, t: torch.Tensor, dm: int):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != dm or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B, S, {dm}) tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if w.shape != (x.shape[-1],) or w.device != x.device:
        raise ValueError(f"weight of shape {tuple(w.shape)} on {w.device} does "
                         f"not fit rows of {x.shape[-1]} on {x.device}")
    if w.dtype != x.dtype or not w.is_contiguous():
        w = w.to(x.dtype).contiguous()
    return w


def _rope_forward(q_proj, k_proj, wq, wk, cos, sin, eps: float):
    if q_proj.device.type == "cpu":
        return fused_rmsnorm_rope_plain(q_proj, k_proj, wq, wk, cos, sin, eps)
    if q_proj.device.type != "cuda":
        raise RuntimeError(f"K4 runs on CUDA or (plain) CPU, not {q_proj.device}")
    b, s, dm = q_proj.shape
    d = 2 * cos.shape[1]
    if d % 8 or dm % d:
        raise ValueError(f"head dim {d} must be a multiple of 8 dividing {dm}")
    _check_rows("q_proj", q_proj, dm)
    _check_rows("k_proj", k_proj, dm)
    if k_proj.shape != q_proj.shape or k_proj.device != q_proj.device:
        raise ValueError("q_proj and k_proj differ in shape or device")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or t.shape != (s, d // 2)
                or not t.is_contiguous() or t.device != q_proj.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: need contiguous, 16-byte aligned float32 "
                             f"({s}, {d // 2}) on {q_proj.device}")
    wq, wk = _weight(wq, q_proj), _weight(wk, k_proj)
    oq = torch.empty((b, s, dm // d, d), dtype=q_proj.dtype, device=q_proj.device)
    ok = torch.empty_like(oq)
    ROPE_KERNEL(q_proj.data_ptr(), k_proj.data_ptr(), wq.data_ptr(),
                wk.data_ptr(), cos.data_ptr(), sin.data_ptr(), oq.data_ptr(),
                ok.data_ptr(), b * s, s, dm, d, eps,
                torch.cuda.current_stream(q_proj.device).cuda_stream)
    return oq, ok


def _rms_forward(x, w, eps: float):
    """K5's launch. Its kernel takes tens of microseconds at the 4,680-token
    request, about what this function costs the host, so the path stays
    short: the raw current stream, no copy of a weight that is already
    bf16 and contiguous."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_rmsnorm_plain(x, w, eps)
        raise RuntimeError(f"K5 runs on CUDA or (plain) CPU, not {x.device}")
    b, s, dm = x.shape
    if dm % 8 or dm > RMS_MAX_WIDTH:
        raise ValueError(f"row width {dm} must be a multiple of 8, at most "
                         f"{RMS_MAX_WIDTH} (K5 holds a row in one warp's registers)")
    _check_rows("x", x, dm)
    w = _weight(w, x)
    out = torch.empty_like(x)
    RMS_KERNEL(x.data_ptr(), w.data_ptr(), out.data_ptr(), b * s, dm, eps,
               torch._C._cuda_getCurrentRawStream(x.get_device()))
    return out


def _recompute_grads(ctx, plain, inputs, consts, grads):
    """Gradients of `plain(*inputs, *consts)` at cotangents `grads`, for the
    inputs autograd asked for (None for the others)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(inputs, ctx.needs_input_grad)]
        outs = plain(*ins, *consts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads))
    return [next(got) if t.requires_grad else None for t in ins]


class FusedRmsNormRopeFunction(torch.autograd.Function):
    """K4 forward; backward by autograd through the plain composition."""

    @staticmethod
    def forward(ctx, q_proj, k_proj, wq, wk, cos, sin, eps: float):
        ctx.save_for_backward(q_proj, k_proj, wq, wk, cos, sin)
        ctx.eps = eps
        return _rope_forward(q_proj, k_proj, wq, wk, cos, sin, eps)

    @staticmethod
    def backward(ctx, gq, gk):
        q_proj, k_proj, wq, wk, cos, sin = ctx.saved_tensors
        grads = _recompute_grads(ctx, fused_rmsnorm_rope_plain,
                                 (q_proj, k_proj, wq, wk), (cos, sin, ctx.eps),
                                 (gq, gk))
        return (*grads, None, None, None)


class FusedRmsNormFunction(torch.autograd.Function):
    """K5 forward; backward by autograd through `rms_norm`."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        grads = _recompute_grads(ctx, fused_rmsnorm_plain, (x, w), (ctx.eps,),
                                 (g,))
        return (*grads, None)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_rmsnorm_rope(q_proj, k_proj, wq, wk, cos, sin,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm + RoPE for the Q/K pair: (B, S, N*D) -> (B, S, N, D) each."""
    if _wants_grad(q_proj, k_proj, wq, wk):
        return FusedRmsNormRopeFunction.apply(q_proj, k_proj, wq, wk, cos, sin, eps)
    return _rope_forward(q_proj, k_proj, wq, wk, cos, sin, eps)


def fused_rmsnorm(x, w, eps: float = 1e-6) -> torch.Tensor:
    """Single-pass RMSNorm of (B, S, Dm) rows; `ops.basic.rms_norm` semantics."""
    if _wants_grad(x, w):
        return FusedRmsNormFunction.apply(x, w, eps)
    return _rms_forward(x, w, eps)
