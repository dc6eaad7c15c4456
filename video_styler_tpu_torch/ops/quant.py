"""Quantized linears: int8 (w8a8), fp8 (e4m3 storage), int4 (w4a8 per
column) and int4_g128 (w4a16 group scales).

Counterpart of `video_styler_tpu/ops/quant.py`, the JAX package's analogue
of the reference's fp8 `torch._scaled_mm` path. The scheme is the same:

  * weights: a per-output-channel (or per-group) absmax scale, quantized
    once;
  * activations: a per-row (token) dynamic absmax scale, quantized per call;
  * y = (x_q @ w_q) * x_scale * w_scale + b, accumulated in int32 / fp32.

Quantized weights keep the JAX layout, (in, out) with scales (1, out), so
the two packages hold the same integers. The matrix products are plain
library GEMMs outside any kernel, as they are `lax.dot_general` in the JAX
package: on the card `torch._int_mm` (int8, and int4 after the unpack),
`torch._scaled_mm` with unit scales (fp8; the row and column scales
multiply the fp32 product afterwards, as in `linear_fp8` there) and
`torch.matmul` (int4_g128); on the CPU exact float64 / fp32 products.

`quantize_params` walks an `nn.Module` and swaps each eligible `nn.Linear`
for a `QuantLinear`; `ops.basic.quantized_linear` dispatches on what the
layer holds.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .basic import linear, quantized_linear

FP8 = torch.float8_e4m3fn


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device. PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which can differ from the
    quotient in the last bit; a quantiser's scale is defined as the
    quotient (absmax / 127), and a last bit of the scale can move a rounded
    integer."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------
# Weight and activation quantizers
# --------------------------------------------------------------------------

def quantize_weight_int8(w):
    """(..., in, out) float weight -> (int8 weight, (..., 1, out) f32 scale)."""
    wf = w.float()
    scale = div_const(wf.abs().amax(dim=-2, keepdim=True), 127.0).clamp_min(1e-8)
    return torch.round(wf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_weight_fp8(w):
    """(..., in, out) float weight -> (e4m3 weight, (..., 1, out) f32 scale)."""
    wf = w.float()
    scale = div_const(wf.abs().amax(dim=-2, keepdim=True), 448.0).clamp_min(1e-8)
    return (wf / scale).to(FP8), scale


def pack_int4(q):
    """(..., in, out) int8 values in [-8, 7] -> (..., in/2, out) packed bytes:
    row 2i in the low nibble, row 2i+1 in the high one. `in` must be even.
    Computed in int16, where the shift cannot overflow."""
    lo = q[..., 0::2, :].to(torch.int16)
    hi = q[..., 1::2, :].to(torch.int16)
    return ((lo & 0x0F) | (hi << 4)).to(torch.int8)


def unpack_int4(packed):
    """(..., in/2, out) packed bytes -> (..., in, out) int8 in [-8, 7], the
    exact inverse of `pack_int4`. The nibbles are sign-extended in int16
    ((x & 15) ^ 8) - 8 for the low one, an arithmetic shift for the high
    one), which does not depend on how a device shifts int8."""
    p16 = packed.to(torch.int16)
    lo = ((p16 & 0x0F) ^ 8) - 8
    hi = p16 >> 4
    both = torch.stack([lo, hi], dim=-2).to(torch.int8)      # (..., in/2, 2, out)
    return both.reshape(packed.shape[:-2] + (packed.shape[-2] * 2, packed.shape[-1]))


def quantize_weight_int4(w):
    """(..., in, out) float weight -> (packed int4, (..., 1, out) f32 scale):
    per-output-channel absmax on the [-7, 7] grid."""
    wf = w.float()
    scale = div_const(wf.abs().amax(dim=-2, keepdim=True), 7.0).clamp_min(1e-8)
    return pack_int4(torch.round(wf / scale).clamp(-7, 7).to(torch.int8)), scale


def quantize_weight_int4_g(w, group: int = 128):
    """Group-wise int4: one scale per (group of `group` input rows, output
    column). Returns (packed, (..., in/group, 1, out) scales)."""
    wf = w.float()
    g = wf.reshape(wf.shape[:-2] + (wf.shape[-2] // group, group, wf.shape[-1]))
    scale = div_const(g.abs().amax(dim=-2, keepdim=True), 7.0).clamp_min(1e-8)
    q = torch.round(g / scale).clamp(-7, 7).to(torch.int8).reshape(wf.shape)
    return pack_int4(q), scale


def quantize_act_int8(x):
    """Per-row dynamic activation quantization -> (int8, (..., 1) f32 scale),
    factored out so that linears sharing one input quantize it once."""
    xf = x.float()
    xs = div_const(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs


# --------------------------------------------------------------------------
# The products
# --------------------------------------------------------------------------

def _int8_matmul(xq, w_q):
    """(..., in) int8 @ (in, out) int8 -> (..., out) float32 holding the
    exact int32 product. CUDA: `torch._int_mm` (rows padded past its
    minimum of 17); CPU: a float64 product, exact below 2^53."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    a = xq.reshape(-1, k)
    if a.device.type != "cuda":
        return (a.double() @ w_q.double()).float().reshape(lead + (w_q.shape[-1],))
    if k % 8 or w_q.shape[-1] % 8:
        raise ValueError(f"torch._int_mm needs dims that are multiples of 8, "
                         f"got {tuple(w_q.shape)}")
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, k))])
    if w_q.stride(0) != 1:                     # make it column-major
        w_q = w_q.t().contiguous().t()
    y = torch._int_mm(a.contiguous(), w_q)[:m]
    return y.float().reshape(lead + (w_q.shape[-1],))


def _fp8_matmul(xq, w_q):
    """(..., in) e4m3 @ (in, out) e4m3 -> (..., out) float32, accumulated in
    fp32. CUDA: `torch._scaled_mm` with unit scales (it wants a row-major
    first and a column-major second operand and dims that are multiples of
    16; rows are padded to that); CPU: an fp32 product of the exact upcasts."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    a = xq.reshape(-1, k)
    n = w_q.shape[-1]
    if a.device.type != "cuda":
        return (a.float() @ w_q.float()).reshape(lead + (n,))
    if k % 16 or n % 16:
        raise ValueError(f"torch._scaled_mm needs dims that are multiples of 16, "
                         f"got {tuple(w_q.shape)}")
    m = a.shape[0]
    pad = -m % 16
    if pad:
        a = torch.cat([a.view(torch.uint8), a.new_zeros((pad, k), dtype=torch.uint8)]
                      ).view(FP8)
    if w_q.stride(0) != 1:                     # make it column-major
        w_q = w_q.t().contiguous().t()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    y = torch._scaled_mm(a.contiguous(), w_q, scale_a=one, scale_b=one,
                         out_dtype=torch.float32)
    return y[:m].reshape(lead + (n,))


def _finish(y, xs, w_scale, bias, dtype):
    y = y * xs * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def linear_int8_prequant(xq, xs, w_q, w_scale, bias, out_dtype):
    """int8 linear on an already-quantized activation (`quantize_act_int8`)."""
    return _finish(_int8_matmul(xq, w_q), xs, w_scale, bias, out_dtype)


def linear_int8(x, w_q, w_scale, bias=None):
    """Dynamic-activation int8 linear: per-row x scale, per-column w scale."""
    xq, xs = quantize_act_int8(x)
    return linear_int8_prequant(xq, xs, w_q, w_scale, bias, x.dtype)


def fused_qkv_int8(x, pq, pk, pv):
    """q/k/v as one int8 product on a weight concatenated at run time: one
    activation quantize and one (S, in) @ (in, 3*out) GEMM, split after.
    Bit-identical to three `linear_int8` calls. pq/pk/pv: layers holding
    int8 `w_q`, `w_scale` and `b` (or None)."""
    xq, xs = quantize_act_int8(x)
    # concatenated through the transposes, so a column-major w_q stays so
    w = torch.cat([pq.w_q.t(), pk.w_q.t(), pv.w_q.t()], dim=0).t()
    s = torch.cat([pq.w_scale, pk.w_scale, pv.w_scale], dim=-1)
    y = _int8_matmul(xq, w) * xs * s
    d = pq.w_q.shape[-1]
    outs = []
    for i, p in enumerate((pq, pk, pv)):
        yi = y[..., i * d:(i + 1) * d]
        if p.b is not None:
            yi = yi + p.b.float()
        outs.append(yi.to(x.dtype).contiguous())
    return tuple(outs)


def dequant_int4_leaf(layer):
    """A per-column int4 layer as the int8 path's input: `w_q` unpacked to
    int8 (a transient; the layer itself stays packed), same scale and bias."""
    from types import SimpleNamespace
    return SimpleNamespace(w_q=unpack_int4(layer.w_q4), w_scale=layer.w_scale,
                           b=layer.b)


def linear_int4(x, w_q4, w_scale, bias=None):
    """w4a8: unpack the nibbles to int8 and take the int8 path."""
    return linear_int8(x, unpack_int4(w_q4), w_scale, bias)


def _dequant_int4_g(w_q4, w_scale):
    q = unpack_int4(w_q4)
    in_dim, out_dim = q.shape[-2], q.shape[-1]
    groups = w_scale.shape[-3]
    g = q.reshape(q.shape[:-2] + (groups, in_dim // groups, out_dim))
    return (g.float() * w_scale).reshape(q.shape)


def linear_int4_g(x, w_q4, w_scale, bias=None):
    """w4a16 group-dequant: int4 -> x.dtype with per-group scales, then one
    full-precision product. The group size is read off the scale's extra
    (in/group) axis."""
    w = _dequant_int4_g(w_q4, w_scale).to(x.dtype)             # (in, out)
    return linear(x, w.t(), bias)


def linear_fp8(x, w_q, w_scale, bias=None):
    """fp8 storage path (the reference's fp8_linear semantics: a row scale
    clamped to at least 1); the product accumulates in fp32."""
    xf = x.float()
    xs = div_const(xf.abs().amax(dim=-1, keepdim=True), 448.0).clamp_min(1.0)
    return _finish(_fp8_matmul((xf / xs).to(FP8), w_q), xs, w_scale, bias, x.dtype)


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

class QuantLinear(nn.Module):
    """A quantized linear layer: buffers `w_q` (int8 or e4m3) or `w_q4`
    (packed int4), `w_scale` (fp32) and `b` (or None), named as the JAX
    leaves are.

    `w_q` has the JAX shape (in, out), the shape the integer GEMM takes as
    its second operand, and is kept column-major in memory (the transpose
    of a contiguous (out, in) tensor): that is the operand layout
    `torch._int_mm` and `torch._scaled_mm` run without a copy."""

    def __init__(self, w_q=None, w_q4=None, w_scale=None, b=None):
        super().__init__()
        if (w_q is None) == (w_q4 is None):
            raise ValueError("exactly one of w_q and w_q4")
        if w_q is not None:
            w_q = w_q.t().contiguous().t()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_q4", w_q4)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)

    @property
    def in_features(self) -> int:
        return self.w_q.shape[0] if self.w_q is not None else self.w_q4.shape[0] * 2

    @property
    def out_features(self) -> int:
        return self.w_scale.shape[-1]

    @property
    def mode(self) -> str:
        if self.w_q4 is not None:
            grouped = self.w_scale.dim() == self.w_q4.dim() + 1
            return f"int4_g{self.in_features // self.w_scale.shape[-3]}" if grouped else "int4"
        return "int8" if self.w_q.dtype == torch.int8 else "fp8"

    def forward(self, x):
        return quantized_linear(x, self.w_q, self.w_q4, self.w_scale, self.b)

    def extra_repr(self) -> str:
        return f"in={self.in_features}, out={self.out_features}, mode={self.mode}"


def _quantizer(mode: str) -> Callable:
    quant = {"int8": quantize_weight_int8, "fp8": quantize_weight_fp8,
             "int4": quantize_weight_int4}.get(mode)
    if quant is None:
        if not mode.startswith("int4_g"):
            raise ValueError(f"unknown quantization mode {mode!r}")
        group = int(mode.split("_g")[1])
        return lambda w: quantize_weight_int4_g(w, group)
    return quant


def _replace_linears(module: nn.Module, fn: Callable, path: str = "", stack: int = 1):
    """Depth-first walk; fn(path, layer, stack) returns the layer or its
    replacement. `stack` is the length of the enclosing `nn.ModuleList`."""
    for name, child in list(module.named_children()):
        child_path = f"{path}.{name}" if path else name
        new = fn(child_path, child, stack)
        if new is not child:
            setattr(module, name, new)
        elif not isinstance(child, (nn.Linear, QuantLinear)):
            _replace_linears(child, fn, child_path,
                             len(child) if isinstance(child, nn.ModuleList) else stack)
    return module


@torch.no_grad()
def quantize_params(module: nn.Module, mode: str = "int8",
                    predicate: Optional[Callable[[str, nn.Module], bool]] = None,
                    min_size: int = 1 << 16, min_dim: int = 128) -> nn.Module:
    """Swap every eligible `nn.Linear` under `module` for a `QuantLinear`,
    in place (the JAX function returns a new tree); returns `module`.

    Kept in high precision, by the JAX rule: layers with fewer than
    `min_size` weight elements, with a dimension under `min_dim`, or for
    which predicate(dotted path, layer) is False. The JAX trees stack the
    layers of a block list along a leading axis, and its size rule counts
    the whole stack: a linear inside an `nn.ModuleList` counts its elements
    times the list's length.

    Modes: "int8" (w8a8), "fp8" (e4m3 storage), "int4" (w4a8 per column,
    0.5 byte/param), "int4_g128" (w4a16 group scales).

    A module that `parallel.shard_params_fsdp` wrapped is not changed in
    place: the quantised, sharded module is returned
    (`parallel.fsdp.quantize_sharded`; each rank quantises its own rows).
    Quantising first and sharding after gives the same pieces."""
    quant = _quantizer(mode)
    from ..parallel.fsdp import is_sharded, quantize_sharded
    if is_sharded(module):
        return quantize_sharded(
            module, lambda twin: quantize_params(twin, mode, predicate, min_size, min_dim),
            quant)

    def swap(path, layer, stack):
        if not isinstance(layer, nn.Linear):
            return layer
        w = layer.weight                                       # (out, in)
        if (w.numel() * stack < min_size or min(w.shape) < min_dim
                or (predicate is not None and not predicate(path, layer))):
            return layer
        q, scale = quant(w.detach().t())
        bias = None if layer.bias is None else layer.bias.detach()
        if mode.startswith("int4"):
            return QuantLinear(w_q4=q, w_scale=scale, b=bias)
        return QuantLinear(w_q=q, w_scale=scale, b=bias)

    return _replace_linears(module, swap)


def dequant_leaf(layer, dtype=torch.bfloat16):
    """A `QuantLinear` of any mode -> the (in, out) weight in `dtype`; any
    other layer is returned as it is."""
    if not isinstance(layer, QuantLinear):
        return layer
    if layer.w_q4 is not None:
        if layer.w_scale.dim() == layer.w_q4.dim() + 1:        # group scales
            w = _dequant_int4_g(layer.w_q4, layer.w_scale)
        else:
            w = unpack_int4(layer.w_q4).float() * layer.w_scale
    else:
        w = layer.w_q.float() * layer.w_scale
    return w.to(dtype)


@torch.no_grad()
def dequantize_params(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Inverse walk of `quantize_params`, in place: every `QuantLinear`
    becomes a plain linear layer in `dtype`."""
    from ..models.wan_dit import Linear

    def swap(path, layer, stack):
        if not isinstance(layer, QuantLinear):
            return layer
        w = dequant_leaf(layer, dtype)
        lin = Linear(w.shape[0], w.shape[1], bias=layer.b is not None,
                     device="meta", dtype=dtype)
        lin.weight = nn.Parameter(w.t().contiguous(), requires_grad=False)
        if layer.b is not None:
            lin.bias = nn.Parameter(layer.b.to(dtype), requires_grad=False)
        return lin

    return _replace_linears(module, swap)


def quantized_fraction(module: nn.Module) -> float:
    """Diagnostic: the fraction of linear weight elements that run quantized.
    As in the JAX package, layers holding `w_q` count as quantized, plain
    linears as not, and packed int4 layers (`w_q4`) are not counted at all."""
    q = n = 0
    for m in module.modules():
        if isinstance(m, QuantLinear):
            if m.w_q is not None:
                q += m.w_q.numel()
                n += m.w_q.numel()
        elif isinstance(m, nn.Linear) and m.weight.dim() >= 2:
            n += m.weight.numel()
    return q / max(n, 1)
