"""Wan video diffusion transformer (DiT) in PyTorch.

Counterpart of `video_styler_tpu/models/wan_dit.py`. Parameters live in
`nn.Module`s named after the JAX pytree (`blocks` is an `nn.ModuleList` in
place of the stacked per-layer trees); the forward pieces are the same
functions: patchify, time/text embeddings, self-attention (K4 fused
RMSNorm+RoPE, then K1), cross-attention (K5 RMSNorm on Q, then K1), the
GELU-tanh FFN (after `ops.quant.quantize_params` the linears are
`QuantLinear`s, and int8 / per-column int4 q, k, v run as one fused GEMM), the 6-way adaLN-modulated block, VACE hint injection after
mapped layers, and the modulated head.

The single-GPU port has no mesh: the sharding constraints and the
mesh-divisibility padding of the JAX package are gone, so every token is
real and no key is masked.

`remat=True` (training) rematerialises each trunk block and each VACE
block in the backward, as `jax.checkpoint` does for the trunk in the JAX
package: the forward keeps only the block's input, the backward runs the
block again.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.basic import (gelu_tanh, layer_norm, linear, modulate, rms_norm,
                         silu, sinusoidal_embedding_1d)
from ..ops.fused_norm_rope import fused_rmsnorm, fused_rmsnorm_rope
from ..ops.rope import assemble_freqs_grid


@dataclass(frozen=True)
class WanDiTConfig:
    dim: int
    in_dim: int
    ffn_dim: int
    out_dim: int
    num_heads: int
    num_layers: int
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_T2V_14B = WanDiTConfig(dim=5120, in_dim=16, ffn_dim=13824, out_dim=16,
                           num_heads=40, num_layers=40)


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

class Linear(nn.Linear):
    """nn.Linear whose forward is `ops.basic.linear` (weight cast to x.dtype,
    fp32 accumulation, bias added before the rounding)."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class LayerNormAffine(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = Linear(dim, dim, **kw)
        self.k = Linear(dim, dim, **kw)
        self.v = Linear(dim, dim, **kw)
        self.o = Linear(dim, dim, **kw)
        self.norm_q = RMSNorm(dim, **kw)
        self.norm_k = RMSNorm(dim, **kw)


class FFN(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, ffn_dim, device=device, dtype=dtype)
        self.fc2 = Linear(ffn_dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class DiTBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.self_attn = Attention(cfg.dim, **kw)
        self.cross_attn = Attention(cfg.dim, **kw)
        self.norm3 = LayerNormAffine(cfg.dim, **kw)
        self.ffn = FFN(cfg.dim, cfg.ffn_dim, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 6, cfg.dim, **kw))


class TextEmbedding(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(cfg.text_dim, cfg.dim, device=device, dtype=dtype)
        self.fc2 = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)


class TimeEmbedding(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(cfg.freq_dim, cfg.dim, device=device, dtype=dtype)
        self.fc2 = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)


class Head(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        pt, ph, pw = cfg.patch_size
        self.head = Linear(cfg.dim, cfg.out_dim * pt * ph * pw,
                           device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 2, cfg.dim,
                                                   device=device, dtype=dtype))


class WanDiT(nn.Module):
    """Parameters of the Wan DiT; `wan_dit_forward` runs it."""

    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pt, ph, pw = cfg.patch_size
        self.cfg = cfg
        self.patch_embedding = Linear(cfg.in_dim * pt * ph * pw, cfg.dim, **kw)
        self.text_embedding = TextEmbedding(cfg, **kw)
        self.time_embedding = TimeEmbedding(cfg, **kw)
        self.time_projection = Linear(cfg.dim, cfg.dim * 6, **kw)
        self.head = Head(cfg, **kw)
        self.blocks = nn.ModuleList(DiTBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers))


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, norm scales 1, modulation tables N(0, 1/dim), other free
    parameters (embedding tables) N(0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (RMSNorm, LayerNormAffine)):
            m.scale.fill_(1.0)
            if isinstance(m, LayerNormAffine):
                m.bias.zero_()
        elif isinstance(m, (DiTBlock, Head)):
            m.modulation.normal_(0.0, 1.0 / math.sqrt(m.modulation.shape[-1]),
                                 generator=generator)
    return module


# --------------------------------------------------------------------------
# Forward pieces
# --------------------------------------------------------------------------

def _split_mod(modulation, t_mod, n: int) -> List[torch.Tensor]:
    """(1, n, D) table + (B, n, D) t_mod -> n terms of shape (B, 1, D)."""
    mod = modulation.to(t_mod.dtype) + t_mod
    return [mod[:, i][:, None, :] for i in range(n)]


def self_attention(p: Attention, x, cos, sin, num_heads: int,
                   eps: float = 1e-6):
    b, s, d = x.shape
    mode = getattr(p.q, "mode", None)
    if mode in ("int8", "int4"):
        # one activation quantize and one (S, in) @ (in, 3*out) int8 GEMM;
        # per-column int4 unpacks its nibbles to int8 first
        from ..ops.quant import dequant_int4_leaf, fused_qkv_int8
        pq, pk, pv = p.q, p.k, p.v
        if mode == "int4":
            pq, pk, pv = (dequant_int4_leaf(pq), dequant_int4_leaf(pk),
                          dequant_int4_leaf(pv))
        q0, k0, v = fused_qkv_int8(x, pq, pk, pv)
    else:
        q0, k0, v = p.q(x), p.k(x), p.v(x)
    q, k = fused_rmsnorm_rope(q0, k0, p.norm_q.scale, p.norm_k.scale,
                              cos, sin, eps)
    v = v.view(b, s, num_heads, d // num_heads)
    out = attention(q, k, v)
    return p.o(out.reshape(b, s, d))


def cross_attention(p: Attention, x, y, num_heads: int, eps: float = 1e-6):
    b, s, d = x.shape
    hd = d // num_heads
    q = fused_rmsnorm(p.q(x), p.norm_q.scale, eps)
    k = rms_norm(p.k(y), p.norm_k.scale, eps)
    v = p.v(y)
    out = attention(q.view(b, s, num_heads, hd),
                    k.view(b, y.shape[1], num_heads, hd),
                    v.view(b, y.shape[1], num_heads, hd))
    return p.o(out.reshape(b, s, d))


def dit_block(p: DiTBlock, x, context, t_mod, cos, sin, cfg: WanDiTConfig):
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        _split_mod(p.modulation, t_mod, 6)
    h = modulate(layer_norm(x, eps=cfg.eps), shift_msa, scale_msa)
    x = x + gate_msa * self_attention(p.self_attn, h, cos, sin,
                                      cfg.num_heads, cfg.eps)
    x = x + cross_attention(p.cross_attn,
                            layer_norm(x, p.norm3.scale, p.norm3.bias, cfg.eps),
                            context, cfg.num_heads, cfg.eps)
    h = modulate(layer_norm(x, eps=cfg.eps), shift_mlp, scale_mlp)
    return x + gate_mlp * p.ffn(h)


def block_fn(remat: bool):
    """`dit_block`, or with remat a version whose activations are recomputed
    in the backward (torch.utils.checkpoint, non-reentrant); same values."""
    if not remat:
        return dit_block

    def run(*args):
        return checkpoint(dit_block, *args, use_reentrant=False)
    return run


def run_blocks(blocks: Sequence[DiTBlock], x, context, t_mod, cos, sin,
               cfg: WanDiTConfig, vace_hints=None,
               vace_layers: Optional[Sequence[int]] = None,
               vace_scale: float = 1.0, remat: bool = False, layer_gate=None):
    """The block stack; VACE hint j is added after layer vace_layers[j],
    cast to the trunk dtype (the scale too, so an fp32 scale never promotes
    a bf16 trunk).

    layer_gate: optional (num_layers, B) tensor; layer i's update of batch
    row b becomes x + g[i, b] * (block(x) - x) in the trunk dtype, so a 0
    makes the block an identity for that row (skip-layer guidance)."""
    inject = {}
    if vace_hints is not None and vace_layers is not None:
        inject = {layer: j for j, layer in enumerate(vace_layers)}
    body = block_fn(remat)
    for i, blk in enumerate(blocks):
        y = body(blk, x, context, t_mod, cos, sin, cfg)
        if layer_gate is not None:
            y = x + layer_gate[i].to(x.dtype)[:, None, None] * (y - x)
        x = y
        if i in inject:
            x = x + vace_hints[inject[i]].to(x.dtype) * \
                torch.tensor(vace_scale, dtype=x.dtype, device=x.device)
    return x


def patchify(p: Linear, x, patch_size: Tuple[int, int, int]):
    """(B, C, F, H, W) -> tokens (B, f*h*w, dim) and the (f, h, w) grid;
    token features flatten in (c, pt, ph, pw) order."""
    pt, ph, pw = patch_size
    b, c, F_, H, W = x.shape
    f, h, w = F_ // pt, H // ph, W // pw
    t = x.reshape(b, c, f, pt, h, ph, w, pw)
    t = t.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, f * h * w, c * pt * ph * pw)
    return p(t), (f, h, w)


def unpatchify(x, grid: Tuple[int, int, int], patch_size: Tuple[int, int, int],
               out_dim: int):
    """(B, f*h*w, pt*ph*pw*c) -> (B, c, F, H, W), features in (pt, ph, pw, c)
    order."""
    f, h, w = grid
    pt, ph, pw = patch_size
    b = x.shape[0]
    t = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    t = t.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return t.reshape(b, out_dim, f * pt, h * ph, w * pw)


def time_embed(model: WanDiT, timestep):
    """timestep (B,) -> (t, t_mod (B, 6, dim))."""
    cfg = model.cfg
    emb = sinusoidal_embedding_1d(cfg.freq_dim, timestep.float())
    te = model.time_embedding
    emb = emb.to(te.fc1.weight.dtype)
    t = te.fc2(silu(te.fc1(emb)))
    t_mod = model.time_projection(silu(t))
    return t, t_mod.reshape(t_mod.shape[:-1] + (6, cfg.dim))


def text_embed(model: WanDiT, context):
    p = model.text_embedding
    return p.fc2(gelu_tanh(p.fc1(context)))


def head(model: WanDiT, x, t):
    p = model.head
    mod = p.modulation.to(t.dtype) + t[:, None, :]
    shift, scale = mod[:, 0][:, None, :], mod[:, 1][:, None, :]
    x = layer_norm(x, eps=model.cfg.eps) * (1 + scale) + shift
    return p.head(x)


def wan_dit_forward_with_residual(model: WanDiT, x, timestep, context,
                                  rope_indices=None, vace=None,
                                  vace_context=None, vace_scale: float = 1.0,
                                  remat: bool = False, layer_gate=None):
    """`wan_dit_forward`, also returning the block stack's residual
    (tokens out - tokens in, (B, S, dim)) that TeaCache replays."""
    cfg = model.cfg
    t, t_mod = time_embed(model, timestep)
    context = text_embed(model, context)
    tokens_in, (f, h, w) = patchify(model.patch_embedding, x, cfg.patch_size)
    cos, sin = assemble_freqs_grid(cfg.head_dim, f, h, w, rope_indices,
                                   device=tokens_in.device)
    hints = None
    if vace is not None and vace_context is not None:
        from .wan_vace import vace_forward
        hints = vace_forward(vace, tokens_in, vace_context, context, t_mod,
                             cos, sin, remat=remat)
    tokens = run_blocks(model.blocks, tokens_in, context, t_mod, cos, sin, cfg,
                        vace_hints=hints,
                        vace_layers=None if hints is None else vace.cfg.vace_layers,
                        vace_scale=vace_scale, remat=remat, layer_gate=layer_gate)
    out = unpatchify(head(model, tokens, t), (f, h, w), cfg.patch_size,
                     cfg.out_dim)
    return out, tokens - tokens_in


def wan_dit_forward(model: WanDiT, x, timestep, context, rope_indices=None,
                    vace=None, vace_context=None, vace_scale: float = 1.0,
                    remat: bool = False, layer_gate=None):
    """Full DiT forward, optionally with the VACE branch.

    x: (B, C, F, H, W) latents; timestep: (B,); context: (B, L, text_dim);
    vace: a `WanVace`, vace_context: (B, vace_in_dim, F, H, W).
    layer_gate: optional (num_layers, B) per-row block gates (`run_blocks`).
    remat: recompute each trunk block and each VACE block in the backward.
    The JAX package's `remat` covers the trunk only
    (`models/wan_vace.py:85-92`); the VACE blocks are recomputed too because
    their activations at 29,640 tokens do not fit one 80 GB card beside the
    14B weights. It changes no value."""
    return wan_dit_forward_with_residual(model, x, timestep, context,
                                         rope_indices, vace, vace_context,
                                         vace_scale, remat, layer_gate)[0]
