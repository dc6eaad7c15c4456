"""umT5-xxl encoder (the Wan text encoder) in PyTorch.

Counterpart of `video_styler_tpu/models/t5.py`: per-layer relative position
bias (buckets computed with numpy), unscaled attention with an fp32 softmax
and a `finfo(float32).min` padding mask, gated-GELU FFN, T5 RMS layernorm.
This attention is no Pallas kernel in the JAX package either; its products
go to `torch.matmul`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..ops.basic import t5_layer_norm
from .wan_dit import Linear


@dataclass(frozen=True)
class T5Config:
    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32


UMT5_XXL = T5Config()


@lru_cache(maxsize=16)
def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              bidirectional: bool = True,
                              max_dist: int = 128) -> np.ndarray:
    """(lq, lk) int32 bucket ids (T5 relative position bucketing)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        rel_buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        rel_buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel_pos, 1) / max_exact) / math.log(max_dist / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets = rel_buckets + np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets.astype(np.int32)


def t5_gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                     * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


class Scale(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = Linear(cfg.dim, cfg.dim_attn, **kw)
        self.k = Linear(cfg.dim, cfg.dim_attn, **kw)
        self.v = Linear(cfg.dim, cfg.dim_attn, **kw)
        self.o = Linear(cfg.dim_attn, cfg.dim, **kw)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc1 = Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc2 = Linear(cfg.dim_ffn, cfg.dim, **kw)

    def forward(self, x):
        return self.fc2(self.fc1(x) * t5_gelu(self.gate(x)))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Scale(cfg.dim, **kw)
        self.norm2 = Scale(cfg.dim, **kw)
        self.attn = T5Attention(cfg, **kw)
        self.ffn = T5FFN(cfg, **kw)
        self.pos_emb = nn.Parameter(torch.empty(cfg.num_buckets, cfg.num_heads, **kw))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab, cfg.dim, **kw))
        self.blocks = nn.ModuleList(T5Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.norm = Scale(cfg.dim, **kw)


@torch.no_grad()
def init_t5_(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Random init with the JAX package's std: linears N(0, 1/in), norms 1,
    position tables N(0, 1/(2*buckets*heads)), token embedding N(0, 1)."""
    cfg = model.cfg
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)
        elif isinstance(m, T5Block):
            m.pos_emb.normal_(0.0, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
                              generator=generator)
    model.token_embedding.normal_(0.0, 1.0, generator=generator)
    return model


def t5_attention(p: T5Attention, x, pos_bias, mask, num_heads: int):
    """No scaling, additive position bias, fp32 logits and softmax."""
    b, s, _ = x.shape
    hd = p.q.weight.shape[0] // num_heads
    q = p.q(x).view(b, s, num_heads, hd)
    k = p.k(x).view(b, s, num_heads, hd)
    v = p.v(x).view(b, s, num_heads, hd)
    logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float()) + pos_bias
    if mask is not None:
        big_neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(mask[:, None, None, :] == 0, big_neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnij,bjnc->binc", probs.float(), v.float()).to(x.dtype)
    return p.o(out.reshape(b, s, num_heads * hd))


def _pos_bias(table, length: int, num_buckets: int):
    idx = torch.from_numpy(relative_position_buckets(length, length, num_buckets)
                           ).long().to(table.device)
    return table[idx].permute(2, 0, 1)[None].float()  # (1, H, lq, lk)


def t5_block(p: T5Block, x, mask, cfg: T5Config):
    pos_bias = _pos_bias(p.pos_emb, x.shape[1], cfg.num_buckets)
    x = x + t5_attention(p.attn, t5_layer_norm(x, p.norm1.scale), pos_bias,
                         mask, cfg.num_heads)
    return x + p.ffn(t5_layer_norm(x, p.norm2.scale))


def t5_encode(model: T5Encoder, ids, mask=None):
    """ids (B, L) integer -> embeddings (B, L, dim)."""
    x = model.token_embedding[ids.long()]
    for blk in model.blocks:
        x = t5_block(blk, x, mask, model.cfg)
    return t5_layer_norm(x, model.norm.scale)


def convert_t5(sd, cfg: T5Config):
    """Reference WanTextEncoder state dict -> `T5Encoder` state dict (the
    JAX package's `convert_t5`): per block the norms' `.weight`, the
    attention's q/k/v/o, the FFN's `gate.0`, `fc1`, `fc2`, and the block's
    own `pos_embedding.embedding.weight`. Values pass through."""
    out = {"token_embedding": sd["token_embedding.weight"],
           "norm.scale": sd["norm.weight"]}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        out[f"{pre}.norm1.scale"] = sd[f"{pre}.norm1.weight"]
        out[f"{pre}.norm2.scale"] = sd[f"{pre}.norm2.weight"]
        for name in ("q", "k", "v", "o"):
            out[f"{pre}.attn.{name}.weight"] = sd[f"{pre}.attn.{name}.weight"]
        out[f"{pre}.ffn.gate.weight"] = sd[f"{pre}.ffn.gate.0.weight"]
        out[f"{pre}.ffn.fc1.weight"] = sd[f"{pre}.ffn.fc1.weight"]
        out[f"{pre}.ffn.fc2.weight"] = sd[f"{pre}.ffn.fc2.weight"]
        out[f"{pre}.pos_emb"] = sd[f"{pre}.pos_embedding.embedding.weight"]
    return out
