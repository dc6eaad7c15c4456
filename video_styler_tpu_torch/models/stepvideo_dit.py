"""The StepVideo (Step-Video-T2V, 30B) DiT in PyTorch.

Counterpart of `video_styler_tpu/models/stepvideo_dit.py`: 48 PixArt-style
blocks of width 6144 (48 heads of 128) with a per-block scale/shift table
added to the adaLN-single timestep modulation, the half-rotation 3-D RoPE
split (64, 32, 32) over each head, per-head RMSNorm on q and k, a caption
projection of the Step-1 LLM's states with the CLIP states projected and
put in front, and a per-frame 1x1 patch embedding.

The self-attention goes through `ops.attention.attention`: K1 on the card
(bf16, head dim 128), its plain version on the CPU, as the JAX DiT calls its
`attention` (`stepvideo_dit.py:228`). The cross-attention to the text is
the exact `sdpa` under the text mask's bias, as in JAX (:238). The RoPE
tables come from numpy (float32) and are cached per grid on the device.

Parameters keep the reference's names (`transformer_blocks.{i}.attn1.wqkv`,
`adaln_single.emb.timestep_embedder.linear_1`, `caption_projection`,
`scale_shift_table`, ...); `convert_step_video_dit` only flattens the 1x1
patch convolution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention, sdpa
from ..ops.basic import gelu_tanh, layer_norm
from .flux_dit import timestep_embedding_flux
from .wan_dit import Linear


@dataclass(frozen=True)
class StepVideoDiTConfig:
    num_heads: int = 48
    head_dim: int = 128
    num_layers: int = 48
    in_channels: int = 64
    out_channels: int = 64
    caption_dim: int = 6144
    clip_dim: int = 1024
    rope_split: Tuple[int, ...] = (64, 32, 32)
    eps: float = 1e-6

    @property
    def dim(self) -> int:
        return self.num_heads * self.head_dim


STEP_VIDEO = StepVideoDiTConfig()
STEP_VIDEO_TINY = StepVideoDiTConfig(num_heads=4, head_dim=32, num_layers=2,
                                     in_channels=64, out_channels=64,
                                     caption_dim=96, clip_dim=48,
                                     rope_split=(16, 8, 8))


# ------------------------------------------------------------------ RoPE

def step_rope_tables(cfg: StepVideoDiTConfig, f: int, h: int, w: int):
    """[(cos, sin) per axis chunk], each (S, d_i) float32 with the [freqs |
    freqs] duplication of the half rotation."""
    tt, hh, ww = np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")
    mesh = np.stack([tt.ravel(), hh.ravel(), ww.ravel()], axis=-1)
    tables = []
    for i, d in enumerate(cfg.rope_split):
        inv = 1.0 / (1e4 ** (np.arange(0, d, 2, dtype=np.float32) / d))
        freqs = np.einsum("i,j->ij", mesh[:, i].astype(np.float32), inv)
        freqs = np.concatenate([freqs, freqs], axis=-1)
        tables.append((np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)))
    return tables


@lru_cache(maxsize=8)
def _rope_on(cfg: StepVideoDiTConfig, f: int, h: int, w: int, device: torch.device):
    return tuple((torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))
                 for c, s in step_rope_tables(cfg, f, h, w))


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def step_rope_apply(x, tables, rope_split):
    """x (B, S, N, D): each channel chunk rotated by halves in fp32."""
    outs, start = [], 0
    for (cos, sin), d in zip(tables, rope_split):
        xf = x[..., start:start + d].float()
        outs.append((xf * cos[None, :, None] + _rotate_half(xf) * sin[None, :, None])
                    .to(x.dtype))
        start += d
    return torch.cat(outs, dim=-1)


# ------------------------------------------------------------------ modules

class _Weight(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: StepVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.wqkv = Linear(d, 3 * d, bias=False, **kw)
        self.wo = Linear(d, d, bias=False, **kw)
        self.q_norm = _Weight(cfg.head_dim, **kw)
        self.k_norm = _Weight(cfg.head_dim, **kw)


class CrossAttention(nn.Module):
    def __init__(self, cfg: StepVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.wq = Linear(d, d, bias=False, **kw)
        self.wkv = Linear(d, 2 * d, bias=False, **kw)
        self.wo = Linear(d, d, bias=False, **kw)
        self.q_norm = _Weight(cfg.head_dim, **kw)
        self.k_norm = _Weight(cfg.head_dim, **kw)


class _FF(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.net = nn.ModuleDict({"0": nn.Module(), "2": Linear(4 * d, d, **kw)})
        self.net["0"].proj = Linear(d, 4 * d, **kw)


class StepBlock(nn.Module):
    def __init__(self, cfg: StepVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.attn1 = SelfAttention(cfg, **kw)
        self.attn2 = CrossAttention(cfg, **kw)
        self.ff = _FF(d, **kw)
        self.norm1 = nn.LayerNorm(d, **kw)
        self.norm2 = nn.LayerNorm(d, **kw)
        self.scale_shift_table = nn.Parameter(torch.empty(6, d, **kw))


class _Lin2(nn.Module):
    def __init__(self, din: int, d: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = Linear(din, d, device=device, dtype=dtype)
        self.linear_2 = Linear(d, d, device=device, dtype=dtype)


class _AdaLNSingle(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.emb = nn.Module()
        self.emb.timestep_embedder = _Lin2(256, d, device=device, dtype=dtype)
        self.linear = Linear(d, 6 * d, device=device, dtype=dtype)


class _PosEmbed(nn.Module):
    def __init__(self, cin: int, d: int, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(cin, d, device=device, dtype=dtype)


class StepVideoDiT(nn.Module):
    """Parameters of the StepVideo DiT; `step_video_dit_forward` runs it."""

    def __init__(self, cfg: StepVideoDiTConfig = STEP_VIDEO, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.pos_embed = _PosEmbed(cfg.in_channels, d, **kw)
        self.adaln_single = _AdaLNSingle(d, **kw)
        self.caption_projection = _Lin2(cfg.caption_dim, d, **kw)
        self.clip_projection = Linear(cfg.clip_dim, d, **kw)
        self.transformer_blocks = nn.ModuleList(StepBlock(cfg, **kw)
                                                for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.empty(2, d, **kw))
        self.proj_out = Linear(d, cfg.out_channels, **kw)


@torch.no_grad()
def init_step_video_dit_(model: StepVideoDiT, generator: torch.Generator) -> StepVideoDiT:
    """Random init with the JAX package's std: linears N(0, 1/in), biases
    0, norms 1 and 0, scale/shift tables N(0, 1/dim)."""
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        if leaf == "scale_shift_table":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
        elif isinstance(owner, nn.Linear):
            if leaf == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            else:
                p.zero_()
        else:
            p.fill_(0.0 if leaf == "bias" else 1.0)
    return model


# ------------------------------------------------------------------ forward

def _rms_head(p: _Weight, x, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p.weight.float()).to(x.dtype)


def step_block(p: StepBlock, x, kv, temb6, tables, kv_bias, cfg: StepVideoDiTConfig):
    nh, hd, d = cfg.num_heads, cfg.head_dim, cfg.dim
    b, s = x.shape[:2]
    mods = (p.scale_shift_table[None].float() + temb6.reshape(-1, 6, d).float()).to(x.dtype)
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mods.split(1, dim=1)

    nx = layer_norm(x, p.norm1.weight, p.norm1.bias, 1e-5) * (1 + sc_msa) + sh_msa
    q, k, v = p.attn1.wqkv(nx).reshape(b, s, nh, 3 * hd).chunk(3, dim=-1)
    q = step_rope_apply(_rms_head(p.attn1.q_norm, q), tables, cfg.rope_split)
    k = step_rope_apply(_rms_head(p.attn1.k_norm, k), tables, cfg.rope_split)
    out = attention(q, k, v).reshape(b, s, d)
    x = x + g_msa * p.attn1.wo(out)

    q = _rms_head(p.attn2.q_norm, p.attn2.wq(x).reshape(b, s, nh, hd))
    k2, v2 = p.attn2.wkv(kv).reshape(kv.shape[0], kv.shape[1], nh, 2 * hd).chunk(2, dim=-1)
    k2 = _rms_head(p.attn2.k_norm, k2)
    x = x + p.attn2.wo(sdpa(q, k2, v2, bias=kv_bias).reshape(b, s, d))

    nx = layer_norm(x, p.norm2.weight, p.norm2.bias, 1e-5) * (1 + sc_mlp) + sh_mlp
    h = gelu_tanh(p.ff.net["0"].proj(nx))
    return x + g_mlp * p.ff.net["2"](h)


def step_video_dit_forward(model: StepVideoDiT, hidden_states, timestep,
                           encoder_hidden_states, encoder_hidden_states_2=None,
                           encoder_attention_mask=None):
    """hidden_states (B, F, C, H, W); timestep (B,) in [0, 1] (x 1000 for
    the embedding); encoder_hidden_states (B, L, 6144) the LLM's states;
    encoder_hidden_states_2 (B, L2, 1024) CLIP's; encoder_attention_mask
    (B, L2 + L) {0, 1} -> the velocity (B, F, C, H, W)."""
    cfg = model.cfg
    B, Fr, C, H, W = hidden_states.shape
    dtype = hidden_states.dtype
    x = model.pos_embed.proj(hidden_states.permute(0, 1, 3, 4, 2).reshape(B, Fr * H * W, C))

    te = model.adaln_single.emb.timestep_embedder
    emb = timestep_embedding_flux(timestep * 1000.0, 256).to(dtype)
    embedded_t = te.linear_2(F.silu(te.linear_1(emb)))
    temb6 = model.adaln_single.linear(F.silu(embedded_t))

    cp = model.caption_projection
    cap = layer_norm(encoder_hidden_states, eps=cfg.eps)
    cap = cp.linear_2(gelu_tanh(cp.linear_1(cap)))
    if encoder_hidden_states_2 is not None:
        cap = torch.cat([model.clip_projection(encoder_hidden_states_2), cap], dim=1)

    kv_bias = None
    if encoder_attention_mask is not None:
        m = encoder_attention_mask.bool()
        kv_bias = torch.where(m[:, None, None, :], 0.0, torch.finfo(torch.float32).min)

    tables = _rope_on(cfg, Fr, H, W, x.device)
    for p in model.transformer_blocks:
        x = step_block(p, x, cap, temb6, tables, kv_bias, cfg)

    sh, sc = (model.scale_shift_table[None].float()
              + embedded_t[:, None].float()).to(dtype).chunk(2, dim=1)
    x = layer_norm(x, eps=cfg.eps) * (1 + sc) + sh
    x = model.proj_out(x)
    return x.reshape(B, Fr, H, W, cfg.out_channels).permute(0, 1, 4, 2, 3)


def convert_step_video_dit(sd: Dict, cfg: StepVideoDiTConfig = STEP_VIDEO) -> Dict:
    """The reference state dict -> `StepVideoDiT` state dict: the 1x1 patch
    convolution flattened; keys the DiT does not hold dropped."""
    with torch.device("meta"):
        names = StepVideoDiT(cfg).state_dict().keys()
    out = {n: sd[n] for n in names}
    w = out["pos_embed.proj.weight"]
    out["pos_embed.proj.weight"] = w.reshape(w.shape[0], w.shape.numel() // w.shape[0])
    return out
