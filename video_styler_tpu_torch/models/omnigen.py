"""OmniGen (a Phi-3 decoder as the diffusion backbone) in PyTorch.

Counterpart of `video_styler_tpu/models/omnigen.py`: the noisy latents are
patchified (2x2) with the centre crop of a 2-D sin-cos table added, and
follow [text tokens (reference images' patches spliced in at their
placeholders) | a time token]; 32 Phi-3 layers (RMSNorm, fused qkv, the
LongRoPE "su"-scaled half rotation from explicit position ids, SiLU-gated
MLP) run under the prompter's mask (causal over the text, open over the
image tokens), then a DiT-style adaLN final layer on the image tokens.
Attention (heads of 96) is the exact `sdpa` under that mask, as in JAX.
The RoPE and position tables come from numpy.

Parameters keep the release's names (`llm.layers.{i}.self_attn.qkv_proj`,
`x_embedder.proj`, `time_token.mlp.0`, `final_layer.adaLN_modulation.1`,
...); `convert_omnigen` flattens the patch convolutions and takes the
position table's only row (or builds the table where the file has none).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .wan_dit import Linear


@dataclass(frozen=True)
class OmniGenConfig:
    hidden_size: int = 3072
    num_heads: int = 32
    num_layers: int = 32
    intermediate_size: int = 8192
    vocab_size: int = 32064
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    original_max_pos: int = 4096
    max_pos: int = 131072
    patch_size: int = 2
    in_channels: int = 4
    pos_embed_max_size: int = 192
    pe_interpolation: float = 1.0
    pos_base_size: int = 64

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


OMNIGEN = OmniGenConfig()
OMNIGEN_TINY = OmniGenConfig(hidden_size=32, num_heads=4, num_layers=2,
                             intermediate_size=64, vocab_size=64,
                             original_max_pos=32, max_pos=64,
                             pos_embed_max_size=8)

# Phi-3-128k's short su factors (image generation stays below
# original_max_pos)
PHI3_SU_SHORT = np.asarray(
    [1.05, 1.05, 1.05, 1.1, 1.1, 1.1, 1.2500000000000002, 1.2500000000000002,
     1.4000000000000004, 1.4500000000000004, 1.5500000000000005,
     1.8500000000000008, 1.9000000000000008] + [2.000000000000001] * 19
    + [2.1000000000000005, 2.1000000000000005, 2.2, 2.3499999999999996,
       2.3499999999999996, 2.3499999999999996, 2.3499999999999996,
       2.3999999999999995, 2.3999999999999995, 2.6499999999999986,
       2.6999999999999984, 2.8999999999999977, 2.9499999999999975,
       3.049999999999997, 3.049999999999997, 3.049999999999997],
    np.float64)


# ------------------------------------------------------------------ positions

def get_2d_sincos_pos_embed(cfg: OmniGenConfig) -> np.ndarray:
    """(max^2, hidden) float32: [sin | cos] per axis, the width positions
    first."""
    n = cfg.pos_embed_max_size
    grid = np.arange(n, dtype=np.float32) / (n / cfg.pos_base_size) / cfg.pe_interpolation
    gw, gh = np.meshgrid(grid, grid)
    half = cfg.hidden_size // 2

    def emb_1d(pos):
        omega = 1.0 / 10000.0 ** (np.arange(half // 2, dtype=np.float64) / (half / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([emb_1d(gw), emb_1d(gh)], axis=1).astype(np.float32)


def cropped_pos_embed(cfg: OmniGenConfig, table, height: int, width: int):
    """The centre crop of the table for a latent of height x width:
    (1, h * w, hidden)."""
    h, w = height // cfg.patch_size, width // cfg.patch_size
    n = cfg.pos_embed_max_size
    top, left = (n - h) // 2, (n - w) // 2
    return table.reshape(n, n, -1)[top:top + h, left:left + w].reshape(1, h * w, -1)


def longrope_tables(cfg: OmniGenConfig, positions: np.ndarray,
                    su_factor: Optional[np.ndarray] = None):
    """Phi-3 LongRoPE cos/sin (B, L, head_dim) float32 for position ids (B,
    L), float64 math."""
    d = cfg.head_dim
    inv = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    if su_factor is not None:
        inv = inv / np.asarray(su_factor, np.float64)
    scale = cfg.max_pos / cfg.original_max_pos
    mag = 1.0 if scale <= 1.0 else math.sqrt(
        1.0 + math.log(scale) / math.log(cfg.original_max_pos))
    freqs = np.asarray(positions).astype(np.float64)[..., None] * inv
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (np.cos(emb) * mag).astype(np.float32), (np.sin(emb) * mag).astype(np.float32)


# ------------------------------------------------------------------ modules

class _Weight(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class _SelfAttn(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.qkv_proj = Linear(d, 3 * d, bias=False, device=device, dtype=dtype)
        self.o_proj = Linear(d, d, bias=False, device=device, dtype=dtype)


class _MLP(nn.Module):
    def __init__(self, d: int, ffn: int, device=None, dtype=None):
        super().__init__()
        self.gate_up_proj = Linear(d, 2 * ffn, bias=False, device=device, dtype=dtype)
        self.down_proj = Linear(ffn, d, bias=False, device=device, dtype=dtype)


class Phi3Layer(nn.Module):
    def __init__(self, cfg: OmniGenConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.input_layernorm = _Weight(d, **kw)
        self.self_attn = _SelfAttn(d, **kw)
        self.post_attention_layernorm = _Weight(d, **kw)
        self.mlp = _MLP(d, cfg.intermediate_size, **kw)


class _LLM(nn.Module):
    def __init__(self, cfg: OmniGenConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(Phi3Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.norm = _Weight(cfg.hidden_size, **kw)


class _Proj(nn.Module):
    def __init__(self, din: int, dout: int, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(din, dout, device=device, dtype=dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.mlp = nn.ModuleDict({"0": Linear(256, d, device=device, dtype=dtype),
                                  "2": Linear(d, d, device=device, dtype=dtype)})


class _Final(nn.Module):
    def __init__(self, cfg: OmniGenConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(d, 2 * d, **kw)})
        self.linear = Linear(d, cfg.patch_size ** 2 * cfg.in_channels, **kw)


class OmniGen(nn.Module):
    """Parameters of OmniGen; `omnigen_forward` runs it."""

    def __init__(self, cfg: OmniGenConfig = OMNIGEN, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        patch_in = cfg.in_channels * cfg.patch_size ** 2
        self.cfg = cfg
        self.llm = _LLM(cfg, **kw)
        self.x_embedder = _Proj(patch_in, d, **kw)
        self.input_x_embedder = _Proj(patch_in, d, **kw)
        self.time_token = _Mlp(d, **kw)
        self.t_embedder = _Mlp(d, **kw)
        self.pos_embed = nn.Parameter(torch.empty(cfg.pos_embed_max_size ** 2, d, **kw))
        self.final_layer = _Final(cfg, **kw)


@torch.no_grad()
def init_omnigen_(model: OmniGen, generator: torch.Generator) -> OmniGen:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, norms 1, the token table N(0, 0.02^2), the sin-cos position
    table."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _Weight):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
    model.pos_embed.copy_(torch.from_numpy(get_2d_sincos_pos_embed(model.cfg)))
    return model


# ------------------------------------------------------------------ forward

def _rms(p: _Weight, x, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p.weight.float()).to(x.dtype)


def _rot_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def phi3_block(p: Phi3Layer, x, cos, sin, mask, cfg: OmniGenConfig):
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q, k, v = p.self_attn.qkv_proj(_rms(p.input_layernorm, x, cfg.rms_eps)).chunk(3, dim=-1)
    q, k, v = (t.reshape(b, s, n, hd) for t in (q, k, v))
    c, sn = cos[:, :, None].float(), sin[:, :, None].float()
    q = (q.float() * c + _rot_half(q.float()) * sn).to(x.dtype)
    k = (k.float() * c + _rot_half(k.float()) * sn).to(x.dtype)
    x = x + p.self_attn.o_proj(sdpa(q, k, v, bias=mask).reshape(b, s, d))
    gate, up = p.mlp.gate_up_proj(_rms(p.post_attention_layernorm, x, cfg.rms_eps)).chunk(2, -1)
    return x + p.mlp.down_proj(F.silu(gate) * up)


_T_FREQS = np.exp(-math.log(10000) * np.arange(128, dtype=np.float32) / 128)


def _t_embed(p: _Mlp, t, dtype):
    args = t.float()[:, None] * torch.from_numpy(_T_FREQS).to(t.device)[None]
    te = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(dtype)
    return p.mlp["2"](F.silu(p.mlp["0"](te)))


def _patchify(model: OmniGen, lat, embedder: _Proj, dtype):
    cfg, ps = model.cfg, model.cfg.patch_size
    hh, ww = lat.shape[-2:]
    p = lat.reshape(lat.shape[0], cfg.in_channels, hh // ps, ps, ww // ps, ps)
    p = p.permute(0, 2, 4, 1, 3, 5).reshape(lat.shape[0], (hh // ps) * (ww // ps), -1)
    return embedder.proj(p) + cropped_pos_embed(cfg, model.pos_embed, hh, ww).to(dtype)


def omnigen_forward(model: OmniGen, x, timestep, input_ids, input_img_latents,
                    input_image_sizes, attention_mask, position_ids=None, su_factor=None,
                    cos=None, sin=None):
    """x (B, 4, H, W) noisy latents; input_ids (B, L) or None;
    input_img_latents: (1, 4, h, w) reference latents spliced into the text
    at input_image_sizes {b: [(start, end), ...]}; attention_mask (B, S, S)
    {0, 1}; position_ids (B, S) numpy (or cos/sin given) -> (B, 4, H, W)."""
    cfg = model.cfg
    dtype = x.dtype
    b = x.shape[0]
    height, width = x.shape[-2:]
    tokens = _patchify(model, x, model.x_embedder, dtype)
    num_tokens = tokens.shape[1]
    time_token = _t_embed(model.time_token, timestep, dtype)[:, None]
    if input_ids is not None:
        cond = model.llm.embed_tokens.weight[input_ids.long()].to(dtype)
        if input_img_latents:
            cond = cond.clone()
            img_idx = 0
            for b_inx in dict(input_image_sizes or {}):
                for start, end in input_image_sizes[b_inx]:
                    ref = _patchify(model, input_img_latents[img_idx], model.input_x_embedder,
                                    dtype)
                    cond[b_inx, start:start + ref.shape[1]] = ref[0].to(dtype)
                    img_idx += 1
        n = cond.shape[0]
        h = torch.cat([cond, time_token.expand(n, 1, cfg.hidden_size),
                       tokens.expand(n, *tokens.shape[1:])], dim=1)
    else:
        h = torch.cat([time_token, tokens], dim=1)
    if cos is None:
        cos, sin = (torch.from_numpy(a).to(x.device)
                    for a in longrope_tables(cfg, np.asarray(position_ids), su_factor))
    mask = torch.where(attention_mask[:, None].bool(), 0.0, float("-inf")).float()
    for p in model.llm.layers:
        h = phi3_block(p, h, cos, sin, mask, cfg)
    h = _rms(model.llm.norm, h, cfg.rms_eps)
    img = h[:, -num_tokens:]
    temb = _t_embed(model.t_embedder, timestep, dtype)
    fl = model.final_layer
    shift, scale = fl.adaLN_modulation["1"](F.silu(temb.float()).to(dtype)).chunk(2, dim=1)
    img = layer_norm(img, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]
    img = fl.linear(img)
    ps = cfg.patch_size
    g_h, g_w = height // ps, width // ps
    img = img.reshape(b, g_h, g_w, ps, ps, cfg.in_channels)
    return img.permute(0, 5, 1, 3, 2, 4).reshape(b, cfg.in_channels, height, width)


def convert_omnigen(sd: Dict, cfg: OmniGenConfig = OMNIGEN) -> Dict:
    """An OmniGen checkpoint -> `OmniGen` state dict: the patch convolutions
    flattened, the position table's one row (or the sin-cos table where the
    file has none); keys the model does not hold dropped."""
    from .hunyuan_video_dit import _read
    with torch.device("meta"):
        names = OmniGen(cfg).state_dict().keys()
    out = {}
    for n in names:
        if n == "pos_embed":
            out[n] = (_read(sd["pos_embed"])[0] if "pos_embed" in sd
                      else torch.from_numpy(get_2d_sincos_pos_embed(cfg)))
        elif n in ("x_embedder.proj.weight", "input_x_embedder.proj.weight"):
            w = sd[n]
            out[n] = w.reshape(w.shape[0], w.shape.numel() // w.shape[0])
        else:
            out[n] = sd[n]
    return out
