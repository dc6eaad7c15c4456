"""CogVideoX (the DiT and its VAE) in PyTorch.

Counterpart of `video_styler_tpu/models/cog_video.py`:

- the DiT: 42 joint blocks over [text | video] with one affine LayerNorm
  modulated per stream, per-head affine LayerNorm on q and k, and the 3-D
  interleaved RoPE on the video rows, whose spatial grid is resampled into
  the 480x720 training crop (`cog_rope`, numpy tables cached per grid).
  Heads are 64 wide: the JAX dispatcher sends a head dim that is not a
  multiple of 128 to the exact `sdpa` (`video_styler_tpu/ops/attention.py:
  67-72`) and K1 takes 128 only, so the attention is the port's exact
  `ops.attention.sdpa`, run by heads where the fp32 logits of one call
  would pass `ATTN_SPLIT_BYTES` (the same arithmetic a head);
- the VAE: causal convolutions whose cache starts as the first frame
  twice, GroupNorm (eps 1e-6) in the encoder, the spatial norm on the
  latents in the decoder, and the chunk schedules of the reference
  (8 video frames, 2 latent frames a chunk) with the 2-frame caches carried
  (`wan_vae._CacheIO`); each chunk normalises over itself, as the
  reference does. fp32 with cuDNN convolutions.

Parameters keep the reference's names (`blocks.{i}.attn1.to_q`,
`time_embedder.timestep_embedder.0`, `blocks.{i}.norm1.norm_layer`, ...);
`convert_cog_dit` flattens the patch convolution; the VAE's names pass
through.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import gelu_tanh, layer_norm
from .flux_dit import rope_apply_interleaved, timestep_embedding_flux
from .wan_dit import Linear
from .wan_vae import _CacheIO

ATTN_SPLIT_BYTES = 8 << 30


@dataclass(frozen=True)
class CogDiTConfig:
    dim: int = 3072
    cond_dim: int = 512
    num_heads: int = 48
    num_layers: int = 42
    in_channels: int = 16
    text_dim: int = 4096
    time_freq_dim: int = 3072
    theta: int = 10000
    base_height: int = 480
    base_width: int = 720
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


COG_VIDEO_X = CogDiTConfig()
COG_DIT_TINY = CogDiTConfig(dim=96, cond_dim=32, num_heads=2, num_layers=2,
                            text_dim=64, time_freq_dim=64)
COG_VAE_SCALING = 0.7


def cog_rope(cfg: CogDiTConfig, t: int, h: int, w: int):
    """cos/sin (t*h*w, head_dim / 2), float32: the fractional grid in the
    training crop, channels (head_dim/4, 3/8, 3/8) over (t, h, w)."""
    bw, bh = cfg.base_width // 16, cfg.base_height // 16
    if h / w > bh / bw:
        rh, rw = bh, int(round(bh / h * w))
    else:
        rw, rh = bw, int(round(bw / w * h))
    top = int(round((bh - rh) / 2.0))
    left = int(round((bw - rw) / 2.0))
    grid_h = np.linspace(top, top + rh, h, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(left, left + rw, w, endpoint=False, dtype=np.float32)
    grid_t = np.linspace(0, t, t, endpoint=False, dtype=np.float32)
    d = cfg.head_dim
    dim_t, dim_h, dim_w = d // 4, d // 8 * 3, d // 8 * 3

    def freqs(grid, dim):
        f = 1.0 / cfg.theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
        return np.einsum("n,f->nf", grid, f)

    ft, fh, fw = freqs(grid_t, dim_t), freqs(grid_h, dim_h), freqs(grid_w, dim_w)
    full = np.concatenate([
        np.broadcast_to(ft[:, None, None], (t, h, w, ft.shape[-1])),
        np.broadcast_to(fh[None, :, None], (t, h, w, fh.shape[-1])),
        np.broadcast_to(fw[None, None, :], (t, h, w, fw.shape[-1])),
    ], axis=-1).reshape(t * h * w, -1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@lru_cache(maxsize=8)
def _rope_on(cfg: CogDiTConfig, t: int, h: int, w: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in cog_rope(cfg, t, h, w))


# ------------------------------------------------------------------ DiT modules

class _Ada(nn.Module):
    def __init__(self, cfg: CogDiTConfig, n: int, device=None, dtype=None):
        super().__init__()
        self.linear = Linear(cfg.cond_dim, n * cfg.dim, device=device, dtype=dtype)
        self.norm = nn.LayerNorm(cfg.dim, device=device, dtype=dtype)


class _Attn(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.to_q = Linear(d, d, **kw)
        self.to_k = Linear(d, d, **kw)
        self.to_v = Linear(d, d, **kw)
        self.to_out = Linear(d, d, **kw)


class CogBlock(nn.Module):
    def __init__(self, cfg: CogDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.norm1 = _Ada(cfg, 6, **kw)
        self.attn1 = _Attn(d, **kw)
        self.norm_q = nn.LayerNorm(cfg.head_dim, **kw)
        self.norm_k = nn.LayerNorm(cfg.head_dim, **kw)
        self.norm2 = _Ada(cfg, 6, **kw)
        self.ff = nn.ModuleDict({"0": Linear(d, 4 * d, **kw), "2": Linear(4 * d, d, **kw)})


class _Patchify(nn.Module):
    def __init__(self, cfg: CogDiTConfig, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(cfg.in_channels * 4, cfg.dim, device=device, dtype=dtype)


class _TimeEmbedder(nn.Module):
    def __init__(self, cfg: CogDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.timestep_embedder = nn.ModuleDict({
            "0": Linear(cfg.time_freq_dim, cfg.cond_dim, **kw),
            "2": Linear(cfg.cond_dim, cfg.cond_dim, **kw)})


class CogDiT(nn.Module):
    """Parameters of the CogVideoX DiT; `cog_dit_forward` runs it."""

    def __init__(self, cfg: CogDiTConfig = COG_VIDEO_X, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.patchify = _Patchify(cfg, **kw)
        self.time_embedder = _TimeEmbedder(cfg, **kw)
        self.context_embedder = Linear(cfg.text_dim, d, **kw)
        self.blocks = nn.ModuleList(CogBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.norm_final = nn.LayerNorm(d, **kw)
        self.norm_out = _Ada(cfg, 2, **kw)
        self.proj_out = Linear(d, cfg.in_channels * 4, **kw)


@torch.no_grad()
def init_cog_dit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, LayerNorms 1 and 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


# ------------------------------------------------------------------ DiT forward

def _ada(p: _Ada, x_a, x_b, temb, eps: float):
    sh_a, sc_a, g_a, sh_b, sc_b, g_b = p.linear(F.silu(temb))[:, None].chunk(6, dim=-1)
    na = layer_norm(x_a, p.norm.weight, p.norm.bias, eps) * (1 + sc_a) + sh_a
    nb = layer_norm(x_b, p.norm.weight, p.norm.bias, eps) * (1 + sc_b) + sh_b
    return na, nb, g_a, g_b


def _ln_head(p: nn.LayerNorm, x, eps: float):
    return layer_norm(x, eps=eps) * p.weight.to(x.dtype) + p.bias.to(x.dtype)


def cog_block(p: CogBlock, vid, txt, temb, cos, sin, cfg: CogDiTConfig):
    nv, nt, g_a, g_b = _ada(p.norm1, vid, txt, temb, cfg.eps)
    x = torch.cat([nt, nv], dim=1)
    nh, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = x.shape
    q = _ln_head(p.norm_q, p.attn1.to_q(x).reshape(b, s, nh, hd), 1e-6)
    k = _ln_head(p.norm_k, p.attn1.to_k(x).reshape(b, s, nh, hd), 1e-6)
    v = p.attn1.to_v(x).reshape(b, s, nh, hd)
    st = txt.shape[1]
    q = torch.cat([q[:, :st], rope_apply_interleaved(q[:, st:], cos, sin)], dim=1)
    k = torch.cat([k[:, :st], rope_apply_interleaved(k[:, st:], cos, sin)], dim=1)
    out = p.attn1.to_out(sdpa(q, k, v, split_bytes=ATTN_SPLIT_BYTES).reshape(b, s, cfg.dim))
    vid = vid + g_a * out[:, st:]
    txt = txt + g_b * out[:, :st]

    nv, nt, g_a, g_b = _ada(p.norm2, vid, txt, temb, cfg.eps)
    vid = vid + g_a * p.ff["2"](gelu_tanh(p.ff["0"](nv)))
    txt = txt + g_b * p.ff["2"](gelu_tanh(p.ff["0"](nt)))
    return vid, txt


def cog_dit_forward(model: CogDiT, latents, timestep, prompt_emb):
    """latents (B, 16, T, H, W), timestep (B,), prompt_emb (B, L, 4096) ->
    the v-prediction (B, 16, T, H, W)."""
    cfg = model.cfg
    B, Cc, T, H, W = latents.shape
    vid = latents.reshape(B, Cc, T, H // 2, 2, W // 2, 2).permute(0, 2, 3, 5, 1, 4, 6)
    vid = model.patchify.proj(vid.reshape(B, T * (H // 2) * (W // 2), Cc * 4))
    te = model.time_embedder.timestep_embedder
    temb = timestep_embedding_flux(timestep, cfg.time_freq_dim).to(vid.dtype)
    temb = te["2"](F.silu(te["0"](temb)))
    txt = model.context_embedder(prompt_emb)
    cos, sin = _rope_on(cfg, T, H // 2, W // 2, latents.device)
    for p in model.blocks:
        vid, txt = cog_block(p, vid, txt, temb, cos, sin, cfg)
    vid = _ln_head(model.norm_final, vid, cfg.eps)
    sh, sc = model.norm_out.linear(F.silu(temb))[:, None].chunk(2, dim=-1)
    n = model.norm_out.norm
    vid = layer_norm(vid, n.weight, n.bias, cfg.eps) * (1 + sc) + sh
    vid = model.proj_out(vid)
    vid = vid.reshape(B, T, H // 2, W // 2, Cc, 2, 2).permute(0, 4, 1, 2, 5, 3, 6)
    return vid.reshape(B, Cc, T, H, W)


def convert_cog_dit(sd: Dict, cfg: CogDiTConfig = COG_VIDEO_X) -> Dict:
    """The reference state dict -> `CogDiT` state dict: the (1, 2, 2) patch
    convolution flattened; keys the DiT does not hold dropped."""
    with torch.device("meta"):
        names = CogDiT(cfg).state_dict().keys()
    out = {n: sd[n] for n in names}
    w = out["patchify.proj.weight"]
    out["patchify.proj.weight"] = w.reshape(w.shape[0], w.shape.numel() // w.shape[0])
    return out


# ------------------------------------------------------------------ VAE modules

COG_ENCODER_PLAN = (["res"] * 3 + [("down", True)] + ["res"] * 3
                    + [("down", True)] + ["res"] * 3 + [("down", False)]
                    + ["res"] * 5)
COG_DECODER_PLAN = (["res"] * 6 + [("up", True)] + ["res"] * 4
                    + [("up", True)] + ["res"] * 4 + [("up", False)]
                    + ["res"] * 4)
ENCODER_WIDTHS = (128, 256, 256, 512)      # per level, the encoder's resnets
DECODER_WIDTHS = (512, 256, 256, 128)
Z_CHANNELS = 16
GROUPS = 32


class SpatialNorm(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_layer = nn.GroupNorm(GROUPS, c, **kw)
        self.conv_y = nn.Conv3d(Z_CHANNELS, c, 1, **kw)
        self.conv_b = nn.Conv3d(Z_CHANNELS, c, 1, **kw)


class CogResnet(nn.Module):
    def __init__(self, cin: int, cout: int, spatial: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = SpatialNorm(cin, **kw) if spatial else nn.GroupNorm(GROUPS, cin, **kw)
        self.conv1 = nn.Conv3d(cin, cout, 3, **kw)
        self.norm2 = SpatialNorm(cout, **kw) if spatial else nn.GroupNorm(GROUPS, cout, **kw)
        self.conv2 = nn.Conv3d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = nn.Conv3d(cin, cout, 1, **kw)


class _Resample(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, device=device, dtype=dtype)


def _vae_blocks(plan, widths, spatial: bool, start: int, **kw) -> nn.ModuleList:
    blocks, level, cur, first = [], 0, start, True
    for op in plan:
        if op == "res":
            blocks.append(CogResnet(cur, widths[level], spatial, **kw))
            cur = widths[level]
        else:
            blocks.append(_Resample(cur, **kw))
            level += 1
    return nn.ModuleList(blocks)


class CogVAEEncoder(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_in = nn.Conv3d(3, ENCODER_WIDTHS[0], 3, **kw)
        self.blocks = _vae_blocks(COG_ENCODER_PLAN, ENCODER_WIDTHS, False, ENCODER_WIDTHS[0],
                                  **kw)
        self.norm_out = nn.GroupNorm(GROUPS, ENCODER_WIDTHS[-1], **kw)
        self.conv_out = nn.Conv3d(ENCODER_WIDTHS[-1], 2 * Z_CHANNELS, 3, **kw)


class CogVAEDecoder(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_in = nn.Conv3d(Z_CHANNELS, DECODER_WIDTHS[0], 3, **kw)
        self.blocks = _vae_blocks(COG_DECODER_PLAN, DECODER_WIDTHS, True, DECODER_WIDTHS[0],
                                  **kw)
        self.norm_out = SpatialNorm(DECODER_WIDTHS[-1], **kw)
        self.conv_out = nn.Conv3d(DECODER_WIDTHS[-1], 3, 3, **kw)


@torch.no_grad()
def init_cog_vae_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init: conv weights N(0, 1/fan_in), biases N(0, 0.02^2), norm
    weights 1 + N(0, 0.1^2) and biases N(0, 0.1^2)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.normal_(1.0, 0.1, generator=generator)
            m.bias.normal_(0.0, 0.1, generator=generator)
    return model


# ------------------------------------------------------------------ VAE forward

def _cached_conv3d(p: nn.Conv3d, x, io: Optional[_CacheIO] = None):
    """The reference's CachedConv3d: the first frame twice in front (a
    fresh cache), or the 2-frame tail of the previous chunk's padded input."""
    if io is None:
        xin = torch.cat([x[:, :, :1], x[:, :, :1], x], dim=2)
    else:
        cache = io.get(lambda: torch.cat([x[:, :, :1], x[:, :, :1]], dim=2))
        xin = torch.cat([cache, x], dim=2)
        io.put(xin[:, :, -2:])
    return F.conv3d(xin, p.weight.to(xin.dtype), p.bias.to(xin.dtype), 1, (0, 1, 1))


def _gn(p: nn.GroupNorm, x, eps: float = 1e-6):
    return F.group_norm(x.float(), GROUPS, p.weight.float(), p.bias.float(), eps).to(x.dtype)


def _nearest_resize_3d(z, size):
    T, H, W = size
    ti = torch.arange(T, device=z.device) * z.shape[2] // T
    hi = torch.arange(H, device=z.device) * z.shape[3] // H
    wi = torch.arange(W, device=z.device) * z.shape[4] // W
    return z[:, :, ti][:, :, :, hi][:, :, :, :, wi]


def _conv1x1(p: nn.Conv3d, x):
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype))


def _spatial_norm(p: SpatialNorm, f, zq):
    if f.shape[2] > 1 and f.shape[2] % 2 == 1:
        zf = _nearest_resize_3d(zq[:, :, :1], (1,) + tuple(f.shape[3:]))
        zr = _nearest_resize_3d(zq[:, :, 1:], (f.shape[2] - 1,) + tuple(f.shape[3:]))
        zq = torch.cat([zf, zr], dim=2)
    else:
        zq = _nearest_resize_3d(zq, tuple(f.shape[2:]))
    return _gn(p.norm_layer, f) * _conv1x1(p.conv_y, zq) + _conv1x1(p.conv_b, zq)


def _silu(h):
    return F.silu(h.float()).to(h.dtype)


def _resnet3d(p: CogResnet, x, zq, io=None):
    res = x
    h = _spatial_norm(p.norm1, x, zq) if isinstance(p.norm1, SpatialNorm) else _gn(p.norm1, x)
    h = _cached_conv3d(p.conv1, _silu(h), io)
    h = _spatial_norm(p.norm2, h, zq) if isinstance(p.norm2, SpatialNorm) else _gn(p.norm2, h)
    h = _cached_conv3d(p.conv2, _silu(h), io)
    if hasattr(p, "conv_shortcut"):
        w = p.conv_shortcut.weight
        res = (_cached_conv3d(p.conv_shortcut, res, io) if w.shape[2] == 3
               else _conv1x1(p.conv_shortcut, res))
    return h + res


def _frames_conv2d(p: nn.Conv2d, x, stride: int, padding: int):
    b, c, t, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * t, c, h, w)
    y = F.conv2d(x2, p.weight.to(x.dtype), p.bias.to(x.dtype), stride, padding)
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


def _downsample3d(p: _Resample, x, compress_time: bool):
    if compress_time:
        b, c, t, h, w = x.shape
        if t % 2 == 1:
            first, rest = x[:, :, :1], x[:, :, 1:]
            if rest.shape[2] > 0:
                rest = rest.reshape(b, c, rest.shape[2] // 2, 2, h, w).mean(dim=3)
            x = torch.cat([first, rest], dim=2)
        else:
            x = x.reshape(b, c, t // 2, 2, h, w).mean(dim=3)
    return _frames_conv2d(p.conv, F.pad(x, (0, 1, 0, 1)), 2, 0)


def _up2(x):
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


def _upsample3d(p: _Resample, x, compress_time: bool):
    if compress_time and x.shape[2] > 1 and x.shape[2] % 2 == 1:
        first = _up2(x[:, :, 0])[:, :, None]
        rest = _up2(x[:, :, 1:].repeat_interleave(2, dim=2))
        x = torch.cat([first, rest], dim=2)
    elif compress_time and x.shape[2] > 1:
        x = _up2(x.repeat_interleave(2, dim=2))
    else:
        x = _up2(x)
    return _frames_conv2d(p.conv, x, 1, 1)


def _encode_core(enc: CogVAEEncoder, video, io=None):
    h = _cached_conv3d(enc.conv_in, video, io)
    for p, op in zip(enc.blocks, COG_ENCODER_PLAN):
        h = _resnet3d(p, h, video, io=io) if op == "res" else _downsample3d(p, h, op[1])
    h = _silu(_gn(enc.norm_out, h))
    return _cached_conv3d(enc.conv_out, h, io)[:, :Z_CHANNELS]


def _decode_core(dec: CogVAEDecoder, z, io=None):
    h = _cached_conv3d(dec.conv_in, z, io)
    for p, op in zip(dec.blocks, COG_DECODER_PLAN):
        h = _resnet3d(p, h, z, io=io) if op == "res" else _upsample3d(p, h, op[1])
    h = _silu(_spatial_norm(dec.norm_out, h, z))
    return _cached_conv3d(dec.conv_out, h, io)


def _encode_chunks(T: int):
    """The reference's 8-frame schedule (an odd T puts the extra frame in
    chunk 0), with a final partial chunk where the reference drops the
    tail, as the JAX package does."""
    odd = T % 2
    chunks = [(0, min(9, T)) if odd and i == 0 else (8 * i + odd, 8 * i + 8 + odd)
              for i in range(max(T // 8, 1 if odd else 0))]
    if not chunks:
        return [(0, T)]
    if chunks[-1][1] < T:
        chunks.append((chunks[-1][1], T))
    return chunks


def _decode_chunks(T: int):
    odd = T % 2
    return [(0, 3) if odd and i == 0 else (2 * i + odd, 2 * i + 2 + odd)
            for i in range(T // 2)]


def cog_vae_encode(enc: CogVAEEncoder, video, scaling: float = COG_VAE_SCALING,
                   streaming: Optional[bool] = None):
    """video (B, 3, T, H, W) -> latents (B, 16, T', H/8, W/8), chunk by
    chunk with the caches carried (streaming=False: one pass)."""
    chunks = _encode_chunks(video.shape[2])
    if streaming is False or len(chunks) == 1:
        return _encode_core(enc, video) * scaling
    caches, outs = None, []
    for tl, tr in chunks:
        io = _CacheIO(caches)
        outs.append(_encode_core(enc, video[:, :, tl:tr], io))
        caches = io.out
    return torch.cat(outs, dim=2) * scaling


def cog_vae_decode(dec: CogVAEDecoder, latents, scaling: float = COG_VAE_SCALING,
                   streaming: Optional[bool] = None):
    """latents (B, 16, T, h, w) -> video (B, 3, T', 8h, 8w), 2 latent
    frames a chunk with the caches carried (one pass at T <= 2 or
    streaming=False)."""
    z = latents / scaling
    T = z.shape[2]
    if streaming is None:
        streaming = T > 2
    if not streaming or T <= 2:
        return _decode_core(dec, z)
    caches, outs = None, []
    for tl, tr in _decode_chunks(T):
        io = _CacheIO(caches)
        outs.append(_decode_core(dec, z[:, :, tl:tr], io))
        caches = io.out
    return torch.cat(outs, dim=2)
