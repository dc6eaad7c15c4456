"""Wan2.1 causal 3-D video VAE (8x8 spatial, 4x temporal, z=16) in PyTorch.

Counterpart of the Wan2.1 part of `video_styler_tpu/models/wan_vae.py`:
`vae_encode`/`vae_decode` over the whole clip, and the streaming forms
`vae_encode_stream`/`vae_decode_stream` that carry per-conv temporal caches
from chunk to chunk (`_CacheIO`), and the spatially tiled forms
`tiled_encode`/`tiled_decode`. `encode`/`decode` dispatch as the JAX
package does: the streaming form when `tiled=True` with `streaming` unset
(the pipeline default), spatial tiles with `streaming=False, tiled=True`.

The public contract is (B, C, T, H, W), and so is the internal layout here.
Parameters follow the JAX tree of `init_wan_vae` (torch names: `weight`,
`bias`, `gamma`; numbered children as in the checkpoints). The three
places where the causal design bites:
  - CausalConv3d zero-pads 2*pad_t frames on the left in time only;
  - `downsample3d`/`upsample3d` pass frame 0 through their time conv;
  - the upsampling time conv's channel halves become even/odd frames
    (`_interleave_time2`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WAN21_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN21_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    latent_mean: Tuple[float, ...] = WAN21_LATENT_MEAN
    latent_std: Tuple[float, ...] = WAN21_LATENT_STD

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))

    @property
    def upsampling_factor(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)


WAN21_VAE = WanVAEConfig()


# --------------------------------------------------------------------------
# Parameter containers (names follow the checkpoint / JAX tree)
# --------------------------------------------------------------------------

class Conv(nn.Module):
    """weight (O, I, *kernel), bias (O,): a 3-D (O,I,kt,kh,kw) or per-frame
    2-D (O,I,kh,kw) convolution."""

    def __init__(self, out_c: int, in_c: int, kernel: Tuple[int, ...],
                 device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_c, in_c) + tuple(kernel),
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_c, device=device, dtype=dtype))


class Gamma(nn.Module):
    def __init__(self, shape: Tuple[int, ...], device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(shape, device=device, dtype=dtype))


def _res_block(in_c: int, out_c: int, **kw) -> nn.ModuleDict:
    m = nn.ModuleDict({"residual": nn.ModuleDict({
        "0": Gamma((in_c, 1, 1, 1), **kw),
        "2": Conv(out_c, in_c, (3, 3, 3), **kw),
        "3": Gamma((out_c, 1, 1, 1), **kw),
        "6": Conv(out_c, out_c, (3, 3, 3), **kw),
    })})
    if in_c != out_c:
        m["shortcut"] = Conv(out_c, in_c, (1, 1, 1), **kw)
    return m


def _attn_block(c: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"norm": Gamma((c, 1, 1), **kw),
                          "to_qkv": Conv(3 * c, c, (1, 1), **kw),
                          "proj": Conv(c, c, (1, 1), **kw)})


def _resample(c: int, mode: str, **kw) -> nn.ModuleDict:
    if mode in ("downsample2d", "downsample3d"):
        m = nn.ModuleDict({"resample": nn.ModuleDict({"1": Conv(c, c, (3, 3), **kw)})})
        if mode == "downsample3d":
            m["time_conv"] = Conv(c, c, (3, 1, 1), **kw)
    else:
        m = nn.ModuleDict({"resample": nn.ModuleDict({"1": Conv(c // 2, c, (3, 3), **kw)})})
        if mode == "upsample3d":
            m["time_conv"] = Conv(c * 2, c, (3, 1, 1), **kw)
    return m


def _encoder_plan(cfg: WanVAEConfig):
    plan = []
    for i in range(len(cfg.dim_mult)):
        plan += [("res", None)] * cfg.num_res_blocks
        if i != len(cfg.dim_mult) - 1:
            plan.append(("resample", "downsample3d" if cfg.temperal_downsample[i]
                         else "downsample2d"))
    return plan


def _decoder_plan(cfg: WanVAEConfig):
    plan = []
    for i in range(len(cfg.dim_mult)):
        plan += [("res", None)] * (cfg.num_res_blocks + 1)
        if i != len(cfg.dim_mult) - 1:
            plan.append(("resample", "upsample3d" if cfg.temperal_upsample[i]
                         else "upsample2d"))
    return plan


class WanVAE(nn.Module):
    """Parameters of the Wan2.1 VAE (tree of `init_wan_vae` in the JAX
    package); `vae_encode`/`vae_decode` and their streaming forms run it."""

    def __init__(self, cfg: WanVAEConfig = WAN21_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        e_dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        down = nn.ModuleDict()
        in_c = e_dims[0]
        for i in range(len(cfg.dim_mult)):
            out_c = e_dims[i + 1]
            for _ in range(cfg.num_res_blocks):
                down[str(len(down))] = _res_block(in_c, out_c, **kw)
                in_c = out_c
            if i != len(cfg.dim_mult) - 1:
                mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
                down[str(len(down))] = _resample(out_c, mode, **kw)
        top = e_dims[-1]
        self.encoder = nn.ModuleDict({
            "conv1": Conv(e_dims[0], 3, (3, 3, 3), **kw),
            "downsamples": down,
            "middle": nn.ModuleDict({"0": _res_block(top, top, **kw),
                                     "1": _attn_block(top, **kw),
                                     "2": _res_block(top, top, **kw)}),
            "head": nn.ModuleDict({"0": Gamma((top, 1, 1, 1), **kw),
                                   "2": Conv(cfg.z_dim * 2, top, (3, 3, 3), **kw)}),
        })
        d_dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        up = nn.ModuleDict()
        for i in range(len(cfg.dim_mult)):
            in_c, out_c = d_dims[i], d_dims[i + 1]
            if i >= 1:
                in_c //= 2
            for _ in range(cfg.num_res_blocks + 1):
                up[str(len(up))] = _res_block(in_c, out_c, **kw)
                in_c = out_c
            if i != len(cfg.dim_mult) - 1:
                mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
                up[str(len(up))] = _resample(out_c, mode, **kw)
        self.decoder = nn.ModuleDict({
            "conv1": Conv(d_dims[0], cfg.z_dim, (3, 3, 3), **kw),
            "middle": nn.ModuleDict({"0": _res_block(d_dims[0], d_dims[0], **kw),
                                     "1": _attn_block(d_dims[0], **kw),
                                     "2": _res_block(d_dims[0], d_dims[0], **kw)}),
            "upsamples": up,
            "head": nn.ModuleDict({"0": Gamma((out_c, 1, 1, 1), **kw),
                                   "2": Conv(3, out_c, (3, 3, 3), **kw)}),
        })
        self.conv1 = Conv(cfg.z_dim * 2, cfg.z_dim * 2, (1, 1, 1), **kw)
        self.conv2 = Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), **kw)


@torch.no_grad()
def init_wan_vae_(model: WanVAE, generator: torch.Generator) -> WanVAE:
    """Random init with the JAX package's std: conv weights N(0, 1/fan_in),
    biases 0, gammas 1."""
    for m in model.modules():
        if isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, Gamma):
            m.gamma.fill_(1.0)
    return model


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def conv3d(p: Conv, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    """3-D conv on (B, C, T, H, W) with fp32 accumulation."""
    w = p.weight.to(x.dtype)
    if w.dim() == 4:  # per-frame 2-D conv as a (1, kh, kw) 3-D conv
        w = w[:, :, None]
    return F.conv3d(x, w, p.bias.to(x.dtype), stride=stride, padding=padding)


def causal_conv3d(p: Conv, x, stride=(1, 1, 1)):
    """Zero left-pad of 2*pad_t frames in time, symmetric spatial pad."""
    kt, kh, kw = p.weight.shape[2:]
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    if pt:
        x = F.pad(x, (0, 0, 0, 0, 2 * pt, 0))
    return conv3d(p, x, stride=stride, padding=(0, ph, pw))


def conv2d_on_frames(p: Conv, x, stride: int = 1, pad_br: bool = False,
                     padding: int = 0):
    """Per-frame 2-D conv. pad_br: the ZeroPad2d((0,1,0,1)) of downsampling."""
    if pad_br:
        x = F.pad(x, (0, 1, 0, 1))
    return conv3d(p, x, stride=(1, stride, stride), padding=(0, padding, padding))


def rms_norm_spatial(p: Gamma, x, eps: float = 1e-12):
    """F.normalize over channels (dim 1) * sqrt(C) * gamma, in fp32. One
    full-size temporary: the later multiplies run in place on it."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
    gamma = p.gamma.float().reshape(1, -1, *([1] * (x.dim() - 2)))
    y = xf / torch.clamp(norm, min=eps)
    y.mul_(x.shape[1] ** 0.5).mul_(gamma)
    return y.to(x.dtype)


def _silu(y):
    """SiLU in place on a temporary (torch computes it in fp32 internally)."""
    return F.silu(y, inplace=True)


def upsample_conv_2x(p: Conv, x):
    """Nearest 2x spatial upsample, then a 3x3 per-frame conv."""
    b, c, t, h, w = x.shape
    x = x[:, :, :, :, None, :, None].expand(b, c, t, h, 2, w, 2)
    x = x.reshape(b, c, t, 2 * h, 2 * w)
    return conv2d_on_frames(p, x, padding=1)


def _interleave_time2(y):
    """(B, 2C, T, H, W) time-conv output -> (B, C, 2T, H, W): channel half j
    becomes frame 2t+j."""
    b, c2, t, h, w = y.shape
    c = c2 // 2
    return y.view(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)


def residual_block(p, x):
    h = causal_conv3d(p["shortcut"], x) if "shortcut" in p else x
    y = _silu(rms_norm_spatial(p["residual"]["0"], x))
    y = causal_conv3d(p["residual"]["2"], y)
    y = _silu(rms_norm_spatial(p["residual"]["3"], y))
    return causal_conv3d(p["residual"]["6"], y).add_(h)


def attention_block(p, x):
    """Single-head per-frame spatial attention."""
    b, c, t, h, w = x.shape
    identity = x
    y = rms_norm_spatial(p["norm"], x)
    qkv = conv2d_on_frames(p["to_qkv"], y)                     # (B, 3C, T, H, W)
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3 * c)
    q, k, v = qkv.split(c, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / math.sqrt(c))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return conv2d_on_frames(p["proj"], out) + identity


def resample(p, x, mode: str):
    """Full-sequence Resample."""
    if mode == "upsample3d":
        head_f, rest = x[:, :, :1], x[:, :, 1:]
        if rest.shape[2] > 0:
            y = causal_conv3d(p["time_conv"], rest)
            x = torch.cat([head_f, _interleave_time2(y)], dim=2)
        else:
            x = head_f
        return upsample_conv_2x(p["resample"]["1"], x)
    if mode == "upsample2d":
        return upsample_conv_2x(p["resample"]["1"], x)
    x = conv2d_on_frames(p["resample"]["1"], x, stride=2, pad_br=True)
    if mode == "downsample2d":
        return x
    if mode == "downsample3d":
        head_f = x[:, :, :1]
        if x.shape[2] > 2:
            y = conv3d(p["time_conv"], x, stride=(2, 1, 1))
            return torch.cat([head_f, y], dim=2)
        return head_f
    raise ValueError(mode)


def encoder3d(p, x, cfg: WanVAEConfig):
    x = causal_conv3d(p["conv1"], x)
    for idx, (kind, mode) in enumerate(_encoder_plan(cfg)):
        mp = p["downsamples"][str(idx)]
        x = residual_block(mp, x) if kind == "res" else resample(mp, x, mode)
    x = residual_block(p["middle"]["0"], x)
    x = attention_block(p["middle"]["1"], x)
    x = residual_block(p["middle"]["2"], x)
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    return causal_conv3d(p["head"]["2"], x)


def decoder3d(p, x, cfg: WanVAEConfig):
    x = causal_conv3d(p["conv1"], x)
    x = residual_block(p["middle"]["0"], x)
    x = attention_block(p["middle"]["1"], x)
    x = residual_block(p["middle"]["2"], x)
    for idx, (kind, mode) in enumerate(_decoder_plan(cfg)):
        mp = p["upsamples"][str(idx)]
        x = residual_block(mp, x) if kind == "res" else resample(mp, x, mode)
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    return causal_conv3d(p["head"]["2"], x)


def _stats(cfg: WanVAEConfig, like):
    shape = (1, -1, 1, 1, 1)
    mean = torch.tensor(cfg.latent_mean, dtype=like.dtype, device=like.device)
    std = torch.tensor(cfg.latent_std, dtype=like.dtype, device=like.device)
    return mean.view(shape), std.view(shape)


def _normalize(mu, cfg):
    mean, std = _stats(cfg, mu)
    return (mu - mean) * (1.0 / std)


def _denormalize(z, cfg):
    mean, std = _stats(cfg, z)
    return z * std + mean


def vae_encode(model: WanVAE, video):
    """video (B, 3, T, H, W) in [-1, 1] -> normalized latents
    (B, z, 1+(T-1)/4, H/8, W/8)."""
    cfg = model.cfg
    out = encoder3d(model.encoder, video, cfg)
    moments = causal_conv3d(model.conv1, out)
    return _normalize(moments[:, :cfg.z_dim], cfg)


def vae_decode(model: WanVAE, z, clamp: bool = True):
    """normalized latents -> video (B, 3, T, H, W)."""
    cfg = model.cfg
    x = causal_conv3d(model.conv2, _denormalize(z, cfg))
    video = decoder3d(model.decoder, x, cfg)
    return video.clamp(-1.0, 1.0) if clamp else video


# --------------------------------------------------------------------------
# Streaming (temporal-chunked) encode/decode: per-op temporal caches carried
# from chunk to chunk; exact against the full-sequence forms.
# --------------------------------------------------------------------------

class _CacheIO:
    """Threads per-op temporal caches in a fixed op order."""

    def __init__(self, caches: Optional[List[torch.Tensor]]):
        self.create = caches is None
        self.caches = caches or []
        self.out: List[torch.Tensor] = []
        self.idx = 0

    def get(self, make_zeros):
        if self.create:
            return make_zeros()
        c = self.caches[self.idx]
        self.idx += 1
        return c

    def put(self, cache):
        # a copy: a slice is a view, and a view would keep the whole
        # chunk-size tensor it was cut from alive until the next chunk
        self.out.append(cache.clone())


def _causal_conv3d_io(p: Conv, x, io: _CacheIO, stride=(1, 1, 1)):
    kt, kh, kw = p.weight.shape[2:]
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    if pt == 0:
        return conv3d(p, x, stride=stride, padding=(0, ph, pw))
    b, c, _, h, w = x.shape
    cache = io.get(lambda: x.new_zeros((b, c, 2 * pt, h, w)))
    xin = torch.cat([cache, x], dim=2)
    y = conv3d(p, xin, stride=stride, padding=(0, ph, pw))
    io.put(xin[:, :, -2 * pt:])
    return y


def _residual_block_io(p, x, io: _CacheIO):
    h = _causal_conv3d_io(p["shortcut"], x, io) if "shortcut" in p else x
    y = _silu(rms_norm_spatial(p["residual"]["0"], x))
    y = _causal_conv3d_io(p["residual"]["2"], y, io)
    y = _silu(rms_norm_spatial(p["residual"]["3"], y))
    return _causal_conv3d_io(p["residual"]["6"], y, io).add_(h)


def _resample_up_io(p, x, mode: str, io: _CacheIO, first: bool):
    if mode == "upsample3d":
        if first:
            head_f, rest = x[:, :, :1], x[:, :, 1:]
            if rest.shape[2] > 0:
                y = _causal_conv3d_io(p["time_conv"], rest, io)
                xt = torch.cat([head_f, _interleave_time2(y)], dim=2)
            else:
                # no frame has entered the time conv yet: its cache is the
                # zero left-pad
                b, c, _, h, w = x.shape
                io.put(io.get(lambda: x.new_zeros((b, c, 2, h, w))))
                xt = head_f
        else:
            xt = _interleave_time2(_causal_conv3d_io(p["time_conv"], x, io))
        return upsample_conv_2x(p["resample"]["1"], xt)
    if mode == "upsample2d":
        return upsample_conv_2x(p["resample"]["1"], x)
    raise ValueError(f"streaming decode only upsamples, got {mode}")


def _decode_stream_step(model: WanVAE, z_chunk, caches, first: bool):
    cfg = model.cfg
    io = _CacheIO(caches)
    x = _causal_conv3d_io(model.conv2, _denormalize(z_chunk, cfg), io)
    p = model.decoder
    x = _causal_conv3d_io(p["conv1"], x, io)
    x = _residual_block_io(p["middle"]["0"], x, io)
    x = attention_block(p["middle"]["1"], x)
    x = _residual_block_io(p["middle"]["2"], x, io)
    for idx, (kind, mode) in enumerate(_decoder_plan(cfg)):
        mp = p["upsamples"][str(idx)]
        x = (_residual_block_io(mp, x, io) if kind == "res"
             else _resample_up_io(mp, x, mode, io, first))
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    return _causal_conv3d_io(p["head"]["2"], x, io), io.out


def _resample_down_io(p, x, mode: str, io: _CacheIO, first: bool):
    if mode not in ("downsample2d", "downsample3d"):
        raise ValueError(f"streaming encode only downsamples, got {mode}")
    x = conv2d_on_frames(p["resample"]["1"], x, stride=2, pad_br=True)
    if mode == "downsample2d":
        return x
    if first:
        # global frame 0 passes through and seeds the stride-2 window cache
        io.put(x[:, :, -1:])
        return x
    xin = torch.cat([io.get(lambda: None), x], dim=2)
    y = conv3d(p["time_conv"], xin, stride=(2, 1, 1))
    io.put(xin[:, :, -1:])
    return y


def _encode_stream_step(model: WanVAE, chunk, caches, first: bool):
    cfg = model.cfg
    io = _CacheIO(caches)
    p = model.encoder
    x = _causal_conv3d_io(p["conv1"], chunk, io)
    for idx, (kind, mode) in enumerate(_encoder_plan(cfg)):
        mp = p["downsamples"][str(idx)]
        x = (_residual_block_io(mp, x, io) if kind == "res"
             else _resample_down_io(mp, x, mode, io, first))
    x = _residual_block_io(p["middle"]["0"], x, io)
    x = attention_block(p["middle"]["1"], x)
    x = _residual_block_io(p["middle"]["2"], x, io)
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    x = _causal_conv3d_io(p["head"]["2"], x, io)
    moments = _causal_conv3d_io(model.conv1, x, io)
    return _normalize(moments[:, :cfg.z_dim], cfg), io.out


def vae_encode_stream(model: WanVAE, video):
    """Temporal-chunked encode with the 1+4k chunk schedule (frame 0, then
    4-frame chunks); exact against `vae_encode`, O(chunk) activations."""
    t_total = video.shape[2]
    out, caches = _encode_stream_step(model, video[:, :, 0:1], None, True)
    outs = [out]
    t0 = 1
    while t0 < t_total:
        t1 = min(t0 + 4, t_total)
        out, caches = _encode_stream_step(model, video[:, :, t0:t1], caches, False)
        outs.append(out)
        t0 = t1
    return torch.cat(outs, dim=2)


def vae_decode_stream(model: WanVAE, z, chunk_size: int = 4, clamp: bool = True):
    """Temporal-chunked decode: latent frame 0 first, then `chunk_size`-frame
    chunks, caches carried between steps; exact against `vae_decode`."""
    t_total = z.shape[2]
    out, caches = _decode_stream_step(model, z[:, :, 0:1], None, True)
    outs = [out]
    t0 = 1
    while t0 < t_total:
        t1 = min(t0 + chunk_size, t_total)
        out, caches = _decode_stream_step(model, z[:, :, t0:t1], caches, False)
        outs.append(out)
        t0 = t1
    video = torch.cat(outs, dim=2)
    return video.clamp(-1.0, 1.0) if clamp else video


# --------------------------------------------------------------------------
# Spatial tiling: overlapping tiles blended with linear ramps. The tiles'
# weighted sums are kept in fp32 on the tensors' device.
# --------------------------------------------------------------------------

def _build_1d_mask(length, left_bound, right_bound, border_width) -> np.ndarray:
    x = np.ones((length,), np.float32)
    if border_width > 0:
        if not left_bound:
            x[:border_width] = (np.arange(border_width) + 1) / border_width
        if not right_bound:
            x[-border_width:] = ((np.arange(border_width) + 1) / border_width)[::-1]
    return x


def _build_mask(h_size, w_size, is_bound, border_width) -> np.ndarray:
    """(1, 1, 1, h, w) blend weights of one tile; is_bound = (top, bottom,
    left, right) edges of the whole frame, which get no ramp."""
    h = _build_1d_mask(h_size, is_bound[0], is_bound[1], border_width[0])
    w = _build_1d_mask(w_size, is_bound[2], is_bound[3], border_width[1])
    return np.minimum(h[:, None], w[None, :])[None, None, None]


def _tile_tasks(H, W, size_h, size_w, stride_h, stride_w):
    """(h0, h1, w0, w1) of each tile; a tile whose predecessor already
    reaches the edge is skipped, in each direction."""
    tasks = []
    for h in range(0, H, stride_h):
        if h - stride_h >= 0 and h - stride_h + size_h >= H:
            continue
        for w in range(0, W, stride_w):
            if w - stride_w >= 0 and w - stride_w + size_w >= W:
                continue
            tasks.append((h, min(h + size_h, H), w, min(w + size_w, W)))
    return tasks


def _blend_tiles(run_tile, x, out_shape, to_out, size, stride):
    """Sum run_tile(tile) * mask over the tiles of x, divided by the summed
    masks. size/stride in x's spatial units; to_out maps a length in those
    units to the output's."""
    H, W = x.shape[3], x.shape[4]
    values = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    weight = torch.zeros((1, 1, 1) + tuple(out_shape[3:]), dtype=torch.float32,
                         device=x.device)
    border = (to_out(size[0] - stride[0]), to_out(size[1] - stride[1]))
    for h, h_, w, w_ in _tile_tasks(H, W, size[0], size[1], stride[0], stride[1]):
        out = run_tile(x[:, :, :, h:h_, w:w_]).float()
        mask = torch.from_numpy(_build_mask(out.shape[3], out.shape[4],
                                            (h == 0, h_ >= H, w == 0, w_ >= W),
                                            border)).to(x.device)
        th, tw = to_out(h), to_out(w)
        region = (slice(None),) * 3 + (slice(th, th + out.shape[3]),
                                       slice(tw, tw + out.shape[4]))
        values[region] += out * mask
        weight[region] += mask
    return values / weight


def tiled_encode(model: WanVAE, video, tile_size=(34, 34), tile_stride=(18, 16)):
    """Spatially tiled encode; tile sizes in latent units (times the 8x
    spatial factor in pixels)."""
    up = model.cfg.upsampling_factor
    B, _, T, H, W = video.shape
    out_shape = (B, model.cfg.z_dim, (T + 3) // 4, H // up, W // up)
    return _blend_tiles(lambda tile: vae_encode(model, tile), video, out_shape,
                        lambda n: n // up, (tile_size[0] * up, tile_size[1] * up),
                        (tile_stride[0] * up, tile_stride[1] * up))


def tiled_decode(model: WanVAE, z, tile_size=(34, 34), tile_stride=(18, 16)):
    """Spatially tiled decode of latents; tile sizes in latent units."""
    up = model.cfg.upsampling_factor
    B, _, T, H, W = z.shape
    out_shape = (B, 3, T * 4 - 3, H * up, W * up)
    video = _blend_tiles(lambda tile: vae_decode(model, tile, clamp=False), z,
                         out_shape, lambda n: n * up, tile_size, tile_stride)
    return video.clamp(-1.0, 1.0)


# --------------------------------------------------------------------------
# Public API: whole-clip, streaming (temporal chunks) or spatially tiled
# --------------------------------------------------------------------------

def encode(model: WanVAE, video, tiled: bool = False, tile_size=(34, 34),
           tile_stride=(18, 16), streaming: Optional[bool] = None):
    """streaming=True, or tiled=True with streaming unset, runs the
    streaming encoder (exact, O(chunk) memory); streaming=False with
    tiled=True tiles the frame spatially, as the JAX package does."""
    if streaming or (tiled and streaming is None):
        return vae_encode_stream(model, video)
    if tiled:
        return tiled_encode(model, video, tile_size, tile_stride)
    return vae_encode(model, video)


def _auto_chunk(z, default: int = 4) -> int:
    """Latent chunk size scaled down with spatial area so peak decoder
    activations stay about constant (4 latent frames at 480p latents)."""
    area = z.shape[-2] * z.shape[-1]
    return max(1, min(default, int(round(default * 6240.0 / max(area, 1)))))


def decode(model: WanVAE, z, tiled: bool = False, tile_size=(34, 34),
           tile_stride=(18, 16), streaming: Optional[bool] = None,
           chunk_size: Optional[int] = None):
    """The dispatch of `encode`, for latents."""
    if streaming or (tiled and streaming is None):
        return vae_decode_stream(model, z, chunk_size=chunk_size or _auto_chunk(z))
    if tiled:
        return tiled_decode(model, z, tile_size, tile_stride)
    return vae_decode(model, z)


def convert_wan_vae(sd: Dict) -> Dict:
    """Reference WanVideoVAE state dict -> `WanVAE` state dict (the JAX
    package's `convert_wan_vae`): the names are kept, a leading `model.`
    is stripped. Values pass through (tensors or `utils.ckpt.LazyTensor`s);
    the pipeline holds the VAE in fp32."""
    return {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}
