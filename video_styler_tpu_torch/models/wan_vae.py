"""Wan causal 3-D video VAEs in PyTorch: Wan2.1 (8x8 spatial, 4x temporal,
z=16) and Wan2.2 (16x16 spatial through a 2x2 pixel patchify, z=48).

Counterpart of `video_styler_tpu/models/wan_vae.py`. The Wan2.1 part:
`vae_encode`/`vae_decode` over the whole clip, and the streaming forms
`vae_encode_stream`/`vae_decode_stream` that carry per-conv temporal caches
from chunk to chunk (`_CacheIO`), and the spatially tiled forms
`tiled_encode`/`tiled_decode`. `encode`/`decode` dispatch as the JAX
package does: the streaming form when `tiled=True` with `streaming` unset
(the pipeline default), spatial tiles with `streaming=False, tiled=True`.

The Wan2.2 VAE (`WanVAE38`, TI2V-5B's) adds the pixel patchify and
unpatchify, down/up residual blocks whose shortcut averages
(`avg_down3d`) or duplicates (`dup_up3d`) space-time into channels, and
upsampling convs that keep the channel count; `vae38_encode`/`vae38_decode`
and the streaming `vae38_encode_stream`/`vae38_decode_stream` run it, and
`encode`/`decode` dispatch on the model's config as the JAX package does
(streaming, or the whole clip: it has no spatial tiling).

Under a sharding context with sp > 1 (`parallel.use_sharding`) every
entry point runs width-sharded, as the JAX package shards its VAE on W
over sp: the input is split on W (`parallel.context.split_w`), each
convolution with a spatial kernel takes one column a side from its
neighbours first (`halo_exchange_w`; the frame's edges get the zero
padding), the stride-2 downsampling takes one column on its right only
(its ZeroPad2d((0,1,0,1))), the nearest 2x upsample exchanges after the
repeat, the mid attention block gathers W for its whole-frame attention
and splits again, the norms, SiLU, time convs, shortcuts and the Wan2.2
patchify, `avg_down3d` and `dup_up3d` are local, the streamed paths' caches
hold each rank's own columns, and the output is gathered once at the
end. Each share must stay even at every stride-2 stage (the encoder's
width must split into multiples of `upsampling_factor`); a width that
does not runs whole, warned and counted (`w_shardable`).

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

import functools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.context import gather_w, halo_exchange_w, split_w, w_shardable

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


_shards = threading.local()


def _w_sharded() -> bool:
    """Whether the VAE is running on this rank's share of the width."""
    return getattr(_shards, "on", False)


@contextmanager
def _on_w_shares():
    _shards.on = True
    try:
        yield
    finally:
        _shards.on = False


def _width_sharded(multiple: str = ""):
    """Run a VAE entry point fn(model, x, ...) on this rank's share of x's
    width under a context with sp > 1, and gather its output: x must split
    into shares of a multiple of `model.cfg.<multiple>` columns (every
    share even at each stride-2 stage), else it runs whole (`w_shardable`
    warns and counts). Nested entry points (a tile of `tiled_encode`, the
    one inside the streamed forms) run as they are called."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(model, x, *args, **kwargs):
            m = getattr(model.cfg, multiple) if multiple else 1
            if _w_sharded() or not w_shardable(x.shape[-1], m):
                return fn(model, x, *args, **kwargs)
            with _on_w_shares():
                out = fn(model, split_w(x), *args, **kwargs)
            return gather_w(out)
        return run
    return wrap


def _conv(p: Conv, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    """conv3d with a symmetric zero padding; on width shares the W padding
    is the neighbours' edge columns (`halo_exchange_w`)."""
    pt, ph, pw = padding
    if pw and _w_sharded():
        x, pw = halo_exchange_w(x, pw, pw), 0
    return conv3d(p, x, stride=stride, padding=(pt, ph, pw))


def causal_conv3d(p: Conv, x, stride=(1, 1, 1)):
    """Zero left-pad of 2*pad_t frames in time, symmetric spatial pad."""
    kt, kh, kw = p.weight.shape[2:]
    pt, ph, pw = (kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2
    if pt:
        x = F.pad(x, (0, 0, 0, 0, 2 * pt, 0))
    return _conv(p, x, stride=stride, padding=(0, ph, pw))


def conv2d_on_frames(p: Conv, x, stride: int = 1, pad_br: bool = False,
                     padding: int = 0):
    """Per-frame 2-D conv. pad_br: the ZeroPad2d((0,1,0,1)) of downsampling
    (on width shares: the next rank's first column on the right)."""
    if pad_br:
        x = F.pad(halo_exchange_w(x, 0, 1) if _w_sharded() else F.pad(x, (0, 1)),
                  (0, 0, 0, 1))
    return _conv(p, x, stride=(1, stride, stride), padding=(0, padding, padding))


def _channel_norm(xf):
    """The L2 norm over dim 1. On the CPU the squares are summed in channel
    order (a scan), whatever torch's thread count: its reduction over a
    small tensor splits differently with the count, and the last bit it
    moves can flip an int8 rounding downstream (ROADMAP Queue 3). On the
    card one reduction, deterministic for a given launch."""
    if xf.device.type == "cpu":
        return torch.cumsum(xf.square(), dim=1).narrow(1, xf.shape[1] - 1, 1).sqrt_()
    return torch.linalg.vector_norm(xf, dim=1, keepdim=True)


def rms_norm_spatial(p: Gamma, x, eps: float = 1e-12):
    """F.normalize over channels (dim 1) * sqrt(C) * gamma, in fp32. One
    full-size temporary: the later multiplies run in place on it."""
    xf = x.float()
    norm = _channel_norm(xf)
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
    """Single-head per-frame spatial attention; on width shares the frame
    is gathered for it and split again after."""
    if _w_sharded():
        return split_w(_attention_block(p, gather_w(x)))
    return _attention_block(p, x)


def _attention_block(p, x):
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


@_width_sharded("upsampling_factor")
def vae_encode(model: WanVAE, video):
    """video (B, 3, T, H, W) in [-1, 1] -> normalized latents
    (B, z, 1+(T-1)/4, H/8, W/8)."""
    cfg = model.cfg
    out = encoder3d(model.encoder, video, cfg)
    moments = causal_conv3d(model.conv1, out)
    return _normalize(moments[:, :cfg.z_dim], cfg)


@_width_sharded()
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
        return _conv(p, x, stride=stride, padding=(0, ph, pw))
    b, c, _, h, w = x.shape
    cache = io.get(lambda: x.new_zeros((b, c, 2 * pt, h, w)))
    xin = torch.cat([cache, x], dim=2)
    y = _conv(p, xin, stride=stride, padding=(0, ph, pw))
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


@_width_sharded("upsampling_factor")
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


@_width_sharded()
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
    tiled=True tiles the frame spatially, as the JAX package does (the
    Wan2.2 VAE then encodes the whole clip)."""
    if isinstance(model, WanVAE38):
        if streaming or (tiled and streaming is None):
            return vae38_encode_stream(model, video)
        return vae38_encode(model, video)
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
    if isinstance(model, WanVAE38):
        if streaming or (tiled and streaming is None):
            return vae38_decode_stream(model, z, chunk_size=chunk_size or _auto_chunk(z))
        return vae38_decode(model, z)
    if streaming or (tiled and streaming is None):
        return vae_decode_stream(model, z, chunk_size=chunk_size or _auto_chunk(z))
    if tiled:
        return tiled_decode(model, z, tile_size, tile_stride)
    return vae_decode(model, z)


# --------------------------------------------------------------------------
# Wan2.2 VAE (z=48): 2x2 pixel patchify around an 8x conv path
# --------------------------------------------------------------------------

WAN22_LATENT_MEAN = (
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667)
WAN22_LATENT_STD = (
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744)


@dataclass(frozen=True)
class WanVAE38Config:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    latent_mean: Tuple[float, ...] = WAN22_LATENT_MEAN
    latent_std: Tuple[float, ...] = WAN22_LATENT_STD

    @property
    def temperal_upsample(self):
        return tuple(reversed(self.temperal_downsample))

    @property
    def upsampling_factor(self) -> int:
        return 16   # the 8x conv path times the 2x pixel patchify


WAN22_VAE = WanVAE38Config()


def _t_flag(flags, i: int) -> bool:
    return flags[i] if i < len(flags) else False


def _resample38_up(c: int, mode: str, **kw) -> nn.ModuleDict:
    """An upsampling Resample whose spatial conv keeps the channel count."""
    m = nn.ModuleDict({"resample": nn.ModuleDict({"1": Conv(c, c, (3, 3), **kw)})})
    if mode == "upsample3d":
        m["time_conv"] = Conv(c * 2, c, (3, 1, 1), **kw)
    return m


class WanVAE38(nn.Module):
    """Parameters of the Wan2.2 VAE under the checkpoint's names:
    `encoder.downsamples.{i}.downsamples.{j}` (residual blocks, then the
    resample) and `decoder.upsamples.{i}.upsamples.{j}`."""

    def __init__(self, cfg: WanVAE38Config = WAN22_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        n = len(cfg.dim_mult)
        e_dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        down = nn.ModuleDict()
        for i in range(n):
            in_c, out_c = e_dims[i], e_dims[i + 1]
            blk = nn.ModuleDict()
            for j in range(cfg.num_res_blocks):
                blk[str(j)] = _res_block(in_c, out_c, **kw)
                in_c = out_c
            if i != n - 1:
                mode = "downsample3d" if _t_flag(cfg.temperal_downsample, i) else "downsample2d"
                blk[str(cfg.num_res_blocks)] = _resample(out_c, mode, **kw)
            down[str(i)] = nn.ModuleDict({"downsamples": blk})
        top = e_dims[-1]
        self.encoder = nn.ModuleDict({
            "conv1": Conv(e_dims[0], 12, (3, 3, 3), **kw),
            "downsamples": down,
            "middle": nn.ModuleDict({"0": _res_block(top, top, **kw),
                                     "1": _attn_block(top, **kw),
                                     "2": _res_block(top, top, **kw)}),
            "head": nn.ModuleDict({"0": Gamma((top, 1, 1, 1), **kw),
                                   "2": Conv(cfg.z_dim * 2, top, (3, 3, 3), **kw)}),
        })
        d_dims = [cfg.dec_dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        up = nn.ModuleDict()
        for i in range(n):
            in_c, out_c = d_dims[i], d_dims[i + 1]
            blk = nn.ModuleDict()
            for j in range(cfg.num_res_blocks + 1):
                blk[str(j)] = _res_block(in_c, out_c, **kw)
                in_c = out_c
            if i != n - 1:
                mode = "upsample3d" if _t_flag(cfg.temperal_upsample, i) else "upsample2d"
                blk[str(cfg.num_res_blocks + 1)] = _resample38_up(out_c, mode, **kw)
            up[str(i)] = nn.ModuleDict({"upsamples": blk})
        self.decoder = nn.ModuleDict({
            "conv1": Conv(d_dims[0], cfg.z_dim, (3, 3, 3), **kw),
            "middle": nn.ModuleDict({"0": _res_block(d_dims[0], d_dims[0], **kw),
                                     "1": _attn_block(d_dims[0], **kw),
                                     "2": _res_block(d_dims[0], d_dims[0], **kw)}),
            "upsamples": up,
            "head": nn.ModuleDict({"0": Gamma((d_dims[-1], 1, 1, 1), **kw),
                                   "2": Conv(12, d_dims[-1], (3, 3, 3), **kw)}),
        })
        self.conv1 = Conv(cfg.z_dim * 2, cfg.z_dim * 2, (1, 1, 1), **kw)
        self.conv2 = Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), **kw)


def pixel_patchify(x, p: int = 2):
    """(B, C, F, H, W) -> (B, C*p*p, F, H/p, W/p), channels in the
    reference's (c, r, q) order (r: the column phase, q: the row phase)."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, h // p, p, w // p, p).permute(0, 1, 6, 4, 2, 3, 5)
    return x.reshape(b, c * p * p, f, h // p, w // p)


def pixel_unpatchify(x, p: int = 2):
    """`pixel_patchify` inverted."""
    b, cpp, f, h, w = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, c, p, p, f, h, w).permute(0, 1, 4, 5, 3, 6, 2)
    return x.reshape(b, c, f, h * p, w * p)


def avg_down3d(x, out_channels: int, factor_t: int, factor_s: int = 1):
    """Left-pad T to a multiple of factor_t with zeros, fold each
    (factor_t, factor_s, factor_s) block into channels in (c, t, h, w)
    order, and average groups of them down to out_channels."""
    b, c, t, h, w = x.shape
    pad_t = (factor_t - t % factor_t) % factor_t
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    group = c * factor_t * factor_s * factor_s // out_channels
    x = x.reshape(b, c, t // factor_t, factor_t, h // factor_s, factor_s,
                  w // factor_s, factor_s).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, out_channels, group, t // factor_t, h // factor_s, w // factor_s)
    return x.mean(dim=2)


def dup_up3d(x, out_channels: int, factor_t: int, factor_s: int = 1,
             first_chunk: bool = False):
    """Repeat each channel, unfold the copies into (factor_t, factor_s,
    factor_s) space-time blocks; the first chunk drops its first
    factor_t - 1 frames."""
    b, c, t, h, w = x.shape
    repeats = out_channels * factor_t * factor_s * factor_s // c
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(b, out_channels, factor_t, factor_s, factor_s, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
        b, out_channels, t * factor_t, h * factor_s, w * factor_s)
    return x[:, :, factor_t - 1:] if first_chunk else x


def _down_block(p, x, t_down: bool, down_flag: bool, mult: int, io=None, first=False):
    """Down residual block (whole clip, or one streaming chunk with `io`)."""
    out_c = p["downsamples"]["0"]["residual"]["6"].weight.shape[0]
    shortcut = avg_down3d(x, out_c, 2 if t_down else 1, 2 if down_flag else 1)
    h = x
    for j in range(mult):
        blk = p["downsamples"][str(j)]
        h = residual_block(blk, h) if io is None else _residual_block_io(blk, h, io)
    if down_flag:
        mode = "downsample3d" if t_down else "downsample2d"
        rs = p["downsamples"][str(mult)]
        h = resample(rs, h, mode) if io is None else _resample_down_io(rs, h, mode, io, first)
    return h + shortcut


def _up_block(p, x, t_up: bool, up_flag: bool, mult: int, first: bool, io=None):
    """Up residual block (whole clip, or one streaming chunk with `io`)."""
    h = x
    for j in range(mult):
        blk = p["upsamples"][str(j)]
        h = residual_block(blk, h) if io is None else _residual_block_io(blk, h, io)
    if not up_flag:
        return h
    mode = "upsample3d" if t_up else "upsample2d"
    rs = p["upsamples"][str(mult)]
    h = resample(rs, h, mode) if io is None else _resample_up_io(rs, h, mode, io, first)
    return h + dup_up3d(x, h.shape[1], 2 if t_up else 1, 2, first_chunk=first)


def _encoder38(p, x, cfg: WanVAE38Config, io=None, first=False):
    cc = causal_conv3d if io is None else (lambda q, y: _causal_conv3d_io(q, y, io))
    rb = residual_block if io is None else (lambda q, y: _residual_block_io(q, y, io))
    x = cc(p["conv1"], x)
    n = len(cfg.dim_mult)
    for i in range(n):
        x = _down_block(p["downsamples"][str(i)], x, _t_flag(cfg.temperal_downsample, i),
                        i != n - 1, cfg.num_res_blocks, io, first)
    x = rb(p["middle"]["0"], x)
    x = attention_block(p["middle"]["1"], x)
    x = rb(p["middle"]["2"], x)
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    return cc(p["head"]["2"], x)


def _decoder38(p, x, cfg: WanVAE38Config, first: bool, io=None):
    cc = causal_conv3d if io is None else (lambda q, y: _causal_conv3d_io(q, y, io))
    rb = residual_block if io is None else (lambda q, y: _residual_block_io(q, y, io))
    x = cc(p["conv1"], x)
    x = rb(p["middle"]["0"], x)
    x = attention_block(p["middle"]["1"], x)
    x = rb(p["middle"]["2"], x)
    n = len(cfg.dim_mult)
    for i in range(n):
        x = _up_block(p["upsamples"][str(i)], x, _t_flag(cfg.temperal_upsample, i),
                      i != n - 1, cfg.num_res_blocks + 1, first, io)
    x = _silu(rms_norm_spatial(p["head"]["0"], x))
    return cc(p["head"]["2"], x)


@_width_sharded("upsampling_factor")
def vae38_encode(model: WanVAE38, video):
    """video (B, 3, T, H, W) in [-1, 1] -> normalized latents
    (B, 48, 1+(T-1)/4, H/16, W/16)."""
    cfg = model.cfg
    out = _encoder38(model.encoder, pixel_patchify(video), cfg)
    moments = causal_conv3d(model.conv1, out)
    return _normalize(moments[:, :cfg.z_dim], cfg)


@_width_sharded()
def vae38_decode(model: WanVAE38, z, clamp: bool = True):
    """normalized latents -> video (B, 3, T, H, W)."""
    cfg = model.cfg
    x = causal_conv3d(model.conv2, _denormalize(z, cfg))
    video = pixel_unpatchify(_decoder38(model.decoder, x, cfg, first=True))
    return video.clamp(-1.0, 1.0) if clamp else video


def _encode38_stream_step(model: WanVAE38, chunk, caches, first: bool):
    cfg = model.cfg
    io = _CacheIO(caches)
    x = _encoder38(model.encoder, pixel_patchify(chunk), cfg, io, first)
    moments = _causal_conv3d_io(model.conv1, x, io)
    return _normalize(moments[:, :cfg.z_dim], cfg), io.out


def _decode38_stream_step(model: WanVAE38, z_chunk, caches, first: bool):
    cfg = model.cfg
    io = _CacheIO(caches)
    x = _causal_conv3d_io(model.conv2, _denormalize(z_chunk, cfg), io)
    return pixel_unpatchify(_decoder38(model.decoder, x, cfg, first, io)), io.out


@_width_sharded("upsampling_factor")
def vae38_encode_stream(model: WanVAE38, video):
    """`vae_encode_stream`'s 1+4k chunk schedule on the Wan2.2 VAE: the
    shortcuts' averaging needs no cache (its zero left-pad covers exactly
    the first chunk)."""
    t_total = video.shape[2]
    out, caches = _encode38_stream_step(model, video[:, :, 0:1], None, True)
    outs = [out]
    t0 = 1
    while t0 < t_total:
        t1 = min(t0 + 4, t_total)
        out, caches = _encode38_stream_step(model, video[:, :, t0:t1], caches, False)
        outs.append(out)
        t0 = t1
    return torch.cat(outs, dim=2)


@_width_sharded()
def vae38_decode_stream(model: WanVAE38, z, chunk_size: int = 4, clamp: bool = True):
    """`vae_decode_stream` on the Wan2.2 VAE: the duplicating shortcuts
    drop their leading frames on the first chunk only."""
    t_total = z.shape[2]
    out, caches = _decode38_stream_step(model, z[:, :, 0:1], None, True)
    outs = [out]
    t0 = 1
    while t0 < t_total:
        t1 = min(t0 + chunk_size, t_total)
        out, caches = _decode38_stream_step(model, z[:, :, t0:t1], caches, False)
        outs.append(out)
        t0 = t1
    video = torch.cat(outs, dim=2)
    return video.clamp(-1.0, 1.0) if clamp else video


def is_wan22_vae(sd: Dict) -> bool:
    """A Wan2.2 VAE state dict: `.conv3.` layers, or a top-level 1x1 conv1
    of 2 x 48 rows. (The JAX loader's test of any key ending in
    `conv1.weight` with 96 rows also takes the Wan2.1 encoder's first conv,
    96 wide: ROADMAP Queue 3.)"""
    conv1 = sd.get("conv1.weight", sd.get("model.conv1.weight"))
    return any(".conv3." in k for k in sd) or (conv1 is not None and conv1.shape[0] == 96)


def convert_wan_vae(sd: Dict) -> Dict:
    """Reference WanVideoVAE or WanVideoVAE38 state dict -> `WanVAE` or
    `WanVAE38` state dict (the JAX package's `convert_wan_vae`): the names
    are kept, a leading `model.`
    is stripped. Values pass through (tensors or `utils.ckpt.LazyTensor`s);
    the pipeline holds the VAE in fp32."""
    return {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}
