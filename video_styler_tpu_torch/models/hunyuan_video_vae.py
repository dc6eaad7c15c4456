"""The HunyuanVideo causal 3D VAE in PyTorch.

Counterpart of `video_styler_tpu/models/hunyuan_video_vae.py`: causal
convolutions with replicate padding (symmetric in space, on the left in
time), GroupNorm resnets, a mid block with one head of attention over all
(frame, row, column) tokens under a frame-causal mask, strided-conv
downsampling and first-frame-pinned nearest upsampling; 4x in time, 8x in
space, z = 16, scaling 0.476986. Tiled encode and decode in 3-D, each tile
weighted by the min(t, h, w) ramp mask, as the JAX tiler (and the
reference's `tile_forward`) blends them; the tiles are summed on the
device in fp32.

Runs in fp32 (cuDNN convolutions, TF32 off). The mid attention is the exact
`sdpa` (fp32 logits, one head of 512 channels): no Pallas kernel in JAX,
and K1 takes heads of 128 only. Parameters follow the reference's module
names with CausalConv3d's `.conv` level removed (`convert_hunyuan_vae`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .wan_dit import Linear


@dataclass(frozen=True)
class HunyuanVAEConfig:
    z_dim: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    num_groups: int = 32
    time_compression: int = 4
    spatial_compression: int = 8
    scaling_factor: float = 0.476986
    eps: float = 1e-6


HUNYUAN_VAE = HunyuanVAEConfig()
HUNYUAN_VAE_TINY = HunyuanVAEConfig(z_dim=4, block_out_channels=(8, 16, 16, 16),
                                    layers_per_block=1, num_groups=4)


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, **kw)
        self.conv1 = nn.Conv3d(cin, cout, 3, **kw)
        self.norm2 = nn.GroupNorm(groups, cout, **kw)
        self.conv2 = nn.Conv3d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = nn.Conv3d(cin, cout, 1, **kw)


class MidAttention(nn.Module):
    def __init__(self, c: int, groups: int, **kw):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, **kw)
        self.to_q = Linear(c, c, **kw)
        self.to_k = Linear(c, c, **kw)
        self.to_v = Linear(c, c, **kw)
        self.to_out = nn.ModuleList([Linear(c, c, **kw)])


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, groups, **kw),
                                      ResnetBlock(c, c, groups, **kw)])
        self.attentions = nn.ModuleList([MidAttention(c, groups, **kw)])


class _Resample(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.conv = nn.Conv3d(c, c, 3, **kw)


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, groups: int, resample: str, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if j == 0 else cout, cout, groups, **kw)
                                     for j in range(n))
        if resample:
            setattr(self, resample, nn.ModuleList([_Resample(cout, **kw)]))


class EncoderCausal3D(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, **kw):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.num_groups
        self.conv_in = nn.Conv3d(3, ch[0], 3, **kw)
        self.down_blocks = nn.ModuleList(
            _Stage(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g,
                   "downsamplers" if has else "", **kw)
            for i, (has, _) in enumerate(_plan(cfg)))
        self.mid_block = MidBlock(ch[-1], g, **kw)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], **kw)
        self.conv_out = nn.Conv3d(ch[-1], 2 * cfg.z_dim, 3, **kw)


class DecoderCausal3D(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, **kw):
        super().__init__()
        ch, g = tuple(reversed(cfg.block_out_channels)), cfg.num_groups
        self.conv_in = nn.Conv3d(cfg.z_dim, ch[0], 3, **kw)
        self.mid_block = MidBlock(ch[0], g, **kw)
        self.up_blocks = nn.ModuleList(
            _Stage(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block + 1, g,
                   "upsamplers" if has else "", **kw)
            for i, (has, _) in enumerate(_plan(cfg)))
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], **kw)
        self.conv_out = nn.Conv3d(ch[-1], 3, 3, **kw)


class HunyuanVAEEncoder(nn.Module):
    """The reference's HunyuanVideoVAEEncoder: `encoder` and `quant_conv`."""

    def __init__(self, cfg: HunyuanVAEConfig = HUNYUAN_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = EncoderCausal3D(cfg, **kw)
        self.quant_conv = nn.Conv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1, **kw)


class HunyuanVAEDecoder(nn.Module):
    """The reference's HunyuanVideoVAEDecoder: `post_quant_conv` and
    `decoder`."""

    def __init__(self, cfg: HunyuanVAEConfig = HUNYUAN_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.post_quant_conv = nn.Conv3d(cfg.z_dim, cfg.z_dim, 1, **kw)
        self.decoder = DecoderCausal3D(cfg, **kw)


@torch.no_grad()
def init_hunyuan_vae_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator`: convolutions and linears N(0, 1/fan_in),
    biases 0, GroupNorm weights 1 and biases 0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def causal_conv3d(p: nn.Conv3d, x, stride=(1, 1, 1)):
    """CausalConv3d: replicate padding, k - 1 frames on the left and k // 2
    on each side in space, then a valid convolution."""
    k = p.weight.shape[2]
    pad = k // 2
    x = F.pad(x, (pad, pad, pad, pad, k - 1, 0), mode="replicate")
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride)


def group_norm_3d(p: nn.GroupNorm, x, groups: int, eps: float):
    return F.group_norm(x.float(), groups, p.weight.float(), p.bias.float(), eps).to(x.dtype)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def resnet_block(p: ResnetBlock, x, cfg: HunyuanVAEConfig):
    h = causal_conv3d(p.conv1, _silu(group_norm_3d(p.norm1, x, cfg.num_groups, cfg.eps)))
    h = causal_conv3d(p.conv2, _silu(group_norm_3d(p.norm2, h, cfg.num_groups, cfg.eps)))
    if hasattr(p, "conv_shortcut"):
        x = causal_conv3d(p.conv_shortcut, x)
    return x + h


def mid_attention(p: MidAttention, x, cfg: HunyuanVAEConfig):
    """One head over the (frame, row, column) tokens; a query sees the keys
    of its own and earlier frames (the exact `sdpa`, fp32 logits)."""
    b, c, t, h, w = x.shape
    y = group_norm_3d(p.group_norm, x, cfg.num_groups, cfg.eps)
    tok = y.permute(0, 2, 3, 4, 1).reshape(b, t * h * w, c)
    q, k, v = (lin(tok)[:, :, None] for lin in (p.to_q, p.to_k, p.to_v))
    frame = torch.arange(t * h * w, device=x.device) // (h * w)
    bias = torch.where(frame[:, None] >= frame[None, :], 0.0,
                       torch.finfo(torch.float32).min)[None, None]
    out = p.to_out[0](sdpa(q, k, v, bias=bias)[:, :, 0])
    return x + out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def mid_block(p: MidBlock, x, cfg: HunyuanVAEConfig):
    x = resnet_block(p.resnets[0], x, cfg)
    x = mid_attention(p.attentions[0], x, cfg)
    return resnet_block(p.resnets[1], x, cfg)


def upsample_causal(p: _Resample, x, factor):
    """UpsampleCausal3D: the first frame upsampled in space only, the rest in
    time and space (nearest), then the causal conv."""
    ft, fh, fw = factor
    first = x[:, :, :1].repeat_interleave(fh, dim=-2).repeat_interleave(fw, dim=-1)
    if x.shape[2] > 1:
        rest = x[:, :, 1:].repeat_interleave(ft, dim=2)
        rest = rest.repeat_interleave(fh, dim=-2).repeat_interleave(fw, dim=-1)
        x = torch.cat([first, rest], dim=2)
    else:
        x = first
    return causal_conv3d(p.conv, x)


def _plan(cfg: HunyuanVAEConfig):
    """Per stage: (whether it resamples, its (t, h, w) factor), the same for
    the encoder's downsampling and the decoder's upsampling."""
    n = len(cfg.block_out_channels)
    ns = int(np.log2(cfg.spatial_compression))
    nt = int(np.log2(cfg.time_compression))
    plan = []
    for i in range(n):
        s = i < ns
        t = i >= (n - 1 - nt) and i != n - 1
        plan.append((s or t, (2 if t else 1, 2 if s else 1, 2 if s else 1)))
    return plan


def encoder_forward(p: EncoderCausal3D, x, cfg: HunyuanVAEConfig):
    h = causal_conv3d(p.conv_in, x)
    for bp, (has_down, stride) in zip(p.down_blocks, _plan(cfg)):
        for r in bp.resnets:
            h = resnet_block(r, h, cfg)
        if has_down:
            h = causal_conv3d(bp.downsamplers[0].conv, h, stride=stride)
    h = mid_block(p.mid_block, h, cfg)
    h = group_norm_3d(p.conv_norm_out, h, cfg.num_groups, cfg.eps)
    return causal_conv3d(p.conv_out, _silu(h))


def decoder_forward(p: DecoderCausal3D, z, cfg: HunyuanVAEConfig):
    h = causal_conv3d(p.conv_in, z)
    h = mid_block(p.mid_block, h, cfg)
    for bp, (has_up, factor) in zip(p.up_blocks, _plan(cfg)):
        for r in bp.resnets:
            h = resnet_block(r, h, cfg)
        if has_up:
            h = upsample_causal(bp.upsamplers[0], h, factor)
    h = group_norm_3d(p.conv_norm_out, h, cfg.num_groups, cfg.eps)
    return causal_conv3d(p.conv_out, _silu(h))


def vae_encode(enc: HunyuanVAEEncoder, video):
    """(B, 3, T, H, W) in [-1, 1] -> the scaled mean latents (B, z, T', H/8,
    W/8)."""
    cfg = enc.cfg
    m = causal_conv3d(enc.quant_conv, encoder_forward(enc.encoder, video, cfg))
    return m[:, :cfg.z_dim] * cfg.scaling_factor


def vae_decode(dec: HunyuanVAEDecoder, latents):
    cfg = dec.cfg
    z = causal_conv3d(dec.post_quant_conv, latents / cfg.scaling_factor)
    return decoder_forward(dec.decoder, z, cfg)


# --------------------------------------------------------------------------
# 3-D tiling
# --------------------------------------------------------------------------

def _mask_1d(length, left_bound, right_bound, border):
    x = np.ones((length,), np.float32)
    if border > 0:
        if not left_bound:
            x[:border] = (np.arange(border) + 1) / border
        if not right_bound:
            x[-border:] = ((np.arange(border) + 1) / border)[::-1]
    return x


def _mask_3d(T, H, W, is_bound, border):
    t = _mask_1d(T, is_bound[0], is_bound[1], border[0])
    h = _mask_1d(H, is_bound[2], is_bound[3], border[1])
    w = _mask_1d(W, is_bound[4], is_bound[5], border[2])
    m = np.minimum.reduce(np.broadcast_arrays(t[:, None, None], h[None, :, None],
                                              w[None, None, :]))
    return m[None, None]


def _tile_tasks(T, dims, sizes, strides):
    tasks = []
    size_t, size_h, size_w = sizes
    st, sh, sw = strides
    H, W = dims
    for t in range(0, T, st):
        if t - st >= 0 and t - st + size_t >= T:
            continue
        for h in range(0, H, sh):
            if h - sh >= 0 and h - sh + size_h >= H:
                continue
            for w in range(0, W, sw):
                if w - sw >= 0 and w - sw + size_w >= W:
                    continue
                tasks.append((t, min(t + size_t, T), h, min(h + size_h, H),
                              w, min(w + size_w, W)))
    return tasks


def _blend(run, x, out_shape, tasks, out_pos, border):
    """Runs `run` on each tile of `x`, drops a later tile's first frame,
    weights it by its ramp mask and sums tiles and masks in fp32 on x's
    device. out_pos maps a tile's (t, h, w) start to the output's."""
    values = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    weight = torch.zeros((1, 1) + tuple(out_shape[2:]), dtype=torch.float32, device=x.device)
    T, H, W = x.shape[2:]
    for t, t_, h, h_, w, w_ in tasks:
        tile = run(x[:, :, t:t_, h:h_, w:w_]).float()
        if t > 0:
            tile = tile[:, :, 1:]
        mask = torch.from_numpy(_mask_3d(*tile.shape[2:],
                                          (t == 0, t_ >= T, h == 0, h_ >= H, w == 0, w_ >= W),
                                          border)).to(x.device)
        tt, hh, ww = out_pos(t, h, w)
        sl = (slice(None), slice(None), slice(tt, tt + tile.shape[2]),
              slice(hh, hh + tile.shape[3]), slice(ww, ww + tile.shape[4]))
        values[sl] += tile * mask
        weight[sl] += mask
    return values / weight


def tiled_decode(dec: HunyuanVAEDecoder, latents, tile_size=(17, 32, 32),
                 tile_stride=(12, 24, 24)):
    """Latent-space tiles of `tile_size` every `tile_stride` (latent units),
    decoded and blended -> (B, 3, (T-1)*4+1, H*8, W*8) fp32."""
    cfg = dec.cfg
    B, _, T, H, W = latents.shape
    up, ut = cfg.spatial_compression, cfg.time_compression
    border = tuple((s - st) * u for s, st, u in zip(tile_size, tile_stride, (ut, up, up)))
    return _blend(lambda z: vae_decode(dec, z), latents, (B, 3, (T - 1) * ut + 1, H * up, W * up),
                  _tile_tasks(T, (H, W), tile_size, tile_stride),
                  lambda t, h, w: (0 if t == 0 else t * ut + 1, h * up, w * up), border)


def tiled_encode(enc: HunyuanVAEEncoder, video, tile_size=(65, 240, 240),
                 tile_stride=(48, 160, 160)):
    """Pixel-space tiles of `tile_size` every `tile_stride`, encoded and
    blended -> (B, z, (T-1)//4+1, H/8, W/8) fp32."""
    cfg = enc.cfg
    B, _, T, H, W = video.shape
    up, ut = cfg.spatial_compression, cfg.time_compression
    border = tuple((s - st) // u for s, st, u in zip(tile_size, tile_stride, (ut, up, up)))
    return _blend(lambda x: vae_encode(enc, x), video,
                  (B, cfg.z_dim, (T - 1) // ut + 1, H // up, W // up),
                  _tile_tasks(T, (H, W), tile_size, tile_stride),
                  lambda t, h, w: (0 if t == 0 else t // ut + 1, h // up, w // up), border)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def convert_hunyuan_vae(sd: Dict) -> Dict:
    """The reference's HunyuanVideoVAEEncoder / Decoder state dict -> the
    `HunyuanVAEEncoder` / `HunyuanVAEDecoder` state dict: CausalConv3d wraps
    its Conv3d as `.conv`, so one `.conv` level before the leaf is removed
    ('conv_in.conv.weight' -> 'conv_in.weight',
    'downsamplers.0.conv.conv.weight' -> 'downsamplers.0.conv.weight').
    Values pass through."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] == "conv" and parts[-1] in ("weight", "bias"):
            parts = parts[:-2] + parts[-1:]
        out[".".join(parts)] = val
    return out
