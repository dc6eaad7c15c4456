"""The StepVideo VAE (version 2) in PyTorch.

Counterpart of `video_styler_tpu/models/stepvideo_vae.py`: 8x temporal and
16x spatial compression with zero-padded causal convolutions, per-frame
GroupNorm (statistics over each frame alone), a single-head token-causal
attention in the mid blocks, pixel (un)shuffle stages with channel
averaging and duplicating shortcuts, and the chunked top level (17 frames
or 3 latent frames a chunk, each chunk on its own, as in the reference).

Everything runs in fp32 with cuDNN convolutions, like the port's other
VAEs. The mid attention is the exact fp32 softmax under the causal mask
(no Pallas kernel in JAX either), taken a block of query rows at a time:
each row's softmax is the same, and the logits of the 42,160 tokens of a
544x992 chunk never exist at once.

Parameters keep the JAX tree's names (`encoder.down.1.block.0.conv1`,
`decoder.up.3.upsample.conv3d.norm1`, ...), which `convert_step_vae` makes
from the reference's as the JAX converter does (the `.conv` level of a
causal convolution dropped).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUPS = 32
ATTN_ROWS = 8192            # query rows a block in the mid attention


@dataclass(frozen=True)
class StepVAEConfig:
    ch: int = 32
    dec_ch: int = 128
    ch_mult: Tuple[int, ...] = (4, 8, 16, 16)
    dec_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 64
    down_sampling_layer: Tuple[int, ...] = (1, 2)
    temporal_up_layers: Tuple[int, ...] = (2, 3)
    temporal_downsample: int = 4
    frame_len: int = 17
    latent_len: int = 3
    scale_factor: float = 1.0


STEP_VAE = StepVAEConfig()
# GroupNorm(32) forces the real channel widths; depth and z shrink
STEP_VAE_TINY = StepVAEConfig(num_res_blocks=1, z_channels=8)


# ------------------------------------------------------------------ modules

def _conv3(cin: int, cout: int, k: int = 3, **kw) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, **kw)


class Resnet3D(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.GroupNorm(GROUPS, cin, **kw)
        self.conv1 = _conv3(cin, cout, **kw)
        self.norm2 = nn.GroupNorm(GROUPS, cout, **kw)
        self.conv2 = _conv3(cout, cout, **kw)
        if cin != cout:
            self.nin_shortcut = _conv3(cin, cout, 1, **kw)


class AttnBlock(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.GroupNorm(GROUPS, c, **kw)
        self.q = _conv3(c, c, 1, **kw)
        self.k = _conv3(c, c, 1, **kw)
        self.v = _conv3(c, c, 1, **kw)
        self.proj_out = _conv3(c, c, 1, **kw)


class Mid(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.block_1 = Resnet3D(c, c, device=device, dtype=dtype)
        self.attn_1 = AttnBlock(c, device=device, dtype=dtype)
        self.block_2 = Resnet3D(c, c, device=device, dtype=dtype)


class Res3DUpsample(nn.Module):
    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = _conv3(c, c, **kw)
        self.norm1 = nn.GroupNorm(GROUPS, c, **kw)
        self.conv2 = _conv3(c, c, **kw)
        self.norm2 = nn.GroupNorm(GROUPS, c, **kw)


class _Holder(nn.Module):
    """A module holding `conv` (or `conv3d`): the reference's wrapper
    levels."""

    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class StepVAEEncoder(nn.Module):
    def __init__(self, cfg: StepVAEConfig = STEP_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_in = _conv3(3, cfg.ch, **kw)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleDict()
        block_in = cfg.ch
        n = len(cfg.ch_mult)
        for i in range(n):
            block_in = cfg.ch * in_mult[i]
            out = cfg.ch * cfg.ch_mult[i]
            level = nn.Module()
            level.block = nn.ModuleDict()
            for j in range(cfg.num_res_blocks):
                level.block[str(j)] = Resnet3D(block_in, out, **kw)
                block_in = out
            if i != n - 1:
                conv = (_conv3(block_in, block_in, **kw) if i in cfg.down_sampling_layer
                        else nn.Conv2d(block_in, block_in, 3, **kw))
                level.downsample = _Holder(conv=conv)
            self.down[str(i)] = level
        self.mid = Mid(block_in, **kw)
        self.norm_out = nn.GroupNorm(GROUPS, block_in, **kw)
        z2 = 2 * cfg.z_channels
        self.conv_patchify = _Holder(conv=_conv3(block_in, z2 // 8, **kw))
        self.conv_out = _conv3(z2, z2, **kw)


class StepVAEDecoder(nn.Module):
    def __init__(self, cfg: StepVAEConfig = STEP_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        block_in = cfg.dec_ch * cfg.dec_ch_mult[-1]
        self.conv_in = _conv3(cfg.z_channels, block_in, **kw)
        self.conv_unpatchify = _Holder(conv=_conv3(block_in, block_in * 8, **kw))
        self.mid = Mid(block_in, **kw)
        self.up = nn.ModuleDict()
        for i in reversed(range(len(cfg.dec_ch_mult))):
            out = cfg.dec_ch * cfg.dec_ch_mult[i]
            level = nn.Module()
            level.block = nn.ModuleDict()
            for j in range(cfg.num_res_blocks + 1):
                level.block[str(j)] = Resnet3D(block_in, out, **kw)
                block_in = out
            if i != 0:
                if i in cfg.temporal_up_layers:
                    level.upsample = _Holder(conv3d=Res3DUpsample(block_in, **kw))
                else:
                    level.upsample = _Holder(conv=nn.Conv2d(block_in, block_in, 3, **kw))
            self.up[str(i)] = level
        self.norm_out = nn.GroupNorm(GROUPS, block_in, **kw)
        self.conv_out = _conv3(block_in, 3, **kw)


class StepVideoVAE(nn.Module):
    def __init__(self, cfg: StepVAEConfig = STEP_VAE, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = StepVAEEncoder(cfg, device=device, dtype=dtype)
        self.decoder = StepVAEDecoder(cfg, device=device, dtype=dtype)


@torch.no_grad()
def init_step_vae_(model: nn.Module, generator: torch.Generator) -> nn.Module:
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


# ------------------------------------------------------------------ primitives

def _conv3d(p: nn.Conv3d, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride, padding)


def causal_conv(p: nn.Conv3d, x, stride=(1, 1, 1)):
    """Zero left time pad (kt - 1) + max(1 - stride_t, 0), symmetric
    spatial padding."""
    kt, kh, kw = p.weight.shape[2:]
    tp = (kt - 1) + max(1 - stride[0], 0)
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, tp, 0))
    return _conv3d(p, x, stride)


def group_norm_frame(p: nn.GroupNorm, x, act_silu: bool = False, eps: float = 1e-5):
    """GroupNorm(32) with statistics per frame, fp32."""
    b, c, t, h, w = x.shape
    xf = x.float().transpose(1, 2).reshape(b * t, c, h, w)
    y = F.group_norm(xf, GROUPS, p.weight.float(), p.bias.float(), eps)
    if act_silu:
        y = F.silu(y)
    return y.reshape(b, t, c, h, w).transpose(1, 2).to(x.dtype)


def _norm_zero_pad(p, x, pad: int = 2):
    """Norm + SiLU, then `pad` zero frames in front."""
    return F.pad(group_norm_frame(p, x, act_silu=True), (0, 0, 0, 0, pad, 0))


def resnet3d(p: Resnet3D, x):
    h = _conv3d(p.conv1, _norm_zero_pad(p.norm1, x), padding=(0, 1, 1))
    if hasattr(p, "nin_shortcut"):
        x = _conv3d(p.nin_shortcut, x)
    h = _conv3d(p.conv2, _norm_zero_pad(p.norm2, h), padding=(0, 1, 1))
    return h + x


def _causal_softmax_attention(q, k, v, rows: int = ATTN_ROWS):
    """(B, S, C) single-head attention, token-causal, fp32 logits and
    softmax (masked logits at finfo.min), `rows` query rows at a time."""
    s, c = q.shape[1], q.shape[2]
    scale = 1.0 / c ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        logits = torch.einsum("bqc,bkc->bqk", qf[:, r0:r1], kf) * scale
        keep = (torch.arange(s, device=q.device)[None, :]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        logits.masked_fill_(~keep[None], torch.finfo(torch.float32).min)
        outs.append(torch.einsum("bqk,bkc->bqc", torch.softmax(logits, dim=-1), vf))
        del logits
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_block(p: AttnBlock, x):
    b, c, t, h, w = x.shape
    y = group_norm_frame(p.norm, x)
    q, k, v = (causal_conv(m, y) for m in (p.q, p.k, p.v))

    def tok(z):
        return z.permute(0, 2, 3, 4, 1).reshape(b, t * h * w, c)

    out = _causal_softmax_attention(tok(q), tok(k), tok(v))
    out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return causal_conv(p.proj_out, out) + x


def _pixel_unshuffle_3d(x, factor: int):
    x = F.pad(x, (0, 0, 0, 0, factor - 1, 0))
    B, C, D, H, W = x.shape
    x = x.reshape(B, C, D // factor, factor, H // factor, factor, W // factor, factor)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(B, C * factor ** 3, D // factor, H // factor, W // factor)


def _pixel_shuffle_3d(x, factor: int):
    B, C, D, H, W = x.shape
    nc = C // factor ** 3
    x = x.reshape(B, nc, factor, factor, factor, D, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(B, nc, D * factor, H * factor, W * factor)
    return x[:, :, factor - 1:]


def _channel_avg_down(x, out_channels: int, factor: int):
    if factor > 1:
        x = _pixel_unshuffle_3d(x, factor)
    B, C, D, H, W = x.shape
    return x.reshape(B, out_channels, C // out_channels, D, H, W).mean(dim=2)


def _channel_dup_up(x, out_channels: int, factor: int):
    B, C, D, H, W = x.shape
    x = x.repeat_interleave(out_channels * factor ** 3 // C, dim=1)
    x = x.reshape(B, out_channels, factor, factor, factor, D, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(B, out_channels, D * factor, H * factor, W * factor)
    return x[:, :, factor - 1:]


def _conv2d_frames(p: nn.Conv2d, x, stride: int = 1, padding: int = 1):
    b, c, t, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * t, c, h, w)
    y = F.conv2d(x2, p.weight.to(x.dtype), p.bias.to(x.dtype), stride, padding)
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


# ------------------------------------------------------------------ encoder / decoder

def encoder_forward(p: StepVAEEncoder, x, cfg: StepVAEConfig):
    """(B, 3, T, H, W) -> (B, T', 2z, H/16, W/16)."""
    h = causal_conv(p.conv_in, x)
    n = len(cfg.ch_mult)
    for i in range(n):
        lp = p.down[str(i)]
        for j in range(cfg.num_res_blocks):
            h = resnet3d(lp.block[str(j)], h)
        if i != n - 1:
            if i in cfg.down_sampling_layer:
                h = causal_conv(lp.downsample.conv, h, stride=(2, 2, 2))
            else:
                h = F.pad(h, (0, 1, 0, 1))
                h = _conv2d_frames(lp.downsample.conv, h, stride=2, padding=0)
    h = resnet3d(p.mid.block_1, h)
    h = attn_block(p.mid.attn_1, h)
    h = resnet3d(p.mid.block_2, h)
    h = group_norm_frame(p.norm_out, h, act_silu=True)
    conv = p.conv_patchify.conv
    shortcut = _channel_avg_down(h, conv.weight.shape[0] * 8, 2)
    h = _pixel_unshuffle_3d(causal_conv(conv, h), 2) + shortcut
    shortcut = _channel_avg_down(h, 2 * cfg.z_channels, 1)
    h = causal_conv(p.conv_out, h) + shortcut
    return h.transpose(1, 2)


def res3d_upsample(p: Res3DUpsample, x):
    h = group_norm_frame(p.norm1, causal_conv(p.conv1, x), act_silu=True)
    h = group_norm_frame(p.norm2, causal_conv(p.conv2, h))
    return F.silu((h + x).float()).to(x.dtype) + x


def decoder_forward(p: StepVAEDecoder, z, cfg: StepVAEConfig):
    """z (B, T, C, H, W) -> (B, 3, T', 16H, 16W)."""
    z = z.transpose(1, 2)
    h = causal_conv(p.conv_in, z)
    h = h + _channel_dup_up(z, p.conv_in.weight.shape[0], 1)
    block_in = cfg.dec_ch * cfg.dec_ch_mult[-1]
    hp = _pixel_shuffle_3d(causal_conv(p.conv_unpatchify.conv, h), 2)
    h = hp + _channel_dup_up(h, block_in, 2)
    del hp
    h = resnet3d(p.mid.block_1, h)
    h = attn_block(p.mid.attn_1, h)
    h = resnet3d(p.mid.block_2, h)
    for i in reversed(range(len(cfg.dec_ch_mult))):
        lp = p.up[str(i)]
        for j in range(cfg.num_res_blocks + 1):
            h = resnet3d(lp.block[str(j)], h)
        if i != 0:
            if i in cfg.temporal_up_layers:
                h = h.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
                h = res3d_upsample(lp.upsample.conv3d, h)
            else:
                h = h.repeat_interleave(2, 3).repeat_interleave(2, 4)
                h = _conv2d_frames(lp.upsample.conv, h)
    h = _conv3d(p.conv_out, _norm_zero_pad(p.norm_out, h), padding=(0, 1, 1))
    return h[:, :, cfg.temporal_downsample - 1:]


def vae_encode(model: StepVideoVAE, video):
    """video (B, T, 3, H, W) in [-1, 1] -> the latent mean (B, T_lat, z,
    h, w), 17 frames a chunk."""
    cfg = model.cfg
    chunks = [encoder_forward(model.encoder, video[:, t0:t0 + cfg.frame_len].transpose(1, 2),
                              cfg) for t0 in range(0, video.shape[1], cfg.frame_len)]
    return torch.cat(chunks, dim=1)[:, :, :cfg.z_channels]


def vae_decode(model: StepVideoVAE, latents):
    """latents (B, T_lat, z, h, w) -> video (B, 3, T, H, W), 3 latent
    frames a chunk."""
    cfg = model.cfg
    outs = [decoder_forward(model.decoder, latents[:, t0:t0 + cfg.latent_len], cfg)
            for t0 in range(0, latents.shape[1], cfg.latent_len)]
    return torch.cat(outs, dim=2)


def convert_step_vae(sd: Dict) -> Dict:
    """The reference state dict -> the port's names: a causal
    convolution's `.conv` level dropped (not under `downsample`,
    `upsample` or `conv_unpatchify`, whose `conv` is a module of its own),
    as the JAX converter does."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if (len(parts) >= 2 and parts[-2] == "conv" and parts[-1] in ("weight", "bias")
                and not (len(parts) >= 3 and parts[-3] in ("downsample", "upsample",
                                                           "conv_unpatchify"))):
            parts = parts[:-2] + parts[-1:]
        out[".".join(parts)] = val
    return out
