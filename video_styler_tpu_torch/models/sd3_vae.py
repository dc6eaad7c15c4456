"""The SD3 / FLUX image VAE (16-channel latents) in PyTorch.

Counterpart of `video_styler_tpu/models/sd3_vae.py`: the SD VAE's block
programs (`models.sd`) with 16 latent channels, no quant convs, and the
(shift, scale) affine of the latents. FLUX differs from SD3 only in that
affine. It runs in fp32, as the Wan VAE does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from .sd import (SD_VAE_CHANNELS, SD_VAE_DECODER_PROGRAM, SD_VAE_ENCODER_PROGRAM, Affine,
                 _silu, conv2d, convert_sd_module, group_norm, run_vae_blocks, vae_blocks)


@dataclass(frozen=True)
class SD3VAEConfig:
    z_dim: int = 16
    scaling_factor: float = 1.5305
    shift_factor: float = 0.0609


SD3_VAE = SD3VAEConfig()
FLUX_VAE = SD3VAEConfig(scaling_factor=0.3611, shift_factor=0.1159)


class SD3VAEEncoder(nn.Module):
    def __init__(self, cfg: SD3VAEConfig = SD3_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ch = SD_VAE_CHANNELS
        self.conv_in = nn.Conv2d(3, ch[0], 3, **kw)
        self.blocks = vae_blocks(SD_VAE_ENCODER_PROGRAM, **kw)
        self.conv_norm_out = Affine(ch[-1], **kw)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.z_dim, 3, **kw)


class SD3VAEDecoder(nn.Module):
    def __init__(self, cfg: SD3VAEConfig = SD3_VAE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ch = SD_VAE_CHANNELS
        self.conv_in = nn.Conv2d(cfg.z_dim, ch[-1], 3, **kw)
        self.blocks = vae_blocks(SD_VAE_DECODER_PROGRAM, **kw)
        self.conv_norm_out = Affine(ch[0], **kw)
        self.conv_out = nn.Conv2d(ch[0], 3, 3, **kw)


def sd3_vae_encoder_forward(enc: SD3VAEEncoder, sample, cfg: SD3VAEConfig = SD3_VAE):
    """Image (B, 3, H, W) in [-1, 1] -> latents (B, 16, H/8, W/8)."""
    h = conv2d(enc.conv_in, sample)
    h = run_vae_blocks(enc.blocks, SD_VAE_ENCODER_PROGRAM, h)
    h = conv2d(enc.conv_out, _silu(group_norm(enc.conv_norm_out, h, eps=1e-6)))
    return (h[:, :cfg.z_dim] - cfg.shift_factor) * cfg.scaling_factor


def sd3_vae_decoder_forward(dec: SD3VAEDecoder, sample, cfg: SD3VAEConfig = SD3_VAE):
    """Latents (B, 16, h, w) -> image (B, 3, 8h, 8w)."""
    h = conv2d(dec.conv_in, sample / cfg.scaling_factor + cfg.shift_factor)
    h = run_vae_blocks(dec.blocks, SD_VAE_DECODER_PROGRAM, h)
    return conv2d(dec.conv_out, _silu(group_norm(dec.conv_norm_out, h, eps=1e-6)))


def convert_sd3_vae(sd: Dict) -> Dict:
    """A reference SD3VAEEncoder or SD3VAEDecoder state dict (names
    relative to the module) -> the port's module state dict."""
    return convert_sd_module(sd)


def split_vae_state_dict(sd: Dict):
    """A whole-VAE file, the encoder's and the decoder's module state dicts
    under `encoder.` and `decoder.` -> (encoder, decoder) state dicts. (The
    JAX pipeline drops only the other side's keys and keeps the prefix,
    which its converter does not expect.)"""
    return tuple({k[len(side) + 1:]: v for k, v in sd.items() if k.startswith(side + ".")}
                 for side in ("encoder", "decoder"))


@torch.no_grad()
def init_sd3_vae_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init: conv weights N(0, 1/fan_in), linear weights N(0, 1/in),
    biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2) and biases N(0, 0.1^2)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, Affine):
            m.scale.normal_(1.0, 0.1, generator=generator)
            m.bias.normal_(0.0, 0.1, generator=generator)
    return module
