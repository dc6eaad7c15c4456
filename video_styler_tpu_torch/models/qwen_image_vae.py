"""Qwen-Image's VAE: the Wan2.1 causal VAE under diffusers-style names.

Counterpart of `video_styler_tpu/models/qwen_image_vae.py`. The Qwen-Image
VAE is the Wan2.1 VAE (the same widths, z = 16, the same latent mean and
std) applied to single frames: `convert_qwen_image_vae` renames its keys
onto `models.wan_vae.WanVAE`'s, and the encode and decode run one frame
through `wan_vae.vae_encode` / `vae_decode` (fp32, cuDNN convolutions).
"""
from __future__ import annotations

from typing import Dict, Optional

from . import wan_vae as V

_RENAMES = [
    ("encoder.conv_in", "encoder.conv1"),
    ("encoder.down_blocks.", "encoder.downsamples."),
    ("encoder.mid_block.resnets.0", "encoder.middle.0"),
    ("encoder.mid_block.attentions.0", "encoder.middle.1"),
    ("encoder.mid_block.resnets.1", "encoder.middle.2"),
    ("encoder.norm_out", "encoder.head.0"),
    ("encoder.conv_out", "encoder.head.2"),
    ("decoder.conv_in", "decoder.conv1"),
    ("decoder.mid_block.resnets.0", "decoder.middle.0"),
    ("decoder.mid_block.attentions.0", "decoder.middle.1"),
    ("decoder.mid_block.resnets.1", "decoder.middle.2"),
    ("decoder.norm_out", "decoder.head.0"),
    ("decoder.conv_out", "decoder.head.2"),
    ("quant_conv", "conv1"),
    ("post_quant_conv", "conv2"),
]

_LEAF_RENAMES = [
    ("norm1.gamma", "residual.0.gamma"),
    ("conv1.weight", "residual.2.weight"), ("conv1.bias", "residual.2.bias"),
    ("norm2.gamma", "residual.3.gamma"),
    ("conv2.weight", "residual.6.weight"), ("conv2.bias", "residual.6.bias"),
    ("conv_shortcut.", "shortcut."),
]


def _flatten_up_blocks(sd: Dict, num_res_blocks: int) -> Dict:
    """decoder.up_blocks.i.{resnets.j | upsamplers.0} -> Wan's flat
    decoder.upsamples.N (num_res_blocks + 1 resnets and an upsampler slot a
    level)."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("decoder.up_blocks."):
            out[k] = v
            continue
        parts = k.split(".")
        base = int(parts[2]) * (num_res_blocks + 2)
        if parts[3] == "resnets":
            out[f"decoder.upsamples.{base + int(parts[4])}." + ".".join(parts[5:])] = v
        elif parts[3] == "upsamplers":
            out[f"decoder.upsamples.{base + num_res_blocks + 1}." + ".".join(parts[5:])] = v
        else:
            out[k] = v
    return out


def convert_qwen_image_vae(sd: Dict, num_res_blocks: Optional[int] = None) -> Dict:
    """The reference's (diffusers-named) state dict -> the `WanVAE` state
    dict. Values pass through; the pipeline holds the VAE in fp32."""
    if num_res_blocks is None:
        n = 0
        while f"decoder.up_blocks.0.resnets.{n}.conv1.weight" in sd:
            n += 1
        num_res_blocks = max(n - 1, 1)
    renamed = {}
    for k, v in _flatten_up_blocks(dict(sd), num_res_blocks).items():
        for old, new in _RENAMES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        # leaf renames only inside residual blocks (the top-level quant
        # convs are conv1 / conv2 too after the prefix rename)
        if any(t in k for t in ("downsamples.", "upsamples.", "middle.")):
            for old, new in _LEAF_RENAMES:
                if f".{old}" in k:
                    k = k.replace(old, new)
                    break
        renamed[k] = v
    return V.convert_wan_vae(renamed)


def qwen_vae_encode(model: V.WanVAE, image):
    """image (B, 3, H, W) in [-1, 1] -> normalised latents (B, 16, H/8, W/8)."""
    return V.vae_encode(model, image[:, :, None])[:, :, 0]


def qwen_vae_decode(model: V.WanVAE, latents):
    """latents (B, 16, h, w) -> image (B, 3, 8h, 8w), not clamped."""
    return V.vae_decode(model, latents[:, :, None], clamp=False)[:, :, 0]
