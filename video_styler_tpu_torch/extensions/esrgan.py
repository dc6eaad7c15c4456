"""ESRGAN (RRDBNet) x4 super-resolution in PyTorch.

Counterpart of `video_styler_tpu/extensions/esrgan.py`: residual-in-residual
dense blocks (3 RDBs per RRDB, 23 RRDBs, nf 64, gc 32), two nearest x2
upsamples, leaky ReLU 0.2. fp32 with TF32 off (`video_styler_tpu_torch`
switches it off); the convolutions are cuDNN's, as the JAX package leaves
them to XLA. Parameters are a nested dict of tensors keyed by the
checkpoint's module names, as `convert_rrdbnet` makes them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import nest_state_dict


def conv2d(p, x, padding=1):
    return F.conv2d(x, p["weight"], p.get("bias"), padding=padding)


def lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _rdb(p, x):
    """ResidualDenseBlock: 5 convs with dense concat, 0.2-scaled residual."""
    x1 = lrelu(conv2d(p["conv1"], x))
    x2 = lrelu(conv2d(p["conv2"], torch.cat([x, x1], 1)))
    x3 = lrelu(conv2d(p["conv3"], torch.cat([x, x1, x2], 1)))
    x4 = lrelu(conv2d(p["conv4"], torch.cat([x, x1, x2, x3], 1)))
    x5 = conv2d(p["conv5"], torch.cat([x, x1, x2, x3, x4], 1))
    return x5 * 0.2 + x


def _rrdb(p, x):
    out = _rdb(p["rdb1"], x)
    out = _rdb(p["rdb2"], out)
    out = _rdb(p["rdb3"], out)
    return out * 0.2 + x


def _upsample_nearest(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def rrdbnet_forward(params, x, num_blocks: int = 23):
    """x: (B, 3, H, W) in [0, 1] -> (B, 3, 4H, 4W)."""
    feat = conv2d(params["conv_first"], x)
    body = feat
    for i in range(num_blocks):
        body = _rrdb(params["body"][str(i)], body)
    feat = feat + conv2d(params["conv_body"], body)
    feat = lrelu(conv2d(params["conv_up1"], _upsample_nearest(feat)))
    feat = lrelu(conv2d(params["conv_up2"], _upsample_nearest(feat)))
    return conv2d(params["conv_last"], lrelu(conv2d(params["conv_hr"], feat)))


def convert_rrdbnet(sd: Dict, device=None) -> Dict:
    """RRDBNet state dict (numpy arrays or tensors) -> nested dict of
    float32 tensors on `device` (the card unless "cpu")."""
    return nest_state_dict(sd, device)


def rrdbnet_shapes(num_blocks: int = 23, nf: int = 64, gc: int = 32) -> Dict[str, tuple]:
    """The RRDBNet checkpoint's tensor names and shapes (3x3 convs)."""
    convs = [("conv_first", 3, nf)]
    for i in range(num_blocks):
        for r in ("rdb1", "rdb2", "rdb3"):
            convs += [(f"body.{i}.{r}.conv{j + 1}", nf + j * gc, gc) for j in range(4)]
            convs.append((f"body.{i}.{r}.conv5", nf + 4 * gc, nf))
    convs += [("conv_body", nf, nf), ("conv_up1", nf, nf), ("conv_up2", nf, nf),
              ("conv_hr", nf, nf), ("conv_last", nf, 3)]
    shapes = {}
    for name, ci, co in convs:
        shapes[f"{name}.weight"] = (co, ci, 3, 3)
        shapes[f"{name}.bias"] = (co,)
    return shapes


class ESRGANUpscaler:
    """x4 upscaling of frames: PIL images in, PIL images out (PIL imported
    then); (H, W, 3) uint8 arrays or tensors in, uint8 arrays out."""

    def __init__(self, params, num_blocks: int = 23, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.num_blocks = num_blocks

    def upscale(self, images: List, batch_size: int = 4):
        as_pil = not isinstance(images[0], np.ndarray) and not torch.is_tensor(images[0])
        arrs = torch.stack([torch.as_tensor(np.array(im) if not torch.is_tensor(im) else im)
                            for im in images]).to(self.device, torch.float32)
        arrs = arrs.permute(0, 3, 1, 2) / 255.0
        outs = []
        with torch.no_grad():
            for i in range(0, arrs.shape[0], batch_size):
                out = rrdbnet_forward(self.params, arrs[i:i + batch_size], self.num_blocks)
                outs.append((out.clamp(0, 1).permute(0, 2, 3, 1) * 255).to(torch.uint8).cpu())
        frames = list(torch.cat(outs).numpy())
        if as_pil:
            from PIL import Image
            return [Image.fromarray(a) for a in frames]
        return frames

    def __call__(self, rendered_frames, **kwargs):
        return self.upscale(rendered_frames)
