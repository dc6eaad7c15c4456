"""Qwen-Image's block-wise ControlNet in PyTorch.

Counterpart of `video_styler_tpu/models/qwen_image_controlnet.py`: one small
block per DiT layer, [RMSNorm of the image tokens, RMSNorm of the control
tokens, linear, exact GELU in fp32, linear], whose output is added (times
the input's scale) to the image tokens after that layer
(`qwen_image_dit_forward`'s `blockwise_cn`). The control tokens are the
VAE-encoded control image, patchified and lifted to the DiT width once a
request (`qwen_blockwise_cn_process`). The inpaint variant reads one more
latent channel (the inverse mask), 4 more features a token.

Modules are named after the checkpoint (`img_in`,
`controlnet_blocks.{i}.x_rms.weight`, `.input_proj`, `.output_proj`), so
`convert_qwen_blockwise_controlnet` only selects the keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch.nn.functional as F
from torch import nn

from .flux_dit import RMSWeight, _rms, patchify
from .wan_dit import Linear


@dataclass(frozen=True)
class QwenBlockwiseCNConfig:
    num_layers: int = 60
    in_dim: int = 64             # 16 latent channels x 2 x 2
    additional_in_dim: int = 0   # 4 for the inpaint variant
    dim: int = 3072


QWEN_BLOCKWISE_CN = QwenBlockwiseCNConfig()


class BlockwiseControlBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.x_rms = RMSWeight(dim, **kw)
        self.y_rms = RMSWeight(dim, **kw)
        self.input_proj = Linear(dim, dim, **kw)
        self.output_proj = Linear(dim, dim, **kw)


class QwenBlockwiseControlNet(nn.Module):
    def __init__(self, cfg: QwenBlockwiseCNConfig = QWEN_BLOCKWISE_CN, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.img_in = Linear(cfg.in_dim + cfg.additional_in_dim, cfg.dim, **kw)
        self.controlnet_blocks = nn.ModuleList(BlockwiseControlBlock(cfg.dim, **kw)
                                               for _ in range(cfg.num_layers))


def qwen_blockwise_cn_process(model: QwenBlockwiseControlNet, conditioning_latents):
    """(B, C, H, W) control latents -> (B, H/2 * W/2, dim) control tokens."""
    return model.img_in(patchify(conditioning_latents))


def qwen_blockwise_cn_block(p: BlockwiseControlBlock, x, y, eps: float = 1e-6):
    """One layer's residual from the image tokens x and control tokens y."""
    h = p.input_proj(_rms(p.x_rms, x, eps) + _rms(p.y_rms, y, eps))
    h = F.gelu(h.float()).to(x.dtype)
    return p.output_proj(h)


def blockwise_cn_config_for(sd: Dict) -> QwenBlockwiseCNConfig:
    """The block count and widths from the file (the inpaint variant's
    extra features from `img_in`)."""
    n = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("controlnet_blocks."))
    dim, din = sd["img_in.weight"].shape
    return QwenBlockwiseCNConfig(num_layers=n, in_dim=64, additional_in_dim=din - 64, dim=dim)


def convert_qwen_blockwise_controlnet(sd: Dict, cfg: QwenBlockwiseCNConfig) -> Dict:
    """The reference's state dict -> the `QwenBlockwiseControlNet` state dict
    (the same names). Values pass through."""
    names = ["img_in.weight", "img_in.bias"]
    for i in range(cfg.num_layers):
        b = f"controlnet_blocks.{i}"
        names += [f"{b}.x_rms.weight", f"{b}.y_rms.weight"]
        names += [f"{b}.{m}.{leaf}" for m in ("input_proj", "output_proj")
                  for leaf in ("weight", "bias")]
    return {k: sd[k] for k in names}
