"""The Stable Video Diffusion family's CLIP-H image encoder in PyTorch, the
tower that SD's IP-Adapter embeds its image with.

Counterpart of `svd_image_encoder_forward` of
`video_styler_tpu/models/svd.py` (:354-380): a 14x14 patch embedding (no
bias), the class token and position table, a pre LayerNorm, 32 layers of
1280 wide (16 heads of 80; the exact GELU in fp32, no mask: the
arithmetic of `sd3_text_encoder.clip_layer`, whose layer this is), the
post LayerNorm of the class token and `visual_projection` to 1024 (no
bias). Attention is the exact `sdpa` over 257 tokens, as in JAX. The SVD
UNet and VAE come with ROADMAP Queue 1 item 11f.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .sd import Affine, _ln
from .sd3_text_encoder import ClipTextConfig, ClipTextLayer, clip_layer
from .wan_dit import Linear


@dataclass(frozen=True)
class SVDImageEncoderConfig:
    dim: int = 1280
    ffn_dim: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    proj_dim: int = 1024

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


SVD_IMAGE_ENCODER = SVDImageEncoderConfig()
SVD_IMAGE_ENCODER_TINY = SVDImageEncoderConfig(dim=32, ffn_dim=64, num_layers=2, num_heads=2,
                                               patch_size=14, image_size=56, proj_dim=24)


class Embeddings(nn.Module):
    def __init__(self, cfg: SVDImageEncoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.empty(cfg.dim, **kw))
        self.position_embeds = nn.Parameter(torch.empty(1, cfg.tokens, cfg.dim, **kw))


class SVDImageEncoder(nn.Module):
    def __init__(self, cfg: SVDImageEncoderConfig = SVD_IMAGE_ENCODER, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        layer = ClipTextConfig(dim=cfg.dim, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads)
        self.embeddings = Embeddings(cfg, **kw)
        self.pre_layernorm = Affine(cfg.dim, **kw)
        self.encoders = nn.ModuleList(ClipTextLayer(layer, **kw) for _ in range(cfg.num_layers))
        self.post_layernorm = Affine(cfg.dim, **kw)
        self.visual_projection = Linear(cfg.dim, cfg.proj_dim, bias=False, **kw)


def svd_image_encoder_forward(model: SVDImageEncoder, pixel_values):
    """pixel_values (B, 3, 224, 224), CLIP-normalised -> (B, 1024)."""
    cfg = model.cfg
    b = pixel_values.shape[0]
    emb = model.embeddings
    x = F.conv2d(pixel_values, emb.patch_embedding.weight.to(pixel_values.dtype),
                 stride=cfg.patch_size).flatten(2).transpose(1, 2)
    x = torch.cat([emb.class_embedding.to(x.dtype).expand(b, 1, cfg.dim), x], dim=1)
    x = _ln(model.pre_layernorm, x + emb.position_embeds.to(x.dtype))
    for p in model.encoders:
        x = clip_layer(p, x, None, cfg.num_heads, quick_gelu=False)
    return model.visual_projection(_ln(model.post_layernorm, x[:, 0]))
