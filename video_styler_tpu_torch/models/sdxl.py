"""The SDXL family's second text encoder (OpenCLIP bigG, "CLIP-G") in
PyTorch: SD3's text encoder 2.

Counterpart of the text-encoder part of `video_styler_tpu/models/sdxl.py`
(`_clip_layer` :93-103, which is `sd3_text_encoder.clip_layer` here, and
`sdxl_text_encoder_2_forward` :120-137): 32 layers of 1280 wide with 20
heads of 64, the exact GELU in fp32, a causal mask; `hidden` is the state
`clip_skip` layers before the end (no final norm), `pooled` the final-norm
row at the largest input id (CLIP's end token), through `text_projection`
(no bias). Attention is the exact `sdpa`, as in the JAX package (heads of
64 are no Pallas kernel there). The SDXL UNet comes with the SD slice.
"""
from __future__ import annotations

import torch

from ..ops.basic import layer_norm
from .sd import convert_sd_module
from .sd3_text_encoder import ClipTextConfig, ClipTextEncoder, causal_mask, clip_layer
from .wan_dit import Linear

CLIP_G = ClipTextConfig(vocab=49408, dim=1280, ffn_dim=5120, num_layers=32, num_heads=20)
# 20 heads of 2: the JAX forward's head count at a tiny width
CLIP_G_TINY = ClipTextConfig(vocab=128, dim=40, ffn_dim=80, num_layers=3, num_heads=20)


class SDXLTextEncoder2(ClipTextEncoder):
    def __init__(self, cfg: ClipTextConfig = CLIP_G, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.text_projection = Linear(cfg.dim, cfg.dim, bias=False, device=device, dtype=dtype)


def sdxl_text_encoder_2_forward(model: SDXLTextEncoder2, input_ids, clip_skip: int = 2):
    """input_ids (B, L) -> (pooled projected (B, D), hidden (B, L, D))."""
    cfg = model.cfg
    ids = input_ids.long()
    x = model.token_embedding.weight[ids]
    x = x + model.position_embeds.to(x.dtype)
    mask = causal_mask(x.shape[1], x.device)
    hidden = None
    for i, p in enumerate(model.encoders):
        x = clip_layer(p, x, mask, cfg.num_heads, quick_gelu=False)
        if i + clip_skip == cfg.num_layers:
            hidden = x
    x = layer_norm(x, model.final_layer_norm.scale, model.final_layer_norm.bias, 1e-5)
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return model.text_projection(pooled), hidden


# a reference module's state dict -> the port's names, as in JAX
convert_sdxl_module = convert_sd_module
