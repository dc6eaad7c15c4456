"""The SDXL family in PyTorch: the UNet (and Kolors'), CLIP-L with 11
layers and no final norm, and the second text encoder (OpenCLIP bigG,
"CLIP-G"; SD3's text encoder 2).

Counterpart of `video_styler_tpu/models/sdxl.py`: `SDXL_UNET_PROGRAM` and
`sdxl_unet_forward` (:25-90) on SD's blocks and interpreter (`models.sd`):
10/20-head attention blocks of 2/10 transformers, the `add_time_id` /
`add_text_embeds` micro-conditioning (six sizes through a 256-wide
sinusoid, after the pooled text), the ControlNet residuals after block 22,
the motion modules after the blocks of their call map, and Kolors'
`text_intermediate_proj` (4096 -> 2048) with its 5632-wide add embedding;
`sdxl_text_encoder_forward` (:105) and `sdxl_text_encoder_2_forward`
(:120-137): 32 layers of 1280 wide with 20 heads of 64, the exact GELU in
fp32, a causal mask; `hidden` is the state `clip_skip` layers before the
end (no final norm), `pooled` the final-norm row at the largest input id
(CLIP's end token), through `text_projection` (no bias). Attention is the
exact `sdpa`, as in the JAX package (heads of 64 are no Pallas kernel
there).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..ops.basic import layer_norm
from .sd import (TIME_PROJ, SDUNet, SDUNetConfig, conv2d, convert_sd_module, embed_time, run_unet,
                 timestep_embedding)
from .sd3_text_encoder import (CLIP_L, ClipTextConfig, ClipTextEncoder, causal_mask,
                               clip_layer)
from .wan_dit import Linear

# (kind, heads) per block of the SDXL UNet
SDXL_UNET_PROGRAM: List[Tuple[str, int]] = (
    [("res", 0), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 10), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 20), ("push", 0)] * 2
    + [("res", 0), ("attn", 20), ("res", 0)]
    + [("pop", 0), ("res", 0), ("attn", 20)] * 3 + [("up", 0)]
    + [("pop", 0), ("res", 0), ("attn", 10)] * 3 + [("up", 0)]
    + [("pop", 0), ("res", 0)] * 3
)
SDXL_CONTROLNET_AT = 22

SDXL_UNET = SDUNetConfig(channels=(320, 640, 1280), text_dim=2048, depth=(0, 2, 10),
                         mid_depth=10, add_embed_dim=1280 + 6 * 256)
# Kolors: ChatGLM's 4096-wide states through text_intermediate_proj, its
# pooled 4096 in the add embedding
KOLORS_UNET = dataclasses.replace(SDXL_UNET, add_embed_dim=4096 + 6 * 256, text_proj_dim=4096)
# 10 and 20 heads of 16 and 8 at 160 wide (GroupNorm's 32 groups and the
# program's head counts); the context of a 48-wide CLIP-L beside a 40-wide
# CLIP-G
SDXL_UNET_TINY = SDUNetConfig(channels=(32, 160, 160), text_dim=88, depth=(0, 2, 2),
                              mid_depth=2, add_embed_dim=40 + 6 * 256)


class SDXLUNet(SDUNet):
    program = SDXL_UNET_PROGRAM


def sdxl_unet_forward(model: SDXLUNet, sample, timestep, encoder_hidden_states, add_time_id,
                      add_text_embeds, controlnet_res_stack=None, ipadapter_kwargs_list=None,
                      motion=None):
    """sample (B, 4, H/8, W/8); add_time_id (6,) original / crop / target
    sizes; add_text_embeds (1 or B, pooled width) -> the predicted noise.
    controlnet_res_stack: 10 residuals (added after block 22)."""
    t_emb = embed_time(model.time_embedding,
                       timestep_embedding(timestep, TIME_PROJ).to(sample.dtype))
    time_embeds = timestep_embedding(torch.as_tensor(add_time_id, dtype=torch.float32,
                                                     device=sample.device).reshape(-1), 256)
    time_embeds = time_embeds.reshape(add_text_embeds.shape[0], -1)
    add_embeds = torch.cat([add_text_embeds, time_embeds.to(add_text_embeds.dtype)],
                           dim=-1).to(sample.dtype)
    time_emb = t_emb + embed_time(model.add_time_embedding, add_embeds)
    h = conv2d(model.conv_in, sample)
    text_emb = encoder_hidden_states
    if hasattr(model, "text_intermediate_proj"):
        text_emb = model.text_intermediate_proj(text_emb)
    return run_unet(model, SDXL_UNET_PROGRAM, h, time_emb, text_emb, controlnet_res_stack,
                    ipadapter_kwargs_list, motion, controlnet_at=SDXL_CONTROLNET_AT)


# ------------------------------------------------------------- text encoders

SDXL_CLIP_L = dataclasses.replace(CLIP_L, num_layers=11)
# 12 heads of 4 (the JAX forwards' CLIP-L head count)
CLIP_L_TINY_12 = ClipTextConfig(vocab=128, dim=48, ffn_dim=96, num_layers=3, num_heads=12)
CLIP_G = ClipTextConfig(vocab=49408, dim=1280, ffn_dim=5120, num_layers=32, num_heads=20)
# 20 heads of 2: the JAX forward's head count at a tiny width
CLIP_G_TINY = ClipTextConfig(vocab=128, dim=40, ffn_dim=80, num_layers=3, num_heads=20)


class SDXLTextEncoder(ClipTextEncoder):
    """CLIP-L's first 11 layers, without the final norm."""

    def __init__(self, cfg: ClipTextConfig = SDXL_CLIP_L, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        del self.final_layer_norm


def sdxl_text_encoder_forward(model: SDXLTextEncoder, input_ids, clip_skip: int = 1):
    """input_ids (B, L) -> the raw state `clip_skip - 1` layers before the
    end (B, L, 768)."""
    cfg = model.cfg
    x = model.token_embedding.weight[input_ids.long()]
    x = x + model.position_embeds.to(x.dtype)
    mask = causal_mask(x.shape[1], x.device)
    for i, p in enumerate(model.encoders):
        x = clip_layer(p, x, mask, cfg.num_heads, quick_gelu=True)
        if i + clip_skip == cfg.num_layers:
            break
    return x


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
