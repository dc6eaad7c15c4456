"""CLIP-L, the SD3 text encoder 1 and the FLUX pooled-prompt tower, in
PyTorch.

Counterpart of `video_styler_tpu/models/sd3_text_encoder.py`
(`sd3_text_encoder_1_forward` :21-49): a causal mask, quickGELU MLPs
(`clip_layer`, the JAX `sdxl._clip_layer`, which CLIP-G and the FLUX LoRA
encoder run too),
`hidden` taken `clip_skip` layers before the end (no final norm) and
`pooled`, the final-norm embedding at the position of the largest input id
(CLIP's EOS, whose id is the vocabulary's largest). The T5 v1.1 tower is
`models.t5` (`T5_V11_XXL`, `convert_hf_t5`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from ..ops.basic import layer_norm
from .sd import Affine, Attention, attn, convert_sd_module
from .wan_dit import Linear


@dataclass(frozen=True)
class ClipTextConfig:
    vocab: int = 49408
    dim: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77


CLIP_L = ClipTextConfig()
# pooled 32 wide: FLUX_DIT_TINY's pooled_dim
CLIP_L_TINY = ClipTextConfig(vocab=128, dim=32, ffn_dim=64, num_layers=3, num_heads=2)


class TokenEmbedding(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim, device=device, dtype=dtype))


class ClipTextLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = Affine(cfg.dim, **kw)
        self.attn = Attention(cfg.dim, **kw)
        self.layer_norm2 = Affine(cfg.dim, **kw)
        self.fc1 = Linear(cfg.dim, cfg.ffn_dim, **kw)
        self.fc2 = Linear(cfg.ffn_dim, cfg.dim, **kw)


class ClipTextEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig = CLIP_L, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = TokenEmbedding(cfg.vocab, cfg.dim, **kw)
        self.position_embeds = nn.Parameter(torch.empty(1, cfg.max_len, cfg.dim, **kw))
        self.encoders = nn.ModuleList(ClipTextLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_layer_norm = Affine(cfg.dim, **kw)


def detect_clip_text_config(sd: Dict, num_heads: int) -> ClipTextConfig:
    """A CLIP text tower's config from its state dict (the head count is not
    in the tensors)."""
    n = 0
    while f"encoders.{n}.fc1.weight" in sd:
        n += 1
    vocab, dim = sd["token_embedding.weight"].shape
    return ClipTextConfig(vocab=vocab, dim=dim, ffn_dim=sd["encoders.0.fc1.weight"].shape[0],
                          num_layers=n, num_heads=num_heads,
                          max_len=sd["position_embeds"].shape[-2])


def clip_layer(p: ClipTextLayer, x, mask, num_heads: int, quick_gelu: bool):
    """One CLIP encoder layer (the JAX `sdxl._clip_layer`): pre-norm
    attention through the exact `sdpa` (mask (L, L) added to the fp32
    logits, or None), then the MLP with quickGELU or the exact GELU in
    fp32."""
    x = x + attn(p.attn, layer_norm(x, p.layer_norm1.scale, p.layer_norm1.bias, 1e-5),
                 num_heads=num_heads, mask=mask)
    h = p.fc1(layer_norm(x, p.layer_norm2.scale, p.layer_norm2.bias, 1e-5))
    if quick_gelu:
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = torch.nn.functional.gelu(h.float()).to(h.dtype)
    return x + p.fc2(h)


def causal_mask(length: int, device) -> torch.Tensor:
    return torch.full((length, length), float("-inf"), device=device).triu(1)


def sd3_text_encoder_1_forward(model: ClipTextEncoder, input_ids, clip_skip: int = 2):
    """input_ids (B, L) -> (pooled (B, D), hidden (B, L, D))."""
    cfg = model.cfg
    ids = input_ids.long()
    x = model.token_embedding.weight[ids]
    x = x + model.position_embeds.to(x.dtype)
    mask = causal_mask(x.shape[1], x.device)
    hidden = None
    for i, p in enumerate(model.encoders):
        x = clip_layer(p, x, mask, cfg.num_heads, quick_gelu=True)
        if i + clip_skip == cfg.num_layers:
            hidden = x
    embeds = layer_norm(x, model.final_layer_norm.scale, model.final_layer_norm.bias, 1e-5)
    pooled = embeds[torch.arange(embeds.shape[0], device=x.device), ids.argmax(dim=-1)]
    return pooled, (embeds if hidden is None else hidden)


def convert_sd3_text_encoder_1(sd: Dict) -> Dict:
    """A reference SD3TextEncoder1 state dict -> the port's module state
    dict (the norms' `weight` become `scale`)."""
    return convert_sd_module(sd)


@torch.no_grad()
def init_clip_text_(model: ClipTextEncoder, generator: torch.Generator) -> ClipTextEncoder:
    """Random init: linear weights N(0, 1/in), biases 0, norms 1 and 0, token
    and position embeddings N(0, 0.02^2)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Affine):
            m.scale.fill_(1.0)
            m.bias.zero_()
    model.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
    model.position_embeds.normal_(0.0, 0.02, generator=generator)
    return model
