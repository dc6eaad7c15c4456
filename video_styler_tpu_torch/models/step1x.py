"""Step1x-Edit's connector: Qwen2.5-VL features -> FLUX conditioning.

Counterpart of `video_styler_tpu/models/step1x.py`: HunyuanVideo's token
refiner (`hunyuan_video_dit.token_refiner`: the timestep and masked-mean
context gating two self-attention blocks, 32 heads of 128, the exact
`sdpa` under the pairwise mask) lifts the 3584-wide Qwen2.5-VL hidden
states to FLUX's 4096-wide context, and a masked mean scaled by
(1 + scale_factor) is projected to the 768-wide pooled slot. Parameters
live in modules named after the JAX tree (`refiner.blocks.{i}.mlp.0`,
`global_proj_out`, `scale_factor`); `convert_step1x_connector` reads the
reference's Qwen2Connector names into them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from .hunyuan_video_dit import TokenRefiner, init_hunyuan_video_dit_, token_refiner
from .wan_dit import Linear


@dataclass(frozen=True)
class Step1xConnectorConfig:
    in_channels: int = 3584
    hidden_size: int = 4096
    num_heads: int = 32
    depth: int = 2
    pooled_dim: int = 768
    time_freq_dim: int = 256
    eps: float = 1e-6


STEP1X_CONNECTOR = Step1xConnectorConfig()
STEP1X_CONNECTOR_TINY = Step1xConnectorConfig(in_channels=16, hidden_size=32, num_heads=2,
                                              depth=2, pooled_dim=8)


class Step1xConnector(nn.Module):
    def __init__(self, cfg: Step1xConnectorConfig = STEP1X_CONNECTOR, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.refiner = TokenRefiner(cfg.in_channels, cfg.hidden_size, cfg.depth,
                                    cfg.time_freq_dim, **kw)
        self.global_proj_out = Linear(cfg.in_channels, cfg.pooled_dim, **kw)
        self.scale_factor = nn.Parameter(torch.empty(1, **kw))


@torch.no_grad()
def init_step1x_connector_(model: Step1xConnector, generator: torch.Generator):
    """The JAX init: linears N(0, 1/in), biases 0, LayerNorms 1 and 0,
    scale_factor -(1 - 0.09)."""
    init_hunyuan_video_dit_(model, generator)
    model.scale_factor.fill_(-(1 - 0.09))
    return model


def step1x_connector_forward(model: Step1xConnector, x, t, mask):
    """x (B, L, in_channels) Qwen hidden states; t (B,) timestep / 1000;
    mask (B, L) {0, 1} -> (context (B, L, hidden), pooled (B, pooled_dim))."""
    refined = token_refiner(model.refiner, model.cfg, x, t, mask)
    mask_f = mask.float()[..., None]
    pooled = (x.float() * mask_f).sum(dim=1) / mask_f.sum(dim=1)
    pooled = pooled * (1.0 + model.scale_factor.float())
    return refined, model.global_proj_out(pooled.to(x.dtype))


def convert_step1x_connector(sd: Dict, cfg: Step1xConnectorConfig = STEP1X_CONNECTOR) -> Dict:
    """A Qwen2Connector state dict (`S.*` refiner, `global_proj_out`,
    `scale_factor`; an optional `connector.` prefix) -> the
    `Step1xConnector` state dict. Values pass through."""
    sd = {k.removeprefix("connector."): v for k, v in sd.items()}
    names = {"refiner.input_embedder": "S.input_embedder",
             "refiner.t_embedder.fc1": "S.t_embedder.mlp.0",
             "refiner.t_embedder.fc2": "S.t_embedder.mlp.2",
             "refiner.c_embedder.0": "S.c_embedder.linear_1",
             "refiner.c_embedder.2": "S.c_embedder.linear_2",
             "global_proj_out": "global_proj_out"}
    for i in range(cfg.depth):
        src, dst = f"S.individual_token_refiner.blocks.{i}", f"refiner.blocks.{i}"
        for a, b in (("norm1", "norm1"), ("self_attn_qkv", "self_attn_qkv"),
                     ("self_attn_proj", "self_attn_proj"), ("norm2", "norm2"),
                     ("mlp.0", "mlp.fc1"), ("mlp.2", "mlp.fc2"),
                     ("adaLN_modulation.1", "adaLN_modulation.1")):
            names[f"{dst}.{a}"] = f"{src}.{b}"
    out = {f"{dst}.{leaf}": sd[f"{src}.{leaf}"] for dst, src in names.items()
           for leaf in ("weight", "bias")}
    out["scale_factor"] = sd["scale_factor"]
    return out
