"""ControlNets for SD 1.5 and SDXL in PyTorch.

Counterpart of `video_styler_tpu/models/controlnet.py` (:46-177): the
trunk is the down and middle part of the UNet's block program with a push
after every stage (`SD_CONTROLNET_PROGRAM`, 13 residuals;
`SDXL_CONTROLNET_PROGRAM`, 10), fed by `conv_in` of the latents plus a
conditioning stem of 3x3 convs and SiLUs (stride 2 at the third, fifth and
seventh conv) of the control image; each residual leaves through a 1x1
zero conv (`controlnet_blocks`), optionally mean-pooled. The SDXL union
ControlNet adds the task (a one-hot of 8 through a 256-wide sinusoid) to
the time embedding, and fuses the condition into the input: the pooled
stem output plus the task's embedding and the pooled `conv_in` output
pass one CLIP-style residual attention block (torch MultiheadAttention
weights, 8 heads, sequence-first: it attends over the batch axis, as the
reference's does), whose first row scales into a per-channel shift.
Attention is the exact `sdpa`, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .sd import (LATENT_CHANNELS, SD_UNET, TIME_PROJ, SDUNetConfig, _embedding, _silu, attention_block, conv2d,
                 downsample, embed_time, program_widths, resnet_block, timestep_embedding,
                 unet_blocks)
from .wan_dit import Linear

SD_CONTROLNET_PROGRAM: List[Tuple[str, int]] = (
    [("res", 8), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 8), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 8), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("push", 0)] * 2
    + [("res", 0), ("attn", 8), ("res", 0), ("push", 0)]
)

SDXL_CONTROLNET_PROGRAM: List[Tuple[str, int]] = (
    [("res", 0), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 10), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 20), ("push", 0)] * 2
    + [("res", 0), ("attn", 20), ("res", 0), ("push", 0)]
)

SDXL_UNION_TASK_ID = {"openpose": 0, "depth": 1, "softedge": 2, "canny": 3,
                      "lineart": 3, "lineart_anime": 3, "tile": 6, "inpaint": 7}
UNION_TASKS = 8
UNION_HEADS = 8


STEM_WIDTHS = (3, 16, 32, 96, 256)  # the conditioning stem's widths before conv_in's


@dataclass(frozen=True)
class ControlNetConfig:
    unet: SDUNetConfig = SD_UNET
    union: bool = False             # the SDXL union ControlNet


class ConditioningLayer(nn.Module):
    """Conv, SiLU, then per inner width a same-width conv and a widening
    one (each with its SiLU), then the last conv: the reference's module
    list, so that the convs keep its indices."""

    def __init__(self, widths: Sequence[int], device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        blocks = [nn.Conv2d(widths[0], widths[1], 3, **kw), nn.SiLU()]
        for i in range(1, len(widths) - 2):
            blocks += [nn.Conv2d(widths[i], widths[i], 3, **kw), nn.SiLU(),
                       nn.Conv2d(widths[i], widths[i + 1], 3, **kw), nn.SiLU()]
        blocks.append(nn.Conv2d(widths[-2], widths[-1], 3, **kw))
        self.blocks = nn.ModuleList(blocks)


class TorchLayerNorm(nn.Module):
    """A LayerNorm under torch's names (`ln_1`/`ln_2` hold no "norm": the
    converters keep their `weight`)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))


class MultiheadAttention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device, dtype=dtype))
        self.out_proj = Linear(dim, dim, device=device, dtype=dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.c_fc = Linear(dim, 4 * dim, device=device, dtype=dtype)
        self.c_proj = Linear(4 * dim, dim, device=device, dtype=dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = TorchLayerNorm(dim, **kw)
        self.attn = MultiheadAttention(dim, **kw)
        self.ln_2 = TorchLayerNorm(dim, **kw)
        self.mlp = Mlp(dim, **kw)


class ControlNet(nn.Module):
    def __init__(self, cfg: ControlNetConfig = ControlNetConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        u = cfg.unet
        c0 = u.channels[0]
        program = SDXL_CONTROLNET_PROGRAM if cfg.union else SD_CONTROLNET_PROGRAM
        self.time_embedding = _embedding(TIME_PROJ, u.temb_dim, **kw)
        if cfg.union:
            self.add_time_embedding = _embedding(u.add_embed_dim, u.temb_dim, **kw)
            self.control_type_embedding = _embedding(UNION_TASKS * 256, u.temb_dim, **kw)
            self.controlnet_transformer = ResidualAttentionBlock(c0, **kw)
            self.task_embedding = nn.Parameter(torch.empty(UNION_TASKS, c0, **kw))
            self.spatial_ch_projs = Linear(c0, c0, **kw)
        self.conv_in = nn.Conv2d(LATENT_CHANNELS, c0, 3, **kw)
        self.controlnet_conv_in = ConditioningLayer(STEM_WIDTHS + (c0,), **kw)
        self.blocks = unet_blocks(program, u, **kw)
        _, pushed = program_widths(program, u)
        self.controlnet_blocks = nn.ModuleList(nn.Conv2d(w, w, 1, **kw) for w in pushed)


def detect_controlnet_config(sd: Dict) -> ControlNetConfig:
    """A ControlNet's config from its state dict under the port's names."""
    from .sd import detect_unet_config
    union = "controlnet_transformer.ln_1.weight" in sd
    unet = detect_unet_config(sd, SDXL_CONTROLNET_PROGRAM if union else SD_CONTROLNET_PROGRAM)
    return ControlNetConfig(unet=unet, union=union)


def conditioning_stem(p: ConditioningLayer, x):
    convs = [m for m in p.blocks if isinstance(m, nn.Conv2d)]
    n = len(convs)
    for j, conv in enumerate(convs):
        x = conv2d(conv, x, stride=2 if 0 < j < n - 1 and j % 2 == 0 else 1)
        if j < n - 1:
            x = _silu(x)
    return x


def _run_trunk(model: ControlNet, program, h, time_emb, text_emb):
    res_stack = [h]
    for i, (kind, heads) in enumerate(program):
        p = model.blocks[i]
        if kind == "res":
            h = resnet_block(p, h, time_emb=time_emb)
        elif kind == "attn":
            h = attention_block(p, h, text_emb, heads)
        elif kind == "push":
            res_stack.append(h)
        elif kind == "down":
            h = downsample(p, h)
    return res_stack


def _zero_convs(model: ControlNet, res_stack, global_pool: bool):
    out = [conv2d(conv, r, padding=0) for conv, r in zip(model.controlnet_blocks, res_stack)]
    if global_pool:
        out = [o.mean(dim=(2, 3), keepdim=True) for o in out]
    return out


def sd_controlnet_forward(model: ControlNet, sample, timestep, text_emb, conditioning,
                          global_pool: bool = False):
    """-> the 13 residuals that `sd_unet_forward` takes."""
    time_emb = embed_time(model.time_embedding,
                          timestep_embedding(timestep, TIME_PROJ).to(sample.dtype))
    time_emb = time_emb.expand(sample.shape[0], -1)
    h = conv2d(model.conv_in, sample) + conditioning_stem(model.controlnet_conv_in,
                                                          conditioning.to(sample.dtype))
    return _zero_convs(model, _run_trunk(model, SD_CONTROLNET_PROGRAM, h, time_emb, text_emb),
                       global_pool)


def _ln_torch(p: TorchLayerNorm, x, eps: float = 1e-5):
    return layer_norm(x, p.weight, p.bias, eps)


def residual_attention_block(p: ResidualAttentionBlock, x):
    """x (B, S, D), read as torch's sequence-first (L=B, N=S, D): the
    attention runs over the leading axis."""
    h = _ln_torch(p.ln_1, x)
    d = h.shape[-1]
    qkv = torch.matmul(h, p.attn.in_proj_weight.to(h.dtype).t()) + p.attn.in_proj_bias.to(h.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    L, N, _ = h.shape
    nh = UNION_HEADS

    def heads(t):
        return t.transpose(0, 1).reshape(N, L, nh, d // nh)

    out = sdpa(heads(q), heads(k), heads(v)).reshape(N, L, d).transpose(0, 1)
    x = x + p.attn.out_proj(out)
    h = p.mlp.c_fc(_ln_torch(p.ln_2, x))
    return x + p.mlp.c_proj(h * torch.sigmoid(1.702 * h))


def sdxl_controlnet_union_forward(model: ControlNet, sample, timestep, text_emb, conditioning,
                                  processor_id: str, add_time_id, add_text_embeds,
                                  global_pool: bool = False):
    """-> the 10 residuals that `sdxl_unet_forward` takes."""
    task_id = SDXL_UNION_TASK_ID[processor_id]
    dev, dt = sample.device, sample.dtype
    t_emb = embed_time(model.time_embedding, timestep_embedding(timestep, TIME_PROJ).to(dt))
    time_embeds = timestep_embedding(torch.as_tensor(add_time_id, dtype=torch.float32,
                                                     device=dev).reshape(-1), 256)
    time_embeds = time_embeds.reshape(add_text_embeds.shape[0], -1)
    add_embeds = torch.cat([add_text_embeds, time_embeds.to(add_text_embeds.dtype)],
                           dim=-1).to(dt)
    add_embeds = embed_time(model.add_time_embedding, add_embeds)
    control_type = torch.zeros(sample.shape[0], UNION_TASKS, dtype=dt, device=dev)
    control_type[:, task_id] = 1.0
    control_embeds = timestep_embedding(control_type.reshape(-1), 256)
    control_embeds = control_embeds.reshape(sample.shape[0], -1).to(dt)
    time_emb = t_emb + add_embeds + embed_time(model.control_type_embedding, control_embeds)

    h = conv2d(model.conv_in, sample)
    cond = conditioning_stem(model.controlnet_conv_in, conditioning.to(dt))
    feat_seq = cond.mean(dim=(2, 3)) + model.task_embedding[task_id].to(cond.dtype)
    x2 = torch.stack([feat_seq, h.mean(dim=(2, 3))], dim=1)
    x2 = residual_attention_block(model.controlnet_transformer, x2)
    alpha = model.spatial_ch_projs(x2[:, 0])[:, :, None, None]
    h = h + (cond + alpha)
    return _zero_convs(model, _run_trunk(model, SDXL_CONTROLNET_PROGRAM, h, time_emb, text_emb),
                       global_pool)


def convert_controlnet(sd: Dict) -> Dict:
    """A reference SDControlNet / SDXLControlNetUnion state dict -> the
    port's names (norms' `weight` -> `scale`; `ln_1`/`ln_2` keep theirs)."""
    from .sd import convert_sd_module
    return convert_sd_module(sd)
