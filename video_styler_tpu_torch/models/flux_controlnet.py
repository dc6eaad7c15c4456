"""The FLUX ControlNet and the FLUX IP-Adapter in PyTorch.

Counterpart of `video_styler_tpu/models/flux_controlnet.py`:

- `FluxControlNet` (:32-195): a cut FLUX trunk (5 joint + 10 single blocks
  by default) over the latents' tokens plus `controlnet_x_embedder` of the
  patchified conditioning latents, one linear residual per block. A union
  ControlNet (`controlnet_mode_embedder`) prepends its mode token to the
  text, with the first text id repeated for its RoPE row; an inpainting one
  takes `additional_input_dim` more conditioning channels. The residual
  stacks are repeated over the DiT's 19 / 38 blocks by `align_res_stack`.
  The trunk is the DiT's own `joint_block` / `single_block`, so its
  self-attention is K1 on the card.
- The IP-Adapter (:198-249): a SigLIP pooled embedding (B, 1152) through
  `image_proj` to 128 tokens a picture (LayerNorm eps 1e-5), then each DiT
  block's `to_k_ip` / `to_v_ip`, k normalised by an RMSNorm without affine
  terms (eps 1e-5). The keys and values are stacked over the blocks for
  `flux_dit.flux_trunk`. The DiffSynth (`image_proj.{0,2}`) and InstantX
  (`image_proj.proj.{0,2}`, `ip_adapter.{i}`) layouts both load.

Parameters live in modules named after the JAX trees.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from . import flux_dit as F
from .wan_dit import LayerNormAffine, Linear
from ..ops.basic import layer_norm


@dataclass(frozen=True)
class FluxControlNetConfig:
    dit: F.FluxDiTConfig = F.FLUX_DEV
    num_joint_blocks: int = 5
    num_single_blocks: int = 10
    guidance_embed: bool = True
    num_mode: int = 0                      # union ControlNets: the mode table's rows
    additional_input_dim: int = 0          # inpainting: extra conditioning channels


FLUX_CONTROLNET = FluxControlNetConfig()
FLUX_CONTROLNET_TINY = FluxControlNetConfig(dit=F.FLUX_DIT_TINY, num_joint_blocks=2,
                                            num_single_blocks=2, guidance_embed=True)


class FluxControlNet(nn.Module):
    def __init__(self, cfg: FluxControlNetConfig = FLUX_CONTROLNET, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dit
        self.cfg = cfg
        self.time_embedder = F.MLPEmbed(d.time_freq_dim, d.dim, **kw)
        self.pooled_text_embedder = F.MLPEmbed(d.pooled_dim, d.dim, **kw)
        if cfg.guidance_embed:
            self.guidance_embedder = F.MLPEmbed(d.time_freq_dim, d.dim, **kw)
        self.context_embedder = Linear(d.context_dim, d.dim, **kw)
        self.x_embedder = Linear(d.in_dim, d.dim, **kw)
        self.controlnet_x_embedder = Linear(64 + cfg.additional_input_dim, d.dim, **kw)
        self.blocks = nn.ModuleList(F.JointBlock(d, **kw) for _ in range(cfg.num_joint_blocks))
        self.controlnet_blocks = nn.ModuleList(Linear(d.dim, d.dim, **kw)
                                               for _ in range(cfg.num_joint_blocks))
        self.single_blocks = nn.ModuleList(F.SingleBlock(d, **kw)
                                           for _ in range(cfg.num_single_blocks))
        self.controlnet_single_blocks = nn.ModuleList(Linear(d.dim, d.dim, **kw)
                                                      for _ in range(cfg.num_single_blocks))
        if cfg.num_mode:
            self.mode_embedder = nn.Parameter(torch.empty(cfg.num_mode, d.dim, **kw))


@torch.no_grad()
def init_flux_controlnet_(model: FluxControlNet, generator: torch.Generator) -> FluxControlNet:
    """Random init with the JAX init's std: linear weights N(0, 1/in),
    biases 0, RMSNorm weights 1, the mode table N(0, 0.02^2)."""
    F.init_flux_dit_(model, generator)
    if hasattr(model, "mode_embedder"):
        model.mode_embedder.normal_(0.0, 0.02, generator=generator)
    return model


def flux_controlnet_forward(model: FluxControlNet, hidden_states, controlnet_conditioning,
                            timestep, prompt_emb, pooled_prompt_emb, guidance=None,
                            image_ids=None, text_ids=None,
                            processor_id: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (res (num_joint, B, S_img, D), single_res (num_single, B, S_img,
    D)), not yet aligned to the DiT's block counts (`align_res_stack`)."""
    cfg = model.cfg
    d = cfg.dit
    dtype = hidden_states.dtype
    height, width = hidden_states.shape[-2:]
    if image_ids is None:
        image_ids = F.prepare_image_ids(0, height // 2, width // 2)
    if text_ids is None:
        text_ids = np.zeros((prompt_emb.shape[1], 3), np.float64)

    temb = F._mlp_embed(model.time_embedder,
                        F.timestep_embedding_flux(timestep, d.time_freq_dim).to(dtype))
    temb = temb + F._mlp_embed(model.pooled_text_embedder, pooled_prompt_emb)
    if cfg.guidance_embed and guidance is not None:
        temb = temb + F._mlp_embed(
            model.guidance_embedder,
            F.timestep_embedding_flux(guidance * 1000.0, d.time_freq_dim).to(dtype))

    ctx = model.context_embedder(prompt_emb)
    text_ids = np.asarray(text_ids, np.float64)
    if hasattr(model, "mode_embedder") and processor_id is not None:
        mode = model.mode_embedder[processor_id].to(ctx.dtype)
        ctx = torch.cat([mode.expand(ctx.shape[0], 1, ctx.shape[-1]), ctx], dim=1)
        text_ids = np.concatenate([text_ids[:1], text_ids], axis=0)
    ids = np.ascontiguousarray(np.concatenate(
        [text_ids, np.asarray(image_ids, np.float64)], axis=0))
    cos, sin = F._rope_tables(ids.tobytes(), tuple(d.axes_dim), d.theta, ctx.device)

    x = model.x_embedder(F.patchify(hidden_states))
    x = x + model.controlnet_x_embedder(F.patchify(controlnet_conditioning).to(dtype))
    res = []
    for blk, out in zip(model.blocks, model.controlnet_blocks):
        x, ctx = F.joint_block(blk, x, ctx, temb, cos, sin, d)
        res.append(out(x))
    s_ctx = ctx.shape[1]
    h = torch.cat([ctx, x], dim=1)
    single = []
    for blk, out in zip(model.single_blocks, model.controlnet_single_blocks):
        h = F.single_block(blk, h, temb, cos, sin, d)
        single.append(out(h[:, s_ctx:]))
    res = torch.stack(res) if res else x.new_zeros((0,) + x.shape)
    single = torch.stack(single) if single else x.new_zeros((0,) + x.shape)
    return res, single


def align_res_stack(res, num_blocks: int):
    """Repeat each emitted residual over an interval of the DiT's
    `num_blocks` blocks; None for an empty stack."""
    n = res.shape[0]
    if n == 0:
        return None
    interval = (num_blocks + n - 1) // n
    return res[torch.from_numpy(np.arange(num_blocks) // interval).to(res.device)]


def controlnet_config_for(sd: Dict, dit: F.FluxDiTConfig) -> FluxControlNetConfig:
    """The JAX loader's config (block counts from `controlnet_blocks.{i}` /
    `controlnet_single_blocks.{i}`, the guidance embedder from its key);
    the mode table's rows and the conditioning width come from the tensors'
    shapes, where the JAX converter takes the tensors as they are."""
    def count(prefix):
        return 1 + max((int(k.split(".")[1]) for k in sd if k.startswith(prefix)), default=-1)
    mode = sd.get("controlnet_mode_embedder.weight")
    return FluxControlNetConfig(
        dit=dit, num_joint_blocks=count("controlnet_blocks."),
        num_single_blocks=count("controlnet_single_blocks."),
        guidance_embed="guidance_embedder.timestep_embedder.0.weight" in sd,
        num_mode=0 if mode is None else int(mode.shape[0]),
        additional_input_dim=int(sd["controlnet_x_embedder.weight"].shape[1]) - 64)


def convert_flux_controlnet(sd: Dict, cfg: FluxControlNetConfig) -> Dict:
    """A DiffSynth-layout FluxControlNet state dict -> the `FluxControlNet`
    state dict: the embedders' `timestep_embedder.{0,2}` / `{0,2}` become
    `fc1` / `fc2`, `controlnet_mode_embedder.weight` the `mode_embedder`
    table; every other name is the module's."""
    out = {}
    embeds = [("time_embedder", "time_embedder.timestep_embedder"),
              ("pooled_text_embedder", "pooled_text_embedder")]
    if cfg.guidance_embed:
        embeds.append(("guidance_embedder", "guidance_embedder.timestep_embedder"))
    for dst, src in embeds:
        for fc, i in (("fc1", 0), ("fc2", 2)):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{fc}.{leaf}"] = sd[f"{src}.{i}.{leaf}"]
    prefixes = ["context_embedder.", "x_embedder.", "controlnet_x_embedder."]
    prefixes += [f"blocks.{i}." for i in range(cfg.num_joint_blocks)]
    prefixes += [f"controlnet_blocks.{i}." for i in range(cfg.num_joint_blocks)]
    prefixes += [f"single_blocks.{i}." for i in range(cfg.num_single_blocks)]
    prefixes += [f"controlnet_single_blocks.{i}." for i in range(cfg.num_single_blocks)]
    out.update({k: v for k, v in sd.items() if k.startswith(tuple(prefixes))})
    if cfg.num_mode:
        out["mode_embedder"] = sd["controlnet_mode_embedder.weight"]
    return out


# ---------------------------------------------------------------------------
# The FLUX IP-Adapter
# ---------------------------------------------------------------------------

class IpAdapterBlock(nn.Module):
    def __init__(self, ctx_dim: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.to_k_ip = Linear(ctx_dim, dim, bias=False, device=device, dtype=dtype)
        self.to_v_ip = Linear(ctx_dim, dim, bias=False, device=device, dtype=dtype)


@dataclass(frozen=True)
class FluxIpAdapterConfig:
    dit: F.FluxDiTConfig = F.FLUX_DEV
    image_dim: int = 1152                  # SigLIP so400m pooled width
    num_tokens: int = 128                  # tokens a picture
    num_blocks: int = 57                   # the DiT's 19 + 38 blocks


FLUX_IPADAPTER = FluxIpAdapterConfig()


class FluxIpAdapter(nn.Module):
    def __init__(self, cfg: FluxIpAdapterConfig = FLUX_IPADAPTER, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ctx = cfg.dit.context_dim
        self.cfg = cfg
        self.proj = nn.ModuleDict({"0": Linear(cfg.image_dim, 2 * cfg.image_dim, **kw),
                                   "2": Linear(2 * cfg.image_dim, ctx * cfg.num_tokens, **kw)})
        self.norm = LayerNormAffine(ctx, **kw)
        # the JAX tree's `modules` (a name nn.Module keeps for itself)
        self.blocks = nn.ModuleList(IpAdapterBlock(ctx, cfg.dit.dim, **kw)
                                    for _ in range(cfg.num_blocks))


@torch.no_grad()
def init_flux_ipadapter_(model: FluxIpAdapter, generator: torch.Generator) -> FluxIpAdapter:
    """Linear weights N(0, 1/in), biases 0, the LayerNorm 1 and 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    model.norm.scale.fill_(1.0)
    model.norm.bias.zero_()
    return model


def flux_ipadapter_kv(model: FluxIpAdapter, image_emb):
    """image_emb (B, image_dim) -> (ip_k, ip_v), each (num_blocks, 1,
    B * num_tokens, N, D): every picture's tokens in one stream."""
    d = model.cfg.dit
    x = model.proj["2"](Fn.gelu(model.proj["0"](image_emb)))
    ctx = model.norm.scale.shape[0]
    x = layer_norm(x.reshape(-1, x.shape[-1] // ctx, ctx), model.norm.scale,
                   model.norm.bias, 1e-5)
    x = x.reshape(1, -1, ctx)
    ks, vs = [], []
    for blk in model.blocks:
        k = blk.to_k_ip(x).reshape(1, -1, d.num_heads, d.head_dim)
        kf = k.float()
        ks.append((kf * torch.rsqrt(kf.square().mean(dim=-1, keepdim=True) + 1e-5)).to(x.dtype))
        vs.append(blk.to_v_ip(x).reshape(1, -1, d.num_heads, d.head_dim))
    return torch.stack(ks), torch.stack(vs)


def convert_flux_ipadapter(sd: Dict, num_blocks: int = 57) -> Dict:
    """A FluxIpAdapter state dict (`image_proj.{0,2}` or InstantX's
    `image_proj.proj.{0,2}`; `ipadapter_modules.{i}` or `ip_adapter.{i}`)
    -> the `FluxIpAdapter` state dict."""
    if any(k.startswith("ip_adapter.") for k in sd):
        sd = {k.replace("ip_adapter.", "ipadapter_modules."): v for k, v in sd.items()}
    proj = "image_proj.proj" if any(k.startswith("image_proj.proj.0") for k in sd) \
        else "image_proj"
    out = {f"proj.{i}.{leaf}": sd[f"{proj}.{i}.{leaf}"]
           for i in "02" for leaf in ("weight", "bias")}
    out["norm.scale"] = sd["image_proj.norm.weight"]
    out["norm.bias"] = sd["image_proj.norm.bias"]
    for i in range(num_blocks):
        for w in ("to_k_ip", "to_v_ip"):
            out[f"blocks.{i}.{w}.weight"] = sd[f"ipadapter_modules.{i}.{w}.weight"]
    return out


def ipadapter_config_for(sd: Dict, dit: F.FluxDiTConfig) -> FluxIpAdapterConfig:
    """The image width and tokens a picture from the projection's shapes;
    the block count is the DiT's (the JAX loader's rule)."""
    proj = "image_proj.proj" if any(k.startswith("image_proj.proj.0") for k in sd) \
        else "image_proj"
    image_dim = int(sd[f"{proj}.0.weight"].shape[1])
    tokens = int(sd[f"{proj}.2.weight"].shape[0]) // int(sd["image_proj.norm.weight"].shape[0])
    return FluxIpAdapterConfig(dit=dit, image_dim=image_dim, num_tokens=tokens,
                               num_blocks=dit.num_joint_blocks + dit.num_single_blocks)
