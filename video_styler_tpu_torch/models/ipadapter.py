"""IP-Adapters for SD 1.5 and SDXL in PyTorch.

Counterpart of `video_styler_tpu/models/ipadapter.py` (:19-71): a CLIP image
embedding is projected to `extra_tokens` context tokens (`image_proj`:
linear, then LayerNorm); at each attention site of the UNet a (to_k_ip,
to_v_ip) pair turns them into keys and values that the cross-attention
adds as `scale * sdpa(q, ip_k, ip_v)` (`models.sd.attn`). SD's 16 sites
are one per attention block (`SD_IPADAPTER_BLOCK_IDS`), SDXL's 70 one per
transformer (`SDXL_IPADAPTER_MAP`); InstantStyle keeps only modules 34-43
(block 28's ten transformers). A module's width is that of its block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch
from torch import nn

from .sd import SD_UNET, SD_UNET_PROGRAM, Affine, SDUNetConfig, _ln, program_widths
from .wan_dit import Linear

SD_IPADAPTER_BLOCK_IDS = [1, 4, 9, 12, 17, 20, 40, 43, 46, 50, 53, 56, 60, 63, 66, 29]
SDXL_IPADAPTER_MAP = sum([
    [(7, i) for i in range(2)],
    [(10, i) for i in range(2)],
    [(15, i) for i in range(10)],
    [(18, i) for i in range(10)],
    [(25, i) for i in range(10)],
    [(28, i) for i in range(10)],
    [(31, i) for i in range(10)],
    [(35, i) for i in range(2)],
    [(38, i) for i in range(2)],
    [(41, i) for i in range(2)],
    [(21, i) for i in range(10)],
], [])
INSTANT_STYLE_MODULES = range(34, 44)


@dataclass(frozen=True)
class IpAdapterConfig:
    widths: Sequence[int]           # each module's UNet block width
    text_dim: int = 768             # the UNet's cross-attention context width
    clip_dim: int = 1024            # the image embedding's width
    extra_tokens: int = 4


def ipadapter_config(xl: bool, unet_cfg: SDUNetConfig = SD_UNET, clip_dim: int = 1024,
                     extra_tokens: int = 4) -> IpAdapterConfig:
    """The adapter of a UNet of `unet_cfg`'s widths: SD's 16 sites, or (xl)
    SDXL's 70."""
    if xl:
        from .sdxl import SDXL_UNET_PROGRAM
        walk, _ = program_widths(SDXL_UNET_PROGRAM, unet_cfg)
        widths = [walk[b][3] for b, _ in SDXL_IPADAPTER_MAP]
    else:
        walk, _ = program_widths(SD_UNET_PROGRAM, unet_cfg)
        widths = [walk[b][3] for b in SD_IPADAPTER_BLOCK_IDS]
    return IpAdapterConfig(tuple(widths), unet_cfg.text_dim, clip_dim, extra_tokens)


def detect_ipadapter_config(sd: Dict) -> IpAdapterConfig:
    """An adapter's config from its state dict."""
    n = 0
    while f"ipadapter_modules.{n}.to_k_ip.weight" in sd:
        n += 1
    k0 = sd["ipadapter_modules.0.to_k_ip.weight"]
    proj = sd["image_proj.proj.weight"]
    return IpAdapterConfig(tuple(sd[f"ipadapter_modules.{j}.to_k_ip.weight"].shape[0]
                                 for j in range(n)),
                           text_dim=k0.shape[1], clip_dim=proj.shape[1],
                           extra_tokens=proj.shape[0] // k0.shape[1])


class ImageProj(nn.Module):
    def __init__(self, cfg: IpAdapterConfig, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(cfg.clip_dim, cfg.extra_tokens * cfg.text_dim, device=device,
                           dtype=dtype)
        self.norm = Affine(cfg.text_dim, device=device, dtype=dtype)


class IpAdapterModule(nn.Module):
    def __init__(self, text_dim: int, width: int, device=None, dtype=None):
        super().__init__()
        self.to_k_ip = Linear(text_dim, width, bias=False, device=device, dtype=dtype)
        self.to_v_ip = Linear(text_dim, width, bias=False, device=device, dtype=dtype)


class IpAdapter(nn.Module):
    def __init__(self, cfg: IpAdapterConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.image_proj = ImageProj(cfg, device=device, dtype=dtype)
        self.ipadapter_modules = nn.ModuleList(
            IpAdapterModule(cfg.text_dim, w, device=device, dtype=dtype) for w in cfg.widths)


def image_proj(p: ImageProj, image_embeds, extra_tokens: int):
    h = p.proj(image_embeds)
    return _ln(p.norm, h.reshape(-1, extra_tokens, h.shape[-1] // extra_tokens))


def ipadapter_kwargs(model: IpAdapter, image_embeds, scale: float = 1.0, xl: bool = False,
                     instant_style: bool = False) -> Dict:
    """-> {block id: {transformer index: (ip_k, ip_v, scale)}}, as
    `sd_unet_forward` / `sdxl_unet_forward` take them. image_embeds (N,
    clip_dim): the tokens of every image are one sequence."""
    tokens = image_proj(model.image_proj, image_embeds.to(model.image_proj.proj.weight.dtype),
                        model.cfg.extra_tokens)
    tokens = tokens.reshape(1, -1, tokens.shape[-1])
    sites = SDXL_IPADAPTER_MAP if xl else [(b, 0) for b in SD_IPADAPTER_BLOCK_IDS]
    out: Dict = {}
    for j, (block_id, layer) in enumerate(sites):
        if xl and instant_style and j not in INSTANT_STYLE_MODULES:
            continue
        m = model.ipadapter_modules[j]
        out.setdefault(block_id, {})[layer] = (m.to_k_ip(tokens), m.to_v_ip(tokens), scale)
    return out


def convert_ipadapter(sd: Dict) -> Dict:
    """A reference SDIpAdapter / SDXLIpAdapter state dict (or the released
    files' `ip_adapter.{2j+1}` attention processors, module j) -> the port's
    names (the projection norm's `weight` -> `scale`)."""
    from .sd import convert_sd_module
    out = {}
    for k, v in sd.items():
        if k.startswith("ip_adapter."):
            _, n, rest = k.split(".", 2)
            k = f"ipadapter_modules.{(int(n) - 1) // 2}.{rest}"
        out[k] = v
    return convert_sd_module(out)
