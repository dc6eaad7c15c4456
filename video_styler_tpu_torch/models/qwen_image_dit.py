"""The Qwen-Image DiT in PyTorch.

Counterpart of `video_styler_tpu/models/qwen_image_dit.py`: 60 dual-stream
blocks (the image and text tokens with their own weights, attending jointly
over [text | image]) over 2x2-patchified 16-channel latents, with
"scale_rope" positions: the height and width indices are centred, the
negative ones through mirrored frequencies. Parameters live in modules
named after the reference checkpoint (`transformer_blocks.{i}.img_mod.1`,
`.attn.to_q`, `.attn.norm_added_k`, `.img_mlp.net.0.proj`, `txt_norm`,
`time_text_embed.timestep_embedder.linear_1`, ...), so
`convert_qwen_image_dit` only selects the keys.

The joint attention goes through `ops.attention.attention`: K1 on the card
(bf16, head dim 128), its plain version on the CPU; under an EliGen bias it
is the exact `sdpa(..., bias=)`, as the JAX block calls its exact `sdpa`.
The per-head q/k RMSNorm and the interleaved RoPE are FLUX's (`flux_dit.
_rms`, `rope_apply_interleaved`), eager, as JAX computes them. RoPE tables
come from float64 numpy, then float32, and are cached per shape.

The forward takes extra latents (edit and context images: more RoPE frames,
dropped from the output), an attention bias (EliGen) and the block-wise
ControlNets' residuals (added to the image rows after each block).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, sdpa
from ..ops.basic import layer_norm, silu
from . import qwen_image_controlnet as QC
from .flux_dit import (RMSWeight, _heads, _rms, patchify, rope_apply_interleaved,
                       timestep_embedding_flux, unpatchify)
from .wan_dit import Linear


@dataclass(frozen=True)
class QwenImageDiTConfig:
    dim: int = 3072
    num_heads: int = 24
    num_layers: int = 60
    in_dim: int = 64                # 16 channels x 2 x 2
    text_dim: int = 3584            # Qwen2.5-VL's hidden
    time_freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


QWEN_IMAGE = QwenImageDiTConfig()
QWEN_IMAGE_TINY = QwenImageDiTConfig(dim=96, num_heads=4, num_layers=2, text_dim=64,
                                     axes_dim=(4, 10, 10))


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def _rope_1d(index: np.ndarray, dim: int, theta: float):
    freqs = np.outer(index.astype(np.float64),
                     1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.cos(freqs), np.sin(freqs)


def qwen_rope(cfg: QwenImageDiTConfig, img_shapes: List[Tuple[int, int, int]],
              txt_seq_len: int, frame_offsets: Optional[List[int]] = None):
    """-> (img_cos, img_sin, txt_cos, txt_sin), each (S, head_dim // 2)
    float32 from float64 math. The first ceil(h/2) rows take the mirrored
    indices -1, -2, ..., the rest 0 .. h//2 - 1 (and so the columns); the
    text positions start at the largest h//2, w//2; each extra image
    advances the frame axis by its index (or `frame_offsets`)."""
    a0, a1, a2 = cfg.axes_dim
    img_cos, img_sin = [], []
    max_vid = 0
    for idx, (f, h, w) in enumerate(img_shapes):
        fo = idx if frame_offsets is None else frame_offsets[idx]
        f_idx = np.arange(fo, fo + f)
        h_idx = np.concatenate([np.arange(-(h - h // 2), 0), np.arange(h // 2)])
        w_idx = np.concatenate([np.arange(-(w - w // 2), 0), np.arange(w // 2)])
        cf, sf = _rope_1d(f_idx, a0, cfg.theta)
        ch, sh = _rope_1d(h_idx, a1, cfg.theta)
        cw, sw = _rope_1d(w_idx, a2, cfg.theta)
        for out, (tf, th, tw) in ((img_cos, (cf, ch, cw)), (img_sin, (sf, sh, sw))):
            out.append(np.concatenate([
                np.broadcast_to(tf[:, None, None], (f, h, w, a0 // 2)),
                np.broadcast_to(th[None, :, None], (f, h, w, a1 // 2)),
                np.broadcast_to(tw[None, None, :], (f, h, w, a2 // 2)),
            ], axis=-1).reshape(f * h * w, -1))
        max_vid = max(max_vid, h // 2, w // 2)
    t_idx = np.arange(max_vid, max_vid + txt_seq_len)
    ct = np.concatenate([_rope_1d(t_idx, d, cfg.theta)[0] for d in cfg.axes_dim], axis=-1)
    st = np.concatenate([_rope_1d(t_idx, d, cfg.theta)[1] for d in cfg.axes_dim], axis=-1)
    return (np.concatenate(img_cos).astype(np.float32),
            np.concatenate(img_sin).astype(np.float32),
            ct.astype(np.float32), st.astype(np.float32))


@lru_cache(maxsize=8)
def _rope_on(cfg: QwenImageDiTConfig, img_shapes: tuple, txt_seq_len: int,
             device: torch.device):
    tables = qwen_rope(cfg, list(img_shapes), txt_seq_len)
    return tuple(torch.from_numpy(t).to(device) for t in tables)


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

def _mlp(dim: int, **kw) -> nn.Module:
    net = nn.ModuleDict({"0": nn.ModuleDict({"proj": Linear(dim, 4 * dim, **kw)}),
                         "2": Linear(4 * dim, dim, **kw)})
    return nn.ModuleDict({"net": net})


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenImageDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.dim, cfg.head_dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_add_out"):
            setattr(self, name, Linear(d, d, **kw))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSWeight(hd, **kw))
        self.to_out = nn.ModuleDict({"0": Linear(d, d, **kw)})


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenImageDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.img_mod = nn.ModuleDict({"1": Linear(d, 6 * d, **kw)})
        self.txt_mod = nn.ModuleDict({"1": Linear(d, 6 * d, **kw)})
        self.attn = QwenAttention(cfg, **kw)
        self.img_mlp = _mlp(d, **kw)
        self.txt_mlp = _mlp(d, **kw)


class QwenImageDiT(nn.Module):
    """Parameters of the Qwen-Image DiT; `qwen_image_dit_forward` runs it."""

    def __init__(self, cfg: QwenImageDiTConfig = QWEN_IMAGE, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.time_text_embed = nn.ModuleDict({"timestep_embedder": nn.ModuleDict({
            "linear_1": Linear(cfg.time_freq_dim, d, **kw), "linear_2": Linear(d, d, **kw)})})
        self.txt_norm = RMSWeight(cfg.text_dim, **kw)
        self.img_in = Linear(cfg.in_dim, d, **kw)
        self.txt_in = Linear(cfg.text_dim, d, **kw)
        self.transformer_blocks = nn.ModuleList(QwenBlock(cfg, **kw)
                                                for _ in range(cfg.num_layers))
        self.norm_out = nn.ModuleDict({"linear": Linear(d, 2 * d, **kw)})
        self.proj_out = Linear(d, cfg.in_dim, **kw)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _approx_gelu(p, x):
    h = p["proj"](x)
    return h * torch.sigmoid(1.702 * h)


def _mod3(mods, x, eps: float):
    sh, sc, gate = mods[:, None, :].chunk(3, dim=-1)
    return layer_norm(x, eps=eps) * (1 + sc) + sh, gate


def qwen_block(p: QwenBlock, img, txt, temb, img_cs, txt_cs, cfg: QwenImageDiTConfig,
               attn_bias=None):
    """One dual-stream block; the joint attention over [text | image]."""
    img_mod_attn, img_mod_mlp = p.img_mod["1"](silu(temb)).chunk(2, dim=-1)
    txt_mod_attn, txt_mod_mlp = p.txt_mod["1"](silu(temb)).chunk(2, dim=-1)
    n_img, g_img = _mod3(img_mod_attn, img, cfg.eps)
    n_txt, g_txt = _mod3(txt_mod_attn, txt, cfg.eps)

    ap, nh, eps = p.attn, cfg.num_heads, cfg.eps
    q_i = _rms(ap.norm_q, _heads(ap.to_q(n_img), nh), eps)
    k_i = _rms(ap.norm_k, _heads(ap.to_k(n_img), nh), eps)
    v_i = _heads(ap.to_v(n_img), nh)
    q_t = _rms(ap.norm_added_q, _heads(ap.add_q_proj(n_txt), nh), eps)
    k_t = _rms(ap.norm_added_k, _heads(ap.add_k_proj(n_txt), nh), eps)
    v_t = _heads(ap.add_v_proj(n_txt), nh)

    (img_cos, img_sin), (txt_cos, txt_sin) = img_cs, txt_cs
    q = torch.cat([rope_apply_interleaved(q_t, txt_cos, txt_sin),
                   rope_apply_interleaved(q_i, img_cos, img_sin)], dim=1)
    k = torch.cat([rope_apply_interleaved(k_t, txt_cos, txt_sin),
                   rope_apply_interleaved(k_i, img_cos, img_sin)], dim=1)
    v = torch.cat([v_t, v_i], dim=1)
    out = attention(q, k, v) if attn_bias is None else sdpa(q, k, v, bias=attn_bias)
    out = out.reshape(out.shape[0], out.shape[1], cfg.dim)
    s_txt = txt.shape[1]
    out_t, out_i = out[:, :s_txt], out[:, s_txt:]

    img = img + g_img * ap.to_out["0"](out_i)
    txt = txt + g_txt * ap.to_add_out(out_t)

    n_img2, g_img2 = _mod3(img_mod_mlp, img, cfg.eps)
    n_txt2, g_txt2 = _mod3(txt_mod_mlp, txt, cfg.eps)
    img = img + g_img2 * p.img_mlp["net"]["2"](_approx_gelu(p.img_mlp["net"]["0"], n_img2))
    txt = txt + g_txt2 * p.txt_mlp["net"]["2"](_approx_gelu(p.txt_mlp["net"]["0"], n_txt2))
    return img, txt


def qwen_image_dit_forward(model: QwenImageDiT, latents, timestep, prompt_emb,
                           txt_seq_len: Optional[int] = None,
                           extra_latents: Optional[Sequence] = None, attn_bias=None,
                           blockwise_cn=None, remat: bool = False):
    """latents (B, 16, H, W); timestep (B,) already divided by 1000;
    prompt_emb (B, L, text_dim). extra_latents: (B, 16, h, w) edit or
    context images appended as more RoPE frames and dropped from the
    output. attn_bias: (B or 1, 1, S, S) fp32 additive bias of the joint
    attention (EliGen). blockwise_cn: list of (QwenBlockwiseControlNet,
    control tokens (B, n_img, dim), scale): each layer's residual, times
    its scale (rounded to the activations' dtype), is added to the image
    rows after that layer; a scale of 0 skips the ControlNet's layer.
    remat: each block under `torch.utils.checkpoint` (non-reentrant), as
    the JAX forward checkpoints its scan; the same values."""
    cfg = model.cfg
    dtype = latents.dtype
    H, W = latents.shape[-2:]
    img = patchify(latents)
    n_img = img.shape[1]
    img_shapes = [(latents.shape[0], H // 2, W // 2)]
    for e in extra_latents or ():
        img_shapes.append((e.shape[0], e.shape[2] // 2, e.shape[3] // 2))
        img = torch.cat([img, patchify(e.to(dtype))], dim=1)
    img = model.img_in(img)

    pf = prompt_emb.float()
    pf = pf * torch.rsqrt(pf.square().mean(dim=-1, keepdim=True) + cfg.eps)
    txt = model.txt_in((pf * model.txt_norm.weight.float()).to(dtype))

    te = model.time_text_embed["timestep_embedder"]
    emb = timestep_embedding_flux(timestep * 1000.0, cfg.time_freq_dim)
    temb = te["linear_2"](silu(te["linear_1"](emb.to(dtype))))

    if txt_seq_len is None:
        txt_seq_len = prompt_emb.shape[1]
    ic, isin, tc, tsin = _rope_on(cfg, tuple(img_shapes), txt_seq_len, img.device)
    for i, bp in enumerate(model.transformer_blocks):
        args = (bp, img, txt, temb, (ic, isin), (tc, tsin), cfg, attn_bias)
        img, txt = (checkpoint(qwen_block, *args, use_reentrant=False) if remat
                    else qwen_block(*args))
        active = [(cn, cond, scale) for cn, cond, scale in blockwise_cn or () if scale != 0]
        if active:
            sl = img[:, :n_img]
            acc = sl
            for cn, cond, scale in active:
                res = QC.qwen_blockwise_cn_block(cn.controlnet_blocks[i], sl,
                                                 cond.to(sl.dtype), cfg.eps)
                acc = acc + res * torch.tensor(scale, dtype=res.dtype, device=res.device)
            img = torch.cat([acc, img[:, n_img:]], dim=1)

    sc, sh = model.norm_out["linear"](silu(temb))[:, None, :].chunk(2, dim=-1)
    img = layer_norm(img, eps=cfg.eps) * (1 + sc) + sh
    img = model.proj_out(img)[:, :n_img]
    return unpatchify(img, H, W)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

_BLOCK_LINEARS = ("img_mod.1", "txt_mod.1", "attn.to_q", "attn.to_k", "attn.to_v",
                  "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj", "attn.to_out.0",
                  "attn.to_add_out", "img_mlp.net.0.proj", "img_mlp.net.2",
                  "txt_mlp.net.0.proj", "txt_mlp.net.2")
_BLOCK_NORMS = ("attn.norm_q", "attn.norm_k", "attn.norm_added_q", "attn.norm_added_k")


def convert_qwen_image_dit(sd: Dict, cfg: QwenImageDiTConfig = QWEN_IMAGE) -> Dict:
    """The reference's state dict (its module layout is the checkpoint's) ->
    the `QwenImageDiT` state dict of `cfg.num_layers` blocks. Values pass
    through."""
    linears = ["time_text_embed.timestep_embedder.linear_1",
               "time_text_embed.timestep_embedder.linear_2", "img_in", "txt_in",
               "norm_out.linear", "proj_out"]
    norms = ["txt_norm"]
    for i in range(cfg.num_layers):
        linears += [f"transformer_blocks.{i}.{n}" for n in _BLOCK_LINEARS]
        norms += [f"transformer_blocks.{i}.{n}" for n in _BLOCK_NORMS]
    out = {f"{n}.weight": sd[f"{n}.weight"] for n in norms}
    out.update({f"{n}.{leaf}": sd[f"{n}.{leaf}"] for n in linears for leaf in ("weight", "bias")})
    return out

