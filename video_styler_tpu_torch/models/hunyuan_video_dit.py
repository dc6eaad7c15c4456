"""The HunyuanVideo DiT in PyTorch.

Counterpart of `video_styler_tpu/models/hunyuan_video_dit.py`: a text token
refiner (2 gated self-attention blocks over the masked LLaMA features), 20
double-stream blocks (image and text tokens with their own weights,
attending jointly) and 40 single-stream blocks over [image | text], with the
(16, 56, 56)-band interleaved RoPE at theta 256 over the (T, H/2, W/2)
grid. Parameters live in modules named after the reference's DiffSynth
layout (`double_blocks.{i}.component_a.to_qkv`, `single_blocks.{i}.ff.2`,
`txt_in.blocks.{i}.adaLN_modulation.1`, `final_layer.linear`, ...); the
embedders' `timestep_embedder.{0,2}` become `fc1` / `fc2` and the patch
embedding's Conv3d is held as a linear over (c, pt, ph, pw) features.

The text is padded to a fixed `txt_len` and only its first `split_token`
rows are real enough to join the image: each block's attention runs twice
(the reference's split, kept for parity), over [image | text[:split]] and
over text[split:] alone. Both go through `ops.attention.attention`: K1 on
the card (bf16, head dim 128), its plain version on the CPU. The refiner
runs the exact `sdpa` under its pairwise mask (column 0 always open), as
the JAX refiner does. The per-head q/k RMSNorm and the RoPE are FLUX's
(`flux_dit._rms`, `rope_apply_interleaved`), eager, as JAX computes them;
RoPE tables come from float64 numpy, then float32, cached per grid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import attention, sdpa
from ..ops.basic import gelu_tanh, layer_norm, patchify, silu
from .flux_dit import (AdaMod, MLPEmbed, RMSWeight, _heads, _mlp_embed, _rms,
                       flux_rope_cos_sin, rope_apply_interleaved, timestep_embedding_flux)
from .wan_dit import Linear


@dataclass(frozen=True)
class HunyuanVideoDiTConfig:
    hidden_size: int = 3072
    num_heads: int = 24
    num_double_blocks: int = 20
    num_single_blocks: int = 40
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    pooled_dim: int = 768
    time_freq_dim: int = 256
    refiner_depth: int = 2
    rope_dims: Tuple[int, ...] = (16, 56, 56)
    theta: int = 256
    txt_len: int = 256
    split_token: int = 71
    guidance_embed: bool = True
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


HUNYUAN_VIDEO = HunyuanVideoDiTConfig()
HUNYUAN_VIDEO_TINY = HunyuanVideoDiTConfig(
    hidden_size=96, num_heads=4, num_double_blocks=2, num_single_blocks=2,
    text_dim=64, pooled_dim=32, rope_dims=(4, 10, 10), txt_len=8, split_token=3)


def hunyuan_rope(cfg: HunyuanVideoDiTConfig, t: int, h: int, w: int):
    """cos/sin (t*h*w, head_dim // 2) of the integer (T, H/2, W/2) grid (h, w
    after the patchify), float32 from float64 math."""
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    ids = np.stack([tt.ravel(), hh.ravel(), ww.ravel()], axis=-1)
    return flux_rope_cos_sin(ids, cfg.rope_dims, cfg.theta)


@lru_cache(maxsize=8)
def _rope_on(cfg: HunyuanVideoDiTConfig, t: int, h: int, w: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in hunyuan_rope(cfg, t, h, w))


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

def _pair(din: int, dh: int, dout: int, bias2: bool = True, **kw) -> nn.ModuleDict:
    """The reference's nn.Sequential(linear, act, linear): keys "0" and "2"."""
    return nn.ModuleDict({"0": Linear(din, dh, **kw), "2": Linear(dh, dout, bias=bias2, **kw)})


class RefinerBlock(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(d, **kw)
        self.self_attn_qkv = Linear(d, 3 * d, **kw)
        self.self_attn_proj = Linear(d, d, **kw)
        self.norm2 = nn.LayerNorm(d, **kw)
        self.mlp = _pair(d, 4 * d, d, **kw)
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(d, 2 * d, **kw)})


class TokenRefiner(nn.Module):
    """The reference's SingleTokenRefiner (`txt_in`)."""

    def __init__(self, in_dim: int, d: int, depth: int, time_freq_dim: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_embedder = Linear(in_dim, d, **kw)
        self.t_embedder = MLPEmbed(time_freq_dim, d, **kw)
        self.c_embedder = _pair(in_dim, d, d, **kw)
        self.blocks = nn.ModuleList(RefinerBlock(d, **kw) for _ in range(depth))


class DoubleComponent(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.hidden_size, cfg.head_dim
        self.mod = AdaMod(d, 6, **kw)
        self.to_qkv = Linear(d, 3 * d, **kw)
        self.norm_q = RMSWeight(hd, **kw)
        self.norm_k = RMSWeight(hd, **kw)
        self.to_out = Linear(d, d, **kw)
        self.ff = _pair(d, 4 * d, d, **kw)


class DoubleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        self.component_a = DoubleComponent(cfg, device=device, dtype=dtype)
        self.component_b = DoubleComponent(cfg, device=device, dtype=dtype)


class SingleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.hidden_size, cfg.head_dim
        self.mod = AdaMod(d, 3, **kw)
        self.to_qkv = Linear(d, 3 * d, **kw)
        self.norm_q = RMSWeight(hd, **kw)
        self.norm_k = RMSWeight(hd, **kw)
        self.to_out = Linear(d, d, **kw)
        self.ff = _pair(d, 4 * d, d, bias2=False, **kw)


class FinalLayer(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(d, 2 * d, **kw)})
        self.linear = Linear(d, math.prod(cfg.patch_size) * cfg.out_channels, **kw)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HunyuanVideoDiTConfig, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(cfg.in_channels * math.prod(cfg.patch_size), cfg.hidden_size,
                           device=device, dtype=dtype)


class HunyuanVideoDiT(nn.Module):
    """Parameters of the HunyuanVideo DiT; `hunyuan_video_dit_forward` runs
    it."""

    def __init__(self, cfg: HunyuanVideoDiTConfig = HUNYUAN_VIDEO, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.img_in = PatchEmbed(cfg, **kw)
        self.time_in = MLPEmbed(cfg.time_freq_dim, d, **kw)
        self.vector_in = _pair(cfg.pooled_dim, d, d, **kw)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbed(cfg.time_freq_dim, d, **kw)
        self.txt_in = TokenRefiner(cfg.text_dim, d, cfg.refiner_depth, cfg.time_freq_dim, **kw)
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg, **kw)
                                           for _ in range(cfg.num_double_blocks))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg, **kw)
                                           for _ in range(cfg.num_single_blocks))
        self.final_layer = FinalLayer(cfg, **kw)


@torch.no_grad()
def init_hunyuan_video_dit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, RMSNorm and LayerNorm weights 1, LayerNorm biases 0 (also the
    Step1x connector's and any module built of these parts)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, RMSWeight):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def token_refiner(p: TokenRefiner, cfg, x, t, mask):
    """SingleTokenRefiner: x (B, L, in) features, t (B,), mask (B, L) {0, 1}
    -> (B, L, d). `cfg` gives `time_freq_dim`, `num_heads` and `eps` (the
    DiT's config, or the Step1x connector's)."""
    t_emb = _mlp_embed(p.t_embedder, timestep_embedding_flux(t, cfg.time_freq_dim).to(x.dtype))
    mask_f = mask.float()[..., None]
    pooled = (x.float() * mask_f).sum(dim=1) / mask_f.sum(dim=1)
    c = t_emb + p.c_embedder["2"](silu(p.c_embedder["0"](pooled.to(x.dtype))))
    x = p.input_embedder(x)

    # the pairwise mask (B, 1, L, L); column 0 can always be attended to
    m = mask.bool()
    allowed = m[:, None, :, None] & m[:, None, None, :]
    allowed[:, :, :, 0] = True
    bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
    for bp in p.blocks:
        gate_msa, gate_mlp = bp.adaLN_modulation["1"](silu(c))[:, None, :].chunk(2, dim=-1)
        nx = layer_norm(x, bp.norm1.weight, bp.norm1.bias, cfg.eps)
        q, k, v = _heads(bp.self_attn_qkv(nx), 3 * cfg.num_heads).chunk(3, dim=2)
        att = sdpa(q, k, v, bias=bias).reshape(x.shape)
        x = x + bp.self_attn_proj(att) * gate_msa
        nx = layer_norm(x, bp.norm2.weight, bp.norm2.bias, cfg.eps)
        x = x + bp.mlp["2"](silu(bp.mlp["0"](nx))) * gate_mlp
    return x


def _mod3(p: AdaMod, vec, x, eps: float):
    sh, sc, gate = p.linear(silu(vec))[:, None, :].chunk(3, dim=-1)
    return layer_norm(x, eps=eps) * (1 + sc) + sh, gate


def _double_component_qkv(p: DoubleComponent, x, vec, cfg: HunyuanVideoDiTConfig,
                          cos=None, sin=None):
    sh1, sc1, g1, sh2, sc2, g2 = p.mod.linear(silu(vec))[:, None, :].chunk(6, dim=-1)
    nx = layer_norm(x, eps=cfg.eps) * (1 + sc1) + sh1
    q, k, v = _heads(p.to_qkv(nx), 3 * cfg.num_heads).chunk(3, dim=2)
    q = _rms(p.norm_q, q, cfg.eps)
    k = _rms(p.norm_k, k, cfg.eps)
    if cos is not None:
        q = rope_apply_interleaved(q, cos, sin)
        k = rope_apply_interleaved(k, cos, sin)
    return (q, k, v), (g1, sh2, sc2, g2)


def _double_component_ff(p: DoubleComponent, x, attn_out, mod, cfg: HunyuanVideoDiTConfig):
    g1, sh2, sc2, g2 = mod
    x = x + p.to_out(attn_out) * g1
    nx = layer_norm(x, eps=cfg.eps) * (1 + sc2) + sh2
    return x + p.ff["2"](gelu_tanh(p.ff["0"](nx))) * g2


def _split_attention(q_a, k_a, q_b, k_b, v1, v2, split: int, dim: int):
    """The reference's padded-text split: attention over [stream a |
    b[:split]] (values v1) and apart over b[split:] (values v2). Returns
    (the output over stream a, the output over all of b)."""
    q1 = torch.cat([q_a, q_b[:, :split]], dim=1)
    k1 = torch.cat([k_a, k_b[:, :split]], dim=1)
    out1 = attention(q1, k1, v1).reshape(q1.shape[0], q1.shape[1], dim)
    out2 = attention(q_b[:, split:], k_b[:, split:], v2)
    out2 = out2.reshape(out2.shape[0], out2.shape[1], dim)
    n_a = q_a.shape[1]
    return out1[:, :n_a], torch.cat([out1[:, n_a:], out2], dim=1)


def double_block(p: DoubleBlock, img, txt, vec, cos, sin, cfg: HunyuanVideoDiTConfig):
    (q_a, k_a, v_a), mod_a = _double_component_qkv(p.component_a, img, vec, cfg, cos, sin)
    (q_b, k_b, v_b), mod_b = _double_component_qkv(p.component_b, txt, vec, cfg)
    split = cfg.split_token
    v1 = torch.cat([v_a, v_b[:, :split]], dim=1)
    out_a, out_b = _split_attention(q_a, k_a, q_b, k_b, v1, v_b[:, split:], split,
                                    cfg.hidden_size)
    img = _double_component_ff(p.component_a, img, out_a, mod_a, cfg)
    txt = _double_component_ff(p.component_b, txt, out_b, mod_b, cfg)
    return img, txt


def single_block(p: SingleBlock, x, vec, cos, sin, cfg: HunyuanVideoDiTConfig):
    nx, gate = _mod3(p.mod, vec, x, cfg.eps)
    q, k, v = _heads(p.to_qkv(nx), 3 * cfg.num_heads).chunk(3, dim=2)
    q = _rms(p.norm_q, q, cfg.eps)
    k = _rms(p.norm_k, k, cfg.eps)
    n_txt, tail = cfg.txt_len, cfg.txt_len - cfg.split_token
    q_a = rope_apply_interleaved(q[:, :-n_txt], cos, sin)
    k_a = rope_apply_interleaved(k[:, :-n_txt], cos, sin)
    out_a, out_b = _split_attention(q_a, k_a, q[:, -n_txt:], k[:, -n_txt:], v[:, :-tail],
                                    v[:, -tail:], cfg.split_token, cfg.hidden_size)
    out = torch.cat([out_a, out_b], dim=1)
    x = x + p.to_out(out) * gate
    return x + p.ff["2"](gelu_tanh(p.ff["0"](nx))) * gate


def hunyuan_embed(model: HunyuanVideoDiT, x, t, prompt_emb, text_mask, pooled_prompt_emb,
                  guidance=None):
    """The embedding stage -> (img tokens, txt tokens, vec, cos, sin, grid)."""
    cfg = model.cfg
    dtype = x.dtype
    vec = _mlp_embed(model.time_in, timestep_embedding_flux(t, cfg.time_freq_dim).to(dtype))
    vec = vec + model.vector_in["2"](silu(model.vector_in["0"](pooled_prompt_emb.to(dtype))))
    if cfg.guidance_embed and guidance is not None:
        vec = vec + _mlp_embed(
            model.guidance_in,
            timestep_embedding_flux(guidance * 1000.0, cfg.time_freq_dim).to(dtype))
    img, grid = patchify(model.img_in.proj, x, cfg.patch_size)
    txt = token_refiner(model.txt_in, cfg, prompt_emb.to(dtype), t, text_mask)
    cos, sin = _rope_on(cfg, *grid, x.device)
    return img, txt, vec, cos, sin, grid


def hunyuan_trunk(model: HunyuanVideoDiT, img, txt, vec, cos, sin):
    """The double then single stacks -> the image tokens after the trunk."""
    cfg = model.cfg
    for p in model.double_blocks:
        img, txt = double_block(p, img, txt, vec, cos, sin, cfg)
    h = torch.cat([img, txt], dim=1)
    for p in model.single_blocks:
        h = single_block(p, h, vec, cos, sin, cfg)
    return h[:, :-cfg.txt_len]


def hunyuan_head(model: HunyuanVideoDiT, h, vec, grid):
    cfg = model.cfg
    fl = model.final_layer
    sh, sc = fl.adaLN_modulation["1"](silu(vec))[:, None, :].chunk(2, dim=-1)
    h = fl.linear(layer_norm(h, eps=cfg.eps) * (1 + sc) + sh)
    t, hh, ww = grid
    pt, ph, pw = cfg.patch_size
    b = h.shape[0]
    h = h.reshape(b, t, hh, ww, -1, pt, ph, pw)
    return h.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, -1, t * pt, hh * ph, ww * pw)


def hunyuan_modulated_input(model: HunyuanVideoDiT, img, vec):
    """Block 0's component_a first modulation of the embedded image tokens:
    the TeaCache probe."""
    sh1, sc1, *_ = model.double_blocks[0].component_a.mod.linear(silu(vec))[:, None, :].chunk(
        6, dim=-1)
    return layer_norm(img, eps=model.cfg.eps) * (1 + sc1) + sh1


def hunyuan_video_dit_forward(model: HunyuanVideoDiT, x, t, prompt_emb, text_mask,
                              pooled_prompt_emb, guidance=None):
    """x (B, C, T, H, W) latents; prompt_emb (B, txt_len, text_dim) LLaMA
    features; text_mask (B, txt_len); pooled_prompt_emb (B, pooled_dim)
    CLIP-L pooled; guidance (B,) embedded guidance -> (B, C, T, H, W)."""
    img, txt, vec, cos, sin, grid = hunyuan_embed(model, x, t, prompt_emb, text_mask,
                                                  pooled_prompt_emb, guidance)
    return hunyuan_head(model, hunyuan_trunk(model, img, txt, vec, cos, sin), vec, grid)


# --------------------------------------------------------------------------
# Checkpoint conversion
# --------------------------------------------------------------------------

def _read(v):
    """A lazy checkpoint tensor read onto the host; anything else as it is."""
    from ..utils.ckpt import LazyTensor, read_tensors
    if isinstance(v, LazyTensor):
        return read_tensors({"v": v}, "cpu")["v"]
    return torch.as_tensor(v)


_DIRECT = {
    "img_in.proj": "img_in.proj",
    "time_in.mlp.0": "time_in.timestep_embedder.0",
    "time_in.mlp.2": "time_in.timestep_embedder.2",
    "vector_in.in_layer": "vector_in.0",
    "vector_in.out_layer": "vector_in.2",
    "guidance_in.mlp.0": "guidance_in.timestep_embedder.0",
    "guidance_in.mlp.2": "guidance_in.timestep_embedder.2",
    "txt_in.input_embedder": "txt_in.input_embedder",
    "txt_in.t_embedder.mlp.0": "txt_in.t_embedder.timestep_embedder.0",
    "txt_in.t_embedder.mlp.2": "txt_in.t_embedder.timestep_embedder.2",
    "txt_in.c_embedder.linear_1": "txt_in.c_embedder.0",
    "txt_in.c_embedder.linear_2": "txt_in.c_embedder.2",
    "final_layer.linear": "final_layer.linear",
    "final_layer.adaLN_modulation.1": "final_layer.adaLN_modulation.1",
}
_DOUBLE = {f"{s}_{k}": f"component_{c}.{v}" for s, c in (("img", "a"), ("txt", "b"))
           for k, v in (("mod.linear", "mod.linear"), ("attn_qkv", "to_qkv"),
                        ("attn_q_norm", "norm_q"), ("attn_k_norm", "norm_k"),
                        ("attn_proj", "to_out"), ("mlp.fc1", "ff.0"), ("mlp.fc2", "ff.2"))}
_REFINER = {"norm1": "norm1", "self_attn_qkv": "self_attn_qkv",
            "self_attn_proj": "self_attn_proj", "norm2": "norm2", "mlp.fc1": "mlp.0",
            "mlp.fc2": "mlp.2", "adaLN_modulation.1": "adaLN_modulation.1"}


def rename_civitai_hunyuan(sd: Dict, cfg: HunyuanVideoDiTConfig) -> Dict:
    """The raw (civitai) layout -> the DiffSynth layout, the fused single-
    block `linear1` split into `to_qkv` / `ff.0` and `linear2` into `to_out`
    / `ff.2` (its bias to `to_out`), as the JAX `rename_civitai_hunyuan`
    splits them."""
    if "module" in sd:
        sd = sd["module"]
    d = cfg.hidden_size
    out = {}
    for name, param in sd.items():
        names = name.split(".")
        head, leaf = ".".join(names[:-1]), names[-1]
        if head in _DIRECT:
            out[f"{_DIRECT[head]}.{leaf}"] = param
        elif names[0] == "double_blocks":
            mid = ".".join(names[2:-1])
            if mid in _DOUBLE:
                out[f"double_blocks.{names[1]}.{_DOUBLE[mid]}.{leaf}"] = param
        elif names[0] == "single_blocks":
            pre, mid = f"single_blocks.{names[1]}", ".".join(names[2:-1])
            if mid == "linear1":
                a, b = torch.split(_read(param), (3 * d, 4 * d), dim=0)
                out[f"{pre}.to_qkv.{leaf}"] = a
                out[f"{pre}.ff.0.{leaf}"] = b
            elif mid == "linear2":
                if leaf == "weight":
                    a, b = torch.split(_read(param), (d, 4 * d), dim=-1)
                    out[f"{pre}.to_out.{leaf}"] = a
                    out[f"{pre}.ff.2.{leaf}"] = b
                else:
                    out[f"{pre}.to_out.{leaf}"] = param
            elif mid in ("q_norm", "k_norm"):
                out[f"{pre}.norm_{mid[0]}.{leaf}"] = param
            elif mid == "modulation.linear":
                out[f"{pre}.mod.linear.{leaf}"] = param
        elif names[0] == "txt_in" and names[1] == "individual_token_refiner":
            mid = ".".join(names[4:-1])
            if mid in _REFINER:
                out[f"txt_in.blocks.{names[3]}.{_REFINER[mid]}.{leaf}"] = param
    return out


def convert_hunyuan_video_dit(sd: Dict, cfg: HunyuanVideoDiTConfig = HUNYUAN_VIDEO) -> Dict:
    """A DiffSynth-layout HunyuanVideoDiT state dict (a raw civitai one is
    renamed and split first) -> the `HunyuanVideoDiT` state dict. The
    embedders' `timestep_embedder.{0,2}` become `fc1` / `fc2`; the patch
    embedding's (D, C, pt, ph, pw) weight is viewed as (D, C*pt*ph*pw);
    every other name is the module's and values pass through."""
    if any(".img_mod.linear." in k or ".linear1." in k for k in sd):
        sd = rename_civitai_hunyuan(sd, cfg)
    out = {}
    w = sd["img_in.proj.weight"]
    out["img_in.proj.weight"] = w.reshape(w.shape[0], math.prod(w.shape[1:]))
    out["img_in.proj.bias"] = sd["img_in.proj.bias"]
    embeds = [("time_in", "time_in.timestep_embedder"),
              ("txt_in.t_embedder", "txt_in.t_embedder.timestep_embedder")]
    if cfg.guidance_embed and "guidance_in.timestep_embedder.0.weight" in sd:
        embeds.append(("guidance_in", "guidance_in.timestep_embedder"))
    for dst, src in embeds:
        for fc, i in (("fc1", 0), ("fc2", 2)):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{fc}.{leaf}"] = sd[f"{src}.{i}.{leaf}"]
    names = ["vector_in.0", "vector_in.2", "txt_in.input_embedder", "txt_in.c_embedder.0",
             "txt_in.c_embedder.2", "final_layer.linear", "final_layer.adaLN_modulation.1"]
    for i in range(cfg.refiner_depth):
        b = f"txt_in.blocks.{i}"
        names += [f"{b}.{n}" for n in ("norm1", "self_attn_qkv", "self_attn_proj", "norm2",
                                       "mlp.0", "mlp.2", "adaLN_modulation.1")]
    for i in range(cfg.num_double_blocks):
        for c in "ab":
            b = f"double_blocks.{i}.component_{c}"
            names += [f"{b}.{n}" for n in ("mod.linear", "to_qkv", "to_out", "ff.0", "ff.2")]
            out.update({f"{b}.norm_{w}.weight": sd[f"{b}.norm_{w}.weight"] for w in "qk"})
    for i in range(cfg.num_single_blocks):
        b = f"single_blocks.{i}"
        names += [f"{b}.{n}" for n in ("mod.linear", "to_qkv", "to_out", "ff.0")]
        out[f"{b}.ff.2.weight"] = sd[f"{b}.ff.2.weight"]
        out.update({f"{b}.norm_{w}.weight": sd[f"{b}.norm_{w}.weight"] for w in "qk"})
    for name in names:
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"{name}.{leaf}"]
    return out
