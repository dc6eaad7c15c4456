"""The FLUX.1 dual-stream DiT in PyTorch.

Counterpart of `video_styler_tpu/models/flux_dit.py`: 19 joint blocks
(image and text tokens with their own weights, attending jointly over
[text | image]) then 38 single blocks over the concatenated sequence with a
fused qkv+mlp projection. Parameters live in modules named after the JAX
tree (`blocks.{i}.attn.a_to_qkv`, `single_blocks.{i}.to_qkv_mlp`,
`norm1_a.linear`, `ff_a.0`, ...), so LoRA targets in the native naming
(`flux_lora.convert_flux_lora`) resolve through `lora.merge_lora`.

Both self-attentions go through `ops.attention.attention`: K1 on the card
(bf16, head dim 128), its plain version on the CPU. The per-head q/k
RMSNorm (a learned weight over D) and the three-axis interleaved RoPE stay
eager, as the JAX DiT computes them in plain ops rather than through its
fused kernel (K4 normalises the whole Dm row).

Where the numbers can drift from the JAX DiT:
  - RoPE tables come from float64 numpy over the concatenated [text |
    image | kontext] ids, then float32; the rotation is done in fp32 on
    interleaved pairs and cast back (not the Wan RoPE of `ops.rope`);
  - the per-head RMSNorm normalises in fp32, casts to the input dtype,
    then multiplies by the weight;
  - the guidance embedder takes guidance x 1000.

The adapters' hooks, as in the JAX DiT (`flux_dit.py:216-432, 597-638`):
  - IP-Adapter keys and values (`ip_kv`, stacked over the 57 blocks) add
    `ip_scale * attention(q, ip_k, ip_v)` to each block's attention output:
    the joint block queries with the image stream's pre-RoPE normed q, the
    single block with the post-RoPE q over [text | image] (so the text rows
    get it too). That cross-attention is K1 on the card (128 keys an
    image);
  - an EliGen attention bias (`attn_bias`, from
    `build_entity_attention_bias`) sends both self-attentions through the
    exact `ops.attention.sdpa(..., bias=)`, as the JAX DiT calls its exact
    `_sdpa` there: K1 takes no bias;
  - ControlNet residuals (`controlnet_res`, `controlnet_single_res`, one per
    block) are zero-padded to the image (and Kontext) length, added to the
    image stream after each joint block and to the rows past the text after
    each single block.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, sdpa
from ..ops.basic import gelu_tanh, layer_norm, silu
from .wan_dit import Linear


@dataclass(frozen=True)
class FluxDiTConfig:
    dim: int = 3072
    num_heads: int = 24
    num_joint_blocks: int = 19
    num_single_blocks: int = 38
    in_dim: int = 64                      # patchified latent: 16ch * 2 * 2
    out_dim: int = 64
    context_dim: int = 4096               # T5-XXL
    pooled_dim: int = 768                 # CLIP-L pooled
    time_freq_dim: int = 256
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10000
    guidance_embed: bool = True           # dev; schnell has none
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


FLUX_DEV = FluxDiTConfig()
FLUX_SCHNELL = FluxDiTConfig(guidance_embed=False)
FLUX_DIT_TINY = FluxDiTConfig(dim=96, num_heads=4, num_joint_blocks=2,
                              num_single_blocks=2, context_dim=64,
                              pooled_dim=32, axes_dim=(4, 10, 10))


# --------------------------------------------------------------------------
# RoPE (interleaved-pair rotation, per-axis frequency bands)
# --------------------------------------------------------------------------

def flux_rope_cos_sin(ids: np.ndarray, axes_dim, theta: int):
    """ids (S, n_axes) -> cos/sin (S, sum(axes_dim)//2), float32 from
    float64 math."""
    cos_parts, sin_parts = [], []
    for i, d in enumerate(axes_dim):
        scale = np.arange(0, d, 2, dtype=np.float64) / d
        omega = 1.0 / (theta ** scale)
        out = np.asarray(ids[:, i], np.float64)[:, None] * omega[None, :]
        cos_parts.append(np.cos(out))
        sin_parts.append(np.sin(out))
    cos = np.concatenate(cos_parts, axis=-1).astype(np.float32)
    sin = np.concatenate(sin_parts, axis=-1).astype(np.float32)
    return cos, sin


@lru_cache(maxsize=8)
def _rope_tables(ids_bytes: bytes, axes_dim, theta: int, device: torch.device):
    ids = np.frombuffer(ids_bytes, np.float64).reshape(-1, len(axes_dim))
    return tuple(torch.from_numpy(t).to(device) for t in flux_rope_cos_sin(ids, axes_dim, theta))


def rope_apply_interleaved(x, cos, sin):
    """x (B, S, N, D) as interleaved (x0, x1) pairs; cos/sin (S, D//2). fp32
    rotation, cast back."""
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([c * x0 - s * x1, s * x0 + c * x1], dim=-1).reshape(x.shape).to(x.dtype)


def prepare_image_ids(f_id: int, h: int, w: int) -> np.ndarray:
    """Position ids (h*w, 3) of a patchified latent grid of h x w."""
    ids = np.zeros((h, w, 3), np.float64)
    ids[..., 0] = f_id
    ids[..., 1] += np.arange(h)[:, None]
    ids[..., 2] += np.arange(w)[None, :]
    return ids.reshape(h * w, 3)


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

class RMSWeight(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class MLPEmbed(nn.Module):
    def __init__(self, din: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(din, dim, device=device, dtype=dtype)
        self.fc2 = Linear(dim, dim, device=device, dtype=dtype)


class AdaMod(nn.Module):
    def __init__(self, dim: int, n: int, device=None, dtype=None):
        super().__init__()
        self.linear = Linear(dim, n * dim, device=device, dtype=dtype)


def _ff(dim: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"0": Linear(dim, 4 * dim, **kw), "2": Linear(4 * dim, dim, **kw)})


class JointAttention(nn.Module):
    def __init__(self, cfg: FluxDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.dim, cfg.head_dim
        self.a_to_qkv = Linear(d, 3 * d, **kw)
        self.b_to_qkv = Linear(d, 3 * d, **kw)
        self.norm_q_a = RMSWeight(hd, **kw)
        self.norm_k_a = RMSWeight(hd, **kw)
        self.norm_q_b = RMSWeight(hd, **kw)
        self.norm_k_b = RMSWeight(hd, **kw)
        self.a_to_out = Linear(d, d, **kw)
        self.b_to_out = Linear(d, d, **kw)


class JointBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1_a = AdaMod(cfg.dim, 6, **kw)
        self.norm1_b = AdaMod(cfg.dim, 6, **kw)
        self.attn = JointAttention(cfg, **kw)
        self.ff_a = _ff(cfg.dim, **kw)
        self.ff_b = _ff(cfg.dim, **kw)


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.norm = AdaMod(d, 3, **kw)
        self.to_qkv_mlp = Linear(d, 7 * d, **kw)
        self.norm_q_a = RMSWeight(cfg.head_dim, **kw)
        self.norm_k_a = RMSWeight(cfg.head_dim, **kw)
        self.proj_out = Linear(5 * d, d, **kw)


class FluxDiT(nn.Module):
    """Parameters of the FLUX DiT; `flux_dit_forward` runs it."""

    def __init__(self, cfg: FluxDiTConfig = FLUX_DEV, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.time_embedder = MLPEmbed(cfg.time_freq_dim, d, **kw)
        self.pooled_text_embedder = MLPEmbed(cfg.pooled_dim, d, **kw)
        if cfg.guidance_embed:
            self.guidance_embedder = MLPEmbed(cfg.time_freq_dim, d, **kw)
        self.context_embedder = Linear(cfg.context_dim, d, **kw)
        self.x_embedder = Linear(cfg.in_dim, d, **kw)
        self.final_norm_out = AdaMod(d, 2, **kw)
        self.final_proj_out = Linear(d, cfg.out_dim, **kw)
        self.blocks = nn.ModuleList(JointBlock(cfg, **kw)
                                    for _ in range(cfg.num_joint_blocks))
        self.single_blocks = nn.ModuleList(SingleBlock(cfg, **kw)
                                           for _ in range(cfg.num_single_blocks))


@torch.no_grad()
def init_flux_dit_(model: FluxDiT, generator: torch.Generator) -> FluxDiT:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, RMSNorm weights 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            m.bias.zero_()
        elif isinstance(m, RMSWeight):
            m.weight.fill_(1.0)
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def timestep_embedding_flux(timestep, dim: int):
    """[cos | sin] sinusoidal embedding (flip_sin_to_cos, no frequency
    shift), float32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timestep.device) / half
    args = timestep.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mlp_embed(p: MLPEmbed, x):
    return p.fc2(silu(p.fc1(x)))


def _rms(p: RMSWeight, x, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * p.weight.to(x.dtype)


def _ada_mod(p: AdaMod, temb, n: int):
    return (p.linear(silu(temb))[:, None, :]).chunk(n, dim=-1)


def _heads(x, n: int):
    b, s, d = x.shape
    return x.view(b, s, n, d // n)


def _modulate(x, shift, scale, eps: float):
    return layer_norm(x, eps=eps) * (1 + scale) + shift


def _self_attention(q, k, v, attn_bias):
    """K1 (or its plain version), or under an EliGen bias the exact `sdpa`."""
    if attn_bias is None:
        return attention(q, k, v)
    return sdpa(q, k, v, bias=attn_bias)


def _interact_ipadapter(out, q, ip_k, ip_v, scale: float):
    """out += scale * attention(q, ip_k, ip_v), out (B, S, dim)."""
    b, s = out.shape[:2]
    ip = attention(q, ip_k.to(q.dtype), ip_v.to(q.dtype))
    return out + scale * ip.reshape(b, s, -1).to(out.dtype)


def joint_block(p: JointBlock, x_a, x_b, temb, cos, sin, cfg: FluxDiTConfig,
                ip_k=None, ip_v=None, ip_scale: float = 1.0, attn_bias=None):
    """Image stream x_a, text stream x_b; the RoPE rows cover [text | image]
    and the joint attention runs on that order. ip_k/ip_v (B, T, N, D) add
    IP-Adapter attention on the image stream, queried with the pre-RoPE
    normed q_a."""
    sh_a, sc_a, g_a, shm_a, scm_a, gm_a = _ada_mod(p.norm1_a, temb, 6)
    sh_b, sc_b, g_b, shm_b, scm_b, gm_b = _ada_mod(p.norm1_b, temb, 6)
    ap = p.attn
    n = cfg.num_heads
    q_a, k_a, v_a = _heads(ap.a_to_qkv(_modulate(x_a, sh_a, sc_a, cfg.eps)), 3 * n).chunk(3, 2)
    q_b, k_b, v_b = _heads(ap.b_to_qkv(_modulate(x_b, sh_b, sc_b, cfg.eps)), 3 * n).chunk(3, 2)
    q_a = _rms(ap.norm_q_a, q_a, cfg.eps)
    q = torch.cat([_rms(ap.norm_q_b, q_b, cfg.eps), q_a], dim=1)
    k = torch.cat([_rms(ap.norm_k_b, k_b, cfg.eps), _rms(ap.norm_k_a, k_a, cfg.eps)], dim=1)
    v = torch.cat([v_b, v_a], dim=1)
    out = _self_attention(rope_apply_interleaved(q, cos, sin),
                          rope_apply_interleaved(k, cos, sin), v, attn_bias)
    out = out.reshape(out.shape[0], out.shape[1], cfg.dim)
    s_b = x_b.shape[1]
    out_b, out_a = out[:, :s_b], out[:, s_b:]
    if ip_k is not None:
        out_a = _interact_ipadapter(out_a, q_a, ip_k, ip_v, ip_scale)

    x_a = x_a + g_a * ap.a_to_out(out_a)
    h = _modulate(x_a, shm_a, scm_a, cfg.eps)
    x_a = x_a + gm_a * p.ff_a["2"](gelu_tanh(p.ff_a["0"](h)))

    x_b = x_b + g_b * ap.b_to_out(out_b)
    h = _modulate(x_b, shm_b, scm_b, cfg.eps)
    x_b = x_b + gm_b * p.ff_b["2"](gelu_tanh(p.ff_b["0"](h)))
    return x_a, x_b


def single_block(p: SingleBlock, x, temb, cos, sin, cfg: FluxDiTConfig,
                 ip_k=None, ip_v=None, ip_scale: float = 1.0, attn_bias=None):
    """The IP-Adapter query here is the post-RoPE q over the whole
    [text | image] sequence."""
    sh, sc, gate = _ada_mod(p.norm, temb, 3)
    proj = p.to_qkv_mlp(_modulate(x, sh, sc, cfg.eps))
    qkv, mlp = proj[..., :3 * cfg.dim], proj[..., 3 * cfg.dim:]
    q, k, v = _heads(qkv, 3 * cfg.num_heads).chunk(3, 2)
    q = rope_apply_interleaved(_rms(p.norm_q_a, q, cfg.eps), cos, sin)
    k = rope_apply_interleaved(_rms(p.norm_k_a, k, cfg.eps), cos, sin)
    out = _self_attention(q, k, v, attn_bias).reshape(x.shape[0], x.shape[1], cfg.dim)
    if ip_k is not None:
        out = _interact_ipadapter(out, q, ip_k, ip_v, ip_scale)
    return x + gate * p.proj_out(torch.cat([out, gelu_tanh(mlp)], dim=-1))


def patchify(x):
    """(B, C, H, W) -> (B, H/2 * W/2, C * 2 * 2), features in (c, p, q) order."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(
        b, (h // 2) * (w // 2), c * 4)


def unpatchify(x, height: int, width: int):
    b, _, f = x.shape
    c = f // 4
    return x.reshape(b, height // 2, width // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        b, c, height, width)


def flux_dit_forward(model: FluxDiT, hidden_states, timestep, prompt_emb,
                     pooled_prompt_emb, guidance=None, image_ids=None, text_ids=None,
                     kontext_latents=None, kontext_ids=None, controlnet_res=None,
                     controlnet_single_res=None, ip_kv=None, ip_scale: float = 1.0,
                     attn_bias=None, remat: bool = False):
    """hidden_states (B, 16, H, W) latents; prompt_emb (B, L, context_dim);
    pooled_prompt_emb (B, pooled_dim); guidance (B,) embedded guidance (dev
    models); image_ids/text_ids: optional (S, 3) position ids.
    kontext_latents: patchified reference tokens appended after the image
    tokens with their own ids (f_id = 1), dropped from the output. The
    adapters' inputs and `remat` as `flux_trunk` takes them."""
    x, ctx, temb, cos, sin, n_img = flux_embed(
        model, hidden_states, timestep, prompt_emb, pooled_prompt_emb, guidance,
        image_ids, text_ids, kontext_latents, kontext_ids)
    h = flux_trunk(model, x, ctx, temb, cos, sin, controlnet_res=controlnet_res,
                   controlnet_single_res=controlnet_single_res, ip_kv=ip_kv,
                   ip_scale=ip_scale, attn_bias=attn_bias, remat=remat)
    height, width = hidden_states.shape[-2:]
    return flux_head(model, h[:, :n_img], temb, height, width)


def flux_embed(model: FluxDiT, hidden_states, timestep, prompt_emb, pooled_prompt_emb,
               guidance=None, image_ids=None, text_ids=None, kontext_latents=None,
               kontext_ids=None):
    """The embedding stage -> (x_tokens, ctx_tokens, temb, cos, sin, n_img);
    x_tokens holds the Kontext tokens after the image's when given."""
    cfg = model.cfg
    dtype = hidden_states.dtype
    height, width = hidden_states.shape[-2:]
    if image_ids is None:
        image_ids = prepare_image_ids(0, height // 2, width // 2)
    if text_ids is None:
        text_ids = np.zeros((prompt_emb.shape[1], 3), np.float64)

    temb = _mlp_embed(model.time_embedder,
                      timestep_embedding_flux(timestep, cfg.time_freq_dim).to(dtype))
    temb = temb + _mlp_embed(model.pooled_text_embedder, pooled_prompt_emb)
    if cfg.guidance_embed and guidance is not None:
        temb = temb + _mlp_embed(
            model.guidance_embedder,
            timestep_embedding_flux(guidance * 1000.0, cfg.time_freq_dim).to(dtype))

    tokens = patchify(hidden_states)
    n_img = tokens.shape[1]
    if kontext_latents is not None:
        tokens = torch.cat([tokens, kontext_latents.to(tokens.dtype)], dim=1)
        image_ids = np.concatenate([np.asarray(image_ids, np.float64),
                                    np.asarray(kontext_ids, np.float64)], axis=0)
    x = model.x_embedder(tokens)
    ctx = model.context_embedder(prompt_emb)
    ids = np.ascontiguousarray(np.concatenate([np.asarray(text_ids, np.float64),
                                               np.asarray(image_ids, np.float64)], axis=0))
    cos, sin = _rope_tables(ids.tobytes(), tuple(cfg.axes_dim), cfg.theta, x.device)
    return x, ctx, temb, cos, sin, n_img


def flux_trunk(model: FluxDiT, x, ctx, temb, cos, sin, controlnet_res=None,
               controlnet_single_res=None, ip_kv=None, ip_scale: float = 1.0,
               attn_bias=None, remat: bool = False):
    """The joint then single block stacks -> the image (and Kontext)
    tokens after the trunk.

    controlnet_res: (num_joint, B, n_img, D) residuals added to the image
    stream after each joint block, zero-padded to the image and Kontext
    length; controlnet_single_res: (num_single, B, n_img, D) added to the
    rows past the text after each single block. ip_kv: (ip_k, ip_v), each
    (num_joint + num_single, B, T, N, D). attn_bias: (B, 1, S, S) fp32
    additive bias of both self-attentions. remat: each block under
    `torch.utils.checkpoint` (non-reentrant), its activations recomputed in
    the backward; the same values."""
    cfg = model.cfg
    joint, single = joint_block, single_block
    if remat:
        def joint(*args, **kw):
            return checkpoint(joint_block, *args, use_reentrant=False, **kw)

        def single(*args, **kw):
            return checkpoint(single_block, *args, use_reentrant=False, **kw)
    if controlnet_res is not None and controlnet_res.shape[2] < x.shape[1]:
        controlnet_res = torch.nn.functional.pad(
            controlnet_res, (0, 0, 0, x.shape[1] - controlnet_res.shape[2]))
    ip_k, ip_v = ip_kv if ip_kv is not None else (None, None)
    nj = cfg.num_joint_blocks
    for i, p in enumerate(model.blocks):
        x, ctx = joint(p, x, ctx, temb, cos, sin, cfg,
                             ip_k=None if ip_k is None else ip_k[i],
                             ip_v=None if ip_v is None else ip_v[i],
                             ip_scale=ip_scale, attn_bias=attn_bias)
        if controlnet_res is not None:
            x = x + controlnet_res[i].to(x.dtype)
    s_ctx = ctx.shape[1]
    h = torch.cat([ctx, x], dim=1)
    for i, p in enumerate(model.single_blocks):
        h = single(p, h, temb, cos, sin, cfg,
                         ip_k=None if ip_k is None else ip_k[nj + i],
                         ip_v=None if ip_v is None else ip_v[nj + i],
                         ip_scale=ip_scale, attn_bias=attn_bias)
        if controlnet_single_res is not None:
            res = controlnet_single_res[i]
            h = torch.cat([h[:, :s_ctx], h[:, s_ctx:s_ctx + res.shape[1]] + res.to(h.dtype),
                           h[:, s_ctx + res.shape[1]:]], dim=1)
    return h[:, s_ctx:]


def flux_head(model: FluxDiT, h, temb, height: int, width: int):
    scale, shift = _ada_mod(model.final_norm_out, temb, 2)
    h = model.final_proj_out(_modulate(h, shift, scale, model.cfg.eps))
    return unpatchify(h, height, width)


def flux_modulated_input(model: FluxDiT, x, temb):
    """Block 0's norm1_a modulation of the embedded tokens: the TeaCache
    probe."""
    sh, sc, *_ = _ada_mod(model.blocks[0].norm1_a, temb, 6)
    return _modulate(x, sh, sc, model.cfg.eps)


# --------------------------------------------------------------------------
# Checkpoint conversion
# --------------------------------------------------------------------------

def _swap_halves(v):
    """(scale, shift) <- (shift, scale) rows of the final adaLN, read first
    where the value is a lazy checkpoint tensor."""
    from ..utils.ckpt import LazyTensor, read_tensors
    if isinstance(v, LazyTensor):
        v = read_tensors({"v": v}, "cpu")["v"]
    half = v.shape[0] // 2
    return torch.cat([v[half:], v[:half]], dim=0)


def rename_civitai_flux(sd: Dict) -> Dict:
    """Raw BFL (civitai) key layout -> the reference's DiffSynth module
    layout (the JAX `rename_civitai_flux`)."""
    top = {"time_in": "time_embedder.timestep_embedder",
           "vector_in": "pooled_text_embedder",
           "guidance_in": "guidance_embedder.timestep_embedder"}
    out = {}
    for name, v in sd.items():
        if name.startswith("model.diffusion_model."):
            name = name[len("model.diffusion_model."):]
        parts = name.split(".")
        if parts[0] in top:
            io = {"in_layer": "0", "out_layer": "2"}[parts[1]]
            out[f"{top[parts[0]]}.{io}.{parts[2]}"] = v
        elif parts[0] == "txt_in":
            out[f"context_embedder.{parts[1]}"] = v
        elif parts[0] == "img_in":
            out[f"x_embedder.{parts[1]}"] = v
        elif parts[0] == "final_layer":
            if parts[1] == "linear":
                out[f"final_proj_out.{parts[2]}"] = v
            elif parts[1] == "adaLN_modulation":
                out[f"final_norm_out.linear.{parts[3]}"] = _swap_halves(v)
        elif parts[0] == "double_blocks":
            i, rest, leaf = parts[1], ".".join(parts[2:]), parts[-1]
            stream = "a" if rest.startswith("img") else "b"
            if "attn.qkv" in rest:
                out[f"blocks.{i}.attn.{stream}_to_qkv.{leaf}"] = v
            elif "attn.proj" in rest:
                out[f"blocks.{i}.attn.{stream}_to_out.{leaf}"] = v
            elif "attn.norm" in rest:
                which = "q" if "query" in rest else "k"
                out[f"blocks.{i}.attn.norm_{which}_{stream}.weight"] = v
            elif "_mlp" in rest:
                out[f"blocks.{i}.ff_{stream}.{parts[3]}.{leaf}"] = v
            elif "_mod" in rest:
                out[f"blocks.{i}.norm1_{stream}.linear.{leaf}"] = v
        elif parts[0] == "single_blocks":
            i, rest, leaf = parts[1], ".".join(parts[2:]), parts[-1]
            if rest.startswith("linear1"):
                out[f"single_blocks.{i}.to_qkv_mlp.{leaf}"] = v
            elif rest.startswith("linear2"):
                out[f"single_blocks.{i}.proj_out.{leaf}"] = v
            elif rest.startswith("modulation"):
                out[f"single_blocks.{i}.norm.linear.{leaf}"] = v
            elif rest.startswith("norm."):
                which = "q" if "query" in rest else "k"
                out[f"single_blocks.{i}.norm_{which}_a.weight"] = v
    return out


def convert_flux_dit(sd: Dict, cfg: FluxDiTConfig) -> Dict:
    """A DiffSynth-layout FluxDiT state dict (a raw BFL one is renamed
    first) -> the `FluxDiT` state dict. The reference's embedders'
    `timestep_embedder.{0,2}` / `{0,2}` become `fc1` / `fc2`; every other
    name is the module's. Values pass through."""
    if any(k.startswith("double_blocks.") or k == "img_in.weight" for k in sd):
        sd = rename_civitai_flux(sd)
    out = {}
    embeds = [("time_embedder", "time_embedder.timestep_embedder"),
              ("pooled_text_embedder", "pooled_text_embedder")]
    if cfg.guidance_embed and "guidance_embedder.timestep_embedder.0.weight" in sd:
        embeds.append(("guidance_embedder", "guidance_embedder.timestep_embedder"))
    for dst, src in embeds:
        for fc, i in (("fc1", 0), ("fc2", 2)):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{fc}.{leaf}"] = sd[f"{src}.{i}.{leaf}"]
    names = ["context_embedder", "x_embedder", "final_norm_out.linear", "final_proj_out"]
    for i in range(cfg.num_joint_blocks):
        b = f"blocks.{i}"
        names += [f"{b}.norm1_a.linear", f"{b}.norm1_b.linear", f"{b}.ff_a.0",
                  f"{b}.ff_a.2", f"{b}.ff_b.0", f"{b}.ff_b.2"]
        names += [f"{b}.attn.{s}_to_{w}" for s in "ab" for w in ("qkv", "out")]
        out.update({f"{b}.attn.norm_{w}_{s}.weight": sd[f"{b}.attn.norm_{w}_{s}.weight"]
                    for w in "qk" for s in "ab"})
    for i in range(cfg.num_single_blocks):
        b = f"single_blocks.{i}"
        names += [f"{b}.norm.linear", f"{b}.to_qkv_mlp", f"{b}.proj_out"]
        out.update({f"{b}.norm_{w}_a.weight": sd[f"{b}.norm_{w}_a.weight"] for w in "qk"})
    for name in names:
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"{name}.{leaf}"]
    return out


def flux_config_for(sd: Dict) -> FluxDiTConfig:
    """FLUX.1-dev where the file has a guidance embedder, else schnell (the
    JAX loader's rule)."""
    return FLUX_DEV if any("guidance" in k for k in sd) else FLUX_SCHNELL


def build_entity_attention_bias(entity_masks: np.ndarray, prompt_len: int,
                                n_img: int) -> np.ndarray:
    """The EliGen attention bias, host numpy (the JAX function, bit for bit).

    entity_masks: (B, N, 1, H_lat, W_lat) {0, 1} at the latent resolution.
    The sequence is [entity_1 text | ... | entity_N text | global text |
    image]: each entity's text and its own image region see each other,
    entity texts see neither each other nor the global text, the global
    text and image-image attention stay dense. -> (B, 1, S, S) float32,
    0 / -inf."""
    b, n_ent = entity_masks.shape[:2]
    total = (n_ent + 1) * prompt_len + n_img
    bias = np.zeros((b, total, total), np.float32)
    img0 = (n_ent + 1) * prompt_len
    m = entity_masks[:, :, 0]
    hh, ww = m.shape[-2:]
    # one bool per image token: any hit in its 2x2 patch
    patched = m.reshape(b, n_ent, hh // 2, 2, ww // 2, 2).max(axis=(3, 5))
    patched = patched.reshape(b, n_ent, -1) > 0
    neg = np.float32(-np.inf)
    for i in range(n_ent):
        t0, t1 = i * prompt_len, (i + 1) * prompt_len
        blocked = ~patched[:, i]
        bias[:, t0:t1, img0:img0 + n_img] = np.where(blocked[:, None, :], neg, 0.0)
        bias[:, img0:img0 + n_img, t0:t1] = np.where(blocked[:, :, None], neg, 0.0)
    for i in range(n_ent + 1):
        for j in range(n_ent):
            if i != j:
                bias[:, i * prompt_len:(i + 1) * prompt_len,
                     j * prompt_len:(j + 1) * prompt_len] = neg
    for i in range(n_ent):
        bias[:, i * prompt_len:(i + 1) * prompt_len, n_ent * prompt_len:img0] = neg
    return bias[:, None]
