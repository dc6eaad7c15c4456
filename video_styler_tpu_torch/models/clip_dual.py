"""Dual-tower CLIP (vision + text) and the MPS cross model, in PyTorch.

Counterpart of `video_styler_tpu/models/clip_dual.py`, the towers behind the
image-quality metrics: PickScore (HF CLIPModel ViT-H/14), HPS v2 (open_clip
ViT-H-14) and MPS (HF CLIP ViT-H/14 and a 4-layer multi-query cross
model). One `ClipDual` module serves all three; `convert_hf_clip` and
`convert_open_clip` read either checkpoint layout into it, and
`convert_cross_model` reads the MPS cross model into a `CrossModel`.

Modules are named after the JAX pytree (`vision.patch`, `text.tok_emb`,
`layers.{i}.cross.to_q`, ...), so `convert.from_jax_params` carries a JAX
tree across. Attention is the exact-softmax `ops.attention.sdpa`, as the
JAX towers run XLA's sdpa and no Pallas kernel; the cross model's
attentions are its own einsums, as there. fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .wan_dit import LayerNormAffine, Linear


@dataclass(frozen=True)
class CLIPDualConfig:
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1280
    vision_layers: int = 32
    vision_heads: int = 16
    text_dim: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    proj_dim: int = 1024
    vocab_size: int = 49408
    max_len: int = 77
    eos_token_id: int = 49407
    quick_gelu: bool = False
    norm_eps: float = 1e-5


# laion/CLIP-ViT-H-14 (PickScore, MPS, HPS backbones)
CLIP_VIT_H_14_DUAL = CLIPDualConfig()

CLIP_DUAL_TINY = CLIPDualConfig(
    image_size=28, patch_size=14, vision_dim=32, vision_layers=2, vision_heads=2,
    text_dim=24, text_layers=2, text_heads=2, proj_dim=16, vocab_size=64, max_len=8,
    eos_token_id=63)


class ClipDualBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNormAffine(dim, **kw)
        self.q = Linear(dim, dim, **kw)
        self.k = Linear(dim, dim, **kw)
        self.v = Linear(dim, dim, **kw)
        self.o = Linear(dim, dim, **kw)
        self.ln2 = LayerNormAffine(dim, **kw)
        self.fc1 = Linear(dim, 4 * dim, **kw)
        self.fc2 = Linear(4 * dim, dim, **kw)


class ClipVision(nn.Module):
    def __init__(self, cfg: CLIPDualConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, g = cfg.vision_dim, cfg.image_size // cfg.patch_size
        self.patch = Linear(3 * cfg.patch_size ** 2, d, bias=False, **kw)
        self.cls = nn.Parameter(torch.zeros(d, **kw))
        self.pos = nn.Parameter(torch.zeros(g * g + 1, d, **kw))
        self.pre_ln = LayerNormAffine(d, **kw)
        self.post_ln = LayerNormAffine(d, **kw)
        self.blocks = nn.ModuleList(ClipDualBlock(d, **kw) for _ in range(cfg.vision_layers))


class ClipText(nn.Module):
    def __init__(self, cfg: CLIPDualConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.text_dim
        self.tok_emb = nn.Parameter(torch.zeros(cfg.vocab_size, d, **kw))
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_len, d, **kw))
        self.final_ln = LayerNormAffine(d, **kw)
        self.blocks = nn.ModuleList(ClipDualBlock(d, **kw) for _ in range(cfg.text_layers))


class ClipDual(nn.Module):
    """Both towers, their projections and `logit_scale` (a float64 scalar,
    the JAX tree's Python float)."""

    def __init__(self, cfg: CLIPDualConfig = CLIP_VIT_H_14_DUAL, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision = ClipVision(cfg, **kw)
        self.text = ClipText(cfg, **kw)
        self.visual_projection = Linear(cfg.vision_dim, cfg.proj_dim, bias=False, **kw)
        self.text_projection = Linear(cfg.text_dim, cfg.proj_dim, bias=False, **kw)
        self.register_buffer("logit_scale", torch.tensor(float(np.log(100.0)),
                                                         dtype=torch.float64, device=device))


def _act(x, quick: bool):
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x.float()).to(x.dtype)


def _block(p: ClipDualBlock, x, heads: int, quick: bool, eps: float, mask=None):
    b, s, d = x.shape
    h = layer_norm(x, p.ln1.scale, p.ln1.bias, eps)
    q = p.q(h).reshape(b, s, heads, d // heads)
    k = p.k(h).reshape(b, s, heads, d // heads)
    v = p.v(h).reshape(b, s, heads, d // heads)
    x = x + p.o(sdpa(q, k, v, bias=mask).reshape(b, s, d))
    h = layer_norm(x, p.ln2.scale, p.ln2.bias, eps)
    return x + p.fc2(_act(p.fc1(h), quick))


def clip_vision_forward(params: ClipDual, cfg: CLIPDualConfig, pixel_values):
    """pixel_values (B, 3, H, W) CLIP-normalised -> (tokens (B, 1+P, vd),
    pooled (B, vd)): the post LayerNorm applies to the pooled CLS only;
    `tokens` is the raw last hidden state (what MPS projects)."""
    p = params.vision
    b, ps, g = pixel_values.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
    patches = pixel_values.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = p.patch(patches.reshape(b, g * g, -1))
    x = torch.cat([p.cls.to(x.dtype).expand(b, 1, cfg.vision_dim), x], dim=1) + p.pos.to(x.dtype)
    x = layer_norm(x, p.pre_ln.scale, p.pre_ln.bias, cfg.norm_eps)
    for blk in p.blocks:
        x = _block(blk, x, cfg.vision_heads, cfg.quick_gelu, cfg.norm_eps)
    return x, layer_norm(x[:, 0], p.post_ln.scale, p.post_ln.bias, cfg.norm_eps)


def clip_text_forward(params: ClipDual, cfg: CLIPDualConfig, input_ids, attention_mask=None):
    """input_ids (B, L) -> (tokens (B, L, td), pooled (B, td)); pooled at the
    first EOS token after the final LayerNorm (HF CLIPTextTransformer)."""
    p = params.text
    b, s = input_ids.shape
    dev = p.tok_emb.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    x = p.tok_emb[input_ids] + p.pos_emb[:s]
    mask = torch.triu(torch.full((s, s), float("-inf"), device=dev), diagonal=1)[None, None]
    if attention_mask is not None:
        am = torch.as_tensor(attention_mask, device=dev)
        mask = mask + torch.where(am[:, None, None, :] > 0, 0.0, float("-inf"))
    for blk in p.blocks:
        x = _block(blk, x, cfg.text_heads, cfg.quick_gelu, cfg.norm_eps, mask=mask)
    x = layer_norm(x, p.final_ln.scale, p.final_ln.bias, cfg.norm_eps)
    eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
    return x, x[torch.arange(b, device=dev), eos]


def clip_image_features(params: ClipDual, cfg: CLIPDualConfig, pixel_values):
    """Projected pooled image features (B, proj), HF get_image_features."""
    return params.visual_projection(clip_vision_forward(params, cfg, pixel_values)[1])


def clip_text_features(params: ClipDual, cfg: CLIPDualConfig, input_ids,
                       attention_mask=None):
    """Projected pooled text features (B, proj), HF get_text_features."""
    return params.text_projection(clip_text_forward(params, cfg, input_ids,
                                                    attention_mask)[1])


# -- converters ---------------------------------------------------------------

def _t(v) -> torch.Tensor:
    """A checkpoint value (tensor or numpy array) as a float32 tensor."""
    if torch.is_tensor(v):
        return v.detach().float()
    return torch.from_numpy(np.array(v, np.float32))


def _load(module: nn.Module, sd: Dict[str, torch.Tensor], device) -> nn.Module:
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(resolve_device(device)).eval()


def _lin(out: Dict, dst: str, sd, src: str):
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _ln(out: Dict, dst: str, sd, src: str):
    out[f"{dst}.scale"] = _t(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _logit_scale(v) -> torch.Tensor:
    return torch.tensor(float(_t(v)), dtype=torch.float64)  # the JAX float(float32)


def convert_hf_clip(state_dict, cfg: CLIPDualConfig = CLIP_VIT_H_14_DUAL,
                    device=None) -> ClipDual:
    """HF CLIPModel state dict (text_model.* / vision_model.* /
    {visual,text}_projection / logit_scale, optionally under "model.") ->
    `ClipDual` on `device` (the card unless "cpu")."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    conv = _t(sd["vision_model.embeddings.patch_embedding.weight"])
    out = {"vision.patch.weight": conv.reshape(conv.shape[0], -1),
           "vision.cls": _t(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
           "vision.pos": _t(sd["vision_model.embeddings.position_embedding.weight"]),
           "text.tok_emb": _t(sd["text_model.embeddings.token_embedding.weight"]),
           "text.pos_emb": _t(sd["text_model.embeddings.position_embedding.weight"]),
           "logit_scale": _logit_scale(sd["logit_scale"])}
    _ln(out, "vision.pre_ln", sd, "vision_model.pre_layrnorm")
    _ln(out, "vision.post_ln", sd, "vision_model.post_layernorm")
    _ln(out, "text.final_ln", sd, "text_model.final_layer_norm")
    for tower, n in (("vision", cfg.vision_layers), ("text", cfg.text_layers)):
        for i in range(n):
            src, dst = f"{tower}_model.encoder.layers.{i}", f"{tower}.blocks.{i}"
            _ln(out, f"{dst}.ln1", sd, f"{src}.layer_norm1")
            _ln(out, f"{dst}.ln2", sd, f"{src}.layer_norm2")
            for a, b in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                _lin(out, f"{dst}.{a}", sd, f"{src}.self_attn.{b}")
            _lin(out, f"{dst}.fc1", sd, f"{src}.mlp.fc1")
            _lin(out, f"{dst}.fc2", sd, f"{src}.mlp.fc2")
    _lin(out, "visual_projection", sd, "visual_projection")
    _lin(out, "text_projection", sd, "text_projection")
    with torch.device("meta"):
        module = ClipDual(cfg)
    return _load(module, out, device)


def convert_open_clip(state_dict, cfg: CLIPDualConfig = CLIP_VIT_H_14_DUAL,
                      device=None) -> ClipDual:
    """open_clip CLIP state dict (visual.* / transformer.resblocks.*) -> the
    same `ClipDual` (HPS checkpoints, hps.py:48-55)."""
    sd = dict(state_dict)
    conv = _t(sd["visual.conv1.weight"])
    out = {"vision.patch.weight": conv.reshape(conv.shape[0], -1),
           "vision.cls": _t(sd["visual.class_embedding"]).reshape(-1),
           "vision.pos": _t(sd["visual.positional_embedding"]),
           "text.tok_emb": _t(sd["token_embedding.weight"]),
           "text.pos_emb": _t(sd["positional_embedding"]),
           "logit_scale": _logit_scale(sd["logit_scale"])}
    _ln(out, "vision.pre_ln", sd, "visual.ln_pre")
    _ln(out, "vision.post_ln", sd, "visual.ln_post")
    _ln(out, "text.final_ln", sd, "ln_final")
    for tower, prefix, n in (("vision", "visual.transformer", cfg.vision_layers),
                             ("text", "transformer", cfg.text_layers)):
        for i in range(n):
            src, dst = f"{prefix}.resblocks.{i}", f"{tower}.blocks.{i}"
            w = _t(sd[f"{src}.attn.in_proj_weight"]).chunk(3, dim=0)
            b = _t(sd[f"{src}.attn.in_proj_bias"]).chunk(3, dim=0)
            for j, a in enumerate("qkv"):
                out[f"{dst}.{a}.weight"], out[f"{dst}.{a}.bias"] = w[j], b[j]
            _lin(out, f"{dst}.o", sd, f"{src}.attn.out_proj")
            _ln(out, f"{dst}.ln1", sd, f"{src}.ln_1")
            _ln(out, f"{dst}.ln2", sd, f"{src}.ln_2")
            _lin(out, f"{dst}.fc1", sd, f"{src}.mlp.c_fc")
            _lin(out, f"{dst}.fc2", sd, f"{src}.mlp.c_proj")
    # open_clip projections are plain matrices (x @ proj)
    out["visual_projection.weight"] = _t(sd["visual.proj"]).T.contiguous()
    out["text_projection.weight"] = _t(sd["text_projection"]).T.contiguous()
    with torch.device("meta"):
        module = ClipDual(cfg)
    return _load(module, out, device)


# -- MPS cross model (cross_modeling.py:18-292) -------------------------------

@dataclass(frozen=True)
class CrossModelConfig:
    dim: int = 1024            # the projected CLIP width (proj_dim)
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    num_layers: int = 4

    @property
    def inner(self) -> int:
        return self.heads * self.dim_head


MPS_CROSS = CrossModelConfig()


class _Norm(nn.Module):
    """Weight-only LayerNorm (the bias is a zero buffer in the reference)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class CrossAttentionLayer(nn.Module):
    def __init__(self, cfg: CrossModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, ff = cfg.dim, cfg.dim * cfg.ff_mult
        self.norm = _Norm(d, device=device, dtype=dtype)
        self.to_q = Linear(d, cfg.inner, **kw)
        self.to_kv = Linear(d, 2 * cfg.dim_head, **kw)
        self.to_out = Linear(cfg.inner, d, **kw)
        self.ff1 = Linear(d, 2 * ff, **kw)
        self.ff2 = Linear(ff, d, **kw)


class ParallelBlock(nn.Module):
    def __init__(self, cfg: CrossModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, ff = cfg.dim, cfg.dim * cfg.ff_mult
        self.norm = _Norm(d, device=device, dtype=dtype)
        self.fused = Linear(d, cfg.inner + 2 * cfg.dim_head + 2 * ff, **kw)
        self.attn_out = Linear(cfg.inner, d, **kw)
        self.ff_out = Linear(ff, d, **kw)


class CrossLayer(nn.Module):
    def __init__(self, cfg: CrossModelConfig, device=None, dtype=None):
        super().__init__()
        self.cross = CrossAttentionLayer(cfg, device=device, dtype=dtype)
        # "self" as the JAX tree names it
        self.add_module("self", ParallelBlock(cfg, device=device, dtype=dtype))


class CrossModel(nn.Module):
    def __init__(self, cfg: CrossModelConfig = MPS_CROSS, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(CrossLayer(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))


def _wn_layer_norm(p: _Norm, x):
    return layer_norm(x, p.scale, None, eps=1e-5)


def _swiglu(x):
    a, gate = x.chunk(2, dim=-1)
    return F.silu(gate) * a


def _rotary(n: int, dim: int, device):
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freqs = np.arange(n, dtype=np.float32)[:, None] * inv[None]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device), torch.from_numpy(np.sin(emb)).to(device))


def _rot_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _parallel_block(p: ParallelBlock, x, heads: int, dim_head: int = 64):
    """Multi-query self-attention and a parallel SwiGLU FFN, rotary
    positions, with the residual."""
    b, n, d = x.shape
    h = _wn_layer_norm(p.norm, x)
    fused = p.fused(h)
    inner = heads * dim_head
    q = fused[..., :inner].reshape(b, n, heads, dim_head).transpose(1, 2)
    k = fused[..., inner:inner + dim_head]
    v = fused[..., inner + dim_head:inner + 2 * dim_head]
    ff = fused[..., inner + 2 * dim_head:]
    cos, sin = _rotary(n, dim_head, x.device)
    q = q * cos + _rot_half(q) * sin
    k = k * cos + _rot_half(k) * sin
    q = q * (dim_head ** -0.5)
    sim = torch.einsum("bhid,bjd->bhij", q.float(), k.float())
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bjd->bhid", attn, v).transpose(1, 2).reshape(b, n, inner)
    return x + p.attn_out(out) + p.ff_out(_swiglu(ff))


def _cross_attention(p: CrossAttentionLayer, x, context, mask, heads: int,
                     dim_head: int = 64):
    """Multi-query cross attention and a parallel SwiGLU FFN, with the
    residual."""
    b, n, d = x.shape
    h = _wn_layer_norm(p.norm, x)
    q = p.to_q(h).reshape(b, n, heads, dim_head).transpose(1, 2) * (dim_head ** -0.5)
    k, v = p.to_kv(context).chunk(2, dim=-1)
    sim = torch.einsum("bhid,bjd->bhij", q.float(), k.float()) + mask[:, None]
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bjd->bhid", attn, v).transpose(1, 2).reshape(b, n, heads * dim_head)
    return x + p.to_out(out) + p.ff2(_swiglu(p.ff1(h)))


def cross_model_forward(params: CrossModel, query_tokens, context_tokens, mask,
                        heads: int = 16):
    """MPS Cross_model (cross_modeling.py:261-292): interleaved
    cross-attention / parallel-transformer layers over (image, text)."""
    x = query_tokens
    dim_head = params.cfg.dim_head
    for layer in params.layers:
        x = _cross_attention(layer.cross, x, context_tokens, mask, heads, dim_head)
        x = _parallel_block(getattr(layer, "self"), x, heads, dim_head)
    return x


def cross_model_config(sd: Dict[str, torch.Tensor]) -> CrossModelConfig:
    """The widths of a cross model from its port-named state dict."""
    inner, dim = sd["layers.0.cross.to_q.weight"].shape
    dim_head = sd["layers.0.cross.to_kv.weight"].shape[0] // 2
    ff = sd["layers.0.cross.ff2.weight"].shape[1]
    layers = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    return CrossModelConfig(dim=dim, heads=inner // dim_head, dim_head=dim_head,
                            ff_mult=ff // dim, num_layers=layers)


def convert_cross_model(state_dict, num_layers: int = 4, device=None) -> CrossModel:
    """torch Cross_model state dict (layers.{i}.{0,1}.fn.*, optionally under
    "cross_model.") -> `CrossModel` on `device`."""
    sd = {k.removeprefix("cross_model."): v for k, v in state_dict.items()
          if "cross_model." in k or k.startswith("layers.")}
    names = {"0.fn.norm.weight": "cross.norm.scale", "0.fn.to_q": "cross.to_q",
             "0.fn.to_kv": "cross.to_kv", "0.fn.to_out": "cross.to_out",
             "0.fn.ff.0": "cross.ff1", "0.fn.ff.2": "cross.ff2",
             "1.fn.norm.weight": "self.norm.scale",
             "1.fn.fused_attn_ff_proj": "self.fused", "1.fn.attn_out": "self.attn_out",
             "1.fn.ff_out.1": "self.ff_out"}
    out = {}
    for i in range(num_layers):
        for src, dst in names.items():
            if src.endswith(".weight"):
                out[f"layers.{i}.{dst}"] = _t(sd[f"layers.{i}.{src}"])
            else:
                _lin(out, f"layers.{i}.{dst}", sd, f"layers.{i}.{src}")
    with torch.device("meta"):
        module = CrossModel(cross_model_config(out))
    return _load(module, out, device)
