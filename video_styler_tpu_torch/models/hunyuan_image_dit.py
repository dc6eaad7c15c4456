"""HunyuanDiT (image) and its Chinese CLIP-BERT text tower in PyTorch.

Counterpart of `video_styler_tpu/models/hunyuan_image_dit.py`: a U-shaped
DiT (21 down blocks, 19 up blocks that take the down blocks' outputs back
through a LayerNorm + linear skip fusion), per-head q/k LayerNorm and the
2-D interleaved RoPE on the self-attention, the RoPE on the queries alone
on the cross-attention, shift-only adaLN, an mT5 attention pool beside the
size and style embeddings as the condition vector, and the first half of a
2x-channel head as the prediction. The RoPE tables (`hunyuan_image_rope`,
the grid fractionally resampled into the 512-pixel training crop) are made
with numpy and cached per size.

Every attention here (heads of 88 in the release, the pool's 8 heads, the
BERT's 16 heads of 64 under the padding mask) is the exact `sdpa`, as the
JAX package takes it; none reaches a Pallas kernel there.

Parameters live in modules named after the reference's DiffSynth names
(`blocks.{i}.attn1.to_q`, `blocks.{i}.rota1.q_norm`, `t5_pooler.q_proj`,
`timestep_embedder.mlp.0`, ...), so `convert_hunyuan_image_dit` only
renames a raw (civitai) file's keys, splits its fused projections and
flattens the patch convolution; the BERT keeps the Hugging Face
`BertModel` names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import gelu_tanh, layer_norm, sinusoidal_embedding_1d
from .flux_dit import rope_apply_interleaved
from .wan_dit import Linear


@dataclass(frozen=True)
class HunyuanImageDiTConfig:
    hidden_dim: int = 1408
    num_heads: int = 16
    mlp_ratio: float = 4.3637
    num_layers_down: int = 21
    num_layers_up: int = 19
    in_channels: int = 4
    out_channels: int = 8                 # the head emits 2x, the first half kept
    text_dim: int = 1024
    t5_dim: int = 2048
    text_length: int = 77
    t5_length: int = 256
    pooled_dim: int = 1024
    patch_size: int = 2
    base_size: int = 32                   # 512 // 8 // patch
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)


HUNYUAN_DIT = HunyuanImageDiTConfig()
HUNYUAN_DIT_TINY = HunyuanImageDiTConfig(
    hidden_dim=64, num_heads=4, mlp_ratio=2.0, num_layers_down=4,
    num_layers_up=2, text_dim=24, t5_dim=32, text_length=6, t5_length=8,
    pooled_dim=24, base_size=4)
POOL_HEADS = 8
SIZE_FREQ = 256


# ------------------------------------------------------------------ RoPE

def _fill_resize_and_crop(src, tgt: int):
    th, tw = tgt, tgt
    h, w = src
    if h / w > th / tw:
        rh, rw = th, int(round(th / h * w))
    else:
        rw, rh = tw, int(round(tw / w * h))
    top = int(round((th - rh) / 2.0))
    left = int(round((tw - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def hunyuan_image_rope(cfg: HunyuanImageDiTConfig, height: int, width: int):
    """Latent height/width -> cos/sin (HW, head_dim / 2), float32: the
    width positions feed the first half of the table."""
    th, tw = height // cfg.patch_size, width // cfg.patch_size
    start, stop = _fill_resize_and_crop((th, tw), cfg.base_size)
    grid_h = np.linspace(start[0], stop[0], th, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[1], stop[1], tw, endpoint=False, dtype=np.float32)
    dim = cfg.head_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    gw, gh = np.meshgrid(grid_w, grid_h)
    emb_w = gw.reshape(-1)[:, None] * freqs[None]
    emb_h = gh.reshape(-1)[:, None] * freqs[None]
    cos = np.concatenate([np.cos(emb_w), np.cos(emb_h)], axis=1)
    sin = np.concatenate([np.sin(emb_w), np.sin(emb_h)], axis=1)
    return cos.astype(np.float32), sin.astype(np.float32)


@lru_cache(maxsize=8)
def _rope_on(cfg: HunyuanImageDiTConfig, height: int, width: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in hunyuan_image_rope(cfg, height, width))


# ------------------------------------------------------------------ modules

def _pair(din: int, dh: int, dout: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"0": Linear(din, dh, **kw), "2": Linear(dh, dout, **kw)})


class QKVO(nn.Module):
    def __init__(self, d: int, kv_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.to_q = Linear(d, d, **kw)
        self.to_k = Linear(kv_dim, d, **kw)
        self.to_v = Linear(kv_dim, d, **kw)
        self.to_out = Linear(d, d, **kw)


class QKNorm(nn.Module):
    def __init__(self, hd: int, device=None, dtype=None):
        super().__init__()
        self.q_norm = nn.LayerNorm(hd, device=device, dtype=dtype)
        self.k_norm = nn.LayerNorm(hd, device=device, dtype=dtype)


class HunyuanImageBlock(nn.Module):
    def __init__(self, cfg: HunyuanImageDiTConfig, skip: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_dim
        self.norm1 = nn.LayerNorm(d, **kw)
        self.attn1 = QKVO(d, d, **kw)
        self.rota1 = QKNorm(cfg.head_dim, **kw)
        self.norm3 = nn.LayerNorm(d, **kw)
        self.attn2 = QKVO(d, cfg.text_dim, **kw)
        self.rota2 = QKNorm(cfg.head_dim, **kw)
        self.norm2 = nn.LayerNorm(d, **kw)
        self.modulation = nn.ModuleDict({"1": Linear(d, d, **kw)})
        self.mlp = _pair(d, cfg.mlp_dim, d, **kw)
        if skip:
            self.skip_norm = nn.LayerNorm(2 * d, **kw)
            self.skip_linear = Linear(2 * d, d, **kw)


class AttentionPool(nn.Module):
    def __init__(self, cfg: HunyuanImageDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg.t5_dim
        self.positional_embedding = nn.Parameter(torch.empty(cfg.t5_length + 1, c, **kw))
        self.q_proj = Linear(c, c, **kw)
        self.k_proj = Linear(c, c, **kw)
        self.v_proj = Linear(c, c, **kw)
        self.c_proj = Linear(c, cfg.pooled_dim, **kw)


class _Proj(nn.Module):
    def __init__(self, din: int, dout: int, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(din, dout, device=device, dtype=dtype)


class _Mlp(nn.Module):
    def __init__(self, din: int, d: int, device=None, dtype=None):
        super().__init__()
        self.mlp = _pair(din, d, d, device=device, dtype=dtype)


class FinalLayer(nn.Module):
    def __init__(self, cfg: HunyuanImageDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_dim
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(d, 2 * d, **kw)})
        self.linear = Linear(d, cfg.patch_size ** 2 * cfg.out_channels, **kw)


class HunyuanImageDiT(nn.Module):
    """Parameters of HunyuanDiT; `hunyuan_image_dit_forward` runs it."""

    def __init__(self, cfg: HunyuanImageDiTConfig = HUNYUAN_DIT, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_dim
        self.cfg = cfg
        self.text_emb_padding = nn.Parameter(
            torch.empty(cfg.text_length + cfg.t5_length, cfg.text_dim, **kw))
        self.t5_embedder = _pair(cfg.t5_dim, 4 * cfg.t5_dim, cfg.text_dim, **kw)
        self.t5_pooler = AttentionPool(cfg, **kw)
        self.style_embedder = nn.Parameter(torch.empty(d, **kw))
        self.patch_embedder = _Proj(cfg.in_channels * cfg.patch_size ** 2, d, **kw)
        self.timestep_embedder = _Mlp(SIZE_FREQ, d, **kw)
        self.extra_embedder = _pair(SIZE_FREQ * 6 + cfg.pooled_dim + d, 4 * d, d, **kw)
        self.blocks = nn.ModuleList(
            HunyuanImageBlock(cfg, i >= cfg.num_layers_down, **kw)
            for i in range(cfg.num_layers_down + cfg.num_layers_up))
        self.final_layer = FinalLayer(cfg, **kw)


@torch.no_grad()
def init_hunyuan_image_dit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, LayerNorms 1 and 0, the text padding N(0, 0.02^2), the pool's
    position table N(0, 1/t5_dim), the style embedding N(0, 1) (also the
    BERT's tables, N(0, 0.02^2))."""
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod) if mod else model
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(owner, nn.Linear):
            if leaf == "weight":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            else:
                p.zero_()
        elif leaf == "positional_embedding":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
        elif leaf == "style_embedder":
            p.normal_(0.0, 1.0, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


# ------------------------------------------------------------------ forward

def _ln(p: nn.LayerNorm, x, eps: float):
    return layer_norm(x, p.weight, p.bias, eps)


def _heads(x, n: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def hunyuan_image_block(p: HunyuanImageBlock, x, cond, text, cos, sin,
                        cfg: HunyuanImageDiTConfig, skip=None):
    n, eps = cfg.num_heads, cfg.eps
    if skip is not None:
        x = p.skip_linear(_ln(p.skip_norm, torch.cat([x, skip], dim=-1), eps))

    shift = p.modulation["1"](F.silu(cond.float()).to(cond.dtype))[:, None]
    h = _ln(p.norm1, x, eps) + shift
    q = _ln(p.rota1.q_norm, _heads(p.attn1.to_q(h), n), eps)
    k = _ln(p.rota1.k_norm, _heads(p.attn1.to_k(h), n), eps)
    v = _heads(p.attn1.to_v(h), n)
    q = rope_apply_interleaved(q, cos, sin)
    k = rope_apply_interleaved(k, cos, sin)
    x = x + p.attn1.to_out(sdpa(q, k, v).reshape(x.shape))

    h = _ln(p.norm3, x, eps)
    q = _ln(p.rota2.q_norm, _heads(p.attn2.to_q(h), n), eps)
    k = _ln(p.rota2.k_norm, _heads(p.attn2.to_k(text), n), eps)
    v = _heads(p.attn2.to_v(text), n)
    q = rope_apply_interleaved(q, cos, sin)
    x = x + p.attn2.to_out(sdpa(q, k, v).reshape(x.shape))

    h = _ln(p.norm2, x, eps)
    return x + p.mlp["2"](gelu_tanh(p.mlp["0"](h)))


def _attention_pool(p: AttentionPool, x, num_heads: int = POOL_HEADS):
    """The mean token's query over [mean | tokens] + the position table."""
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + p.positional_embedding.to(x.dtype)[None]
    b, s, d = x.shape
    q = _heads(p.q_proj(x[:, :1]), num_heads)
    k = _heads(p.k_proj(x), num_heads)
    v = _heads(p.v_proj(x), num_heads)
    return p.c_proj(sdpa(q, k, v).reshape(b, 1, d))[:, 0]


def _silu32(x):
    return F.silu(x.float()).to(x.dtype)


def hunyuan_image_dit_forward(model: HunyuanImageDiT, hidden_states, text_emb, text_emb_t5,
                              text_emb_mask, text_emb_mask_t5, timestep, size_emb,
                              cos=None, sin=None):
    """hidden_states (B, 4, H, W); text_emb (B, 77, 1024) BERT states;
    text_emb_t5 (B, 256, 2048) mT5 states; masks (B, L) {0, 1}; size_emb
    (B, 6) [w, h, w, h, 0, 0] -> the velocity (B, 4, H, W)."""
    cfg = model.cfg
    dtype = hidden_states.dtype
    b = hidden_states.shape[0]
    height, width = hidden_states.shape[-2:]
    if cos is None:
        cos, sin = _rope_on(cfg, height, width, hidden_states.device)

    t5_proj = model.t5_embedder["2"](_silu32(model.t5_embedder["0"](text_emb_t5)))
    text = torch.cat([text_emb, t5_proj], dim=1)
    mask = torch.cat([text_emb_mask, text_emb_mask_t5], dim=-1) > 0
    text = torch.where(mask[..., None], text, model.text_emb_padding.to(dtype)[None])

    pooled = _attention_pool(model.t5_pooler, text_emb_t5)
    t_emb = sinusoidal_embedding_1d(SIZE_FREQ, timestep.float())
    te = model.timestep_embedder.mlp
    t_emb = te["2"](F.silu(te["0"](t_emb.to(dtype))))
    size = sinusoidal_embedding_1d(SIZE_FREQ, size_emb.float().reshape(-1)).reshape(
        b, 6 * SIZE_FREQ)
    style = model.style_embedder.to(dtype).expand(b, cfg.hidden_dim)
    extra = torch.cat([pooled.to(dtype), size.to(dtype), style], dim=1)
    cond = t_emb + model.extra_embedder["2"](_silu32(model.extra_embedder["0"](extra)))

    ps = cfg.patch_size
    gh, gw = height // ps, width // ps
    patches = hidden_states.reshape(b, cfg.in_channels, gh, ps, gw, ps)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, -1)
    x = model.patch_embedder.proj(patches)

    skips = []
    for i in range(cfg.num_layers_down):
        x = hunyuan_image_block(model.blocks[i], x, cond, text, cos, sin, cfg)
        if i < cfg.num_layers_down - 2:
            skips.append(x)
    for i in range(cfg.num_layers_up):
        x = hunyuan_image_block(model.blocks[cfg.num_layers_down + i], x, cond, text, cos, sin,
                                cfg, skip=skips.pop())

    fl = model.final_layer
    shift, scale = fl.adaLN_modulation["1"](_silu32(cond)).chunk(2, dim=1)
    x = layer_norm(x, eps=cfg.eps) * (1 + scale[:, None]) + shift[:, None]
    x = fl.linear(x)
    x = x.reshape(b, gh, gw, ps, ps, cfg.out_channels)
    x = x.permute(0, 5, 1, 3, 2, 4).reshape(b, cfg.out_channels, height, width)
    return x[:, :cfg.out_channels // 2]


# ------------------------------------------------------------------ converter

def rename_civitai_hunyuan_image(sd: Dict) -> Dict:
    """Raw checkpoint names -> the DiffSynth names (the fused `Wqkv` and
    `kv_proj` read and split)."""
    from .hunyuan_video_dit import _read
    out = {}
    for name, param in sd.items():
        n = (name.replace(".default_modulation.", ".modulation.")
             .replace(".mlp.fc1.", ".mlp.0.").replace(".mlp.fc2.", ".mlp.2.")
             .replace(".attn1.q_norm.", ".rota1.q_norm.")
             .replace(".attn2.q_norm.", ".rota2.q_norm.")
             .replace(".attn1.k_norm.", ".rota1.k_norm.")
             .replace(".attn2.k_norm.", ".rota2.k_norm.")
             .replace(".q_proj.", ".to_q.").replace(".out_proj.", ".to_out.")
             .replace("text_embedding_padding", "text_emb_padding")
             .replace("mlp_t5.0.", "t5_embedder.0.")
             .replace("mlp_t5.2.", "t5_embedder.2.")
             .replace("pooler.", "t5_pooler.")
             .replace("x_embedder.", "patch_embedder.")
             .replace("t_embedder.", "timestep_embedder.")
             .replace("t5_pooler.to_q.", "t5_pooler.q_proj."))
        if ".kv_proj." in n or ".Wqkv." in n:
            param = _read(param)
        if ".kv_proj." in n:
            half = param.shape[0] // 2
            out[n.replace(".kv_proj.", ".to_k.")] = param[:half]
            out[n.replace(".kv_proj.", ".to_v.")] = param[half:]
        elif ".Wqkv." in n:
            third = param.shape[0] // 3
            out[n.replace(".Wqkv.", ".to_q.")] = param[:third]
            out[n.replace(".Wqkv.", ".to_k.")] = param[third:2 * third]
            out[n.replace(".Wqkv.", ".to_v.")] = param[2 * third:]
        elif "style_embedder" in n:
            out["style_embedder"] = param
        else:
            out[n] = param
    return out


def convert_hunyuan_image_dit(sd: Dict, cfg: HunyuanImageDiTConfig = HUNYUAN_DIT) -> Dict:
    """DiffSynth (or raw) state dict -> `HunyuanImageDiT` state dict: the
    patch convolution flattened to a linear over (c, p, q), the style
    embedding to one row; keys the DiT does not hold dropped."""
    if any(".Wqkv." in k or "mlp_t5.0.weight" in k for k in sd):
        sd = rename_civitai_hunyuan_image(sd)
    with torch.device("meta"):
        names = HunyuanImageDiT(cfg).state_dict().keys()
    out = {}
    for name in names:
        if name == "patch_embedder.proj.weight":
            w = sd[name]
            out[name] = w.reshape(w.shape[0], w.shape.numel() // w.shape[0])
        elif name == "style_embedder":
            out[name] = sd[name].reshape(cfg.hidden_dim)
        else:
            out[name] = sd[name]
    return out


# ------------------------------------------------------------------ BERT

@dataclass(frozen=True)
class HunyuanBertConfig:
    vocab: int = 47020
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


HUNYUAN_BERT = HunyuanBertConfig()
HUNYUAN_BERT_TINY = HunyuanBertConfig(vocab=128, dim=24, num_layers=2, num_heads=2,
                                      ffn_dim=48, max_positions=80)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int, ln: bool, eps: float, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(din, dout, device=device, dtype=dtype)
        if ln:
            self.LayerNorm = nn.LayerNorm(dout, eps=eps, device=device, dtype=dtype)


class _SelfAttn(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.query = Linear(d, d, **kw)
        self.key = Linear(d, d, **kw)
        self.value = Linear(d, d, **kw)


class _BertAttention(nn.Module):
    def __init__(self, cfg: HunyuanBertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        setattr(self, "self", _SelfAttn(cfg.dim, **kw))
        self.output = _Dense(cfg.dim, cfg.dim, True, cfg.eps, **kw)


class BertLayer(nn.Module):
    def __init__(self, cfg: HunyuanBertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = _BertAttention(cfg, **kw)
        self.intermediate = _Dense(cfg.dim, cfg.ffn_dim, False, cfg.eps, **kw)
        self.output = _Dense(cfg.ffn_dim, cfg.dim, True, cfg.eps, **kw)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: HunyuanBertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(cfg.vocab, cfg.dim, **kw)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.dim, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.dim, **kw)
        self.LayerNorm = nn.LayerNorm(cfg.dim, eps=cfg.eps, **kw)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: HunyuanBertConfig, device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, device=device, dtype=dtype)
                                   for _ in range(cfg.num_layers))


class HunyuanBert(nn.Module):
    """The Chinese CLIP-BERT tower (Hugging Face `BertModel` names, no
    pooler)."""

    def __init__(self, cfg: HunyuanBertConfig = HUNYUAN_BERT, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _BertEmbeddings(cfg, device=device, dtype=dtype)
        self.encoder = _BertEncoder(cfg, device=device, dtype=dtype)


def hunyuan_bert_forward(model: HunyuanBert, input_ids, attention_mask, clip_skip: int = 1):
    """input_ids, attention_mask (B, S) -> hidden_states[-clip_skip] (B, S,
    dim); with clip_skip > 1 the picked state is brought to the last
    state's mean and std (over every element, std with ddof 1)."""
    cfg = model.cfg
    e = model.embeddings
    s = input_ids.shape[1]
    x = (e.word_embeddings.weight[input_ids.long()] + e.position_embeddings.weight[:s]
         + e.token_type_embeddings.weight[0])
    x = _ln(e.LayerNorm, x, cfg.eps)
    bias = ((1.0 - attention_mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
    states = [x]
    for p in model.encoder.layer:
        a = getattr(p.attention, "self")
        q = _heads(a.query(x), cfg.num_heads)
        k = _heads(a.key(x), cfg.num_heads)
        v = _heads(a.value(x), cfg.num_heads)
        att = sdpa(q, k, v, bias=bias).reshape(x.shape)
        x = _ln(p.attention.output.LayerNorm, p.attention.output.dense(att) + x, cfg.eps)
        h = p.output.dense(F.gelu(p.intermediate.dense(x).float()).to(x.dtype))
        x = _ln(p.output.LayerNorm, h + x, cfg.eps)
        states.append(x)
    emb = states[-clip_skip]
    if clip_skip > 1:
        last, embf = states[-1].float(), emb.float()
        emb = ((embf - embf.mean()) / embf.std(correction=1) * last.std(correction=1)
               + last.mean()).to(emb.dtype)
    return emb


def convert_hunyuan_bert(sd: Dict, cfg: HunyuanBertConfig = HUNYUAN_BERT) -> Dict:
    """Hugging Face `BertModel` state dict (optionally under `bert.`) ->
    `HunyuanBert` state dict: the embeddings and the first
    `cfg.num_layers` layers; the pooler and other heads dropped."""
    sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    with torch.device("meta"):
        names = HunyuanBert(cfg).state_dict().keys()
    return {n: sd[n] for n in names}
