"""Decoder-only LLM tower (LLaMA / Qwen2 family) in PyTorch.

Counterpart of `video_styler_tpu/models/llm_decoder.py`: RMSNorm -> GQA
attention with RoPE (q/k/v biases for Qwen, none for LLaMA) -> residual ->
RMSNorm -> SwiGLU MLP -> residual, with an optional early stop
(`stop_skip_layers`: HunyuanVideo's LLaMA encoder returns the hidden states
of an earlier layer, without the final norm) and Qwen2.5-VL's multimodal
RoPE (three position streams, `mrope_tables`). Parameters live in an
`nn.Module` named after the JAX tree (`embed`, `blocks.{i}.q`, ...,
`final_ln.scale`); `convert_decoder_lm` reads HF names into it.

The attention is exact, as in JAX (no Pallas kernel there): fp32 logits and
softmax over repeated k/v heads through `ops.attention.sdpa`, under an
additive causal bias and, with an attention mask, a bias on the pad keys.
RoPE tables come from float64 numpy, then float32 (standard RoPE), or are
computed in float32 on the host (multimodal RoPE, as JAX computes them);
the rotation runs in fp32 and casts back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import rms_norm, silu
from .wan_dit import Linear, RMSNorm


@dataclass(frozen=True)
class DecoderLMConfig:
    vocab_size: int
    hidden: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    ffn: int
    rope_theta: float = 10000.0
    eps: float = 1e-5
    qkv_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


# llava-llama-3-8b's text tower (HunyuanVideo)
LLAMA3_8B = DecoderLMConfig(vocab_size=128320, hidden=4096, num_layers=32,
                            num_heads=32, num_kv_heads=8, ffn=14336,
                            rope_theta=500000.0, eps=1e-5, qkv_bias=False)
# Qwen2.5-VL-7B's text tower (Qwen-Image, Step1x)
QWEN25_VL_7B_TEXT = DecoderLMConfig(vocab_size=152064, hidden=3584,
                                    num_layers=28, num_heads=28,
                                    num_kv_heads=4, ffn=18944,
                                    rope_theta=1000000.0, eps=1e-6,
                                    qkv_bias=True)
DECODER_LM_TINY = DecoderLMConfig(vocab_size=128, hidden=64, num_layers=2,
                                  num_heads=4, num_kv_heads=2, ffn=128,
                                  rope_theta=10000.0, eps=1e-5, qkv_bias=True)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        kv = cfg.num_kv_heads * cfg.head_dim
        self.input_ln = RMSNorm(cfg.hidden, **kw)
        self.post_ln = RMSNorm(cfg.hidden, **kw)
        self.q = Linear(cfg.hidden, cfg.hidden, bias=cfg.qkv_bias, **kw)
        self.k = Linear(cfg.hidden, kv, bias=cfg.qkv_bias, **kw)
        self.v = Linear(cfg.hidden, kv, bias=cfg.qkv_bias, **kw)
        self.o = Linear(cfg.hidden, cfg.hidden, bias=False, **kw)
        self.gate = Linear(cfg.hidden, cfg.ffn, bias=False, **kw)
        self.up = Linear(cfg.hidden, cfg.ffn, bias=False, **kw)
        self.down = Linear(cfg.ffn, cfg.hidden, bias=False, **kw)


class DecoderLM(nn.Module):
    """Parameters of the decoder stack; `decoder_lm_forward` runs it."""

    def __init__(self, cfg: DecoderLMConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden, device=device,
                                              dtype=dtype))
        self.blocks = nn.ModuleList(DecoderBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.hidden, device=device, dtype=dtype)


@torch.no_grad()
def init_linears_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, RMSNorm scales 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
    return model


@torch.no_grad()
def init_decoder_lm_(model: DecoderLM, generator: torch.Generator) -> DecoderLM:
    """`init_linears_`, and the token table N(0, 0.02^2)."""
    model.embed.normal_(0.0, 0.02, generator=generator)
    return init_linears_(model, generator)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def _inv_freq(cfg: DecoderLMConfig) -> np.ndarray:
    return 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64)
                                     / cfg.head_dim))


@lru_cache(maxsize=16)
def _rope_tables(cfg: DecoderLMConfig, length: int, device: torch.device):
    freqs = np.outer(np.arange(length, dtype=np.float64), _inv_freq(cfg))
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))


def rope_tables(cfg: DecoderLMConfig, length: int, device=None):
    """HF-style rotary tables: (L, head_dim) cos/sin, float32 from float64
    math, half-split layout."""
    return _rope_tables(cfg, length, torch.device(device or "cpu"))


def mrope_tables(cfg: DecoderLMConfig, position_ids, mrope_section, device=None):
    """Qwen2.5-VL multimodal RoPE: position_ids (3, L) t/h/w streams ->
    (L, head_dim) cos/sin, channel piece i taken from stream i % 3 (the
    sections doubled). float32 on the host, as JAX computes it."""
    inv = _inv_freq(cfg).astype(np.float32)
    pos = np.asarray(position_ids, np.float32)
    freqs = pos[..., None] * inv
    emb = np.concatenate([freqs, freqs], axis=-1)
    cos3, sin3 = np.cos(emb), np.sin(emb)
    secs = list(mrope_section) * 2
    bounds = np.cumsum([0] + secs)
    cos = np.concatenate([cos3[i % 3, :, bounds[i]:bounds[i + 1]] for i in range(len(secs))],
                         axis=-1)
    sin = np.concatenate([sin3[i % 3, :, bounds[i]:bounds[i + 1]] for i in range(len(secs))],
                         axis=-1)
    dev = torch.device(device or "cpu")
    return (torch.from_numpy(np.ascontiguousarray(cos, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sin, np.float32)).to(dev))


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x, cos, sin):
    """x (B, L, H, D); cos/sin (L, D). fp32 rotation, cast back."""
    xf = x.float()
    out = xf * cos[None, :, None, :] + rotate_half(xf) * sin[None, :, None, :]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def gqa_attention(q, k, v, bias):
    """q (B, L, H, D), k/v (B, L, Hkv, D), bias (B or 1, 1, L, L) fp32."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    return sdpa(q, k, v, bias=bias)


def decoder_block(p: DecoderBlock, x, cos, sin, bias, cfg: DecoderLMConfig):
    b, l, _ = x.shape
    h = rms_norm(x, p.input_ln.scale, cfg.eps)
    q = p.q(h).view(b, l, cfg.num_heads, cfg.head_dim)
    k = p.k(h).view(b, l, cfg.num_kv_heads, cfg.head_dim)
    v = p.v(h).view(b, l, cfg.num_kv_heads, cfg.head_dim)
    attn = gqa_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, bias)
    x = x + p.o(attn.reshape(b, l, cfg.hidden))
    h = rms_norm(x, p.post_ln.scale, cfg.eps)
    return x + p.down(silu(p.gate(h)) * p.up(h))


def causal_bias(length: int, attention_mask=None, device=None):
    """(1 or B, 1, L, L) fp32: -inf above the diagonal and, where
    `attention_mask` (B, L) is 0, on that key's column."""
    bias = torch.full((length, length), float("-inf"), device=device).triu(1)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask[:, None, None, :].to(device) > 0, 0.0, float("-inf"))
        bias = bias + pad
    return bias


def decoder_lm_forward(model: DecoderLM, input_ids, attention_mask=None,
                       stop_skip_layers: int = 0, final_norm: bool = True,
                       inputs_embeds=None, position_ids=None, mrope_section=None):
    """Hidden states (B, L, hidden) of the decoder stack.

    stop_skip_layers: run num_layers - stop_skip_layers layers and return
    without the final norm (HunyuanVideo's `hidden_state_skip_layer`).
    final_norm: the end RMSNorm (Qwen's hidden_states[-1]).
    inputs_embeds replaces the token embedding (vision tokens injected);
    position_ids (3, L) with mrope_section selects the multimodal RoPE."""
    cfg = model.cfg
    l = input_ids.shape[1]
    x = inputs_embeds if inputs_embeds is not None else model.embed[input_ids]
    dev = x.device
    if position_ids is not None and mrope_section is not None:
        cos, sin = mrope_tables(cfg, position_ids, mrope_section, dev)
    else:
        cos, sin = rope_tables(cfg, l, dev)
    bias = causal_bias(l, attention_mask, dev)
    n_run = cfg.num_layers - stop_skip_layers if stop_skip_layers else cfg.num_layers
    for p in list(model.blocks)[:n_run]:
        x = decoder_block(p, x, cos, sin, bias, cfg)
    if final_norm and stop_skip_layers == 0:
        x = rms_norm(x, model.final_ln.scale, cfg.eps)
    return x


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def _strip_prefix(sd: Dict) -> Dict:
    """HF key prefixes -> bare names: model.language_model. / model. / none."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.language_model.", "language_model.model.",
                    "language_model.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def detect_decoder_lm_config(sd: Dict, family: str = "llama") -> DecoderLMConfig:
    """The architecture from the state dict's shapes (head dim 128 across the
    Llama-3 / Qwen2.5 families); `family` picks theta, eps and biases."""
    sd = _strip_prefix(sd)
    vocab, hidden = sd["embed_tokens.weight"].shape
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    kv_dim = sd["layers.0.self_attn.k_proj.weight"].shape[0]
    ffn = sd["layers.0.mlp.gate_proj.weight"].shape[0]
    head_dim = 128
    if family == "qwen":
        return DecoderLMConfig(vocab_size=vocab, hidden=hidden, num_layers=n_layers,
                               num_heads=hidden // head_dim, num_kv_heads=kv_dim // head_dim,
                               ffn=ffn, rope_theta=1000000.0, eps=1e-6, qkv_bias=True)
    return DecoderLMConfig(vocab_size=vocab, hidden=hidden, num_layers=n_layers,
                           num_heads=hidden // head_dim, num_kv_heads=kv_dim // head_dim,
                           ffn=ffn, rope_theta=500000.0, eps=1e-5, qkv_bias=False)


_BLOCK_NAMES = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"), ("down", "mlp.down_proj"))


def convert_decoder_lm(sd: Dict, cfg: DecoderLMConfig) -> Dict:
    """An HF Llama / Qwen2(-VL text) state dict -> the `DecoderLM` state
    dict. Values pass through (tensors or lazy checkpoint tensors)."""
    sd = _strip_prefix(sd)
    out = {"embed": sd["embed_tokens.weight"], "final_ln.scale": sd["norm.weight"]}
    for i in range(cfg.num_layers):
        b, src = f"blocks.{i}", f"layers.{i}"
        out[f"{b}.input_ln.scale"] = sd[f"{src}.input_layernorm.weight"]
        out[f"{b}.post_ln.scale"] = sd[f"{src}.post_attention_layernorm.weight"]
        for dst, name in _BLOCK_NAMES:
            out[f"{b}.{dst}.weight"] = sd[f"{src}.{name}.weight"]
            if cfg.qkv_bias and dst in ("q", "k", "v"):
                out[f"{b}.{dst}.bias"] = sd[f"{src}.{name}.bias"]
    return out
