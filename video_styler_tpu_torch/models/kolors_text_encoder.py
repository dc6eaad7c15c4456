"""Kolors' text encoder, ChatGLM3-6B, in PyTorch.

Counterpart of `video_styler_tpu/models/kolors_text_encoder.py`: 28 GLM
decoder layers of 4096 wide: RMSNorm, a fused multi-query qkv (32 query
heads of 128, 2 key/value groups, with a bias), a rotary embedding on the
first half of each head in interleaved pairs, the exact `sdpa` under a
causal and padding mask (256 tokens: no Pallas kernel in JAX either), and a
SwiGLU MLP (13,696 wide). `kolors_encode` returns the state `clip_skip`
layers before the end (no final norm) and the last token of the last
state as the pooled embedding, as the reference's Kolors prompter takes
them. Parameters keep the reference's (HF) names, so its state dict loads
as it is (`convert_chatglm` drops the buffers that are not weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .wan_dit import Linear


@dataclass(frozen=True)
class ChatGLMConfig:
    hidden_size: int = 4096
    ffn_hidden_size: int = 13696
    num_layers: int = 28
    num_heads: int = 32
    kv_channels: int = 128
    multi_query_group_num: int = 2
    padded_vocab_size: int = 65024
    layernorm_epsilon: float = 1e-5
    seq_length: int = 32768
    add_qkv_bias: bool = True


CHATGLM3_6B = ChatGLMConfig()
CHATGLM_TINY = ChatGLMConfig(hidden_size=32, ffn_hidden_size=48, num_layers=2, num_heads=4,
                             kv_channels=8, multi_query_group_num=2, padded_vocab_size=64,
                             seq_length=64)
KOLORS_TOKENS = 256


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: ChatGLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n, hd, g = cfg.num_heads, cfg.kv_channels, cfg.multi_query_group_num
        self.query_key_value = Linear(cfg.hidden_size, (n + 2 * g) * hd,
                                      bias=cfg.add_qkv_bias, **kw)
        self.dense = Linear(n * hd, cfg.hidden_size, bias=False, **kw)


class MLP(nn.Module):
    def __init__(self, cfg: ChatGLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dense_h_to_4h = Linear(cfg.hidden_size, 2 * cfg.ffn_hidden_size, bias=False, **kw)
        self.dense_4h_to_h = Linear(cfg.ffn_hidden_size, cfg.hidden_size, bias=False, **kw)


class GLMBlock(nn.Module):
    def __init__(self, cfg: ChatGLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, **kw)
        self.self_attention = SelfAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **kw)
        self.mlp = MLP(cfg, **kw)


class Embedding(nn.Module):
    def __init__(self, cfg: ChatGLMConfig, device=None, dtype=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size, cfg.hidden_size,
                                            device=device, dtype=dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: ChatGLMConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(GLMBlock(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))
        self.final_layernorm = RMSNorm(cfg.hidden_size, device=device, dtype=dtype)


class ChatGLM(nn.Module):
    def __init__(self, cfg: ChatGLMConfig = CHATGLM3_6B, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = Embedding(cfg, device=device, dtype=dtype)
        self.encoder = Encoder(cfg, device=device, dtype=dtype)


def chatglm_rope_cache(cfg: ChatGLMConfig, seq_len: int) -> np.ndarray:
    """(seq, rot/4, 2) cos/sin: the rotary width is kv_channels/2."""
    n_elem = cfg.kv_channels // 2
    theta = 1.0 / (10000.0 ** (np.arange(0, n_elem, 2, dtype=np.float32) / n_elem))
    idx = np.arange(seq_len, dtype=np.float32)[:, None] * theta[None]
    return np.stack([np.cos(idx), np.sin(idx)], axis=-1).astype(np.float32)


def _apply_rotary(x, cache):
    """x (B, S, N, D); cache (S, D/4, 2): interleaved pairs of the first D/2
    rotated in fp32, the rest passed through."""
    b, s, n, _ = x.shape
    rot = cache.shape[-2] * 2
    xr = x[..., :rot].reshape(b, s, n, rot // 2, 2).float()
    cos, sin = cache[None, :, None, :, 0], cache[None, :, None, :, 1]
    out = torch.stack([xr[..., 0] * cos - xr[..., 1] * sin,
                       xr[..., 1] * cos + xr[..., 0] * sin], dim=-1)
    return torch.cat([out.reshape(b, s, n, rot).to(x.dtype), x[..., rot:]], dim=-1)


def _rms(p: RMSNorm, x, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p.weight.float()).to(x.dtype)


def glm_block(p: GLMBlock, x, cache, mask, cfg: ChatGLMConfig):
    b, s, _ = x.shape
    n, hd, g = cfg.num_heads, cfg.kv_channels, cfg.multi_query_group_num
    qkv = p.self_attention.query_key_value(_rms(p.input_layernorm, x, cfg.layernorm_epsilon))
    q = _apply_rotary(qkv[..., :n * hd].reshape(b, s, n, hd), cache)
    k = _apply_rotary(qkv[..., n * hd:(n + g) * hd].reshape(b, s, g, hd), cache)
    v = qkv[..., (n + g) * hd:].reshape(b, s, g, hd)
    k = k.repeat_interleave(n // g, dim=2)
    v = v.repeat_interleave(n // g, dim=2)
    x = x + p.self_attention.dense(sdpa(q, k, v, bias=mask).reshape(b, s, n * hd))
    gate, up = p.mlp.dense_h_to_4h(_rms(p.post_attention_layernorm, x,
                                        cfg.layernorm_epsilon)).chunk(2, dim=-1)
    return x + p.mlp.dense_4h_to_h(F.silu(gate) * up)


def full_attention_mask(attention_mask: np.ndarray) -> np.ndarray:
    """Causal times padding, {0, 1} (B, S, S), 1 = attend; a padded query's
    row is all ones (the reference's `-= pad - 1`)."""
    b, s = attention_mask.shape
    full = np.tril(np.ones((b, s, s), np.float32)) * attention_mask[:, None, :]
    full -= attention_mask[:, :, None] - 1
    return (full >= 0.5).astype(np.float32)


def chatglm_forward(model: ChatGLM, input_ids, attention_mask=None):
    """-> [the embedding, the state after each layer] (the last one without
    the final norm, as the reference records it)."""
    cfg = model.cfg
    b, s = input_ids.shape
    dev = input_ids.device
    cache = torch.from_numpy(chatglm_rope_cache(cfg, s)).to(dev)
    am = (np.ones((b, s), np.float32) if attention_mask is None
          else np.asarray(attention_mask, np.float32))
    mask = torch.from_numpy(np.where(full_attention_mask(am) > 0, 0.0, -np.inf)[:, None]
                            .astype(np.float32)).to(dev)
    x = model.embedding.word_embeddings.weight[input_ids.long()]
    states = [x]
    for p in model.encoder.layers:
        x = glm_block(p, x, cache, mask, cfg)
        states.append(x)
    return states


def kolors_encode(model: ChatGLM, input_ids, attention_mask=None, clip_skip: int = 2):
    """-> (prompt_emb (B, L, H), pooled (B, H) the last token of the last
    state)."""
    states = chatglm_forward(model, input_ids, attention_mask)
    return states[-clip_skip], states[-1][:, -1]


def convert_chatglm(sd: Dict) -> Dict:
    """A ChatGLM state dict (HF names, `transformer.` prefix or none) -> the
    port's: the same names, without the rotary buffer and the LM head."""
    out = {}
    for k, v in sd.items():
        k = k[len("transformer."):] if k.startswith("transformer.") else k
        if k.startswith(("embedding.", "encoder.")):
            out[k] = v
    return out


@torch.no_grad()
def init_chatglm_(model: ChatGLM, generator: torch.Generator) -> ChatGLM:
    """Linear weights N(0, 1/in), qkv biases N(0, 0.02^2), RMSNorm weights
    1 + N(0, 0.1^2), word embeddings N(0, 0.02^2)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / np.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, RMSNorm):
            m.weight.normal_(1.0, 0.1, generator=generator)
    model.embedding.word_embeddings.weight.normal_(0.0, 0.02, generator=generator)
    return model
