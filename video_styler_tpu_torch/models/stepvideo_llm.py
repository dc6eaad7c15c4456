"""The Step-1 LLM (StepVideo's 6144-wide caption tower) in PyTorch.

Counterpart of `video_styler_tpu/models/stepvideo_llm.py`: a decoder with
no position embedding at all, grouped-query attention (48 query heads over
8 shared key/value heads, the groups repeat-interleaved) through one fused
`wqkv`, causal under an exact fp32 softmax (the padding mask is not applied
here: the DiT's cross-attention takes it), a SwiGLU FFN whose SiLU is
taken in fp32, RMSNorm, and no final norm. The attention is no Pallas
kernel in the JAX package either.

Parameters keep the reference's names under `transformer.layers.{i}`
(`attention.wqkv`, `feed_forward.w1`, ...) and
`tok_embeddings.word_embeddings` (kept fp32, as in JAX).
`make_stepchat_tokenize` imports `sentencepiece` when called.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import rms_norm
from .wan_dit import Linear


@dataclass(frozen=True)
class Step1LLMConfig:
    hidden_size: int = 6144
    num_heads: int = 48
    num_groups: int = 8          # the shared key/value heads
    ffn_hidden: int = 16384
    num_layers: int = 48
    vocab_size: int = 65536
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


STEP1_LLM = Step1LLMConfig()
STEP1_LLM_TINY = Step1LLMConfig(hidden_size=32, num_heads=4, num_groups=2,
                                ffn_hidden=512, num_layers=2, vocab_size=64)


class _Weight(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class _Attention(nn.Module):
    def __init__(self, cfg: Step1LLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d = cfg.hidden_size
        self.wqkv = Linear(d, d + 2 * cfg.head_dim * cfg.num_groups, **kw)
        self.wo = Linear(d, d, **kw)


class _FFN(nn.Module):
    def __init__(self, cfg: Step1LLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.w1 = Linear(cfg.hidden_size, 2 * cfg.ffn_hidden, **kw)
        self.w2 = Linear(cfg.ffn_hidden, cfg.hidden_size, **kw)


class Step1Block(nn.Module):
    def __init__(self, cfg: Step1LLMConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention_norm = _Weight(cfg.hidden_size, **kw)
        self.attention = _Attention(cfg, **kw)
        self.ffn_norm = _Weight(cfg.hidden_size, **kw)
        self.feed_forward = _FFN(cfg, **kw)


class _Layers(nn.Module):
    def __init__(self, cfg: Step1LLMConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(Step1Block(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))


class _Embeddings(nn.Module):
    def __init__(self, cfg: Step1LLMConfig, device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                            dtype=torch.float32)


class Step1LLM(nn.Module):
    """Parameters of the Step-1 LLM (the word table fp32 whatever `dtype`);
    `step1_llm_forward` runs it."""

    def __init__(self, cfg: Step1LLMConfig = STEP1_LLM, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = _Embeddings(cfg, device=device)
        self.transformer = _Layers(cfg, device=device, dtype=dtype)


@torch.no_grad()
def init_step1_llm_(model: Step1LLM, generator: torch.Generator) -> Step1LLM:
    """Random init with the JAX package's std: linears N(0, 1/in), norms 1,
    the word table N(0, 0.02^2)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
        elif isinstance(m, _Weight):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
    return model


def _causal_attention(q, k, v):
    """(B, S, H, D) causal attention, fp32 logits and softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = q.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(v.dtype)


def step1_block(p: Step1Block, x, cfg: Step1LLMConfig):
    b, s, d = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p.attention_norm.weight, cfg.eps)
    qkv = p.attention.wqkv(h)
    q = qkv[..., :d].reshape(b, s, cfg.num_heads, hd)
    k, v = qkv[..., d:].reshape(b, s, cfg.num_groups, 2 * hd).chunk(2, dim=-1)
    rep = cfg.num_heads // cfg.num_groups
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    x = x + p.attention.wo(_causal_attention(q, k, v).reshape(b, s, d))
    h = p.feed_forward.w1(rms_norm(x, p.ffn_norm.weight, cfg.eps))
    a, g = h.chunk(2, dim=-1)
    return x + p.feed_forward.w2(F.silu(a.float()).to(g.dtype) * g)


def step1_llm_forward(model: Step1LLM, input_ids):
    """input_ids (B, S) -> hidden states (B, S, hidden), no final norm."""
    dtype = model.transformer.layers[0].attention.wo.weight.dtype
    x = model.tok_embeddings.word_embeddings.weight[input_ids.long()].to(dtype)
    for p in model.transformer.layers:
        x = step1_block(p, x, model.cfg)
    return x


def convert_step1_llm(sd: Dict, cfg: Step1LLMConfig = STEP1_LLM) -> Dict:
    """The reference Step1Model state dict -> `Step1LLM` state dict: its
    first `cfg.num_layers` layers and the word table; other keys dropped."""
    with torch.device("meta"):
        names = Step1LLM(cfg).state_dict().keys()
    return {n: sd[n] for n in names}


def make_stepchat_tokenize(model_file: str):
    """The StepChat sentencepiece tokenizer as a callable(prompt,
    max_length) -> (ids (1, S), mask (1, S)): [BOS=1] + ids[:max - 2] +
    [EOS=2], right-padded with PAD=2."""
    import sentencepiece
    sp = sentencepiece.SentencePieceProcessor(model_file=model_file)
    bos, eos, pad = 1, 2, 2

    def tokenize(prompt: str, max_length: int):
        ids = [bos] + list(sp.encode_as_ids(prompt))[:max_length - 2] + [eos]
        n = len(ids)
        return (np.asarray([ids + [pad] * (max_length - n)], np.int64),
                np.asarray([[1] * n + [0] * (max_length - n)], np.int64))

    return tokenize


def stub_stepchat_tokenize(vocab: int):
    """A deterministic stand-in for `make_stepchat_tokenize`'s callable: one
    id per word (crc32) between BOS and EOS, the same framing and padding."""
    import zlib

    def tokenize(prompt: str, max_length: int):
        words = [3 + zlib.crc32(w.encode()) % (vocab - 3) for w in prompt.split()]
        ids = [1] + words[:max_length - 2] + [2]
        n = len(ids)
        return (np.asarray([ids + [2] * (max_length - n)], np.int64),
                np.asarray([[1] * n + [0] * (max_length - n)], np.int64))

    return tokenize
