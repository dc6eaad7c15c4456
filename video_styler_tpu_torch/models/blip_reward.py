"""BLIP reward tower for ImageReward, in PyTorch.

Counterpart of `video_styler_tpu/models/blip_reward.py`: a timm-style
ViT-L/16 image encoder, a BERT-base text encoder whose every layer
cross-attends to the image tokens (BLIP "multimodal" mode), and the
5-layer reward MLP over the [CLS] text state, z-scored with the published
mean and std. Modules are named after the JAX pytree, so
`convert.from_jax_params` carries a JAX tree across. Attention is the
exact-softmax `ops.attention.sdpa`, as there. fp32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .clip_dual import _ln, _lin, _load, _t
from .wan_dit import LayerNormAffine, Linear


@dataclass(frozen=True)
class BlipRewardConfig:
    # ViT (vit='large', image_size=224, blip_pretrain.py:33)
    image_size: int = 224
    patch_size: int = 16
    vit_dim: int = 1024
    vit_layers: int = 24
    vit_heads: int = 16
    vit_eps: float = 1e-6
    # BERT (med_config: bert-base + cross attention)
    text_dim: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_ffn: int = 3072
    vocab_size: int = 30524
    max_pos: int = 512
    bert_eps: float = 1e-12
    # reward head z-score (imagereward.py:63-64)
    mean: float = 0.16717362830052426
    std: float = 1.0333394966054072


IMAGE_REWARD = BlipRewardConfig()
BLIP_REWARD_TINY = BlipRewardConfig(
    image_size=32, patch_size=16, vit_dim=32, vit_layers=2, vit_heads=2, text_dim=24,
    text_layers=2, text_heads=2, text_ffn=48, vocab_size=64, max_pos=16)
MLP_DIMS = (1024, 128, 64, 16, 1)  # the reward head after the text width


class VitBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNormAffine(dim, **kw)
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.ln2 = LayerNormAffine(dim, **kw)
        self.fc1 = Linear(dim, 4 * dim, **kw)
        self.fc2 = Linear(4 * dim, dim, **kw)


class BlipVit(nn.Module):
    def __init__(self, cfg: BlipRewardConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, g = cfg.vit_dim, cfg.image_size // cfg.patch_size
        self.patch = Linear(3 * cfg.patch_size ** 2, d, **kw)
        self.cls = nn.Parameter(torch.zeros(d, **kw))
        self.pos = nn.Parameter(torch.zeros(g * g + 1, d, **kw))
        self.norm = LayerNormAffine(d, **kw)
        self.blocks = nn.ModuleList(VitBlock(d, **kw) for _ in range(cfg.vit_layers))


class BertAttention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = Linear(dim, dim, **kw)
        self.k = Linear(kv_dim, dim, **kw)
        self.v = Linear(kv_dim, dim, **kw)
        self.out = Linear(dim, dim, **kw)
        self.out_ln = LayerNormAffine(dim, **kw)


class BertLayer(nn.Module):
    def __init__(self, cfg: BlipRewardConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.add_module("self", BertAttention(cfg.text_dim, cfg.text_dim, **kw))
        self.cross = BertAttention(cfg.text_dim, cfg.vit_dim, **kw)
        self.fc1 = Linear(cfg.text_dim, cfg.text_ffn, **kw)
        self.fc2 = Linear(cfg.text_ffn, cfg.text_dim, **kw)
        self.out_ln = LayerNormAffine(cfg.text_dim, **kw)


class BlipBert(nn.Module):
    def __init__(self, cfg: BlipRewardConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tok_emb = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.text_dim, **kw))
        self.pos_emb = nn.Parameter(torch.zeros(cfg.max_pos, cfg.text_dim, **kw))
        self.emb_ln = LayerNormAffine(cfg.text_dim, **kw)
        self.blocks = nn.ModuleList(BertLayer(cfg, **kw) for _ in range(cfg.text_layers))


class BlipReward(nn.Module):
    def __init__(self, cfg: BlipRewardConfig = IMAGE_REWARD, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vit = BlipVit(cfg, **kw)
        self.bert = BlipBert(cfg, **kw)
        dims = (cfg.text_dim,) + MLP_DIMS
        self.mlp = nn.ModuleList(Linear(a, b, **kw) for a, b in zip(dims[:-1], dims[1:]))


def blip_vit_forward(params: BlipReward, cfg: BlipRewardConfig, pixel_values):
    """(B, 3, H, W) CLIP-normalised -> image tokens (B, 1+P, vit_dim)."""
    p = params.vit
    b, ps, g = pixel_values.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
    patches = pixel_values.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = p.patch(patches.reshape(b, g * g, -1))
    x = torch.cat([p.cls.to(x.dtype).expand(b, 1, cfg.vit_dim), x], dim=1) + p.pos.to(x.dtype)
    d, nh = cfg.vit_dim, cfg.vit_heads
    s = x.shape[1]
    for blk in p.blocks:
        h = layer_norm(x, blk.ln1.scale, blk.ln1.bias, cfg.vit_eps)
        q, k, v = blk.qkv(h).chunk(3, dim=-1)
        a = sdpa(q.reshape(b, s, nh, d // nh), k.reshape(b, s, nh, d // nh),
                 v.reshape(b, s, nh, d // nh)).reshape(b, s, d)
        x = x + blk.proj(a)
        h = layer_norm(x, blk.ln2.scale, blk.ln2.bias, cfg.vit_eps)
        x = x + blk.fc2(F.gelu(blk.fc1(h)))
    return layer_norm(x, p.norm.scale, p.norm.bias, cfg.vit_eps)


def _bert_attn(p: BertAttention, x, kv_input, cfg: BlipRewardConfig, mask=None):
    b, s, d = x.shape
    nh, hd = cfg.text_heads, cfg.text_dim // cfg.text_heads
    q = p.q(x).reshape(b, s, nh, hd)
    k = p.k(kv_input).reshape(b, kv_input.shape[1], nh, hd)
    v = p.v(kv_input).reshape(b, kv_input.shape[1], nh, hd)
    a = sdpa(q, k, v, bias=mask).reshape(b, s, d)
    return layer_norm(p.out(a) + x, p.out_ln.scale, p.out_ln.bias, cfg.bert_eps)


def blip_bert_forward(params: BlipReward, cfg: BlipRewardConfig, input_ids, attention_mask,
                      encoder_hidden_states):
    """BLIP multimodal text encoder: every layer is self-attention, then
    cross-attention to the image tokens, then the FFN, post-LN residuals."""
    p = params.bert
    dev = p.tok_emb.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    s = input_ids.shape[1]
    x = layer_norm(p.tok_emb[input_ids] + p.pos_emb[:s], p.emb_ln.scale, p.emb_ln.bias,
                   cfg.bert_eps)
    # HF extended mask: (1 - m) * -10000 on key positions
    am = torch.as_tensor(attention_mask, device=dev).float()
    mask = ((1.0 - am) * -10000.0)[:, None, None, :]
    for blk in p.blocks:
        x = _bert_attn(getattr(blk, "self"), x, x, cfg, mask=mask)
        x = _bert_attn(blk.cross, x, encoder_hidden_states, cfg)
        x = layer_norm(blk.fc2(F.gelu(blk.fc1(x))) + x, blk.out_ln.scale, blk.out_ln.bias,
                       cfg.bert_eps)
    return x


def image_reward_forward(params: BlipReward, cfg: BlipRewardConfig, pixel_values, input_ids,
                         attention_mask):
    """The ImageReward score path (imagereward.py:66-90): z-scored reward
    (B,)."""
    image_embeds = blip_vit_forward(params, cfg, pixel_values)
    x = blip_bert_forward(params, cfg, input_ids, attention_mask, image_embeds)[:, 0]
    for lp in params.mlp:
        x = lp(x)
    return (x[..., 0] - cfg.mean) / cfg.std


def convert_image_reward(state_dict, cfg: BlipRewardConfig = IMAGE_REWARD,
                         device=None) -> BlipReward:
    """ImageReward checkpoint (blip.visual_encoder.* / blip.text_encoder.* /
    mlp.layers.*) -> `BlipReward` on `device` (the card unless "cpu")."""
    sd = dict(state_dict)
    v, t = "blip.visual_encoder", "blip.text_encoder"
    conv = _t(sd[f"{v}.patch_embed.proj.weight"])
    out = {"vit.patch.weight": conv.reshape(conv.shape[0], -1),
           "vit.patch.bias": _t(sd[f"{v}.patch_embed.proj.bias"]),
           "vit.cls": _t(sd[f"{v}.cls_token"]).reshape(-1),
           "vit.pos": _t(sd[f"{v}.pos_embed"])[0],
           "bert.tok_emb": _t(sd[f"{t}.embeddings.word_embeddings.weight"]),
           "bert.pos_emb": _t(sd[f"{t}.embeddings.position_embeddings.weight"])}
    _ln(out, "vit.norm", sd, f"{v}.norm")
    _ln(out, "bert.emb_ln", sd, f"{t}.embeddings.LayerNorm")
    for i in range(cfg.vit_layers):
        src, dst = f"{v}.blocks.{i}", f"vit.blocks.{i}"
        _ln(out, f"{dst}.ln1", sd, f"{src}.norm1")
        _ln(out, f"{dst}.ln2", sd, f"{src}.norm2")
        for a, b in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
                     ("fc2", "mlp.fc2")):
            _lin(out, f"{dst}.{a}", sd, f"{src}.{b}")
    for i in range(cfg.text_layers):
        src, dst = f"{t}.encoder.layer.{i}", f"bert.blocks.{i}"
        for a, b in (("self", "attention"), ("cross", "crossattention")):
            for x in ("q", "k", "v"):
                _lin(out, f"{dst}.{a}.{x}", sd,
                     f"{src}.{b}.self.{dict(q='query', k='key', v='value')[x]}")
            _lin(out, f"{dst}.{a}.out", sd, f"{src}.{b}.output.dense")
            _ln(out, f"{dst}.{a}.out_ln", sd, f"{src}.{b}.output.LayerNorm")
        _lin(out, f"{dst}.fc1", sd, f"{src}.intermediate.dense")
        _lin(out, f"{dst}.fc2", sd, f"{src}.output.dense")
        _ln(out, f"{dst}.out_ln", sd, f"{src}.output.LayerNorm")
    for j, i in enumerate(("0", "2", "4", "6", "7")):
        _lin(out, f"mlp.{j}", sd, f"mlp.layers.{i}")
    with torch.device("meta"):
        module = BlipReward(cfg)
    return _load(module, out, device)
