"""Three small FLUX conditioning adapters in PyTorch.

Counterpart of `video_styler_tpu/models/flux_adapters.py`:

- the InfiniteYou image projector (:34-125): a Perceiver resampler that
  lifts a 512-wide ArcFace identity embedding to the ControlNet's prompt
  tokens (its attention scales q and k each by d^-1/4 and takes the
  softmax in fp32);
- the value controller (:165-197): a scalar in [0, 1] through the
  [cos | sin] embedding of value x 1000 and an MLP, broadcast over a
  learned position table: `prefer_len` tokens appended to the text;
- the FLUX LoRA encoder (:213-324): a LoRA's A and B factors of each
  projection of `default_lora_patterns()` applied to that projection's
  learned probe tokens (a host loop of small products, in fp32 as the JAX
  promotion gives them), each type's linear to the embedding width, then
  learned special tokens ahead of them through CLIP encoder layers
  (`sd3_text_encoder.clip_layer`, quickGELU, 32 heads, the exact `sdpa`),
  a final LayerNorm and linear on the special tokens.

JAX has no init for the LoRA encoder: `init_flux_lora_encoder_` draws one,
and both packages' converters read its reference-named state dict.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch
from torch import nn

from ..ops.basic import layer_norm, silu
from .sd import convert_sd_module
from .sd3_text_encoder import ClipTextConfig, ClipTextLayer, clip_layer
from .wan_dit import LayerNormAffine as Affine
from .wan_dit import Linear


def timestep_embedding_flip(position, dim: int):
    """[cos | sin] sinusoidal embedding, float32 (the JAX package's
    `svd.timestep_embedding_flip`)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=position.device) / half
    args = position.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _ln(p: Affine, x):
    return layer_norm(x, p.scale, p.bias, 1e-5)


# ---------------------------------------------------------------------------
# InfiniteYou image projector
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InfiniteYouConfig:
    dim: int = 1280
    depth: int = 4
    dim_head: int = 64
    heads: int = 20
    num_queries: int = 8
    embedding_dim: int = 512
    output_dim: int = 4096
    ff_mult: int = 4


INFINITEYOU = InfiniteYouConfig()


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: InfiniteYouConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = cfg.dim_head * cfg.heads
        self.norm1 = Affine(cfg.dim, **kw)
        self.norm2 = Affine(cfg.dim, **kw)
        self.to_q = Linear(cfg.dim, inner, bias=False, **kw)
        self.to_kv = Linear(cfg.dim, 2 * inner, bias=False, **kw)
        self.to_out = Linear(inner, cfg.dim, bias=False, **kw)


class FeedForward(nn.Module):
    def __init__(self, cfg: InfiniteYouConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = Affine(cfg.dim, **kw)
        self.fc1 = Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False, **kw)
        self.fc2 = Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False, **kw)


class PerceiverLayer(nn.Module):
    def __init__(self, cfg: InfiniteYouConfig, device=None, dtype=None):
        super().__init__()
        self.attn = PerceiverAttention(cfg, device=device, dtype=dtype)
        self.ff = FeedForward(cfg, device=device, dtype=dtype)


class InfiniteYouProjector(nn.Module):
    def __init__(self, cfg: InfiniteYouConfig = INFINITEYOU, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim, **kw))
        self.proj_in = Linear(cfg.embedding_dim, cfg.dim, **kw)
        self.proj_out = Linear(cfg.dim, cfg.output_dim, **kw)
        self.norm_out = Affine(cfg.output_dim, **kw)
        self.layers = nn.ModuleList(PerceiverLayer(cfg, **kw) for _ in range(cfg.depth))


@torch.no_grad()
def init_infiniteyou_projector_(model: InfiniteYouProjector, generator: torch.Generator):
    """The JAX init's draws: linear weights N(0, 1/in), biases 0, norms 1
    and 0, the latents N(0, 1/dim)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Affine):
            m.scale.fill_(1.0)
            m.bias.zero_()
    model.latents.normal_(0.0, model.cfg.dim ** -0.5, generator=generator)
    return model


def _perceiver_attention(p: PerceiverAttention, x, latents, heads: int, dim_head: int):
    x = _ln(p.norm1, x)
    latents = _ln(p.norm2, latents)
    b, n, _ = latents.shape
    q = p.to_q(latents)
    k, v = p.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

    def heads_first(t):
        return t.reshape(b, t.shape[1], heads, dim_head).transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    scale = 1.0 / math.sqrt(math.sqrt(dim_head))
    w = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
    w = torch.softmax(w.float(), dim=-1).to(v.dtype)
    out = torch.matmul(w, v).transpose(1, 2).reshape(b, n, heads * dim_head)
    return p.to_out(out)


def infiniteyou_projector_forward(model: InfiniteYouProjector, id_emb):
    """id_emb (B, n, 512) -> (B, num_queries, output_dim) prompt tokens of
    the ControlNet branch."""
    cfg = model.cfg
    latents = model.latents.to(id_emb.dtype).expand(id_emb.shape[0], -1, -1)
    x = model.proj_in(id_emb)
    for layer in model.layers:
        latents = _perceiver_attention(layer.attn, x, latents, cfg.heads, cfg.dim_head) + latents
        ff = layer.ff
        h = ff.fc1(_ln(ff.norm, latents))
        h = torch.nn.functional.gelu(h.float()).to(latents.dtype)
        latents = ff.fc2(h) + latents
    return _ln(model.norm_out, model.proj_out(latents))


def convert_infiniteyou_projector(sd: Dict) -> Dict:
    """A reference InfiniteYouImageProjector state dict (already out of the
    `image_proj` bundle) -> the `InfiniteYouProjector` state dict."""
    out = {"latents": sd["latents"]}
    for name in ("proj_in", "proj_out"):
        out[f"{name}.weight"], out[f"{name}.bias"] = sd[f"{name}.weight"], sd[f"{name}.bias"]
    out["norm_out.scale"], out["norm_out.bias"] = sd["norm_out.weight"], sd["norm_out.bias"]
    i = 0
    while f"layers.{i}.0.to_q.weight" in sd:
        for src, dst in (("0.norm1", "attn.norm1"), ("0.norm2", "attn.norm2"),
                         ("1.0", "ff.norm")):
            out[f"layers.{i}.{dst}.scale"] = sd[f"layers.{i}.{src}.weight"]
            out[f"layers.{i}.{dst}.bias"] = sd[f"layers.{i}.{src}.bias"]
        for src, dst in (("0.to_q", "attn.to_q"), ("0.to_kv", "attn.to_kv"),
                         ("0.to_out", "attn.to_out"), ("1.1", "ff.fc1"), ("1.3", "ff.fc2")):
            out[f"layers.{i}.{dst}.weight"] = sd[f"layers.{i}.{src}.weight"]
        i += 1
    return out


def infiniteyou_config_for(sd: Dict) -> InfiniteYouConfig:
    """Widths and depth from a reference projector's tensors; the head
    split is the JAX forward's default (20 heads of 64)."""
    depth = 0
    while f"layers.{depth}.0.to_q.weight" in sd:
        depth += 1
    _, nq, dim = sd["latents"].shape
    return InfiniteYouConfig(dim=int(dim), depth=depth, num_queries=int(nq),
                             embedding_dim=int(sd["proj_in.weight"].shape[1]),
                             output_dim=int(sd["proj_out.weight"].shape[0]),
                             ff_mult=int(sd["layers.0.1.1.weight"].shape[0]) // int(dim))


# ---------------------------------------------------------------------------
# Value controller
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ValueEncoderConfig:
    dim_in: int = 256
    dim_out: int = 4096
    prefer_len: int = 32


class SingleValueEncoder(nn.Module):
    def __init__(self, cfg: ValueEncoderConfig = ValueEncoderConfig(), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(cfg.dim_in, cfg.dim_out, **kw)
        self.fc2 = Linear(cfg.dim_out, cfg.dim_out, **kw)
        self.pos = nn.Parameter(torch.empty(cfg.prefer_len, cfg.dim_out, **kw))


@torch.no_grad()
def init_value_encoder_(model: SingleValueEncoder, generator: torch.Generator):
    """The JAX init's draws: linear weights N(0, 1/in), biases 0, the
    position table N(0, 1)."""
    for m in (model.fc1, model.fc2):
        m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
        m.bias.zero_()
    model.pos.normal_(0.0, 1.0, generator=generator)
    return model


def single_value_encoder_forward(model: SingleValueEncoder, value):
    """value (1,) in [0, 1] -> (prefer_len, dim_out)."""
    emb = timestep_embedding_flip(value * 1000.0, model.fc1.in_features)
    emb = model.fc2(silu(model.fc1(emb.to(model.fc1.weight.dtype))))
    return emb.expand(model.pos.shape[0], -1) + model.pos.to(emb.dtype)


def multi_value_encoder_forward(models: List[SingleValueEncoder], values):
    """One token block per value that is not None, concatenated."""
    embs = [single_value_encoder_forward(m, torch.tensor([v], dtype=torch.float32,
                                                         device=m.pos.device))
            for m, v in zip(models, values) if v is not None]
    return torch.cat(embs, dim=0)


def convert_value_encoder(sd: Dict) -> Dict:
    return {"fc1.weight": sd["prefer_value_embedder.0.weight"],
            "fc1.bias": sd["prefer_value_embedder.0.bias"],
            "fc2.weight": sd["prefer_value_embedder.2.weight"],
            "fc2.bias": sd["prefer_value_embedder.2.bias"],
            "pos": sd["positional_embedding"]}


def value_encoder_config_for(sd: Dict) -> ValueEncoderConfig:
    """The widths of a reference SingleValueEncoder's tensors."""
    dim_out, dim_in = sd["prefer_value_embedder.0.weight"].shape
    return ValueEncoderConfig(int(dim_in), int(dim_out), int(sd["positional_embedding"].shape[0]))


# ---------------------------------------------------------------------------
# FLUX LoRA encoder
# ---------------------------------------------------------------------------

def default_lora_patterns():
    """The probe inventory: the 10 LoRA-targeted projections of each of the
    19 joint blocks and 3 of each of the 38 single blocks, (in, out)."""
    joint = {"attn.a_to_qkv": (3072, 9216), "attn.a_to_out": (3072, 3072),
             "ff_a.0": (3072, 12288), "ff_a.2": (12288, 3072),
             "norm1_a.linear": (3072, 18432),
             "attn.b_to_qkv": (3072, 9216), "attn.b_to_out": (3072, 3072),
             "ff_b.0": (3072, 12288), "ff_b.2": (12288, 3072),
             "norm1_b.linear": (3072, 18432)}
    single = {"to_qkv_mlp": (3072, 21504), "proj_out": (15360, 3072),
              "norm.linear": (3072, 9216)}
    patterns = [{"name": f"blocks.{i}.{s}", "dim": d, "type": s}
                for i in range(19) for s, d in joint.items()]
    patterns += [{"name": f"single_blocks.{i}.{s}", "dim": d, "type": s}
                 for i in range(38) for s, d in single.items()]
    return patterns


@dataclass(frozen=True)
class FluxLoRAEncoderConfig:
    embed_dim: int = 4096
    intermediate_dim: int = 8192
    num_layers: int = 1
    num_embeds_per_lora: int = 16
    num_special_embeds: int = 1
    num_heads: int = 32


FLUX_LORA_ENCODER = FluxLoRAEncoderConfig()


class LoRALayerBlock(nn.Module):
    def __init__(self, length: int, dim_in: int, dim_out: int, device=None, dtype=None):
        super().__init__()
        self.x = nn.Parameter(torch.empty(1, length, dim_in, device=device, dtype=dtype))
        self.layer_norm = Affine(dim_out, device=device, dtype=dtype)


class FluxLoRAEncoder(nn.Module):
    def __init__(self, cfg: FluxLoRAEncoderConfig = FLUX_LORA_ENCODER, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        pats = default_lora_patterns()
        self.model_dict = nn.ModuleDict({
            p["name"].replace(".", "___"): LoRALayerBlock(cfg.num_embeds_per_lora, *p["dim"], **kw)
            for p in pats})
        types = {}
        for p in pats:
            types.setdefault(p["type"].replace(".", "___"), p["dim"][1])
        self.proj_dict = nn.ModuleDict({t: Linear(d, cfg.embed_dim, **kw)
                                        for t, d in types.items()})
        layer = ClipTextConfig(dim=cfg.embed_dim, ffn_dim=cfg.intermediate_dim,
                               num_heads=cfg.num_heads)
        self.encoders = nn.ModuleList(ClipTextLayer(layer, **kw) for _ in range(cfg.num_layers))
        self.special_embeds = nn.Parameter(torch.empty(1, cfg.num_special_embeds,
                                                       cfg.embed_dim, **kw))
        self.final_layer_norm = Affine(cfg.embed_dim, **kw)
        self.final_linear = Linear(cfg.embed_dim, cfg.embed_dim, **kw)


@torch.no_grad()
def init_flux_lora_encoder_(model: FluxLoRAEncoder, generator: torch.Generator):
    """Random weights: linears N(0, 1/in) with biases N(0, 0.02^2), norms
    1 + N(0, 0.05^2) and N(0, 0.05^2), probe and special tokens N(0, 1)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, Affine):
            m.scale.normal_(1.0, 0.05, generator=generator)
            m.bias.normal_(0.0, 0.05, generator=generator)
        elif isinstance(m, LoRALayerBlock):
            m.x.normal_(0.0, 1.0, generator=generator)
    model.special_embeds.normal_(0.0, 1.0, generator=generator)
    return model


def _lora_factor(lora: Dict, name: str, tag: str):
    for suffix in (f".{tag}.default.weight", f".{tag}.weight"):
        if name + suffix in lora:
            return lora[name + suffix]
    raise KeyError(f"{name}.{tag} missing from LoRA for the encoder")


def flux_lora_encoder_forward(model: FluxLoRAEncoder, lora: Dict):
    """A FLUX LoRA in the native naming (`flux_lora.convert_flux_lora`'s
    output; numpy or torch values) -> (1, num_special_embeds, embed_dim)
    float32 conditioning tokens."""
    dev = model.special_embeds.device
    embs = []
    for pat in default_lora_patterns():
        name = pat["name"]
        a = torch.as_tensor(_lora_factor(lora, name, "lora_A")).to(dev, torch.float32)
        b = torch.as_tensor(_lora_factor(lora, name, "lora_B")).to(dev, torch.float32)
        blk = model.model_dict[name.replace(".", "___")]
        h = _ln(blk.layer_norm, blk.x.float() @ a.T @ b.T)
        embs.append(model.proj_dict[pat["type"].replace(".", "___")](h))
    lora_emb = torch.cat(embs, dim=1)
    x = torch.cat([model.special_embeds.to(lora_emb.dtype), lora_emb], dim=1)
    for layer in model.encoders:
        x = clip_layer(layer, x, None, model.cfg.num_heads, quick_gelu=True)
    x = _ln(model.final_layer_norm, x[:, :model.cfg.num_special_embeds])
    return model.final_linear(x)


def convert_flux_lora_encoder(sd: Dict) -> Dict:
    """A reference FluxLoRAEncoder state dict -> the `FluxLoRAEncoder` state
    dict: `embedder.` dropped, the LayerNorms' `weight` become `scale`
    (the probe blocks', the final one's and, through `convert_sd_module`,
    the encoder layers')."""
    out = convert_sd_module({k: v for k, v in sd.items() if k.startswith("encoders.")})
    for k, v in sd.items():
        if k.startswith("encoders."):
            continue
        if k.startswith("embedder."):
            k = k[len("embedder."):]
        if k.endswith("layer_norm.weight"):
            k = k[:-len("weight")] + "scale"
        out[k] = v
    return out


def lora_encoder_config_for(sd: Dict, num_heads: int = 32) -> FluxLoRAEncoderConfig:
    """Widths from a reference FluxLoRAEncoder's tensors (the JAX forward's
    32 heads)."""
    layers = 0
    while f"encoders.{layers}.fc1.weight" in sd:
        layers += 1
    _, special, embed = sd["special_embeds"].shape
    probe = sd["embedder.model_dict.blocks___0___attn___a_to_qkv.x"]
    return FluxLoRAEncoderConfig(
        embed_dim=int(embed), intermediate_dim=int(sd["encoders.0.fc1.weight"].shape[0]),
        num_layers=layers, num_embeds_per_lora=int(probe.shape[1]),
        num_special_embeds=int(special), num_heads=num_heads)
