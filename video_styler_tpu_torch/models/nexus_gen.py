"""Nexus-Gen's conditioning for FLUX: the generation adapter and the
editing merger over Qwen2.5-VL embeddings.

Counterpart of `video_styler_tpu/models/nexus_gen.py` (:31-245):
  - the generation adapter (`NexusGenAdapter`): Linear -> LayerNorm -> ReLU
    -> Linear -> LayerNorm, 3584 -> 4096;
  - the editing merger (`NexusGenMerger`): one bidirectional Qwen2.5-VL
    decoder layer over the target and reference embedding grids, with
    multimodal RoPE positions scaled to a 72x72 base grid
    (`merger_position_ids`, `mrope_tables`, host numpy), then an RMSNorm /
    SiLU projector to 4096. Its attention is the exact GQA `sdpa` (28 heads
    of 128 over 4 k/v heads, no mask), as the JAX layer calls its exact
    `sdpa`; its RMSNorms multiply the weight in fp32 before the cast, as
    the JAX `_rms` does.
Parameters live in modules named after the reference's checkpoint
(`adapter.0`, `layers.0.self_attn.q_proj`, `projector.4`, ...), so the
converters only select the keys.

`NexusGenARModel` is the autoregressive embedding predictor (the JAX class
wraps `transformers`' Qwen2.5-VL on the host) built on the port's own
Qwen2.5-VL modules: see its docstring.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.basic import layer_norm, silu
from .flux_dit import RMSWeight
from .llm_decoder import gqa_attention
from .wan_dit import Linear


# --------------------------------------------------------------------------
# Generation adapter
# --------------------------------------------------------------------------

class NexusGenAdapter(nn.Module):
    def __init__(self, in_dim: int = 3584, out_dim: int = 4096, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.adapter = nn.ModuleDict({"0": Linear(in_dim, out_dim, **kw),
                                      "1": nn.LayerNorm(out_dim, **kw),
                                      "3": Linear(out_dim, out_dim, **kw),
                                      "4": nn.LayerNorm(out_dim, **kw)})


def nexus_gen_adapter_forward(model: NexusGenAdapter, x):
    a = model.adapter
    h = layer_norm(a["0"](x), a["1"].weight, a["1"].bias, eps=1e-5)
    h = torch.clamp_min(h, 0.0)
    return layer_norm(a["3"](h), a["4"].weight, a["4"].bias, eps=1e-5)


def convert_nexus_gen_adapter(sd: Dict) -> Dict:
    return {f"adapter.{i}.{leaf}": sd[f"adapter.{i}.{leaf}"] for i in "0134"
            for leaf in ("weight", "bias")}


# --------------------------------------------------------------------------
# Editing merger
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class NexusGenMergerConfig:
    hidden_size: int = 3584
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18944
    num_layers: int = 1
    out_channel: int = 4096
    expand_ratio: int = 4
    rms_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    spatial_merge_size: int = 2
    tokens_per_second: int = 2
    base_grid: Tuple[int, int, int] = (1, 72, 72)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


NEXUS_GEN_MERGER = NexusGenMergerConfig()
NEXUS_GEN_MERGER_TINY = NexusGenMergerConfig(
    hidden_size=32, num_heads=2, num_kv_heads=1, intermediate_size=48, out_channel=24,
    mrope_section=(4, 2, 2), base_grid=(1, 8, 8))


class MergerLayer(nn.Module):
    def __init__(self, cfg: NexusGenMergerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, kv = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
        self.input_layernorm = RMSWeight(d, **kw)
        self.self_attn = nn.ModuleDict({
            "q_proj": Linear(d, cfg.num_heads * cfg.head_dim, **kw),
            "k_proj": Linear(d, kv, **kw), "v_proj": Linear(d, kv, **kw),
            "o_proj": Linear(cfg.num_heads * cfg.head_dim, d, bias=False, **kw)})
        self.post_attention_layernorm = RMSWeight(d, **kw)
        self.mlp = nn.ModuleDict({n: Linear(*dims, bias=False, **kw) for n, dims in (
            ("gate_proj", (d, cfg.intermediate_size)), ("up_proj", (d, cfg.intermediate_size)),
            ("down_proj", (cfg.intermediate_size, d)))})


class NexusGenMerger(nn.Module):
    def __init__(self, cfg: NexusGenMergerConfig = NEXUS_GEN_MERGER, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        oc, wide = cfg.out_channel, cfg.out_channel * cfg.expand_ratio
        self.layers = nn.ModuleList(MergerLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.projector = nn.ModuleDict({"0": RMSWeight(cfg.hidden_size, **kw),
                                        "1": Linear(cfg.hidden_size, wide, **kw),
                                        "2": RMSWeight(wide, **kw),
                                        "4": Linear(wide, oc, **kw),
                                        "5": RMSWeight(oc, **kw)})


def merger_position_ids(cfg: NexusGenMergerConfig, grid_thw) -> np.ndarray:
    """(3, 1, L) multimodal RoPE positions of one image's merged tokens,
    scaled to the base grid."""
    t, h, w = (int(v) for v in np.asarray(grid_thw)[0])
    gh, gw = h // cfg.spatial_merge_size, w // cfg.spatial_merge_size
    t_idx = np.repeat(np.arange(t) * cfg.tokens_per_second, gh * gw)
    h_idx = np.tile(np.repeat(np.arange(gh), gw), t) * (cfg.base_grid[1] / h)
    w_idx = np.tile(np.tile(np.arange(gw), gh), t) * (cfg.base_grid[2] / w)
    return np.stack([t_idx, h_idx, w_idx]).astype(np.float64)[:, None]


def mrope_tables(cfg: NexusGenMergerConfig, position_ids: np.ndarray):
    """(3, B, L) positions -> (cos, sin), each (B, L, head_dim) float32: the
    t / h / w sections interleaved over the frequency halves."""
    d = cfg.head_dim
    inv = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    freqs = position_ids[..., None] * inv
    emb = np.concatenate([freqs, freqs], axis=-1)
    cos3, sin3 = np.cos(emb), np.sin(emb)
    out_cos, out_sin, start = [], [], 0
    for i, sec in enumerate(list(cfg.mrope_section) * 2):
        out_cos.append(cos3[i % 3, ..., start:start + sec])
        out_sin.append(sin3[i % 3, ..., start:start + sec])
        start += sec
    return (np.concatenate(out_cos, axis=-1).astype(np.float32),
            np.concatenate(out_sin, axis=-1).astype(np.float32))


def _rms(p: RMSWeight, x, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (p.weight.float() * y).to(x.dtype)


def _rot_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _merger_layer(p: MergerLayer, x, cos, sin, cfg: NexusGenMergerConfig):
    b, s, d = x.shape
    n, g, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = _rms(p.input_layernorm, x, cfg.rms_eps)
    q = p.self_attn["q_proj"](h).view(b, s, n, hd)
    k = p.self_attn["k_proj"](h).view(b, s, g, hd)
    v = p.self_attn["v_proj"](h).view(b, s, g, hd)
    c, sn = cos[:, :, None], sin[:, :, None]
    q = (q.float() * c + _rot_half(q.float()) * sn).to(x.dtype)
    k = (k.float() * c + _rot_half(k.float()) * sn).to(x.dtype)
    x = x + p.self_attn["o_proj"](gqa_attention(q, k, v, None).reshape(b, s, n * hd))
    h = _rms(p.post_attention_layernorm, x, cfg.rms_eps)
    return x + p.mlp["down_proj"](silu(p.mlp["gate_proj"](h)) * p.mlp["up_proj"](h))


def nexus_gen_merger_forward(model: NexusGenMerger, embeds, embeds_grid, ref_embeds=None,
                             ref_embeds_grid=None):
    """embeds (B, L, hidden) of the target grid `embeds_grid` (1, 3), and
    optionally the reference's -> (B, L [+ L_ref], out_channel)."""
    cfg = model.cfg
    pos = merger_position_ids(cfg, embeds_grid)
    x = embeds
    if ref_embeds is not None:
        pos = np.concatenate([pos, merger_position_ids(cfg, ref_embeds_grid)], axis=-1)
        x = torch.cat([embeds, ref_embeds.to(embeds.dtype)], dim=1)
    cos, sin = (torch.from_numpy(t).to(x.device) for t in mrope_tables(cfg, pos))
    for layer in model.layers:
        x = _merger_layer(layer, x, cos, sin, cfg)
    p = model.projector
    x = p["1"](_rms(p["0"], x, cfg.rms_eps))
    x = p["4"](silu(_rms(p["2"], x, cfg.rms_eps)))
    return _rms(p["5"], x, cfg.rms_eps)


def convert_nexus_gen_merger(sd: Dict, cfg: NexusGenMergerConfig = NEXUS_GEN_MERGER) -> Dict:
    """The reference's NexusGenImageEmbeddingMerger state dict -> the
    `NexusGenMerger` state dict (its rotary and base-grid buffers dropped).
    Values pass through."""
    keys = [k for k in NexusGenMerger(cfg, device="meta").state_dict()]
    return {k: sd[k] for k in keys}



# --------------------------------------------------------------------------
# The autoregressive embedding predictor
# --------------------------------------------------------------------------

GEN_MSG = ("You are a helpful assistant capable of generating images. "
           "Generate an image according to the user's instruction.")
TARGET_SIZE = 252           # the white target image: 18 x 18 patches, 81 merged tokens
NUM_IMG_TOKENS = 81


def chat_text(instruction: str, with_reference: bool) -> str:
    """The Qwen2.5-VL chat layout of Nexus-Gen's request (the system turn,
    the user's instruction after the reference image, the assistant's
    target image), each image one vision block."""
    from .qwen_vl_embedder import IMG_BLOCK
    user = f"{IMG_BLOCK} {instruction}" if with_reference else instruction
    turns = (("system", GEN_MSG), ("user", user), ("assistant", IMG_BLOCK))
    return "".join(f"<|im_start|>{role}\n{content}<|im_end|>\n" for role, content in turns)


class NexusGenARModel:
    """callable(instruction, ref_image=None) -> (embed (81, D), the reference
    image's vision embeds (n, hidden) or None, grids (n_images, 3)): the
    JAX `NexusGenARModel` (a host wrapper over `transformers`' Qwen2.5-VL)
    built on the port's modules. The chat layout with a white 252x252
    target image; the token embedding; `qwen_vl_vision` over the images;
    the input image's vision embeds written over its pad tokens and the
    learned prefill embeds over the target's; the multimodal RoPE
    positions; the text tower (`llm_decoder`, final norm); `vision_head`
    on the hidden states; each target token's prediction read from the
    row before it. `vl` is a `qwen_vl_embedder.QwenVL` with its vision
    tower."""

    def __init__(self, vl, vision_head: nn.Linear, prefill_embeds: torch.Tensor):
        self.vl = vl
        self.vision_head = vision_head
        self.prefill_embeds = prefill_embeds

    @classmethod
    def from_state_dict(cls, sd: Dict, tokenizer, device=None, dtype=torch.bfloat16,
                        **vl_kwargs) -> "NexusGenARModel":
        """The Qwen2.5-VL towers, `vision_head` and `image_prefill_embeds`
        from one state dict (HF names)."""
        from ..utils.ckpt import read_tensors
        from .qwen_vl_embedder import QwenVL
        extra = ("vision_head.weight", "vision_head.bias", "image_prefill_embeds.weight")
        vl = QwenVL.from_state_dict({k: v for k, v in sd.items() if k not in extra}, tokenizer,
                                    device=device, dtype=dtype, **vl_kwargs)
        t = read_tensors({k: sd[k] for k in extra}, vl.device, dtype)
        out_dim, hidden = t["vision_head.weight"].shape
        head = Linear(hidden, out_dim, device=vl.device, dtype=dtype)
        head.load_state_dict({"weight": t["vision_head.weight"], "bias": t["vision_head.bias"]})
        return cls(vl, head.eval(), t["image_prefill_embeds.weight"])

    @torch.no_grad()
    def __call__(self, instruction: str, ref_image=None, num_img_tokens: int = NUM_IMG_TOKENS):
        from PIL import Image
        from .llm_decoder import decoder_lm_forward
        from .qwen_vl_vision import get_rope_index
        vl = self.vl
        images = [Image.new("RGB", (TARGET_SIZE, TARGET_SIZE), (255, 255, 255))]
        if ref_image is not None:
            images.insert(0, ref_image)
        img_emb, grids = vl.embed_images(images)
        text = vl._expand_image_pads(chat_text(instruction, ref_image is not None), grids)
        ids = np.asarray(vl.tokenizer(text, return_tensors="np")["input_ids"][0], np.int64)
        ids_t = torch.from_numpy(ids).to(vl.device)[None]
        embeds = vl.text.embed[ids_t].clone()
        pads = np.where(ids == vl.image_token_id)[0]
        n_in = img_emb.shape[0] - num_img_tokens
        embeds[0, torch.from_numpy(pads[:n_in]).to(vl.device)] = img_emb[:n_in].to(embeds.dtype)
        gt = pads[n_in:]
        embeds[0, torch.from_numpy(gt).to(vl.device)] = self.prefill_embeds.to(embeds.dtype)
        pos = get_rope_index(ids, list(grids), merge=vl.vision_cfg.merge,
                             tokens_per_second=vl.vision_cfg.tokens_per_second,
                             image_token_id=vl.image_token_id, video_token_id=vl.video_token_id)
        hidden = decoder_lm_forward(vl.text, ids_t, inputs_embeds=embeds, position_ids=pos,
                                    mrope_section=vl.mrope_section)
        embed = self.vision_head(hidden[0, torch.from_numpy(gt - 1).to(vl.device)])
        return (embed, img_emb[:n_in] if ref_image is not None else None,
                np.asarray(grids, np.int64))
