"""Qwen2.5-VL vision tower (windowed ViT and patch merger) in PyTorch.

Counterpart of `video_styler_tpu/models/qwen_vl_vision.py`, the vision side
of the Qwen2.5-VL encoder that conditions Qwen-Image-Edit's prompt and the
Step1x embedder. All planning is host numpy, as in JAX: the processor's
smart resize and merge-order patch flattening (`preprocess_image`, PIL's
bicubic resize, imported when called), the window permutation and the
segment ids (`vision_plan`), the rotary tables and Qwen2.5-VL's 3-stream
position ids (`get_rope_index`).

The strided Conv3d patch embed is one linear on the flattened patches.
Window and full attention run as one dense exact attention over the
(N, N) additive bias of their segment ids (`ops.attention.sdpa`: fp32
logits and softmax; heads of 80, so no kernel), as the JAX tower runs it.
Parameters live in modules named after the JAX tree (`patch_embed`,
`blocks.{i}.qkv`, `ln_q`, `mlp0`, `mlp2`); `convert_qwen_vl_vision` reads
the HF `visual.*` names into them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import rms_norm, silu
from .wan_dit import Linear, RMSNorm

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

IMAGE_TOKEN_ID = 151655
VIDEO_TOKEN_ID = 151656
VISION_START_TOKEN_ID = 151652


@dataclass(frozen=True)
class QwenVLVisionConfig:
    depth: int = 32
    hidden: int = 1280
    num_heads: int = 16
    intermediate: int = 3420
    out_hidden: int = 3584
    in_channels: int = 3
    patch: int = 14
    temporal_patch: int = 2
    merge: int = 2
    window: int = 112
    fullatt: Tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: int = 2
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch * self.patch ** 2

    @property
    def merge_unit(self) -> int:
        return self.merge ** 2


QWEN25_VL_7B_VISION = QwenVLVisionConfig()
QWEN_VL_VISION_TINY = QwenVLVisionConfig(
    depth=4, hidden=64, num_heads=4, intermediate=96, out_hidden=48,
    patch=4, temporal_patch=2, merge=2, window=16, fullatt=(1, 3))


class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.hidden, **kw)
        self.norm2 = RMSNorm(cfg.hidden, **kw)
        self.qkv = Linear(cfg.hidden, 3 * cfg.hidden, **kw)
        self.proj = Linear(cfg.hidden, cfg.hidden, **kw)
        self.gate = Linear(cfg.hidden, cfg.intermediate, **kw)
        self.up = Linear(cfg.hidden, cfg.intermediate, **kw)
        self.down = Linear(cfg.intermediate, cfg.hidden, **kw)


class QwenVLVision(nn.Module):
    """Parameters of the vision tower; `vision_forward` runs it."""

    def __init__(self, cfg: QwenVLVisionConfig = QWEN25_VL_7B_VISION, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mu = cfg.merge_unit
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_dim, cfg.hidden, bias=False, **kw)
        self.blocks = nn.ModuleList(VisionBlock(cfg, **kw) for _ in range(cfg.depth))
        self.ln_q = RMSNorm(cfg.hidden, **kw)
        self.mlp0 = Linear(mu * cfg.hidden, mu * cfg.hidden, **kw)
        self.mlp2 = Linear(mu * cfg.hidden, cfg.out_hidden, **kw)


# --------------------------------------------------------------- preprocess

def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 256 * 28 * 28,
                 max_pixels: int = 1280 * 28 * 28) -> Tuple[int, int]:
    """The HF Qwen2VL smart_resize: both sides divisible by `factor`, the
    pixel count in [min, max], the aspect kept."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def preprocess_image(image, cfg: QwenVLVisionConfig = QWEN25_VL_7B_VISION,
                     min_pixels: int = 256 * 28 * 28, max_pixels: int = 1280 * 28 * 28):
    """PIL image -> (flattened patches (N, patch_dim) float32, grid (1, h, w)):
    bicubic smart resize, 1/255, CLIP mean/std, the frame repeated to
    temporal_patch frames, the merge-order flattening."""
    from PIL import Image
    img = image.convert("RGB")
    h_bar, w_bar = smart_resize(img.height, img.width, factor=cfg.patch * cfg.merge,
                                min_pixels=min_pixels, max_pixels=max_pixels)
    img = img.resize((w_bar, h_bar), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = ((arr - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)
    patches = np.repeat(arr[None], cfg.temporal_patch, axis=0)
    grid_t, grid_h, grid_w = 1, h_bar // cfg.patch, w_bar // cfg.patch
    m, p = cfg.merge, cfg.patch
    patches = patches.reshape(grid_t, cfg.temporal_patch, cfg.in_channels,
                              grid_h // m, m, p, grid_w // m, m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, cfg.patch_dim)
    return np.ascontiguousarray(flat, np.float32), (grid_t, grid_h, grid_w)


# --------------------------------------------------------------- planning

def _rot_pos_ids(grid_thw: Sequence[Tuple[int, int, int]], merge: int):
    """(h, w) rotary position ids of each patch token, in the processor's
    merge-order layout."""
    out = []
    for t, h, w in grid_thw:
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hp = hp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wp = wp.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def _window_plan(grid_thw, cfg: QwenVLVisionConfig):
    """-> (window_index, window_seg, full_seg) over the merged tokens: the
    window permutation (HF get_window_index) and, after it, each merged
    token's window id and image id."""
    wm = cfg.window // cfg.merge // cfg.patch
    index_chunks, seg_chunks, full_chunks = [], [], []
    base = win_base = 0
    for img_i, (t, h, w) in enumerate(grid_thw):
        lh, lw = h // cfg.merge, w // cfg.merge
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = wm - lh % wm if lh % wm else 0
        pad_w = wm - lw % wm if lw % wm else 0
        nh, nw = (lh + pad_h) // wm, (lw + pad_w) // wm
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        padded = padded.reshape(t, nh, wm, nw, wm).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t * nh * nw, wm * wm)
        win_ids = np.broadcast_to(np.arange(padded.shape[0])[:, None] + win_base,
                                  padded.shape)
        keep = padded.reshape(-1) != -100
        index_chunks.append(padded.reshape(-1)[keep] + base)
        seg_chunks.append(win_ids.reshape(-1)[keep])
        full_chunks.append(np.full(keep.sum(), img_i, np.int64))
        base += t * lh * lw
        win_base += padded.shape[0]
    return (np.concatenate(index_chunks), np.concatenate(seg_chunks),
            np.concatenate(full_chunks))


def vision_plan(grid_thw, cfg: QwenVLVisionConfig) -> Dict[str, np.ndarray]:
    """The host plan of a patch batch: the window permutation and its
    inverse, the rotary tables in window order, the token-level segment
    ids of the window and full attentions."""
    grid_thw = [tuple(int(v) for v in g) for g in grid_thw]
    pos = _rot_pos_ids(grid_thw, cfg.merge)
    n = pos.shape[0]
    window_index, window_seg, full_seg = _window_plan(grid_thw, cfg)
    half = cfg.head_dim // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, half, 2, np.float64) / half))
    rot = (pos[..., None].astype(np.float64) * inv).reshape(n, -1)
    mu = cfg.merge_unit
    rot = rot.reshape(n // mu, mu, -1)[window_index].reshape(n, -1)
    emb = np.concatenate([rot, rot], axis=-1)
    return {
        "window_index": window_index.astype(np.int32),
        "reverse_index": np.argsort(window_index).astype(np.int32),
        "cos": np.cos(emb).astype(np.float32),
        "sin": np.sin(emb).astype(np.float32),
        "window_seg": np.repeat(window_seg, mu).astype(np.int32),
        "full_seg": np.repeat(full_seg, mu).astype(np.int32),
    }


# --------------------------------------------------------------- forward

def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _segment_bias(seg):
    """(N,) segment ids -> (1, 1, N, N) fp32: 0 within a segment, the fp32
    minimum across."""
    neg = float(np.finfo(np.float32).min)
    return torch.where(seg[:, None] == seg[None, :], 0.0, neg)[None, None]


def vision_block(p: VisionBlock, x, cos, sin, bias, cfg: QwenVLVisionConfig):
    n = x.shape[0]
    h = rms_norm(x, p.norm1.scale, cfg.eps)
    qkv = p.qkv(h).view(n, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]

    def rope(t):
        tf = t.float()
        return (tf * cos[:, None, :] + _rotate_half(tf) * sin[:, None, :]).to(t.dtype)

    attn = sdpa(rope(q)[None], rope(k)[None], v[None], bias=bias)[0]
    x = x + p.proj(attn.reshape(n, cfg.hidden))
    h = rms_norm(x, p.norm2.scale, cfg.eps)
    return x + p.down(silu(p.gate(h)) * p.up(h))


def vision_forward(model: QwenVLVision, patches, plan):
    """patches (N, patch_dim); plan: `vision_plan`'s -> (N / merge_unit,
    out_hidden) image embeddings in the input's token order."""
    cfg = model.cfg
    dev = patches.device
    n, mu = patches.shape[0], cfg.merge_unit
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in plan.items()}
    x = model.patch_embed(patches.to(model.patch_embed.weight.dtype))
    x = x.reshape(n // mu, mu, cfg.hidden)[t["window_index"].long()].reshape(n, cfg.hidden)
    bias_win, bias_full = _segment_bias(t["window_seg"]), _segment_bias(t["full_seg"])
    for i, p in enumerate(model.blocks):
        x = vision_block(p, x, t["cos"], t["sin"],
                         bias_full if i in cfg.fullatt else bias_win, cfg)
    h = rms_norm(x, model.ln_q.scale, cfg.eps).reshape(n // mu, mu * cfg.hidden)
    out = model.mlp2(F.gelu(model.mlp0(h)))
    return out[t["reverse_index"].long()]


def encode_images(model: QwenVLVision, images, min_pixels: int = 256 * 28 * 28,
                  max_pixels: int = 1280 * 28 * 28):
    """PIL images -> (embeds (sum n_i, out_hidden), grids)."""
    cfg = model.cfg
    pats, grids = [], []
    for im in images:
        p, g = preprocess_image(im, cfg, min_pixels, max_pixels)
        pats.append(p)
        grids.append(g)
    patches = torch.from_numpy(np.concatenate(pats, axis=0)).to(model.patch_embed.weight.device)
    return vision_forward(model, patches, vision_plan(grids, cfg)), grids


# --------------------------------------------------------------- mRoPE

def get_rope_index(input_ids: np.ndarray, image_grid_thw, merge: int = 2,
                   tokens_per_second: int = 2, image_token_id: int = IMAGE_TOKEN_ID,
                   video_token_id: int = VIDEO_TOKEN_ID,
                   second_per_grid_ts=None) -> np.ndarray:
    """Qwen2.5-VL's 3-stream position ids of one unpadded sequence (L,) ->
    (3, L) int32: text advances all three streams together; an image span
    takes its t/h/w grid indices past the preceding text's maximum."""
    toks = input_ids.tolist()
    grids = [tuple(int(v) for v in g) for g in (image_grid_thw or [])]
    pieces = []
    st, img_i = 0, 0
    while img_i < len(grids) and image_token_id in toks[st:]:
        ed = toks.index(image_token_id, st)
        t, h, w = grids[img_i]
        lh, lw = h // merge, w // merge
        st_idx = pieces[-1].max() + 1 if pieces else 0
        text_len = ed - st
        pieces.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        spg = 0.0 if second_per_grid_ts is None else float(second_per_grid_ts[img_i])
        t_idx = (np.arange(t)[:, None] * spg * tokens_per_second).astype(np.int64)
        t_idx = np.broadcast_to(t_idx, (t, lh * lw)).reshape(-1)
        h_idx = np.broadcast_to(np.arange(lh)[None, :, None], (t, lh, lw)).reshape(-1)
        w_idx = np.broadcast_to(np.arange(lw)[None, None, :], (t, lh, lw)).reshape(-1)
        pieces.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
        st = ed + t * lh * lw
        img_i += 1
    if st < len(toks):
        st_idx = pieces[-1].max() + 1 if pieces else 0
        ln = len(toks) - st
        pieces.append(np.broadcast_to(np.arange(ln), (3, ln)) + st_idx)
    return np.concatenate(pieces, axis=1).astype(np.int32)


# --------------------------------------------------------------- checkpoints

def _visual(sd: Dict) -> Dict:
    return {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")} or dict(sd)


def detect_vision_config(sd: Dict) -> QwenVLVisionConfig:
    """The architecture from the `visual.*` shapes (heads of 80, the 7B
    release's merge, window and full-attention layers)."""
    sd = _visual(sd)
    pw = sd["patch_embed.proj.weight"]
    hidden = pw.shape[0]
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    base = QWEN25_VL_7B_VISION
    return QwenVLVisionConfig(
        depth=depth, hidden=hidden, num_heads=max(1, hidden // 80),
        intermediate=sd["blocks.0.mlp.gate_proj.weight"].shape[0],
        out_hidden=sd["merger.mlp.2.weight"].shape[0], in_channels=pw.shape[1],
        patch=pw.shape[3], temporal_patch=pw.shape[2], merge=base.merge, window=base.window,
        fullatt=tuple(i for i in base.fullatt if i < depth))


def convert_qwen_vl_vision(sd: Dict, cfg: QwenVLVisionConfig) -> Dict:
    """An HF `visual.*` state dict -> the `QwenVLVision` state dict (qkv kept
    fused; the Conv3d patch weight flattened). Values pass through."""
    sd = _visual(sd)
    out = {"patch_embed.weight": sd["patch_embed.proj.weight"].reshape(cfg.hidden,
                                                                       cfg.patch_dim),
           "ln_q.scale": sd["merger.ln_q.weight"]}
    names = {"mlp0": "merger.mlp.0", "mlp2": "merger.mlp.2"}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        out[f"{b}.norm1.scale"] = sd[f"{b}.norm1.weight"]
        out[f"{b}.norm2.scale"] = sd[f"{b}.norm2.weight"]
        names.update({f"{b}.qkv": f"{b}.attn.qkv", f"{b}.proj": f"{b}.attn.proj",
                      f"{b}.gate": f"{b}.mlp.gate_proj", f"{b}.up": f"{b}.mlp.up_proj",
                      f"{b}.down": f"{b}.mlp.down_proj"})
    for dst, src in names.items():
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]
    return out
