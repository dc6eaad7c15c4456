"""The Stable Video Diffusion family's CLIP-H image encoder in PyTorch, the
tower that SD's IP-Adapter embeds its image with.

Counterpart of `svd_image_encoder_forward` of
`video_styler_tpu/models/svd.py` (:354-380): a 14x14 patch embedding (no
bias), the class token and position table, a pre LayerNorm, 32 layers of
1280 wide (16 heads of 80; the exact GELU in fp32, no mask: the
arithmetic of `sd3_text_encoder.clip_layer`, whose layer this is), the
post LayerNorm of the class token and `visual_projection` to 1024 (no
bias). Attention is the exact `sdpa` over 257 tokens, as in JAX.

The spatio-temporal UNet (`svd_unet_forward`, the JAX function :214):
`SVD_UNET_PROGRAM` over SD's push/pop interpreter with three more kinds of
block, the temporal resnet ((3, 1, 1) convolutions over the frames, which
are the batch), the temporal attention (per pixel across the frames, the
frame positions a sinusoid, or ExVideo's trained 128-frame table and its
reflect-padded 3x3x3 positional convolution) and the learned sigmoid mix
of the spatial and temporal paths; the temporal VAE decoder
(`svd_vae_decode`: SD's decoder blocks with temporal resnets between them
and a (3, 1, 1) output convolution) and `svd_vae_encode` (SD's encoder at
the scaling 0.13025). Every attention is the exact `sdpa` (heads of 64),
run in pieces of batch rows where its fp32 logits would pass
`ATTN_SPLIT_BYTES`: 9,216 spatial tokens a frame at 576x1024. Parameters
keep the reference's names as `sd.convert_sd_module` renames them (a
norm's `weight` is `scale`); a block's index is its program index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flux_dit import timestep_embedding_flux
from .sd import (GEGLU, Affine, Attention, BasicTransformerBlock, ResnetBlock, Resample,
                 SDUNetConfig, VAEAttentionBlock, _embedding, _ln, _silu, attn,
                 basic_transformer_block, conv2d, downsample, geglu, group_norm, resnet_block,
                 sd_vae_encoder_forward, SD_VAE_SCALING, TIME_PROJ, timestep_embedding,
                 upsample)
from .sd3_text_encoder import ClipTextConfig, ClipTextLayer, clip_layer
from .wan_dit import Linear


@dataclass(frozen=True)
class SVDImageEncoderConfig:
    dim: int = 1280
    ffn_dim: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    proj_dim: int = 1024

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


SVD_IMAGE_ENCODER = SVDImageEncoderConfig()
SVD_IMAGE_ENCODER_TINY = SVDImageEncoderConfig(dim=32, ffn_dim=64, num_layers=2, num_heads=2,
                                               patch_size=14, image_size=56, proj_dim=24)
# the pipeline's 224x224 input, projected to SVD_UNET_TINY's context
SVD_IMAGE_ENCODER_TINY_224 = SVDImageEncoderConfig(dim=32, ffn_dim=64, num_layers=2,
                                                   num_heads=2, proj_dim=32)


class Embeddings(nn.Module):
    def __init__(self, cfg: SVDImageEncoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.empty(cfg.dim, **kw))
        self.position_embeds = nn.Parameter(torch.empty(1, cfg.tokens, cfg.dim, **kw))


class SVDImageEncoder(nn.Module):
    def __init__(self, cfg: SVDImageEncoderConfig = SVD_IMAGE_ENCODER, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        layer = ClipTextConfig(dim=cfg.dim, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads)
        self.embeddings = Embeddings(cfg, **kw)
        self.pre_layernorm = Affine(cfg.dim, **kw)
        self.encoders = nn.ModuleList(ClipTextLayer(layer, **kw) for _ in range(cfg.num_layers))
        self.post_layernorm = Affine(cfg.dim, **kw)
        self.visual_projection = Linear(cfg.dim, cfg.proj_dim, bias=False, **kw)


def svd_image_encoder_forward(model: SVDImageEncoder, pixel_values):
    """pixel_values (B, 3, 224, 224), CLIP-normalised -> (B, 1024)."""
    cfg = model.cfg
    b = pixel_values.shape[0]
    emb = model.embeddings
    x = F.conv2d(pixel_values, emb.patch_embedding.weight.to(pixel_values.dtype),
                 stride=cfg.patch_size).flatten(2).transpose(1, 2)
    x = torch.cat([emb.class_embedding.to(x.dtype).expand(b, 1, cfg.dim), x], dim=1)
    x = _ln(model.pre_layernorm, x + emb.position_embeds.to(x.dtype))
    for p in model.encoders:
        x = clip_layer(p, x, None, cfg.num_heads, quick_gelu=False)
    return model.visual_projection(_ln(model.post_layernorm, x[:, 0]))


# ------------------------------------------------------------------ the UNet

ATTN_SPLIT_BYTES = 4 << 30


def _spatio_temporal_pair(heads, eps):
    return [("res", eps), ("push", None), ("tres", eps), ("popmix", None),
            ("push", None),
            ("attn", heads), ("push", None), ("tattn", heads),
            ("popmix_proj", None), ("push", None)]


SVD_UNET_PROGRAM: List[Tuple[str, object]] = (
    _spatio_temporal_pair(5, 1e-6) * 2 + [("down", None), ("push", None)]
    + _spatio_temporal_pair(10, 1e-6) * 2 + [("down", None), ("push", None)]
    + _spatio_temporal_pair(20, 1e-6) * 2 + [("down", None), ("push", None)]
    + [("res", 1e-5), ("push", None), ("tres", 1e-5), ("popmix", None),
       ("push", None)] * 2
    + [("res", 1e-5), ("push", None), ("tres", 1e-5), ("popmix", None),
       ("push", None),
       ("attn", 20), ("push", None), ("tattn", 20), ("popmix_proj", None),
       ("res", 1e-5), ("push", None), ("tres", 1e-5), ("popmix", None)]
    + [("pop", None), ("res", 1e-6), ("push", None), ("tres", 1e-5),
       ("popmix", None)] * 3 + [("up", None)]
    + ([("pop", None), ("res", 1e-6), ("push", None), ("tres", 1e-6),
        ("popmix", None), ("push", None),
        ("attn", 20), ("push", None), ("tattn", 20), ("popmix_proj", None)] * 3
       + [("up", None)])
    + ([("pop", None), ("res", 1e-6), ("push", None), ("tres", 1e-6),
        ("popmix", None), ("push", None),
        ("attn", 10), ("push", None), ("tattn", 10), ("popmix_proj", None)] * 3
       + [("up", None)])
    + ([("pop", None), ("res", 1e-6), ("push", None), ("tres", 1e-6),
        ("popmix", None), ("push", None),
        ("attn", 5), ("push", None), ("tattn", 5), ("popmix_proj", None)] * 3)
)
SVD_UNET = SDUNetConfig(channels=(320, 640, 1280, 1280), text_dim=1024)
# the smallest widths the program's fixed heads (5, 10, 20) and GroupNorm's
# 32 groups allow at every level
SVD_UNET_TINY = SDUNetConfig(channels=(160, 160, 160, 160), text_dim=32)
EXVIDEO_FRAMES = 128        # ExVideo-SVD-128f's trained position table
SVD_VAE_DECODER_PROGRAM = (
    [("res", 1e-6), ("tres", 1e-6), ("vattn", 1e-6), ("res", 1e-6), ("tres", 1e-6)]
    + ([("res", 1e-6), ("tres", 1e-6)] * 3 + [("up", None)]) * 3
    + [("res", 1e-6), ("tres", 1e-6)] * 3
)
SVD_VAE_CHANNELS = (512, 512, 256, 128)
SVD_VAE_SCALING = 0.13025


class TemporalResnet(nn.Module):
    def __init__(self, c: int, temb_dim: Optional[int], device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Affine(c, **kw)
        self.conv1 = nn.Conv3d(c, c, (3, 1, 1), **kw)
        if temb_dim:
            self.time_emb_proj = Linear(temb_dim, c, **kw)
        self.norm2 = Affine(c, **kw)
        self.conv2 = nn.Conv3d(c, c, (3, 1, 1), **kw)
        if not temb_dim:
            self.mix_factor = nn.Parameter(torch.empty(1, **kw))


class SpatialAttention(nn.Module):
    """The spatial transformer without `proj_out` (the mix's `proj` takes
    its place)."""

    def __init__(self, c: int, text_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = Affine(c, **kw)
        self.proj_in = Linear(c, c, **kw)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(c, text_dim, **kw)])


class TemporalAttention(nn.Module):
    def __init__(self, c: int, text_dim: int, exvideo: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if exvideo:
            self.positional_embedding = nn.Module()
            self.positional_embedding.embeddings = nn.Parameter(
                torch.empty(EXVIDEO_FRAMES, c, **kw))
            self.positional_conv = nn.Conv3d(c, c, 3, **kw)
        self.positional_embedding_proj = _embedding(c, 4 * c, **kw)
        self.positional_embedding_proj["2"] = Linear(4 * c, c, **kw)
        self.norm_in = Affine(c, **kw)
        self.act_fn_in = GEGLU(c, 4 * c, **kw)
        self.ff_in = Linear(4 * c, c, **kw)
        self.norm1 = Affine(c, **kw)
        self.attn1 = Attention(c, qkv_bias=False, **kw)
        self.norm2 = Affine(c, **kw)
        self.attn2 = Attention(c, kv_dim=text_dim, qkv_bias=False, **kw)
        self.norm_out = Affine(c, **kw)
        self.act_fn_out = GEGLU(c, 4 * c, **kw)
        self.ff_out = Linear(4 * c, c, **kw)


class PopMix(nn.Module):
    def __init__(self, c: int, proj: bool, device=None, dtype=None):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1, device=device, dtype=dtype))
        if proj:
            self.proj = Linear(c, c, device=device, dtype=dtype)


def svd_program_widths(program, channels, start: int):
    """Per block, (kind, input width); a pop concatenates the top of the
    residual stack, a mix pops one (two with its projection)."""
    level, cur, stack, out = 0, start, [start], []
    for kind, _ in program:
        out.append((kind, cur))
        if kind == "res":
            cur = channels[level]
        elif kind == "push":
            stack.append(cur)
        elif kind == "pop":
            cur = cur + stack.pop()
        elif kind in ("popmix", "popmix_proj"):
            stack.pop()
            if kind == "popmix_proj":
                stack.pop()
        elif kind == "down":
            level += 1
        elif kind == "up":
            level -= 1
    return out


class SVDUNet(nn.Module):
    """Parameters of the SVD UNet (ExVideo's with `exvideo`); frames are the
    batch."""

    def __init__(self, cfg: SDUNetConfig = SVD_UNET, device=None, dtype=None,
                 exvideo: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        c0, temb = cfg.channels[0], cfg.temb_dim
        self.time_embedding = _embedding(TIME_PROJ, temb, **kw)
        self.add_time_embedding = _embedding(3 * 256, temb, **kw)
        self.conv_in = nn.Conv2d(8, c0, 3, **kw)
        blocks = []
        walk = svd_program_widths(SVD_UNET_PROGRAM, cfg.channels, c0)
        level = 0
        for kind, cin in walk:
            if kind == "res":
                blocks.append(ResnetBlock(cin, cfg.channels[level], temb_dim=temb, **kw))
            elif kind == "tres":
                blocks.append(TemporalResnet(cin, temb, **kw))
            elif kind == "attn":
                blocks.append(SpatialAttention(cin, cfg.text_dim, **kw))
            elif kind == "tattn":
                blocks.append(TemporalAttention(cin, cfg.text_dim, exvideo, **kw))
            elif kind in ("popmix", "popmix_proj"):
                blocks.append(PopMix(cin, kind == "popmix_proj", **kw))
            elif kind in ("down", "up"):
                blocks.append(Resample(cin, **kw))
                level += 1 if kind == "down" else -1
            else:
                blocks.append(nn.Module())
        self.blocks = nn.ModuleList(blocks)
        self.conv_norm_out = Affine(c0, **kw)
        self.conv_out = nn.Conv2d(c0, 4, 3, **kw)


def _gn3(p: Affine, x, eps: float, groups: int = 32):
    return F.group_norm(x.float(), min(groups, x.shape[1]), p.scale.float(), p.bias.float(),
                        eps).to(x.dtype)


def _conv3_t(p: nn.Conv3d, x):
    """(3, 1, 1) temporal convolution, padding (1, 0, 0)."""
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), 1, (1, 0, 0))


def temporal_resnet_block(p: TemporalResnet, x, time_emb, eps: float):
    """x (T, C, H, W), the frames a batch -> (T, C, H, W)."""
    h = x.transpose(0, 1)[None]
    h = _conv3_t(p.conv1, _silu(_gn3(p.norm1, h, eps)))
    if time_emb is not None and hasattr(p, "time_emb_proj"):
        h = h + p.time_emb_proj(_silu(time_emb))[:, :, None, None, None].to(h.dtype)
    h = _conv3_t(p.conv2, _silu(_gn3(p.norm2, h, eps)))
    return x + h[0].transpose(0, 1)


def positional_id_map(num_frames: int, max_id: int = 25, repeat_length: int = 20,
                      pivot: int = 0) -> np.ndarray:
    """ExVideo's PositionalID: frames past `max_id` reflect back and forth
    through the trained table."""
    def one(frame_id):
        if frame_id < max_id:
            return frame_id
        pid = (frame_id - max_id) % (repeat_length * 2)
        if pid < repeat_length:
            return max_id - 2 - pid
        return max_id - 2 * repeat_length + pid

    return np.asarray([one(abs(i - pivot)) for i in range(num_frames)], np.int32)


def _reflect_pad1(x):
    """numpy's reflect padding by 1 on the last three axes (an axis of
    length 1 repeats its element)."""
    for dim in (2, 3, 4):
        idx = np.pad(np.arange(x.shape[dim]), 1, mode="reflect")
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def temporal_attention_block(p: TemporalAttention, x, text_emb, num_heads: int):
    """Per-pixel attention over the frames. x (T, C, H, W); text_emb (1, L,
    C_ctx)."""
    T, C, H, W = x.shape
    if hasattr(p, "positional_embedding"):
        pos = p.positional_embedding.embeddings[:T].to(x.dtype)
    else:
        pos = timestep_embedding_flux(torch.arange(T, device=x.device), C).to(x.dtype)
    pos = p.positional_embedding_proj["2"](_silu(p.positional_embedding_proj["0"](pos)))
    h = x + pos[:, :, None, None]
    if hasattr(p, "positional_conv"):
        h5 = _reflect_pad1(h.transpose(0, 1)[None])
        w = p.positional_conv
        h5 = F.conv3d(h5.float(), w.weight.float(), w.bias.float())
        h = h5[0].to(h.dtype).transpose(0, 1)
    h = h.permute(2, 3, 0, 1).reshape(H * W, T, C)
    h = h + p.ff_in(geglu(p.act_fn_in, _ln(p.norm_in, h)))
    h = h + attn(p.attn1, _ln(p.norm1, h), num_heads=num_heads)
    ctx = text_emb.expand(H * W, *text_emb.shape[1:])
    h = h + attn(p.attn2, _ln(p.norm2, h), num_heads=num_heads, context=ctx)
    h = h + p.ff_out(geglu(p.act_fn_out, _ln(p.norm_out, h)))
    return h.reshape(H, W, T, C).permute(2, 3, 0, 1)


def svd_spatial_attention(p: SpatialAttention, x, text_emb, num_heads: int,
                          eps: float = 1e-6):
    """GroupNorm, proj_in and the transformer; no proj_out, no residual."""
    b, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    h = p.proj_in(h)
    te = text_emb.expand(b, *text_emb.shape[1:])
    for blk in p.transformer_blocks:
        h = basic_transformer_block(blk, h, te, num_heads, split_bytes=ATTN_SPLIT_BYTES)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def popmix(p: PopMix, x, res_stack: list, proj: bool):
    res = res_stack.pop()
    alpha = torch.sigmoid(p.mix_factor.float()).to(x.dtype)
    x = alpha * res + (1 - alpha) * x
    if proj:
        x = p.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = x + res_stack.pop()
    return x


def svd_unet_forward(model: SVDUNet, sample, timestep: float, encoder_hidden_states,
                     add_time_id):
    """sample (T, 8, H/8, W/8), the frames a batch; encoder_hidden_states
    (1, 1024) or (1, 1, 1024), the CLIP image embedding; add_time_id (3,)
    [fps - 1, motion_bucket_id, noise_aug] -> (T, 4, H/8, W/8)."""
    dev, dtype = sample.device, sample.dtype
    t_emb = timestep_embedding(torch.tensor([float(timestep)], device=dev), TIME_PROJ).to(dtype)
    t_emb = model.time_embedding["2"](_silu(model.time_embedding["0"](t_emb)))
    add = timestep_embedding_flux(torch.as_tensor(np.asarray(add_time_id, np.float32),
                                                  device=dev), 256)
    add = add.reshape(1, -1).to(dtype)
    add = model.add_time_embedding["2"](_silu(model.add_time_embedding["0"](add)))
    time_emb = t_emb + add
    h = conv2d(model.conv_in, sample)
    text_emb = encoder_hidden_states
    if text_emb.dim() == 2:
        text_emb = text_emb[:, None]
    res_stack = [h]
    for p, (kind, arg) in zip(model.blocks, SVD_UNET_PROGRAM):
        if kind == "res":
            h = resnet_block(p, h, eps=arg, time_emb=time_emb)
        elif kind == "tres":
            h = temporal_resnet_block(p, h, time_emb, arg)
        elif kind == "attn":
            h = svd_spatial_attention(p, h, text_emb, arg)
        elif kind == "tattn":
            h = temporal_attention_block(p, h, text_emb, arg)
        elif kind in ("popmix", "popmix_proj"):
            h = popmix(p, h, res_stack, proj=kind == "popmix_proj")
        elif kind == "push":
            res_stack.append(h)
        elif kind == "pop":
            h = torch.cat([h, res_stack.pop()], dim=1)
        elif kind == "down":
            h = downsample(p, h)
        elif kind == "up":
            h = upsample(p, h)
    h = _silu(group_norm(model.conv_norm_out, h, eps=1e-5))
    return conv2d(model.conv_out, h)


# ------------------------------------------------------------------ the VAE

class SVDVAEDecoder(nn.Module):
    """SD's decoder blocks with temporal resnets, no post-quant conv, and a
    (3, 1, 1) output convolution across the frames."""

    def __init__(self, cfg=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = SVD_VAE_CHANNELS
        self.conv_in = nn.Conv2d(4, ch[0], 3, **kw)
        blocks, level, cur = [], 0, ch[0]
        for kind, _ in SVD_VAE_DECODER_PROGRAM:
            if kind == "res":
                blocks.append(ResnetBlock(cur, ch[level], **kw))
                cur = ch[level]
            elif kind == "tres":
                blocks.append(TemporalResnet(cur, None, **kw))
            elif kind == "vattn":
                blocks.append(VAEAttentionBlock(cur, **kw))
            else:
                blocks.append(Resample(cur, **kw))
                level += 1
        self.blocks = nn.ModuleList(blocks)
        self.conv_norm_out = Affine(ch[-1], **kw)
        self.conv_out = nn.Conv2d(ch[-1], 3, 3, **kw)
        self.time_conv_out = nn.Conv3d(3, 3, (3, 1, 1), **kw)


def svd_temporal_resnet_vae(p: TemporalResnet, x, eps: float):
    """The VAE's temporal resnet: no time embedding, a sigmoid mix with its
    input."""
    h = x.transpose(0, 1)[None]
    h = _conv3_t(p.conv1, _silu(_gn3(p.norm1, h, eps)))
    h = _conv3_t(p.conv2, _silu(_gn3(p.norm2, h, eps)))
    alpha = torch.sigmoid(p.mix_factor.float()).to(x.dtype)
    return alpha * (x + h[0].transpose(0, 1)) + (1 - alpha) * x


def svd_vae_attention(p: VAEAttentionBlock, x, eps: float):
    b, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    for blk in p.transformer_blocks:
        h = attn(blk, h, num_heads=1, split_bytes=ATTN_SPLIT_BYTES)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def svd_vae_decode(dec: SVDVAEDecoder, latents, scaling: float = SD_VAE_SCALING):
    """latents (4, T, h, w) -> video (3, T, 8h, 8w)."""
    h = conv2d(dec.conv_in, latents.transpose(0, 1) / scaling)
    for p, (kind, eps) in zip(dec.blocks, SVD_VAE_DECODER_PROGRAM):
        if kind == "res":
            h = resnet_block(p, h, eps=eps)
        elif kind == "tres":
            h = svd_temporal_resnet_vae(p, h, eps)
        elif kind == "vattn":
            h = svd_vae_attention(p, h, eps)
        else:
            h = upsample(p, h)
    h = conv2d(dec.conv_out, _silu(group_norm(dec.conv_norm_out, h, eps=1e-5)))
    return _conv3_t(dec.time_conv_out, h.transpose(0, 1)[None])[0]


def svd_vae_encode(enc, image, scaling: float = SVD_VAE_SCALING):
    """SD's encoder (an `sd.SDVAEEncoder`) at the scaling 0.13025."""
    return sd_vae_encoder_forward(enc, image) / SD_VAE_SCALING * scaling


def sd_vae_encode_raw(enc, image):
    """The unscaled latent (the pipeline's image condition)."""
    return sd_vae_encoder_forward(enc, image) / SD_VAE_SCALING


@torch.no_grad()
def init_svd_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """`sd.init_sd_module_` with the 3-D convolutions drawn as the 2-D ones
    (weights N(0, 1/fan_in), biases N(0, 0.02^2)) and the mix factors
    N(0, 1)."""
    from .sd import init_sd_module_
    init_sd_module_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            m.bias.normal_(0.0, 0.02, generator=generator)
        if isinstance(getattr(m, "mix_factor", None), nn.Parameter):
            m.mix_factor.normal_(0.0, 1.0, generator=generator)
    return module


def convert_svd_module(sd: Dict) -> Dict:
    """A reference SVD module's state dict -> the port's names (SD's rule:
    a norm's `weight` becomes `scale`)."""
    from .sd import convert_sd_module
    return convert_sd_module(sd)
