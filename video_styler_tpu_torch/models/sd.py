"""Stable Diffusion 1.5 in PyTorch: the UNet, the CLIP-L text encoder, the
VAE, and the building blocks that the SDXL UNet, the ControlNets, the
AnimateDiff motion modules and the FLUX / SD3 image VAE share.

Counterpart of `video_styler_tpu/models/sd.py`: `conv2d`, `group_norm`
(fp32 statistics, cast back), `attn` (the exact `sdpa`, with a mask added to
the fp32 logits and the IP-Adapter's decoupled term `scale * sdpa(q, ip_k,
ip_v)` before `to_out`: heads of 40/80/160, 64, CLIP's causal mask and the
VAE's one 512-wide head are no Pallas kernel in JAX either),
`timestep_embedding` (cos first), `basic_transformer_block`,
`resnet_block` (the time embedding added after `conv1`),
`attention_block`, the VAE's blocks, `SD_UNET_PROGRAM` and
`sd_unet_forward` (the ControlNet residuals added after block 30, the
IP-Adapter kv pairs per attention block, the motion modules after the
blocks of their call map), `sd_text_encoder_forward`, the VAE forwards
with `SD_VAE_SCALING`, and `convert_sd_module`.

Parameters live in modules named after the reference's (DiffSynth) names,
so one state dict feeds the JAX converter and this one: convolutions are
`nn.Conv2d` (weight OIHW, bias), norms hold `scale` and `bias` (the
reference's `weight` renamed, as the JAX converter renames it), linears are
`wan_dit.Linear` (weight (out, in)). The JAX forwards read the widths from
the weights; here `SDUNetConfig` gives them, and `unet_blocks` builds a
block program's modules by walking it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .wan_dit import LayerNormAffine as Affine
from .wan_dit import Linear


# ------------------------------------------------------------- primitives

def conv2d(p: nn.Conv2d, x, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p.weight.to(x.dtype),
                    None if p.bias is None else p.bias.to(x.dtype), stride, padding)


def group_norm(p: Affine, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm with fp32 statistics and affine terms, cast back."""
    return F.group_norm(x.float(), groups, p.scale.float(), p.bias.float(), eps).to(x.dtype)


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def _ln(p: Affine, x, eps: float = 1e-5):
    return layer_norm(x, p.scale, p.bias, eps)


class Attention(nn.Module):
    """to_q / to_k / to_v (biased where `qkv_bias`; keys and values read
    `kv_dim`-wide context) and a biased to_out."""

    def __init__(self, dim: int, device=None, dtype=None, kv_dim: Optional[int] = None,
                 qkv_bias: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        kv_dim = kv_dim or dim
        self.to_q = Linear(dim, dim, bias=qkv_bias, **kw)
        self.to_k = Linear(kv_dim, dim, bias=qkv_bias, **kw)
        self.to_v = Linear(kv_dim, dim, bias=qkv_bias, **kw)
        self.to_out = Linear(dim, dim, **kw)


def attn(p: Attention, x, num_heads: int = 8, mask: Optional[torch.Tensor] = None,
         context=None, ip_kv=None):
    """Attention (b, s, c) -> (b, s, c) through the exact `sdpa`, over
    `context` (b, sk, c_kv) or x itself; mask (s, sk) is added to the fp32
    logits. ip_kv = (ip_k, ip_v, scale) adds the IP-Adapter's
    `scale * sdpa(q, ip_k, ip_v)` before `to_out`."""
    context = x if context is None else context
    b, s, _ = x.shape
    sk = context.shape[1]
    q, k, v = p.to_q(x), p.to_k(context), p.to_v(context)
    d = q.shape[-1] // num_heads
    bias = None if mask is None else mask[None, None].float()
    qh = q.view(b, s, num_heads, d)
    out = sdpa(qh, k.view(b, sk, num_heads, d), v.view(b, sk, num_heads, d), bias=bias)
    if ip_kv is not None:
        ip_k, ip_v, scale = ip_kv
        lk = ip_k.shape[1]
        ip_k = ip_k.to(q.dtype).expand(b, lk, -1).reshape(b, lk, num_heads, d)
        ip_v = ip_v.to(q.dtype).expand(b, lk, -1).reshape(b, lk, num_heads, d)
        out = out + scale * sdpa(qh, ip_k, ip_v)
    return p.to_out(out.reshape(b, s, num_heads * d))


def timestep_embedding(timesteps, num_channels: int = 320):
    """Sinusoidal embedding, cos first, exponents spaced over half the
    width (fp32)."""
    half = num_channels // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32,
                                               device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


# ------------------------------------------------------------- blocks

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None, dtype=None,
                 temb_dim: Optional[int] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Affine(cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        if temb_dim:
            self.time_emb_proj = Linear(temb_dim, cout, **kw)
        self.norm2 = Affine(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1, **kw)


class VAEAttentionBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.norm = Affine(dim, device=device, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([Attention(dim, device=device, dtype=dtype)])


class Resample(nn.Module):
    """The stride-2 conv of a downsample, or the conv after a 2x upsample."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, device=device, dtype=dtype)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, device=device, dtype=dtype)


def geglu(p: GEGLU, x):
    """proj, split in halves, the first times the exact GELU (fp32) of the
    second."""
    a, gate = p.proj(x).chunk(2, dim=-1)
    return a * F.gelu(gate.float()).to(a.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, text_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Affine(dim, **kw)
        self.attn1 = Attention(dim, qkv_bias=False, **kw)
        self.norm2 = Affine(dim, **kw)
        self.attn2 = Attention(dim, kv_dim=text_dim, qkv_bias=False, **kw)
        self.norm3 = Affine(dim, **kw)
        self.act_fn = GEGLU(dim, 4 * dim, **kw)
        self.ff = Linear(4 * dim, dim, **kw)


class AttentionBlock(nn.Module):
    """The UNet's spatial transformer: GroupNorm, proj_in, `depth` basic
    transformer blocks, proj_out."""

    def __init__(self, dim: int, depth: int, text_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = Affine(dim, **kw)
        self.proj_in = Linear(dim, dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(dim, text_dim, **kw) for _ in range(depth))
        self.proj_out = Linear(dim, dim, **kw)


def resnet_block(p: ResnetBlock, x, eps: float = 1e-5, time_emb=None):
    h = conv2d(p.conv1, _silu(group_norm(p.norm1, x, eps=eps)))
    if time_emb is not None and hasattr(p, "time_emb_proj"):
        h = h + p.time_emb_proj(_silu(time_emb))[:, :, None, None].to(h.dtype)
    h = conv2d(p.conv2, _silu(group_norm(p.norm2, h, eps=eps)))
    if hasattr(p, "conv_shortcut"):
        x = conv2d(p.conv_shortcut, x, padding=0)
    return x + h


def basic_transformer_block(p: BasicTransformerBlock, x, text_emb, num_heads: int,
                            ip_kv=None):
    x = x + attn(p.attn1, _ln(p.norm1, x), num_heads=num_heads)
    x = x + attn(p.attn2, _ln(p.norm2, x), num_heads=num_heads, context=text_emb,
                 ip_kv=ip_kv)
    return x + p.ff(geglu(p.act_fn, _ln(p.norm3, x)))


def attention_block(p: AttentionBlock, x, text_emb, num_heads: int, eps: float = 1e-6,
                    ipadapter_kwargs=None):
    """(b, c, h, w) -> (b, c, h, w); ipadapter_kwargs maps a transformer
    layer's index to its (ip_k, ip_v, scale)."""
    b, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    h = p.proj_in(h)
    te = text_emb if text_emb.shape[0] == b else text_emb.expand(b, *text_emb.shape[1:])
    for i, blk in enumerate(p.transformer_blocks):
        ip_kv = None if ipadapter_kwargs is None else ipadapter_kwargs.get(i)
        h = basic_transformer_block(blk, h, te, num_heads, ip_kv=ip_kv)
    h = p.proj_out(h)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def vae_attention_block(p: VAEAttentionBlock, x, eps: float = 1e-6):
    """One head over every position: (b, c, h, w) -> (b, c, h, w)."""
    b, c, hh, ww = x.shape
    h = group_norm(p.norm, x, eps=eps)
    h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    for blk in p.transformer_blocks:
        h = attn(blk, h, num_heads=1)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def downsample(p: Resample, x, padding: int = 1, extra_padding: bool = False):
    if extra_padding:
        x = F.pad(x, (0, 1, 0, 1))
    return conv2d(p.conv, x, stride=2, padding=padding)


def upsample(p: Resample, x):
    return conv2d(p.conv, x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


# ------------------------------------------------------------- UNet programs

# (kind, heads) per block of the SD 1.5 UNet
SD_UNET_PROGRAM: List[Tuple[str, int]] = (
    [("res", 0), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("attn", 8), ("push", 0)] * 2 + [("down", 0), ("push", 0)]
    + [("res", 0), ("push", 0)] * 2
    + [("res", 0), ("attn", 8), ("res", 0)]
    + [("pop", 0), ("res", 0)] * 3 + [("up", 0)]
    + [("pop", 0), ("res", 0), ("attn", 8)] * 3 + [("up", 0)]
    + [("pop", 0), ("res", 0), ("attn", 8)] * 3 + [("up", 0)]
    + [("pop", 0), ("res", 0), ("attn", 8)] * 3
)
SD_CONTROLNET_AT = 30       # the block after which the ControlNet residuals join
TIME_PROJ = 320             # the timestep sinusoid's width, whatever the UNet's
LATENT_CHANNELS = 4


@dataclass(frozen=True)
class SDUNetConfig:
    """Widths of a UNet of the SD family. `depth[level]` is the transformer
    count of an attention block at that level, `mid_depth` the middle
    block's; `add_embed_dim` (SDXL) the micro-conditioning input (pooled
    text + 6 x 256), `text_proj_dim` (Kolors) the text width that
    `text_intermediate_proj` maps to `text_dim`."""
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    text_dim: int = 768
    depth: Tuple[int, ...] = (1, 1, 1, 0)
    mid_depth: int = 1
    add_embed_dim: int = 0
    text_proj_dim: int = 0

    @property
    def temb_dim(self) -> int:
        return 4 * self.channels[0]


SD_UNET = SDUNetConfig()
# 8 heads of 4 and 8 at the smallest widths GroupNorm's 32 groups allow;
# the context of a CLIP-L of 12 heads of 4
SD_UNET_TINY = SDUNetConfig(channels=(32, 32, 64, 64), text_dim=48)


def program_widths(program, cfg: SDUNetConfig, start: Optional[int] = None):
    """Walk a block program from `conv_in`'s width: per block, (kind,
    level, input width, output width); and the widths of the pushed
    residuals, `conv_in`'s output first."""
    level, cur = 0, cfg.channels[0] if start is None else start
    stack, pushed, out = [cur], [cur], []
    for kind, _ in program:
        cin = cur
        if kind == "res":
            cur = cfg.channels[level]
        elif kind == "push":
            stack.append(cur)
            pushed.append(cur)
        elif kind == "pop":
            cur = cur + stack.pop()
        elif kind == "down":
            level += 1
        elif kind == "up":
            level -= 1
        out.append((kind, level, cin, cur))
    return out, pushed


def unet_blocks(program, cfg: SDUNetConfig, device=None, dtype=None) -> nn.ModuleList:
    """The program's modules in order (an empty module for push and pop,
    so that `blocks.N` keeps the program's index). The middle attention
    block (the one a resnet follows) has `mid_depth` transformers."""
    kw = dict(device=device, dtype=dtype)
    walk, _ = program_widths(program, cfg)
    blocks = []
    for i, (kind, level, cin, cout) in enumerate(walk):
        if kind == "res":
            blocks.append(ResnetBlock(cin, cout, temb_dim=cfg.temb_dim, **kw))
        elif kind == "attn":
            mid = i + 1 < len(program) and program[i + 1][0] == "res"
            depth = cfg.mid_depth if mid else cfg.depth[level]
            blocks.append(AttentionBlock(cin, depth, cfg.text_dim, **kw))
        elif kind in ("down", "up"):
            blocks.append(Resample(cin, **kw))
        else:
            blocks.append(nn.Module())
    return nn.ModuleList(blocks)


def detect_unet_config(sd: Dict, program) -> SDUNetConfig:
    """A UNet's (or a ControlNet trunk's) widths read from its state dict
    under the port's names: each level's resnet width, each attention
    block's transformer count, the context width, the add embedding's and
    Kolors' text projection's input widths."""
    levels = 1 + sum(kind == "down" for kind, _ in program)
    channels, depth = [0] * levels, [0] * levels
    mid_depth, text_dim, level = 0, 0, 0
    for i, (kind, _) in enumerate(program):
        if kind == "down":
            level += 1
        elif kind == "up":
            level -= 1
        elif kind == "res":
            channels[level] = sd[f"blocks.{i}.conv1.weight"].shape[0]
        elif kind == "attn":
            n = 0
            while f"blocks.{i}.transformer_blocks.{n}.attn2.to_k.weight" in sd:
                n += 1
            text_dim = sd[f"blocks.{i}.transformer_blocks.0.attn2.to_k.weight"].shape[1]
            if i + 1 < len(program) and program[i + 1][0] == "res":
                mid_depth = n
            else:
                depth[level] = n
    add = sd.get("add_time_embedding.0.weight")
    proj = sd.get("text_intermediate_proj.weight")
    return SDUNetConfig(channels=tuple(channels), text_dim=text_dim, depth=tuple(depth),
                        mid_depth=mid_depth, add_embed_dim=0 if add is None else add.shape[1],
                        text_proj_dim=0 if proj is None else proj.shape[1])


def _embedding(cin: int, dim: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"0": Linear(cin, dim, **kw), "2": Linear(dim, dim, **kw)})


class SDUNet(nn.Module):
    program = SD_UNET_PROGRAM

    def __init__(self, cfg: SDUNetConfig = SD_UNET, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        c0 = cfg.channels[0]
        self.time_embedding = _embedding(TIME_PROJ, cfg.temb_dim, **kw)
        if cfg.add_embed_dim:
            self.add_time_embedding = _embedding(cfg.add_embed_dim, cfg.temb_dim, **kw)
        if cfg.text_proj_dim:
            self.text_intermediate_proj = Linear(cfg.text_proj_dim, cfg.text_dim, **kw)
        self.conv_in = nn.Conv2d(LATENT_CHANNELS, c0, 3, **kw)
        self.blocks = unet_blocks(self.program, cfg, **kw)
        self.conv_norm_out = Affine(c0, **kw)
        self.conv_out = nn.Conv2d(c0, LATENT_CHANNELS, 3, **kw)


def embed_time(emb: nn.ModuleDict, t_emb):
    return emb["2"](_silu(emb["0"](t_emb)))


def run_unet(model, program, h, time_emb, text_emb, controlnet_res_stack=None,
             ipadapter_kwargs_list=None, motion=None, controlnet_at: int = SD_CONTROLNET_AT):
    """The push/pop interpreter over `program` from `conv_in`'s output to
    `conv_out`'s. motion = (a motion model, {block id: module index})."""
    from .motion import temporal_block
    res_stack = [h]
    cn = None if controlnet_res_stack is None else list(controlnet_res_stack)
    for i, (kind, heads) in enumerate(program):
        p = model.blocks[i]
        if kind == "res":
            h = resnet_block(p, h, time_emb=time_emb)
        elif kind == "attn":
            ip = None if ipadapter_kwargs_list is None else ipadapter_kwargs_list.get(i)
            h = attention_block(p, h, text_emb, heads, ipadapter_kwargs=ip)
        elif kind == "push":
            res_stack.append(h)
        elif kind == "pop":
            h = torch.cat([h, res_stack.pop()], dim=1)
        elif kind == "down":
            h = downsample(p, h)
        elif kind == "up":
            h = upsample(p, h)
        if motion is not None and i in motion[1]:
            h = temporal_block(motion[0].motion_modules[motion[1][i]], h)
        if cn is not None and i == controlnet_at:
            h = h + cn.pop().to(h.dtype)
            res_stack = [r + a.to(r.dtype) for r, a in zip(res_stack, cn)]
    return conv2d(model.conv_out, _silu(group_norm(model.conv_norm_out, h)))


def sd_unet_forward(model: SDUNet, sample, timestep, text_emb, controlnet_res_stack=None,
                    ipadapter_kwargs_list=None, motion=None):
    """sample (B, 4, H/8, W/8), timestep (1,) or (B,), text_emb (1 or B, L,
    768) -> the predicted noise. controlnet_res_stack: 13 residuals (added
    after block 30); ipadapter_kwargs_list: {block id: {layer: (ip_k, ip_v,
    scale)}}; motion: (a motion model, `SD_MOTION_CALL_BLOCK_ID`)."""
    time_emb = embed_time(model.time_embedding,
                          timestep_embedding(timestep, TIME_PROJ).to(sample.dtype))
    h = conv2d(model.conv_in, sample)
    return run_unet(model, SD_UNET_PROGRAM, h, time_emb, text_emb, controlnet_res_stack,
                    ipadapter_kwargs_list, motion)


# ------------------------------------------------------------- text encoder

def sd_text_encoder_forward(model, input_ids, clip_skip: int = 1):
    """CLIP-L (`sd3_text_encoder.ClipTextEncoder`, 12 layers): input_ids
    (B, L) -> the final norm of the state `clip_skip - 1` layers before the
    end (B, L, 768)."""
    from .sd3_text_encoder import causal_mask, clip_layer
    cfg = model.cfg
    x = model.token_embedding.weight[input_ids.long()]
    x = x + model.position_embeds.to(x.dtype)
    mask = causal_mask(x.shape[1], x.device)
    for i, p in enumerate(model.encoders):
        x = clip_layer(p, x, mask, cfg.num_heads, quick_gelu=True)
        if i + clip_skip == cfg.num_layers:
            break
    return _ln(model.final_layer_norm, x)


# ------------------------------------------------------------- VAE

# (kind, eps) per block of the VAE's decoder and encoder
SD_VAE_DECODER_PROGRAM = (
    [("res", 1e-6), ("vattn", 1e-6), ("res", 1e-6)]
    + ([("res", 1e-6)] * 3 + [("up", 0)]) * 3
    + [("res", 1e-6)] * 3
)

SD_VAE_ENCODER_PROGRAM = (
    ([("res", 1e-6)] * 2 + [("downx", 0)]) * 3
    + [("res", 1e-6)] * 2
    + [("res", 1e-6), ("vattn", 1e-6), ("res", 1e-6)]
)

# the width of each resolution level, outermost first (the JAX forwards
# read them from the weights)
SD_VAE_CHANNELS = (128, 256, 512, 512)
SD_VAE_SCALING = 0.18215


def vae_blocks(program, device=None, dtype=None) -> nn.ModuleList:
    """The program's blocks in order. The encoder walks the levels of
    `SD_VAE_CHANNELS` in, the decoder out, each resample moving to the next
    level. A level's first resnet block changes the width; the mid blocks
    sit at the innermost level."""
    kw = dict(device=device, dtype=dtype)
    encoder = any(kind == "downx" for kind, _ in program)
    levels = list(SD_VAE_CHANNELS) if encoder else list(SD_VAE_CHANNELS)[::-1]
    blocks, level = [], 0
    cin = levels[0]
    for kind, _ in program:
        if kind == "res":
            blocks.append(ResnetBlock(cin, levels[level], **kw))
            cin = levels[level]
        elif kind == "vattn":
            blocks.append(VAEAttentionBlock(cin, **kw))
        else:
            blocks.append(Resample(cin, **kw))
            level += 1
    return nn.ModuleList(blocks)


def run_vae_blocks(blocks: nn.ModuleList, program, h):
    for p, (kind, eps) in zip(blocks, program):
        if kind == "res":
            h = resnet_block(p, h, eps=eps)
        elif kind == "vattn":
            h = vae_attention_block(p, h, eps)
        elif kind == "downx":
            h = downsample(p, h, padding=0, extra_padding=True)
        else:
            h = upsample(p, h)
    return h


class SDVAEEncoder(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = SD_VAE_CHANNELS
        self.conv_in = nn.Conv2d(3, ch[0], 3, **kw)
        self.blocks = vae_blocks(SD_VAE_ENCODER_PROGRAM, **kw)
        self.conv_norm_out = Affine(ch[-1], **kw)
        self.conv_out = nn.Conv2d(ch[-1], 8, 3, **kw)
        self.quant_conv = nn.Conv2d(8, 8, 1, **kw)


class SDVAEDecoder(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = SD_VAE_CHANNELS
        self.post_quant_conv = nn.Conv2d(4, 4, 1, **kw)
        self.conv_in = nn.Conv2d(4, ch[-1], 3, **kw)
        self.blocks = vae_blocks(SD_VAE_DECODER_PROGRAM, **kw)
        self.conv_norm_out = Affine(ch[0], **kw)
        self.conv_out = nn.Conv2d(ch[0], 3, 3, **kw)


def sd_vae_encoder_forward(enc: SDVAEEncoder, sample):
    """Image (B, 3, H, W) in [-1, 1] -> scaled latents (B, 4, H/8, W/8)
    (the mean of the posterior)."""
    h = conv2d(enc.conv_in, sample)
    h = run_vae_blocks(enc.blocks, SD_VAE_ENCODER_PROGRAM, h)
    h = conv2d(enc.conv_out, _silu(group_norm(enc.conv_norm_out, h, eps=1e-6)))
    h = conv2d(enc.quant_conv, h, padding=0)
    return h[:, :4] * SD_VAE_SCALING


def sd_vae_decoder_forward(dec: SDVAEDecoder, sample):
    """Scaled latents (B, 4, h, w) -> image (B, 3, 8h, 8w). The output
    norm's eps is 1e-5, as in JAX (the encoder's is 1e-6)."""
    h = conv2d(dec.post_quant_conv, sample / SD_VAE_SCALING, padding=0)
    h = conv2d(dec.conv_in, h)
    h = run_vae_blocks(dec.blocks, SD_VAE_DECODER_PROGRAM, h)
    return conv2d(dec.conv_out, _silu(group_norm(dec.conv_norm_out, h)))


# ------------------------------------------------------------- init, converter

@torch.no_grad()
def init_sd_module_(module: nn.Module, generator: torch.Generator, bias_std: float = 0.02,
                    norm_std: float = 0.1) -> nn.Module:
    """Random init of any module of this family: conv and linear weights
    N(0, 1/fan_in), biases N(0, bias_std^2), norm scales 1 + N(0,
    norm_std^2) and biases N(0, norm_std^2), every other parameter (token,
    position and task tables) N(0, 0.02^2)."""
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
            if m.bias is not None:
                m.bias.normal_(0.0, bias_std, generator=generator)
        elif isinstance(m, Affine):
            m.scale.normal_(1.0, norm_std, generator=generator)
            m.bias.normal_(0.0, norm_std, generator=generator)
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in done:
            p.normal_(0.0, 0.02, generator=generator)
    return module


def convert_sd_module(sd: Dict) -> Dict:
    """A reference module's state dict -> the port's names: a norm's
    `weight` becomes `scale` (the JAX converter's rule: "norm" in the leaf
    or its parent's name); every other name and layout passes through."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        parent = parts[-2] if len(parts) > 1 else ""
        if parts[-1] == "weight" and ("norm" in parent or "norm" in parts[-1]):
            key = ".".join(parts[:-1] + ["scale"])
        out[key] = val
    return out
