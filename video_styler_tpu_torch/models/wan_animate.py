"""Wan2.2-Animate adapter in PyTorch: pose and face conditioning.

Counterpart of `video_styler_tpu/models/wan_animate.py`. The modules carry
the reference's names, so the official state dict loads as it is
(`convert_wan_animate` only picks the adapter's keys):

- `pose_patch_embedding`: pose latents (16 channels, patch 1x2x2) -> tokens
  added to the DiT tokens of latent frames 1.. after patchify.
- `motion_encoder`: the StyleGAN-style appearance encoder (equalised convs
  and linears, blur-downsampling residual blocks, fused leaky ReLU) at
  `face_size`, an equalised-linear head, and the projection onto the QR
  basis of the `direction` weight. Q is taken on the host (LAPACK, as the
  JAX package takes it on the CPU) once per weight and kept: a QR's columns
  are unique only up to sign, and the card's solver may pick other signs.
- `face_encoder`: a causal conv1d pyramid (stride 1, 2, 2) over the
  per-frame motion vectors -> 4 motion tokens a latent frame plus a
  learned padding token.
- `face_adapter.fuser_blocks`: `face_block`, a per-frame cross-attention
  of the video tokens to that frame's 5 motion tokens, added after every
  5th DiT layer. Its attention is the exact `ops.attention.sdpa`, as the
  JAX package's is XLA's sdpa (no Pallas kernel): 5 keys per query.

Every convolution runs in the activation dtype with fp32 accumulation and
one rounding (cuDNN on the card; fp32 arithmetic on the rounded operands on
the CPU), as the JAX package's `preferred_element_type` convolutions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm, patchify, rms_norm, silu

# the appearance encoder's channels by resolution
_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64,
             512: 32, 1024: 16}
_BLUR = (1, 3, 3, 1)


@dataclass(frozen=True)
class AnimateConfig:
    dim: int = 5120                  # the DiT width
    num_face_blocks: int = 8         # one after every 5th of 40 layers
    face_size: int = 512             # the motion encoder's input resolution
    style_dim: int = 512
    motion_dim: int = 20
    face_heads: int = 4              # the face encoder's token count
    face_conv_dim: int = 1024        # the face encoder's conv width
    pose_in_dim: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)


WAN_ANIMATE_14B = AnimateConfig()


# ------------------------------------------------------------ containers

class _Params(nn.Module):
    """A leaf holding `weight` and optionally `bias` of given shapes."""

    def __init__(self, weight, bias=None, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight, device=device, dtype=dtype))
        if bias is not None:
            self.bias = nn.Parameter(torch.empty(bias, device=device, dtype=dtype))


class _Bias(nn.Module):
    """FusedLeakyReLU: a (1, C, 1, 1) bias."""

    def __init__(self, c, device=None, dtype=None):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(1, c, 1, 1, device=device, dtype=dtype))


def _blur_kernel() -> torch.Tensor:
    k = torch.tensor(_BLUR, dtype=torch.float32, device="cpu")
    k = k[None, :] * k[:, None]
    return k / k.sum()


class _Blur(nn.Module):
    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.register_buffer("kernel", torch.empty(4, 4, device=device, dtype=dtype))


def _conv_layer(cin, cout, k, downsample, activate=True, **kw) -> nn.Sequential:
    """ConvLayer: [Blur] EqualConv2d [FusedLeakyReLU]; the conv has no bias
    when activated (the activation holds it) or when asked for none."""
    layers = [_Blur(**kw)] if downsample else []
    layers.append(_Params((cout, cin, k, k), **kw))
    if activate:
        layers.append(_Bias(cout, **kw))
    return nn.Sequential(*layers)


class _ResBlock(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv1 = _conv_layer(cin, cin, 3, False, **kw)
        self.conv2 = _conv_layer(cin, cout, 3, True, **kw)
        self.skip = _conv_layer(cin, cout, 1, True, activate=False, **kw)


class _EncoderApp(nn.Module):
    def __init__(self, size, w_dim, **kw):
        super().__init__()
        log_size = int(math.log(size, 2))
        convs = [_conv_layer(3, _CHANNELS[size], 1, False, **kw)]
        cin = _CHANNELS[size]
        for i in range(log_size, 2, -1):
            cout = _CHANNELS[2 ** (i - 1)]
            convs.append(_ResBlock(cin, cout, **kw))
            cin = cout
        convs.append(_Params((w_dim, cin, 4, 4), **kw))
        self.convs = nn.ModuleList(convs)


class _Encoder(nn.Module):
    def __init__(self, cfg: AnimateConfig, **kw):
        super().__init__()
        d = cfg.style_dim
        self.net_app = _EncoderApp(cfg.face_size, d, **kw)
        self.fc = nn.ModuleList([_Params((d, d), (d,), **kw) for _ in range(4)]
                                + [_Params((cfg.motion_dim, d), (cfg.motion_dim,), **kw)])


class _Direction(nn.Module):
    def __init__(self, cfg: AnimateConfig, **kw):
        super().__init__()
        self.direction = _Params((cfg.style_dim, cfg.motion_dim), **kw)


class MotionEncoder(nn.Module):
    def __init__(self, cfg: AnimateConfig, **kw):
        super().__init__()
        self.enc = _Encoder(cfg, **kw)
        self.dec = _Direction(cfg, **kw)
        self._q = None   # (key of the direction weight, Q on its device)


class _CausalConv(nn.Module):
    def __init__(self, cin, cout, k=3, **kw):
        super().__init__()
        self.conv = _Params((cout, cin, k), (cout,), **kw)


class FaceEncoder(nn.Module):
    def __init__(self, cfg: AnimateConfig, **kw):
        super().__init__()
        c = cfg.face_conv_dim
        self.conv1_local = _CausalConv(cfg.style_dim, c * cfg.face_heads, **kw)
        self.conv2 = _CausalConv(c, c, **kw)
        self.conv3 = _CausalConv(c, c, **kw)
        self.out_proj = _Params((cfg.dim, c), (cfg.dim,), **kw)
        self.padding_tokens = nn.Parameter(torch.empty(1, 1, 1, cfg.dim, **kw))


class FaceBlock(nn.Module):
    def __init__(self, dim: int, head_dim: int, **kw):
        super().__init__()
        self.linear1_kv = _Params((2 * dim, dim), (2 * dim,), **kw)
        self.linear1_q = _Params((dim, dim), (dim,), **kw)
        self.linear2 = _Params((dim, dim), (dim,), **kw)
        self.q_norm = _Params((head_dim,), **kw)
        self.k_norm = _Params((head_dim,), **kw)


class _FaceAdapter(nn.Module):
    def __init__(self, cfg: AnimateConfig, head_dim: int, **kw):
        super().__init__()
        self.fuser_blocks = nn.ModuleList(FaceBlock(cfg.dim, head_dim, **kw)
                                          for _ in range(cfg.num_face_blocks))


class WanAnimateAdapter(nn.Module):
    """The adapter's parameters under the reference's names. `head_dim` is
    the face blocks' (the DiT's heads split the width: 128 at 14B)."""

    def __init__(self, cfg: AnimateConfig, head_dim: int = 128, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        pt, ph, pw = cfg.patch_size
        self.pose_patch_embedding = _Params((cfg.dim, cfg.pose_in_dim, pt, ph, pw),
                                            (cfg.dim,), **kw)
        self.motion_encoder = MotionEncoder(cfg, **kw)
        self.face_encoder = FaceEncoder(cfg, **kw)
        self.face_adapter = _FaceAdapter(cfg, head_dim, **kw)


@torch.no_grad()
def init_wan_animate_(m: WanAnimateAdapter, generator: torch.Generator):
    """Random weights (the JAX package has no init for the adapter): the
    equalised layers N(0, 1) as the reference initialises them (their
    scale is applied in the forward), other linears and convs N(0, 1/fan
    in), biases and the padding token 0, norm weights 1, the pose
    embedding at std 0.02; the blur kernels get their fixed values."""
    equalised = {mod for mod in m.motion_encoder.modules() if isinstance(mod, _Params)}
    for mod in m.modules():
        if isinstance(mod, _Params):
            w = mod.weight
            if mod in equalised:
                w.normal_(0.0, 1.0, generator=generator)
            elif w.dim() == 1:
                w.fill_(1.0)
            else:
                w.normal_(0.0, 1.0 / math.sqrt(math.prod(w.shape[1:])), generator=generator)
            if hasattr(mod, "bias"):
                mod.bias.zero_()
        elif isinstance(mod, _Bias):
            mod.bias.zero_()
        elif isinstance(mod, _Blur):
            mod.kernel.copy_(_blur_kernel())
    m.pose_patch_embedding.weight.normal_(0.0, 0.02, generator=generator)
    m.face_encoder.padding_tokens.zero_()
    return m


# ------------------------------------------------------------ StyleGAN ops

def _conv(x, w, stride=1, padding=0):
    """x.dtype operands, fp32 accumulation, one rounding to x.dtype."""
    w = w.to(x.dtype)
    if x.is_cuda:
        return F.conv2d(x, w, None, stride, padding)
    return F.conv2d(x.float(), w.float(), None, stride, padding).to(x.dtype)


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Upsample by zeros, pad (or crop, where negative), filter with the
    flipped kernel per channel, downsample. x: (B, C, H, W)."""
    b, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    x = x[:, :, max(-p0, 0): x.shape[2] - max(-p1, 0),
          max(-p0, 0): x.shape[3] - max(-p1, 0)]
    k = torch.flip(kernel, (0, 1))[None, None]
    y = _conv(x.reshape(b * c, 1, x.shape[2], x.shape[3]), k)
    y = y.reshape(b, c, y.shape[2], y.shape[3])
    return y[:, :, ::down, ::down]


def equal_conv2d(p: _Params, x, stride=1, padding=0):
    w = p.weight
    scale = 1 / math.sqrt(w.shape[1] * w.shape[2] ** 2)
    y = _conv(x, w * scale, stride, padding)
    if hasattr(p, "bias"):
        y = y + p.bias.to(y.dtype)[None, :, None, None]
    return y


def fused_leaky_relu(p: _Bias, x, negative_slope=0.2, scale=2 ** 0.5):
    y = x + p.bias.to(x.dtype)
    return torch.where(y >= 0, y, negative_slope * y) * scale


def equal_linear(p: _Params, x):
    scale = 1 / math.sqrt(p.weight.shape[1])
    return x @ (p.weight.t() * scale).to(x.dtype) + p.bias.to(x.dtype)


def conv_layer(seq: nn.Sequential, x, kernel_size: int, downsample: bool):
    """ConvLayer: [Blur] EqualConv2d [FusedLeakyReLU]."""
    idx = 0
    if downsample:
        pl = (len(_BLUR) - 2) + (kernel_size - 1)
        x = upfirdn2d(x, seq[0].kernel, pad=((pl + 1) // 2, pl // 2))
        idx, stride, padding = 1, 2, 0
    else:
        stride, padding = 1, kernel_size // 2
    x = equal_conv2d(seq[idx], x, stride, padding)
    if len(seq) > idx + 1:
        x = fused_leaky_relu(seq[idx + 1], x)
    return x


def res_block(p: _ResBlock, x):
    out = conv_layer(p.conv1, x, 3, False)
    out = conv_layer(p.conv2, out, 3, True)
    skip = conv_layer(p.skip, x, 1, True)
    return (out + skip) / math.sqrt(2)


def encoder_app(p: _EncoderApp, x):
    """(B, 3, size, size) -> (B, style_dim)."""
    h = conv_layer(p.convs[0], x, 1, False)
    for blk in p.convs[1:-1]:
        h = res_block(blk, h)
    h = equal_conv2d(p.convs[-1], h)
    return h[:, :, 0, 0]


def motion_directions(m: MotionEncoder) -> torch.Tensor:
    """Q of the QR of `direction.weight + 1e-8` (fp32), taken on the host
    once per weight and kept on the weight's device."""
    w = m.dec.direction.weight
    key = (w.data_ptr(), w._version, w.device)
    if m._q is None or m._q[0] != key:
        q, _ = torch.linalg.qr(w.detach().float().cpu() + 1e-8)
        m._q = (key, q.to(w.device))
    return m._q[1]


def get_motion(m: MotionEncoder, imgs):
    """Face crops (B, 3, size, size) -> motion vectors (B, style_dim)."""
    h = encoder_app(m.enc.net_app, imgs)
    for fc in m.enc.fc:
        h = equal_linear(fc, h)
    q = motion_directions(m)
    return (h.float() @ q.t()).to(imgs.dtype)


# ------------------------------------------------------------ face encoder

def _causal_conv1d(p: _CausalConv, x, stride=1):
    k = p.conv.weight.shape[2]
    x = F.pad(x, (k - 1, 0), mode="replicate")
    if x.is_cuda:
        return F.conv1d(x, p.conv.weight.to(x.dtype), p.conv.bias.to(x.dtype), stride)
    y = F.conv1d(x.float(), p.conv.weight.to(x.dtype).float(), None, stride)
    return (y + p.conv.bias.float()[None, :, None]).to(x.dtype)


def face_encoder(p: FaceEncoder, x, num_heads: int):
    """(B, T, style_dim) -> (B, T', num_heads + 1, dim): T' = T after two
    stride-2 causal convs, the padding token last on each frame."""
    b = x.shape[0]
    x = _causal_conv1d(p.conv1_local, x.transpose(1, 2))
    bn, nc, t = x.shape
    x = x.reshape(b, num_heads, nc // num_heads, t).permute(0, 1, 3, 2)
    x = silu(layer_norm(x.reshape(b * num_heads, t, nc // num_heads), eps=1e-6))
    x = _causal_conv1d(p.conv2, x.transpose(1, 2), stride=2)
    x = silu(layer_norm(x.transpose(1, 2), eps=1e-6))
    x = _causal_conv1d(p.conv3, x.transpose(1, 2), stride=2)
    x = silu(layer_norm(x.transpose(1, 2), eps=1e-6))
    x = x @ p.out_proj.weight.t().to(x.dtype) + p.out_proj.bias.to(x.dtype)
    x = x.reshape(b, num_heads, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)
    pad = p.padding_tokens.to(x.dtype).expand(b, x.shape[1], 1, x.shape[-1])
    return torch.cat([x, pad], dim=-2)


# ------------------------------------------------------------ face block

def _lin(p: _Params, x):
    return x @ p.weight.t().to(x.dtype) + p.bias.to(x.dtype)


def face_block(p: FaceBlock, x, motion_vec, heads_num: int):
    """x (B, S, C) video tokens, motion_vec (B, T, N, C): the tokens split
    into T equal groups (in order), each attending to its group's N motion
    tokens; -> (B, S, C)."""
    B, T, N, C = motion_vec.shape
    S = x.shape[1]
    D = C // heads_num
    kv = _lin(p.linear1_kv, layer_norm(motion_vec, eps=1e-6))
    q = _lin(p.linear1_q, layer_norm(x, eps=1e-6))
    kv = kv.reshape(B, T, N, 2, heads_num, D)
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    q = rms_norm(q.reshape(B, S, heads_num, D), p.q_norm.weight, eps=1e-6)
    k = rms_norm(k, p.k_norm.weight, eps=1e-6)
    q = q.reshape(B * T, S // T, heads_num, D)
    out = sdpa(q, k.reshape(B * T, N, heads_num, D), v.reshape(B * T, N, heads_num, D))
    return _lin(p.linear2, out.reshape(B, S, C))


# ------------------------------------------------------------ adapter

def pose_tokens(m: WanAnimateAdapter, pose_latents):
    """(B, 16, F - 1, H, W) pose latents -> (B, (F - 1) h w, dim) tokens:
    the Conv3d as a product over patches, rounded before the bias as the
    JAX one is."""
    pe = m.pose_patch_embedding
    w = pe.weight.reshape(pe.weight.shape[0], -1).t()
    tok, _ = patchify(lambda t: t @ w.to(t.dtype) + pe.bias.to(t.dtype),
                      pose_latents, tuple(pe.weight.shape[2:]))
    return tok


def animate_after_patch_embedding(m: WanAnimateAdapter, tokens, grid, pose_latents,
                                  face_pixel_values):
    """tokens (B, f h w, dim) after patchify: the pose tokens added to those
    of latent frames 1..; the face crops (B, 3, T, size, size) -> motion
    tokens (B, T' + 1, 5, dim), a zero frame first. Returns (tokens,
    motion_vec)."""
    f, h, w = grid
    pose = pose_tokens(m, pose_latents)
    tokens = torch.cat([tokens[:, :h * w], tokens[:, h * w:] + pose.to(tokens.dtype)],
                       dim=1)
    b, c, t = face_pixel_values.shape[:3]
    faces = face_pixel_values.permute(0, 2, 1, 3, 4).reshape(b * t, c, *face_pixel_values
                                                             .shape[3:])
    motion = get_motion(m.motion_encoder, faces).reshape(b, t, -1)
    motion_vec = face_encoder(m.face_encoder, motion, m.cfg.face_heads)
    pad = torch.zeros_like(motion_vec[:, :1])
    return tokens, torch.cat([pad, motion_vec], dim=1)


def animate_after_transformer_block(m: WanAnimateAdapter, block_idx: int, x, motion_vec,
                                    heads_num: int):
    """After layer `block_idx`: x + the face block's residual every 5th
    layer (0, 5, 10, ...)."""
    if block_idx % 5 != 0:
        return x
    return x + face_block(m.face_adapter.fuser_blocks[block_idx // 5], x, motion_vec,
                          heads_num)


# ------------------------------------------------------------ files

ANIMATE_PREFIXES = ("pose_patch_embedding.", "motion_encoder.", "face_encoder.",
                    "face_adapter.")


def detect_animate_config(sd: Dict) -> AnimateConfig:
    """The adapter's config from its tensors' names and shapes."""
    pose = sd["pose_patch_embedding.weight"]
    n_convs = 0
    while f"motion_encoder.enc.net_app.convs.{n_convs}.0.weight" in sd or \
            f"motion_encoder.enc.net_app.convs.{n_convs}.weight" in sd or \
            f"motion_encoder.enc.net_app.convs.{n_convs}.conv1.0.weight" in sd:
        n_convs += 1
    n_blocks = 0
    while f"face_adapter.fuser_blocks.{n_blocks}.linear2.weight" in sd:
        n_blocks += 1
    conv1 = sd["face_encoder.conv1_local.conv.weight"]
    c = sd["face_encoder.conv2.conv.weight"].shape[0]
    direction = sd["motion_encoder.dec.direction.weight"]
    return AnimateConfig(dim=pose.shape[0], num_face_blocks=n_blocks,
                         face_size=2 ** n_convs, style_dim=direction.shape[0],
                         motion_dim=direction.shape[1], face_heads=conv1.shape[0] // c,
                         face_conv_dim=c, pose_in_dim=pose.shape[1],
                         patch_size=tuple(pose.shape[2:]))


def animate_head_dim(sd: Dict) -> int:
    return sd["face_adapter.fuser_blocks.0.q_norm.weight"].shape[0]


def convert_wan_animate(sd: Dict) -> Dict:
    """The adapter's keys of a (combined) state dict, names unchanged."""
    return {k: v for k, v in sd.items() if k.startswith(ANIMATE_PREFIXES)}


def export_wan_animate(m: WanAnimateAdapter) -> Dict[str, torch.Tensor]:
    return dict(m.state_dict())


def build_wan_animate(sd: Dict, device, dtype) -> WanAnimateAdapter:
    """A `WanAnimateAdapter` from the adapter's keys, on `device` in
    `dtype` (strict)."""
    from ..utils.ckpt import read_tensors
    sd = convert_wan_animate(sd)
    cfg = detect_animate_config(sd)
    with torch.device("meta"):
        m = WanAnimateAdapter(cfg, animate_head_dim(sd), dtype=dtype)
    m.load_state_dict(read_tensors(sd, device, dtype), strict=True, assign=True)
    return m.eval()
