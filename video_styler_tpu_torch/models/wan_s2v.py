"""Wan2.2 S2V (speech-to-video) DiT in PyTorch.

Counterpart of `video_styler_tpu/models/wan_s2v.py`:

  - segment RoPE tables on the host (float32 numpy): the video grid, the
    reference frame at temporal index 30, frame-packed motion latents at
    negative indices (conjugated rotations)
  - the causal audio encoder: layer-weighted wav2vec states through a
    causal conv1d pyramid (replicate padding), local tokens (and a padding
    token) per audio frame, a global track for the AdaLN
  - the frame-pack motioner: 1x/2x/4x projections of trailing motion latents
  - the audio injector: after each of `audio_inject_layers`, a
    cross-attention from each latent frame's tokens to that frame's audio
    tokens, the tokens first AdaLN-normalised by the global track
  - per-token modulation: x tokens by the timestep, reference and motion
    tokens by a zero timestep (the two token ranges modulated apart, so no
    per-token (S, 6, dim) table is built)

The trunk is the Wan DiT's: `DiTBlock`, the text and time embeddings and
the head of `models/wan_dit.py`, so self-attention goes through K4 and K1,
the text cross-attention and the audio cross-attention through K5 and K1.
The audio encoder's and the motioner's convolutions have no Pallas
counterpart and stay plain PyTorch (fp32 convolutions, as the JAX
functions accumulate in fp32). Parameters are named after the JAX pytree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import layer_norm, modulate, patchify, silu
from ..ops.rope import precompute_freqs_3d
from .wan_dit import (Attention, DiTBlock, Head, Linear, TextEmbedding, TimeEmbedding,
                      WanDiTConfig, cross_attention, head, self_attention, text_embed,
                      time_embed, unpatchify)


@dataclass(frozen=True)
class WanS2VConfig:
    dim: int = 5120
    in_dim: int = 16
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    cond_dim: int = 16
    audio_dim: int = 1024
    num_audio_token: int = 4
    num_audio_layers: int = 25
    enable_adain: bool = True
    audio_inject_layers: Tuple[int, ...] = (0, 4, 8, 12, 16, 20, 24, 27, 30, 33, 36, 39)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def dit_cfg(self) -> WanDiTConfig:
        return WanDiTConfig(dim=self.dim, in_dim=self.in_dim, ffn_dim=self.ffn_dim,
                            out_dim=self.out_dim, num_heads=self.num_heads,
                            num_layers=self.num_layers, text_dim=self.text_dim,
                            freq_dim=self.freq_dim, eps=self.eps,
                            patch_size=self.patch_size)


WAN_S2V_14B = WanS2VConfig()
WAN_S2V_TINY = WanS2VConfig(dim=96, in_dim=4, ffn_dim=192, out_dim=4,
                            text_dim=64, freq_dim=32, num_heads=2,
                            num_layers=2, cond_dim=4, audio_dim=16,
                            num_audio_token=2, num_audio_layers=3,
                            audio_inject_layers=(0, 1))
# the reference frame's temporal RoPE index; the motioner's buckets; the
# audio encoder's leading copies of the first column and the frames dropped
REF_ROPE_INDEX = 30
ZIP_FRAME_BUCKETS = (1, 2, 16)
MOTION_FRAMES = (73, 19)


# ------------------------------------------------------------------ RoPE

def s2v_rope_segments(head_dim: int, segments: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token (cos, sin) float32 tables of a list of grid segments, each
    {"start": (f_o, h_o, w_o), "end": (f, h, w), "total": (tf, th, tw)}:
    prod(end - start) tokens; indices linspace-sampled over `total`; a
    negative f_o conjugates the temporal rotation."""
    (cf, sf), (ch, sh), (cw, sw) = precompute_freqs_3d(head_dim)
    cos_out, sin_out = [], []
    for seg in segments:
        f_o, h_o, w_o = seg["start"]
        f, h, w = seg["end"]
        t_f, t_h, t_w = seg["total"]
        seq_f, seq_h, seq_w = f - f_o, h - h_o, w - w_o
        if seq_f * seq_h * seq_w <= 0:
            continue
        if f_o >= 0:
            f_sam = np.linspace(f_o, t_f + f_o - 1, seq_f).astype(int)
            conj = False
        else:
            f_sam = np.linspace(-f_o, -t_f - f_o + 1, seq_f).astype(int)
            conj = True
        h_sam = np.linspace(h_o, t_h + h_o - 1, seq_h).astype(int)
        w_sam = np.linspace(w_o, t_w + w_o - 1, seq_w).astype(int)
        cfo = cf[f_sam]
        sfo = sf[f_sam] * (-1.0 if conj else 1.0)

        def grid(af, ah, aw):
            out = np.concatenate([
                np.broadcast_to(af[:, None, None, :], (seq_f, seq_h, seq_w, af.shape[-1])),
                np.broadcast_to(ah[None, :, None, :], (seq_f, seq_h, seq_w, ah.shape[-1])),
                np.broadcast_to(aw[None, None, :, :], (seq_f, seq_h, seq_w, aw.shape[-1])),
            ], axis=-1)
            return out.reshape(seq_f * seq_h * seq_w, -1)

        cos_out.append(grid(cfo, ch[h_sam], cw[w_sam]))
        sin_out.append(grid(sfo, sh[h_sam], sw[w_sam]))
    return (np.concatenate(cos_out).astype(np.float32),
            np.concatenate(sin_out).astype(np.float32))


def video_segments(f: int, h: int, w: int, rh: int, rw: int) -> List[dict]:
    """The segments of the x tokens' grid and the reference frame's."""
    return [{"start": (0, 0, 0), "end": (f, h, w), "total": (f, h, w)},
            {"start": (REF_ROPE_INDEX, 0, 0), "end": (REF_ROPE_INDEX + 1, rh, rw),
             "total": (1, rh, rw)}]


# ------------------------------------------------------------------ modules

class CausalConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, device=device, dtype=dtype)


class MotionEncoderTC(nn.Module):
    def __init__(self, cfg: WanS2VConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, n = cfg.dim, cfg.num_audio_token
        self.conv1_local = CausalConv(cfg.audio_dim, d // 4 * n, 3, **kw)
        self.conv2 = CausalConv(d // 4, d // 2, 3, **kw)
        self.conv3 = CausalConv(d // 2, d, 3, **kw)
        self.padding_tokens = nn.Parameter(torch.empty(1, 1, 1, d, **kw))
        if cfg.enable_adain:
            self.conv1_global = CausalConv(cfg.audio_dim, d // 4, 3, **kw)
            self.final_linear = Linear(d, d, **kw)


class CausalAudioEncoder(nn.Module):
    def __init__(self, cfg: WanS2VConfig, device=None, dtype=None):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(1, cfg.num_audio_layers, 1, 1,
                                                device=device, dtype=dtype))
        self.encoder = MotionEncoderTC(cfg, device=device, dtype=dtype)


class AdaLayerNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = Linear(dim, 2 * dim, device=device, dtype=dtype)


class AudioInjector(nn.Module):
    def __init__(self, cfg: WanS2VConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(cfg.audio_inject_layers)
        self.injector = nn.ModuleDict({str(i): Attention(cfg.dim, **kw) for i in range(n)})
        if cfg.enable_adain:
            self.injector_adain_layers = nn.ModuleDict(
                {str(i): AdaLayerNorm(cfg.dim, **kw) for i in range(n)})


class FramePacker(nn.Module):
    def __init__(self, cfg: WanS2VConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.proj = nn.Conv3d(16, cfg.dim, (1, 2, 2), stride=(1, 2, 2), **kw)
        self.proj_2x = nn.Conv3d(16, cfg.dim, (2, 4, 4), stride=(2, 4, 4), **kw)
        self.proj_4x = nn.Conv3d(16, cfg.dim, (4, 8, 8), stride=(4, 8, 8), **kw)


class WanS2V(nn.Module):
    """Parameters of the S2V model: the Wan trunk (`DiTBlock`s, text and
    time embeddings, head), the pose `cond_encoder`, the 3-row
    `trainable_cond_mask` (x, reference, motion tokens), the causal audio
    encoder, the audio injector and the frame packer."""

    def __init__(self, cfg: WanS2VConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        dcfg = cfg.dit_cfg()
        pt, ph, pw = cfg.patch_size
        self.patch_embedding = Linear(cfg.in_dim * pt * ph * pw, cfg.dim, **kw)
        self.cond_encoder = Linear(cfg.cond_dim * pt * ph * pw, cfg.dim, **kw)
        self.text_embedding = TextEmbedding(dcfg, **kw)
        self.time_embedding = TimeEmbedding(dcfg, **kw)
        self.time_projection = Linear(cfg.dim, cfg.dim * 6, **kw)
        self.head = Head(dcfg, **kw)
        self.blocks = nn.ModuleList(DiTBlock(dcfg, **kw) for _ in range(cfg.num_layers))
        self.trainable_cond_mask = nn.Parameter(torch.empty(3, cfg.dim, **kw))
        self.casual_audio_encoder = CausalAudioEncoder(cfg, **kw)
        self.audio_injector = AudioInjector(cfg, **kw)
        self.frame_packer = FramePacker(cfg, **kw)


@torch.no_grad()
def init_wan_s2v_(model: WanS2V, generator: torch.Generator) -> WanS2V:
    """Random init on the JAX DiT init's scale (the JAX package has no S2V
    init): the trunk as `wan_dit.init_weights_`; convolutions N(0,
    1/fan_in), biases 0; the padding token and the cond mask N(0, 1/dim);
    the layer weights uniform in [0.005, 0.015] (positive, about the
    reference's 0.01, so their sum stays away from 0)."""
    from .wan_dit import init_weights_
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv3d)):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
            m.bias.zero_()
    gain = 1.0 / math.sqrt(model.cfg.dim)
    model.trainable_cond_mask.normal_(0.0, gain, generator=generator)
    model.casual_audio_encoder.weights.uniform_(0.005, 0.015, generator=generator)
    model.casual_audio_encoder.encoder.padding_tokens.normal_(0.0, gain, generator=generator)
    return model


# ------------------------------------------------------------------ audio

def causal_conv1d(conv: nn.Conv1d, x, stride: int = 1):
    """CausalConv1d: replicate left padding of k - 1, the product in fp32
    from x.dtype operands, the bias added in fp32. x: (B, C, T)."""
    k = conv.weight.shape[2]
    xf = F.pad(x.float(), (k - 1, 0), mode="replicate")
    y = F.conv1d(xf, conv.weight.to(x.dtype).float(), stride=stride)
    return (y + conv.bias.float()[None, :, None]).to(x.dtype)


def _ln_silu(x):
    return silu(layer_norm(x, eps=1e-6))


def motion_encoder_tc(p: MotionEncoderTC, x, num_heads: int, need_global: bool):
    """x (B, T, C) -> (global (B, T', 1, dim) or None, local (B, T', n + 1, dim))."""
    x = x.transpose(1, 2)
    x_ori = x
    b = x.shape[0]
    x = causal_conv1d(p.conv1_local.conv, x)
    _, nc, t = x.shape
    x = x.reshape(b, num_heads, nc // num_heads, t).permute(0, 1, 3, 2)
    x = _ln_silu(x.reshape(b * num_heads, t, nc // num_heads))
    x = _ln_silu(causal_conv1d(p.conv2.conv, x.transpose(1, 2), stride=2).transpose(1, 2))
    x = _ln_silu(causal_conv1d(p.conv3.conv, x.transpose(1, 2), stride=2).transpose(1, 2))
    x = x.reshape(b, num_heads, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)
    padding = p.padding_tokens.to(x.dtype).expand(b, x.shape[1], 1, x.shape[-1])
    x_local = torch.cat([x, padding], dim=-2)
    if not need_global:
        return None, x_local
    x = _ln_silu(causal_conv1d(p.conv1_global.conv, x_ori).transpose(1, 2))
    x = _ln_silu(causal_conv1d(p.conv2.conv, x.transpose(1, 2), stride=2).transpose(1, 2))
    x = _ln_silu(causal_conv1d(p.conv3.conv, x.transpose(1, 2), stride=2).transpose(1, 2))
    x = p.final_linear(x)
    return x[:, :, None], x_local


def causal_audio_encoder(p: CausalAudioEncoder, features, num_token: int,
                         need_global: bool):
    """features (B, num_layers, dim, T) -> `motion_encoder_tc` of their
    silu-weighted layer average."""
    weights = silu(p.weights.to(features.dtype))
    weighted = (features * weights / weights.sum(dim=1, keepdim=True)).sum(dim=1)
    return motion_encoder_tc(p.encoder, weighted.transpose(1, 2), num_token, need_global)


def cal_audio_emb(p: CausalAudioEncoder, audio_input, num_token: int, enable_adain: bool):
    """The first column repeated MOTION_FRAMES[0] times in front, encoded,
    the first MOTION_FRAMES[1] audio frames dropped."""
    motion_frames = MOTION_FRAMES
    first = audio_input[..., 0:1].expand(*audio_input.shape[:-1], motion_frames[0])
    audio_input = torch.cat([first, audio_input], dim=-1)
    emb_global, emb = causal_audio_encoder(p, audio_input, num_token, enable_adain)
    if emb_global is not None:
        emb_global = emb_global[:, motion_frames[1]:]
    return emb_global, emb[:, motion_frames[1]:]


def ada_layer_norm(p: AdaLayerNorm, x, temb):
    temb = p.linear(silu(temb))
    shift, scale = temb.chunk(2, dim=1)
    return layer_norm(x, eps=1e-5) * (1 + scale[:, None, :]) + shift[:, None, :]


def audio_inject(p: AudioInjector, idx: int, x, audio_emb_global, audio_emb,
                 seq_len_x: int, cfg: WanS2VConfig):
    """x[:, :seq_len_x] grouped per audio frame ((b t) n c: one frame's
    tokens a batch row), AdaLN-normalised by its frame's global row,
    cross-attends to that frame's audio tokens; the result is added. As in
    the JAX package nothing checks that the audio frames equal the latent
    frames: a count that divides the tokens regroups them silently."""
    num_frames = audio_emb.shape[1]
    b, _, c = x.shape
    tokens_f = x[:, :seq_len_x].reshape(b * num_frames, -1, c)
    if cfg.enable_adain:
        temb = audio_emb_global.reshape(b * num_frames, -1, c)[:, 0]
        tokens_f = ada_layer_norm(p.injector_adain_layers[str(idx)], tokens_f, temb)
    audio = audio_emb.reshape(b * num_frames, -1, c)
    res = cross_attention(p.injector[str(idx)], tokens_f, audio, cfg.num_heads, cfg.eps)
    res = res.reshape(b, seq_len_x, c)
    return torch.cat([x[:, :seq_len_x] + res.to(x.dtype), x[:, seq_len_x:]], dim=1)


# ------------------------------------------------------------------ motion

def _project(conv: nn.Conv3d, x):
    """Non-overlapping Conv3d as the JAX package computes it: its patches
    (c kt kh kw) times the flattened weight, then the bias."""
    kt, kh, kw = conv.weight.shape[2:]
    b, c, f, h, w = x.shape
    t = x.reshape(b, c, f // kt, kt, h // kh, kh, w // kw, kw)
    t = t.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, c * kt * kh * kw)
    wf = conv.weight.reshape(conv.weight.shape[0], -1).T.to(t.dtype)
    return t @ wf + conv.bias.to(t.dtype)


def frame_pack_motion(p: FramePacker, motion_latents, cfg: WanS2VConfig):
    """FramePackMotioner for batch size 1: motion_latents (16, T, H, W)
    (numpy or tensor) -> (tokens (1, S, dim) fp32 on the packer's device,
    cos, sin). The last sum(buckets) frames (zero-padded in front) split
    into 16 frames for the 4x projection, 2 for the 2x and 1 for the 1x."""
    zb = ZIP_FRAME_BUCKETS
    m = np.asarray(torch.as_tensor(motion_latents).float().cpu())
    lat_h, lat_w = m.shape[2], m.shape[3]
    total = sum(zb)
    padd = np.zeros((m.shape[0], total, lat_h, lat_w), np.float32)
    overlap = min(total, m.shape[1])
    if overlap > 0:
        padd[:, -overlap:] = m[:, -overlap:]
    padd = torch.from_numpy(padd)[None].to(p.proj.weight.device)
    s4, s2, _ = zb[::-1]
    tokens = torch.cat([_project(p.proj, padd[:, :, s4 + s2:]),
                        _project(p.proj_2x, padd[:, :, s4:s4 + s2]),
                        _project(p.proj_4x, padd[:, :, :s4])], dim=1)
    segments = [
        {"start": (-zb[0], 0, 0), "end": (0, lat_h // 2, lat_w // 2),
         "total": (zb[0], lat_h // 2, lat_w // 2)},
        {"start": (-(zb[0] + zb[1]), 0, 0),
         "end": (-(zb[0] + zb[1]) + zb[1] // 2, lat_h // 4, lat_w // 4),
         "total": (zb[1], lat_h // 2, lat_w // 2)},
        {"start": (-(zb[0] + zb[1] + zb[2]), 0, 0),
         "end": (-(zb[0] + zb[1] + zb[2]) + zb[2] // 4, lat_h // 8, lat_w // 8),
         "total": (zb[2], lat_h // 2, lat_w // 2)},
    ]
    cos, sin = s2v_rope_segments(cfg.head_dim, segments)
    return tokens, cos, sin


# ------------------------------------------------------------------ blocks

def s2v_dit_block(p: DiTBlock, x, context, t_mod2, seq_len_x: int, cos, sin,
                  cfg: WanS2VConfig):
    """A DiT block whose first seq_len_x tokens take the timestep's
    modulation rows (t_mod2[0]) and the rest the zero timestep's
    (t_mod2[1]): each term is applied to the two token ranges apart, with
    the rounding of the JAX block's per-token rows."""
    mod = p.modulation[0].to(t_mod2.dtype)[None] + t_mod2
    n = seq_len_x

    def modulate2(h, shift, scale):
        return torch.cat([modulate(h[:, :n], mod[0, shift], mod[0, scale]),
                          modulate(h[:, n:], mod[1, shift], mod[1, scale])], dim=1)

    def gated(x, gate, y):
        return x + torch.cat([mod[0, gate] * y[:, :n], mod[1, gate] * y[:, n:]], dim=1)

    h = modulate2(layer_norm(x, eps=cfg.eps), 0, 1)
    x = gated(x, 2, self_attention(p.self_attn, h, cos, sin, cfg.num_heads, cfg.eps))
    x = x + cross_attention(p.cross_attn, layer_norm(x, p.norm3.scale, p.norm3.bias, cfg.eps),
                            context, cfg.num_heads, cfg.eps)
    h = modulate2(layer_norm(x, eps=cfg.eps), 3, 4)
    return gated(x, 5, p.ffn(h))


def _patch(embed: Linear, tokens):
    """The JAX forward's patch projection: the product in the tokens'
    dtype, then the bias."""
    return tokens @ embed.weight.T.to(tokens.dtype) + embed.bias.to(tokens.dtype)


def wan_s2v_forward(model: WanS2V, latents, timestep, context, audio_input,
                    motion_latents=None, pose_cond=None, drop_motion_frames: bool = True):
    """latents (1, C, 1 + F, H, W), frame 0 the reference latent; timestep
    (1,); context (1, L, text_dim); audio_input (1, num_audio_layers,
    audio_dim, F_video). Returns (1, C, 1 + F, H, W), frame 0 the reference
    passed through. Motion latents join only with drop_motion_frames=False
    (the reference's default drops them)."""
    cfg = model.cfg
    dev = latents.device
    origin_ref = latents[:, :, 0:1]
    x_lat = latents[:, :, 1:]
    ctx = text_embed(model, context)
    audio_emb_global, merged_audio_emb = cal_audio_emb(
        model.casual_audio_encoder, audio_input, cfg.num_audio_token, cfg.enable_adain)
    pose = torch.zeros_like(x_lat) if pose_cond is None else pose_cond
    x, (f, h, w) = patchify(lambda t: _patch(model.patch_embedding, t), x_lat, cfg.patch_size)
    x = x + patchify(lambda t: _patch(model.cond_encoder, t), pose, cfg.patch_size)[0]
    seq_len_x = x.shape[1]
    ref_tokens, (_, rh, rw) = patchify(lambda t: _patch(model.patch_embedding, t),
                                       origin_ref, cfg.patch_size)
    x = torch.cat([x, ref_tokens], dim=1)
    counts = [seq_len_x, ref_tokens.shape[1]]
    cos, sin = s2v_rope_segments(cfg.head_dim, video_segments(f, h, w, rh, rw))
    if motion_latents is not None and not drop_motion_frames:
        mot_tokens, mot_cos, mot_sin = frame_pack_motion(model.frame_packer, motion_latents,
                                                         cfg)
        x = torch.cat([x, mot_tokens.to(x.dtype)], dim=1)
        cos, sin = np.concatenate([cos, mot_cos]), np.concatenate([sin, mot_sin])
        counts.append(mot_tokens.shape[1])
    mask = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                   torch.tensor(counts, device=dev))
    x = x + model.trainable_cond_mask[mask].to(x.dtype)[None]
    ts2 = torch.cat([timestep.float(), torch.zeros(1, device=dev)])
    t, t_mod = time_embed(model, ts2)
    cos_t, sin_t = torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)
    inject = {layer: j for j, layer in enumerate(cfg.audio_inject_layers)}
    for i, blk in enumerate(model.blocks):
        x = s2v_dit_block(blk, x, ctx, t_mod, seq_len_x, cos_t, sin_t, cfg)
        if i in inject:
            x = audio_inject(model.audio_injector, inject[i], x, audio_emb_global,
                             merged_audio_emb, seq_len_x, cfg)
    out = head(model, x[:, :seq_len_x], t[:1])
    out = unpatchify(out, (f, h, w), cfg.patch_size, cfg.out_dim)
    return torch.cat([origin_ref, out.to(origin_ref.dtype)], dim=2)


# ------------------------------------------------------------------ convert

def convert_wan_s2v(sd, cfg: WanS2VConfig):
    """Reference WanS2VModel state dict -> `WanS2V` state dict (values pass
    through: tensors or `utils.ckpt.LazyTensor`s); reads the keys the JAX
    `convert_wan_s2v` reads."""
    from ..utils.convert import _conv_as_lin, _lin, convert_wan_dit
    out = convert_wan_dit(sd, cfg.dit_cfg())
    _conv_as_lin(sd, "cond_encoder", "cond_encoder", out)
    out["trainable_cond_mask"] = sd["trainable_cond_mask.weight"]
    enc = "casual_audio_encoder.encoder"
    names = ["casual_audio_encoder.weights", f"{enc}.padding_tokens"]
    convs = ["conv1_local", "conv2", "conv3"]
    if f"{enc}.conv1_global.conv.weight" in sd:
        convs.append("conv1_global")
        names += [f"{enc}.final_linear.weight", f"{enc}.final_linear.bias"]
    names += [f"{enc}.{c}.conv.{w}" for c in convs for w in ("weight", "bias")]
    names += [f"frame_packer.{pr}.{w}" for pr in ("proj", "proj_2x", "proj_4x")
              for w in ("weight", "bias")]
    out.update({k: sd[k] for k in names})
    for i in range(len(cfg.audio_inject_layers)):
        src = f"audio_injector.injector.{i}"
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{src}.{name}", f"{src}.{name}", out)
        for norm in ("norm_q", "norm_k"):
            out[f"{src}.{norm}.scale"] = sd[f"{src}.{norm}.weight"]
        if cfg.enable_adain:
            ada = f"audio_injector.injector_adain_layers.{i}.linear"
            _lin(sd, ada, ada, out)
    return out


def export_wan_s2v(model: WanS2V) -> dict:
    """A `WanS2V`'s tensors under the reference's names and shapes
    (`convert_wan_s2v` inverted)."""
    from ..utils.convert import export_wan_dit_state
    cfg = model.cfg
    sd = model.state_dict()
    trunk = ("patch_embedding", "text_embedding", "time_embedding", "time_projection",
             "head", "blocks")
    out = export_wan_dit_state({k: v for k, v in sd.items() if k.split(".")[0] in trunk},
                               cfg.dit_cfg())
    w = sd["cond_encoder.weight"]
    out["cond_encoder.weight"] = w.reshape(w.shape[0], cfg.cond_dim, *cfg.patch_size)
    out["cond_encoder.bias"] = sd["cond_encoder.bias"]
    out["trainable_cond_mask.weight"] = sd["trainable_cond_mask"]
    for k, v in sd.items():
        if k.startswith(("casual_audio_encoder.", "frame_packer.")):
            out[k] = v
        elif k.startswith("audio_injector."):
            out[k.replace(".norm_q.scale", ".norm_q.weight")
                 .replace(".norm_k.scale", ".norm_k.weight")] = v
    return out
