"""Wav2Vec2 audio tower for S2V (wav2vec2-large-xlsr-53) in PyTorch.

Counterpart of `video_styler_tpu/models/wav2vec.py`: the 7-layer conv
feature extractor (conv1d -> LayerNorm over channels -> exact GELU, each
conv in fp32), the feature projection, the grouped weight-normed
positional conv (an even kernel trims its last step), 24 pre-LN blocks
and the final LayerNorm, returning L + 1 stacked hidden states; and the
host-side helpers, copied, that turn those states into one S2V
conditioning column per video frame (numpy).

Its attention is the exact-softmax `ops.attention.sdpa` (16 heads of 64),
as the JAX tower runs XLA's sdpa and no Pallas kernel. Parameters are
named after the JAX pytree; a conv's `w` keeps the torch layout (out, in,
k) under the name `weight`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.basic import layer_norm
from .wan_dit import LayerNormAffine, Linear


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


# facebook/wav2vec2-large-xlsr-53
WAV2VEC2_XLSR_53 = Wav2Vec2Config()

WAV2VEC2_TINY = Wav2Vec2Config(
    hidden_size=32, num_heads=4, num_layers=2, intermediate_size=64,
    conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


class ConvLayer(nn.Module):
    def __init__(self, in_c: int, out_c: int, k: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_c, in_c, k, **kw))
        self.bias = nn.Parameter(torch.empty(out_c, **kw))
        self.ln = LayerNormAffine(out_c, **kw)


class PosConv(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.weight = nn.Parameter(torch.empty(
            d, d // cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings,
            device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(d, device=device, dtype=dtype))


class Wav2Vec2Block(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.ln1 = LayerNormAffine(d, **kw)
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)
        self.ln2 = LayerNormAffine(d, **kw)
        self.fc1 = Linear(d, cfg.intermediate_size, **kw)
        self.fc2 = Linear(cfg.intermediate_size, d, **kw)


class Wav2Vec2(nn.Module):
    """Parameters of the tower (the JAX tree of `init_wav2vec`)."""

    def __init__(self, cfg: Wav2Vec2Config = WAV2VEC2_XLSR_53, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayer(i, o, k, **kw) for i, o, k in zip(ins, cfg.conv_dim, cfg.conv_kernel))
        self.proj_ln = LayerNormAffine(cfg.conv_dim[-1], **kw)
        self.proj = Linear(cfg.conv_dim[-1], cfg.hidden_size, **kw)
        self.pos_conv = PosConv(cfg, **kw)
        self.final_ln = LayerNormAffine(cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(Wav2Vec2Block(cfg, **kw) for _ in range(cfg.num_layers))


@torch.no_grad()
def init_wav2vec_(model: Wav2Vec2, generator: torch.Generator) -> Wav2Vec2:
    """Random init with the JAX init's std: conv weights N(0, 1/(in*k)),
    linear weights N(0, 1/in), the positional conv N(0, 0.02^2), biases 0,
    LayerNorms 1 and 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            m.bias.zero_()
        elif isinstance(m, ConvLayer):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1] * m.weight.shape[2]),
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, PosConv):
            m.weight.normal_(0.0, 0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, LayerNormAffine):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return model


def _weight_norm_fold(g, v) -> torch.Tensor:
    """torch weight_norm(conv, dim=2): w = g * v / ||v||_(0,1), in float64."""
    g, v = g.double(), v.double()
    return g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()


_BLOCK_NAMES = {"ln1": "layer_norm", "q": "attention.q_proj", "k": "attention.k_proj",
                "v": "attention.v_proj", "o": "attention.out_proj",
                "ln2": "final_layer_norm", "fc1": "feed_forward.intermediate_dense",
                "fc2": "feed_forward.output_dense"}


def _names(cfg: Wav2Vec2Config):
    """{port name: HF name} of every tensor but the positional conv's weight."""
    out = {}
    for i in range(len(cfg.conv_dim)):
        p = f"feature_extractor.conv_layers.{i}"
        out.update({f"conv_layers.{i}.weight": f"{p}.conv.weight",
                    f"conv_layers.{i}.bias": f"{p}.conv.bias",
                    f"conv_layers.{i}.ln.scale": f"{p}.layer_norm.weight",
                    f"conv_layers.{i}.ln.bias": f"{p}.layer_norm.bias"})
    for dst, src in (("proj_ln", "feature_projection.layer_norm"),
                     ("final_ln", "encoder.layer_norm")):
        out.update({f"{dst}.scale": f"{src}.weight", f"{dst}.bias": f"{src}.bias"})
    out.update({"proj.weight": "feature_projection.projection.weight",
                "proj.bias": "feature_projection.projection.bias",
                "pos_conv.bias": "encoder.pos_conv_embed.conv.bias"})
    for i in range(cfg.num_layers):
        for dst, src in _BLOCK_NAMES.items():
            w_name = "scale" if dst.startswith("ln") else "weight"
            out[f"blocks.{i}.{dst}.{w_name}"] = f"encoder.layers.{i}.{src}.weight"
            out[f"blocks.{i}.{dst}.bias"] = f"encoder.layers.{i}.{src}.bias"
    return out


def convert_wav2vec(state_dict, cfg: Wav2Vec2Config = WAV2VEC2_XLSR_53):
    """HF Wav2Vec2ForCTC / Wav2Vec2Model state dict (optionally under the
    reference's `model.` prefix; tensors or `utils.ckpt.LazyTensor`s) ->
    `Wav2Vec2` state dict of fp32 CPU tensors. The positional conv's weight
    norm is folded in float64 from either storage layout (`weight_g` /
    `weight_v`, or `parametrizations.weight.original0/1`)."""
    from ..utils.ckpt import read_tensors
    sd = {k.removeprefix("model.").removeprefix("wav2vec2."): v
          for k, v in state_dict.items()}
    pc = "encoder.pos_conv_embed.conv"
    pos = next(names for names in ((f"{pc}.weight_g", f"{pc}.weight_v"),
                                   (f"{pc}.parametrizations.weight.original0",
                                    f"{pc}.parametrizations.weight.original1"),
                                   (f"{pc}.weight",)) if names[0] in sd)
    names = _names(cfg)
    wanted = list(names.values()) + list(pos)
    sd = {k: v.float() for k, v in read_tensors({k: sd[k] for k in wanted}, "cpu").items()}
    out = {dst: sd[src] for dst, src in names.items()}
    out["pos_conv.weight"] = (sd[pos[0]] if len(pos) == 1
                              else _weight_norm_fold(sd[pos[0]], sd[pos[1]]).float())
    return out


def export_wav2vec(model: Wav2Vec2) -> dict:
    """A `Wav2Vec2`'s tensors under the HF names, the positional conv as a
    plain weight (`convert_wav2vec` inverted)."""
    sd = model.state_dict()
    out = {src: sd[dst] for dst, src in _names(model.cfg).items()}
    out["encoder.pos_conv_embed.conv.weight"] = sd["pos_conv.weight"]
    return out


# -- forward ------------------------------------------------------------------

def _conv1d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """x (B, C, T), w (O, I/g, K) -> (B, O, T'), computed in fp32."""
    y = F.conv1d(x.float(), w.float(), stride=stride, padding=padding, groups=groups)
    if b is not None:
        y = y + b.float()[None, :, None]
    return y.to(x.dtype)


def _gelu(x):
    return F.gelu(x.float()).to(x.dtype)


def normalize_waveform(audio: np.ndarray) -> np.ndarray:
    """Wav2Vec2Processor zero-mean unit-variance normalization."""
    audio = np.asarray(audio, np.float32)
    return (audio - audio.mean()) / np.sqrt(audio.var() + 1e-7)


def _block(p: Wav2Vec2Block, cfg: Wav2Vec2Config, x):
    eps = cfg.layer_norm_eps
    h = layer_norm(x, p.ln1.scale, p.ln1.bias, eps)
    b, t, d = h.shape
    n = cfg.num_heads
    q = p.q(h).reshape(b, t, n, d // n)
    k = p.k(h).reshape(b, t, n, d // n)
    v = p.v(h).reshape(b, t, n, d // n)
    x = x + p.o(sdpa(q, k, v).reshape(b, t, d))
    h = layer_norm(x, p.ln2.scale, p.ln2.bias, eps)
    return x + p.fc2(_gelu(p.fc1(h)))


def wav2vec_forward(model: Wav2Vec2, input_values):
    """input_values (B, T_samples) -> hidden states (L+1, B, T_feat, d):
    [0] is block 0's input (after the positional conv), the last the final
    LayerNorm's output (the HF output_hidden_states order)."""
    cfg = model.cfg
    eps = cfg.layer_norm_eps
    x = input_values[:, None, :]
    for conv, s in zip(model.conv_layers, cfg.conv_stride):
        x = _conv1d(x, conv.weight, conv.bias, stride=s)
        x = layer_norm(x.transpose(1, 2), conv.ln.scale, conv.ln.bias, eps).transpose(1, 2)
        x = _gelu(x)
    feat = x.transpose(1, 2)
    h = model.proj(layer_norm(feat, model.proj_ln.scale, model.proj_ln.bias, eps))
    pos = _conv1d(h.transpose(1, 2), model.pos_conv.weight, model.pos_conv.bias,
                  padding=cfg.num_conv_pos_embeddings // 2,
                  groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + _gelu(pos).transpose(1, 2)
    states = [h]
    for blk in list(model.blocks)[:-1]:
        h = _block(blk, cfg, h)
        states.append(h)
    h = _block(model.blocks[-1], cfg, h)
    states.append(layer_norm(h, model.final_ln.scale, model.final_ln.bias, eps))
    return torch.stack(states)


# -- host-side bucketing (the JAX package's, copied) ---------------------------

def get_sample_indices(original_fps, total_frames, target_fps, num_sample,
                       fixed_start=None):
    required_duration = num_sample / target_fps
    required_origin_frames = int(np.ceil(required_duration * original_fps))
    if required_duration > total_frames / original_fps:
        raise ValueError("required_duration must be less than video length")
    if fixed_start is not None and fixed_start >= 0:
        start_frame = fixed_start
    else:
        max_start = total_frames - required_origin_frames
        if max_start < 0:
            raise ValueError("video length is too short")
        start_frame = np.random.randint(0, max_start + 1)
    start_time = start_frame / original_fps
    end_time = start_time + required_duration
    time_points = np.linspace(start_time, end_time, num_sample, endpoint=False)
    frame_indices = np.round(time_points * original_fps).astype(int)
    return np.clip(frame_indices, 0, total_frames - 1)


def linear_interpolation(features: np.ndarray, input_fps: float,
                         output_fps: float,
                         output_len: Optional[int] = None) -> np.ndarray:
    """(L, T, D) -> (L, output_len, D); torch linear align_corners=True."""
    L, T, D = features.shape
    if output_len is None:
        output_len = int(T / float(input_fps) * output_fps)
    if output_len == 1:
        src = np.zeros((1,), np.float32)
    else:
        src = np.arange(output_len, dtype=np.float64) * (T - 1) / (output_len - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = (src - lo).astype(np.float32)[None, :, None]
    return (features[:, lo] * (1 - w) + features[:, hi] * w).astype(features.dtype)


def get_audio_embed_bucket_fps(audio_embed: np.ndarray, fps: int = 16,
                               batch_frames: int = 81, m: int = 0,
                               video_rate: int = 30):
    """(L, T_audio_frames, D) -> ((bucket, L, D*(2m+1)), min_batch_num)."""
    num_layers, audio_frame_num, audio_dim = audio_embed.shape
    scale = video_rate / fps
    min_batch_num = int(audio_frame_num / (batch_frames * scale)) + 1
    bucket_num = min_batch_num * batch_frames
    padd = math.ceil(min_batch_num * batch_frames / fps * video_rate) - audio_frame_num
    batch_idx = get_sample_indices(
        original_fps=video_rate, total_frames=audio_frame_num + padd,
        target_fps=fps, num_sample=bucket_num, fixed_start=0)
    stride = int(video_rate / fps)
    rows = []
    for bi in batch_idx:
        if bi < audio_frame_num:
            chosen = np.arange(bi - m * stride, bi + (m + 1) * stride, stride)
            chosen = np.clip(chosen, 0, audio_frame_num - 1)
            rows.append(audio_embed[:, chosen].reshape(num_layers, -1))
        else:
            rows.append(np.zeros((num_layers, audio_dim * (2 * m + 1)), audio_embed.dtype))
    return np.stack(rows), min_batch_num


@torch.no_grad()
def extract_audio_feat(model: Wav2Vec2, input_audio: np.ndarray,
                       return_all_layers: bool = False,
                       video_rate: int = 30) -> np.ndarray:
    """Waveform (16 kHz) -> per-video-frame features, (L or 1, T_vid, D),
    the tower run on its parameters' device."""
    dev = next(model.parameters()).device
    wav = torch.from_numpy(normalize_waveform(input_audio)[None]).to(dev)
    states = wav2vec_forward(model, wav).float()[:, 0].cpu().numpy()
    feat = states if return_all_layers else states[-1:]
    return linear_interpolation(feat, input_fps=50, output_fps=video_rate)


def get_audio_feats_per_inference(model: Wav2Vec2, input_audio: np.ndarray,
                                  fps: int = 16, batch_frames: int = 80, m: int = 0,
                                  video_rate: int = 30) -> List[np.ndarray]:
    """List of (1, L, D*(2m+1), batch_frames) S2V conditioning chunks."""
    feat = extract_audio_feat(model, input_audio, return_all_layers=True,
                              video_rate=video_rate)
    bucket, n = get_audio_embed_bucket_fps(feat, fps=fps, batch_frames=batch_frames,
                                           m=m, video_rate=video_rate)
    bucket = bucket[None].transpose(0, 2, 3, 1)
    return [bucket[..., i * batch_frames:(i + 1) * batch_frames] for i in range(n)]
