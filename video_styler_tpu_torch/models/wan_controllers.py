"""Wan conditioning controllers in PyTorch: speed control (the motion
controller) and camera control (Plücker rays through a SimpleAdapter).

Counterpart of `video_styler_tpu/models/wan_controllers.py`:

- `MotionController`: motion_bucket_id -> a (B, 6 * dim) term added to the
  DiT's t_mod; fc1/fc2/fc3 on the sinusoidal embedding of id * 10, the
  last layer zero-initialised.
- The camera's host side, in numpy as in the JAX package:
  `generate_camera_coordinates` (a direction string -> a trajectory),
  `process_pose_file` (Plücker ray embedding, float64 as there),
  `process_camera_coordinates` and `pack_camera_latents` (the first frame
  repeated 4x, then groups of 4 frames stacked onto channels: (1, 24,
  F_lat, H, W)).
- `SimpleAdapter`: PixelUnshuffle(8), a 2x2 stride-2 conv, and residual
  blocks of two 3x3 convs, giving per-patch features that the DiT adds to
  its tokens after patchify. Its convolutions run as the JAX ones do: in
  the activation dtype with fp32 accumulation (cuDNN on the card) and one
  rounding after the bias.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import linear, silu, sinusoidal_embedding_1d

CAMERA_ORIGIN = (0, 0.532139961, 0.946026558, 0.5, 0.5, 0,
                 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)


# ---------------------------------------------------------------- motion

class MotionController(nn.Module):
    """fc1 (freq_dim -> dim), fc2 (dim -> dim), fc3 (dim -> 6 * dim)."""

    def __init__(self, dim: int = 1536, freq_dim: int = 256, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.freq_dim = freq_dim
        self.fc1 = nn.Linear(freq_dim, dim, **kw)
        self.fc2 = nn.Linear(dim, dim, **kw)
        self.fc3 = nn.Linear(dim, 6 * dim, **kw)


@torch.no_grad()
def init_motion_controller_(m: MotionController, generator: torch.Generator):
    """The JAX init's std (N(0, 1/in) weights, zero biases), fc3 zero."""
    for lin in (m.fc1, m.fc2):
        lin.weight.normal_(0.0, 1.0 / math.sqrt(lin.in_features), generator=generator)
        lin.bias.zero_()
    m.fc3.weight.zero_()
    m.fc3.bias.zero_()
    return m


def motion_controller_forward(m: MotionController, motion_bucket_id) -> torch.Tensor:
    """motion_bucket_id (B,) float32 -> (B, 6 * dim) additive t_mod term."""
    emb = sinusoidal_embedding_1d(m.freq_dim, motion_bucket_id.float() * 10)
    emb = emb.to(m.fc1.weight.dtype)
    x = silu(linear(emb, m.fc1.weight, m.fc1.bias))
    x = silu(linear(x, m.fc2.weight, m.fc2.bias))
    return linear(x, m.fc3.weight, m.fc3.bias)


def convert_motion_controller(sd: Dict) -> Dict:
    """Reference `linear.{0,2,4}` -> `MotionController` state dict."""
    return {f"{dst}.{leaf}": sd[f"linear.{src}.{leaf}"]
            for src, dst in (("0", "fc1"), ("2", "fc2"), ("4", "fc3"))
            for leaf in ("weight", "bias")}


def export_motion_controller(m: MotionController) -> Dict[str, torch.Tensor]:
    """`convert_motion_controller` inverted: the reference's names."""
    return {f"linear.{src}.{leaf}": getattr(getattr(m, dst), leaf)
            for src, dst in (("0", "fc1"), ("2", "fc2"), ("4", "fc3"))
            for leaf in ("weight", "bias")}


# ---------------------------------------------------------------- camera

def generate_camera_coordinates(direction: str, length: int, speed: float = 1 / 54,
                                origin: Sequence[float] = CAMERA_ORIGIN):
    """A direction string (any of Left, Right, Up, Down, In, Out) -> `length`
    camera entries [frame, fx, fy, cx, cy, 0, 0, w2c 3x4 row-major], each
    moved by `speed` from the last."""
    coordinates = [list(origin)]
    while len(coordinates) < length:
        coor = coordinates[-1].copy()
        if "Left" in direction:
            coor[9] += speed
        if "Right" in direction:
            coor[9] -= speed
        if "Up" in direction:
            coor[13] += speed
        if "Down" in direction:
            coor[13] -= speed
        if "In" in direction:
            coor[18] -= speed
        if "Out" in direction:
            coor[18] += speed
        coordinates.append(coor)
    return coordinates


def _relative_poses(entries) -> np.ndarray:
    w2cs, c2ws = [], []
    for e in entries:
        m = np.eye(4)
        m[:3, :] = np.asarray(e[7:]).reshape(3, 4)
        w2cs.append(m)
        c2ws.append(np.linalg.inv(m))
    target = np.eye(4)
    abs2rel = target @ w2cs[0]
    poses = [target] + [abs2rel @ c for c in c2ws[1:]]
    return np.asarray(poses, np.float32)


def process_pose_file(cam_entries, width: int = 672, height: int = 384,
                      original_pose_width: int = 1280,
                      original_pose_height: int = 720) -> np.ndarray:
    """Plücker ray embedding (V, H, W, 6) of the camera entries: the ray
    direction's moment o x d and the direction d, per pixel centre."""
    fx = np.asarray([e[1] for e in cam_entries], np.float64)
    fy = np.asarray([e[2] for e in cam_entries], np.float64)
    cx = np.asarray([e[3] for e in cam_entries], np.float64)
    cy = np.asarray([e[4] for e in cam_entries], np.float64)
    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    if pose_ratio > sample_ratio:
        fx = (height * pose_ratio) * fx / width
    else:
        fy = (width / pose_ratio) * fy / height
    K = np.stack([fx * width, fy * height, cx * width, cy * height],
                 axis=-1).astype(np.float32)
    c2ws = _relative_poses(cam_entries)

    V = K.shape[0]
    j, i = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    i = i.reshape(1, height * width) + 0.5
    j = j.reshape(1, height * width) + 0.5
    fxv, fyv, cxv, cyv = (K[:, k:k + 1].astype(np.float64) for k in range(4))
    zs = np.ones_like(i) * np.ones((V, 1))
    xs = (i - cxv) / fxv * zs
    ys = (j - cyv) / fyv * zs
    directions = np.stack([xs, ys, zs], axis=-1)
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    rays_d = directions @ np.swapaxes(c2ws[:, :3, :3], -1, -2).astype(np.float64)
    rays_o = np.broadcast_to(c2ws[:, None, :3, 3], rays_d.shape)
    rays_dxo = np.cross(rays_o, rays_d)
    plucker = np.concatenate([rays_dxo, rays_d], axis=-1)
    return plucker.reshape(V, height, width, 6).astype(np.float32)


def process_camera_coordinates(direction: str, length: int, height: int, width: int,
                               speed: float = 1 / 54, origin=None) -> np.ndarray:
    """A direction string -> the Plücker embedding (length, H, W, 6)."""
    coordinates = generate_camera_coordinates(
        direction, length, speed, CAMERA_ORIGIN if origin is None else origin)
    return process_pose_file(coordinates, width, height)


def pack_camera_latents(plucker: np.ndarray, num_frames: int) -> np.ndarray:
    """Plücker (V, H, W, 6) -> (1, 24, (F + 3) // 4, H, W): the first frame
    repeated 4x, then each group of 4 frames stacked onto the channels."""
    video = plucker[:num_frames].transpose(3, 0, 1, 2)[None]
    video = np.concatenate([np.repeat(video[:, :, 0:1], 4, axis=2), video[:, :, 1:]],
                           axis=2)
    b, c, f, h, w = video.shape
    lat = video.transpose(0, 2, 1, 3, 4)
    lat = lat.reshape(b, f // 4, 4, c, h, w).transpose(0, 1, 3, 2, 4, 5)
    lat = lat.reshape(b, f // 4, c * 4, h, w).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(lat)


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))


class _ResidualBlock(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv1 = _Conv(dim, dim, 3, device, dtype)
        self.conv2 = _Conv(dim, dim, 3, device, dtype)


class SimpleAdapter(nn.Module):
    """The camera adapter: conv (in_dim * 64 -> out_dim, 2x2 stride 2) after
    PixelUnshuffle(8), then `num_residual_blocks` blocks of relu(conv1),
    conv2 plus the block's input."""

    def __init__(self, in_dim: int = 24, out_dim: int = 1536, num_residual_blocks: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.conv = _Conv(in_dim * 64, out_dim, 2, device, dtype)
        self.residual_blocks = nn.ModuleList(_ResidualBlock(out_dim, device, dtype)
                                             for _ in range(num_residual_blocks))


@torch.no_grad()
def init_simple_adapter_(m: SimpleAdapter, generator: torch.Generator):
    """The JAX init's std: conv weights N(0, 1/fan_in), biases 0."""
    for conv in [m.conv] + [c for b in m.residual_blocks for c in (b.conv1, b.conv2)]:
        fan_in = math.prod(conv.weight.shape[1:])
        conv.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        conv.bias.zero_()
    return m


def _conv2d(p: _Conv, x, stride: int = 1, padding: int = 0):
    """The JAX `_conv2d`: x.dtype operands, fp32 accumulation, the bias
    added before one rounding to x.dtype (on the card in cuDNN's epilogue;
    on the CPU the product of the rounded operands in fp32)."""
    w = p.weight.to(x.dtype)
    if x.is_cuda:
        return F.conv2d(x, w, p.bias.to(x.dtype), stride, padding)
    y = F.conv2d(x.float(), w.float(), None, stride, padding)
    return (y + p.bias.float()[None, :, None, None]).to(x.dtype)


def simple_adapter_forward(m: SimpleAdapter, x) -> torch.Tensor:
    """(B, C, F, H, W) packed Plücker latents -> (B, out_dim, F, H/16, W/16)."""
    b, c, f, h, w = x.shape
    x = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w)
    x = F.pixel_unshuffle(x, 8)
    x = _conv2d(m.conv, x, stride=2)
    for blk in m.residual_blocks:
        y = torch.relu(_conv2d(blk.conv1, x, padding=1))
        x = _conv2d(blk.conv2, y, padding=1) + x
    _, oc, oh, ow = x.shape
    return x.reshape(b, f, oc, oh, ow).permute(0, 2, 1, 3, 4)


def convert_simple_adapter(sd: Dict, prefix: str = "") -> Dict:
    """Reference `conv.*`, `residual_blocks.{i}.conv{1,2}.*` (under
    `prefix`) -> `SimpleAdapter` state dict: the same names."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and k[len(prefix):].startswith(("conv.",
                                                                    "residual_blocks."))}
