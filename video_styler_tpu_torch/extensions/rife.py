"""RIFE IFNet optical-flow frame interpolation in PyTorch.

Counterpart of `video_styler_tpu/extensions/rife.py`: three coarse-to-fine
IFBlocks predict bidirectional flow and a blend mask; the frames are
backward-warped (bilinear, border clamp, align_corners=True) and blended.
fp32 throughout, as there (IFNet does not take fp16). The convolutions are
cuDNN's `conv2d`/`conv_transpose2d` (TF32 off, `video_styler_tpu_torch`
sets that), as the JAX package leaves them to XLA; `warp` and
`resize_bilinear` are the JAX package's gathers, written out.

Parameters are a nested dict of tensors keyed by the checkpoint's module
names ('module.' stripped), in torch layouts, as `convert_ifnet` makes them.
Frames go in as PIL images or (H, W, 3) uint8 arrays or tensors; PIL is
needed only for PIL frames or a side that is not a multiple of 32 (PIL's
resize then pads the frame, as in JAX). Frames are flipped to BGR on the
way in and back on the way out, as the reference does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import nest_state_dict

IFNET_WIDTH = 90      # IFBlock(7 + 4, c=90) for block0..2 and block_tea
IFNET_IN = 11         # [img0 | img1 | mask] (7) and the 4 flow channels


# ---------------------------------------------------------------- primitives

def conv2d(p, x, stride=1, padding=1):
    return F.conv2d(x, p["weight"], p.get("bias"), stride=stride, padding=padding)


def conv_transpose2d(p, x, stride=2, padding=1):
    """torch ConvTranspose2d, weight (in, out, kh, kw)."""
    return F.conv_transpose2d(x, p["weight"], p.get("bias"), stride=stride, padding=padding)


def prelu(p, x):
    return torch.where(x >= 0, x, p["weight"][None, :, None, None] * x)


def resize_bilinear(x, out_hw):
    """F.interpolate(mode='bilinear', align_corners=False, antialias=False)
    as the JAX package writes it: half-pixel centres, edge clamp."""
    h_in, w_in = x.shape[2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x

    def axis_weights(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) \
            * (n_in / n_out) - 0.5
        i0 = torch.clamp(torch.floor(src), 0, n_in - 1)
        frac = torch.clamp(src - i0, 0.0, 1.0)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0.long(), i1.long(), frac

    y0, y1, fy = axis_weights(h_in, h_out)
    x0, x1, fx = axis_weights(w_in, w_out)
    top, bot = x[:, :, y0, :], x[:, :, y1, :]
    rows = top + (bot - top) * fy[None, None, :, None]
    left, right = rows[:, :, :, x0], rows[:, :, :, x1]
    return left + (right - left) * fx[None, None, None, :]


def warp(img, flow):
    """Backward warp: img (B, C, H, W), flow (B, 2, H, W) pixel offsets
    (x, y); bilinear, border clamp, align_corners=True."""
    b, c, h, w = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[None, :, None]
    gx = torch.clamp(xs + flow[:, 0], 0, w - 1)
    gy = torch.clamp(ys + flow[:, 1], 0, h - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    bi = torch.arange(b, device=img.device)[:, None, None]
    hwc = img.permute(0, 2, 3, 1)

    def gather(yy, xx):
        return hwc[bi, yy.long(), xx.long()]  # (B, H, W, C)

    out = (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x1) * wx * (1 - wy)
           + gather(y1, x0) * (1 - wx) * wy + gather(y1, x1) * wx * wy)
    return out.permute(0, 3, 1, 2)


# ---------------------------------------------------------------- IFNet

def _conv_prelu(p, x, stride=1):
    return prelu(p["1"], conv2d(p["0"], x, stride=stride, padding=1))


def _ifblock(p, x, flow, scale):
    h, w = x.shape[2:]
    sh, sw = int(h / scale), int(w / scale)
    x = resize_bilinear(x, (sh, sw))
    flow = resize_bilinear(flow, (sh, sw)) * (1.0 / scale)
    feat = _conv_prelu(p["conv0"]["0"], torch.cat([x, flow], dim=1), stride=2)
    feat = _conv_prelu(p["conv0"]["1"], feat, stride=2)
    for blk in ("convblock0", "convblock1", "convblock2", "convblock3"):
        f = _conv_prelu(p[blk]["0"], feat)
        f = _conv_prelu(p[blk]["1"], f)
        feat = f + feat
    fl = conv_transpose2d(p["conv1"]["2"], prelu(p["conv1"]["1"],
                                                  conv_transpose2d(p["conv1"]["0"], feat)))
    mk = conv_transpose2d(p["conv2"]["2"], prelu(p["conv2"]["1"],
                                                  conv_transpose2d(p["conv2"]["0"], feat)))
    return resize_bilinear(fl, (h, w)) * scale, resize_bilinear(mk, (h, w))


def ifnet_forward(params, x, scale_list=(4, 2, 1)):
    """x: (B, 6, H, W) = [img0 | img1] in [0, 1] -> (flow_list, mask,
    merged) as IFNet.forward."""
    channel = x.shape[1] // 2
    img0, img1 = x[:, :channel], x[:, channel:]
    warped_img0, warped_img1 = img0, img1
    flow = torch.zeros((x.shape[0], 4) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    mask = torch.zeros((x.shape[0], 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    flow_list, mask_list, merged = [], [], []
    for i, name in enumerate(("block0", "block1", "block2")):
        p = params[name]
        f0, m0 = _ifblock(p, torch.cat([warped_img0[:, :3], warped_img1[:, :3], mask], 1),
                          flow, scale_list[i])
        f1, m1 = _ifblock(p, torch.cat([warped_img1[:, :3], warped_img0[:, :3], -mask], 1),
                          torch.cat([flow[:, 2:4], flow[:, :2]], 1), scale_list[i])
        flow = flow + (f0 + torch.cat([f1[:, 2:4], f1[:, :2]], 1)) / 2
        mask = mask + (m0 + (-m1)) / 2
        mask_list.append(mask)
        flow_list.append(flow)
        warped_img0 = warp(img0, flow[:, :2])
        warped_img1 = warp(img1, flow[:, 2:4])
        merged.append((warped_img0, warped_img1))
    out = []
    for i in range(3):
        m = torch.sigmoid(mask_list[i])
        out.append(merged[i][0] * m + merged[i][1] * (1 - m))
    return flow_list, torch.sigmoid(mask_list[2]), out


def convert_ifnet(sd: Dict, device=None) -> Dict:
    """torch IFNet state dict (numpy arrays or tensors) -> nested dict of
    float32 tensors ('module.' prefix stripped), on `device` (the card
    unless "cpu")."""
    return nest_state_dict(sd, device, strip="module.")


def ifnet_shapes(c: int = IFNET_WIDTH, in_planes: int = IFNET_IN) -> Dict[str, tuple]:
    """The IFNet checkpoint's tensor names and shapes (block0..2 and the
    unused teacher block_tea, which takes 3 more input channels)."""
    shapes = {}
    for blk, cin in (("block0", in_planes), ("block1", in_planes), ("block2", in_planes),
                     ("block_tea", in_planes + 3)):
        convs = [("conv0.0", cin, c // 2), ("conv0.1", c // 2, c)]
        convs += [(f"convblock{i}.{j}", c, c) for i in range(4) for j in range(2)]
        for name, ci, co in convs:
            shapes[f"{blk}.{name}.0.weight"] = (co, ci, 3, 3)
            shapes[f"{blk}.{name}.0.bias"] = (co,)
            shapes[f"{blk}.{name}.1.weight"] = (co,)
        for head, out in (("conv1", 4), ("conv2", 1)):
            shapes[f"{blk}.{head}.0.weight"] = (c, c // 2, 4, 4)
            shapes[f"{blk}.{head}.0.bias"] = (c // 2,)
            shapes[f"{blk}.{head}.1.weight"] = (c // 2,)
            shapes[f"{blk}.{head}.2.weight"] = (c // 2, out, 4, 4)
            shapes[f"{blk}.{head}.2.bias"] = (out,)
    return shapes


# ---------------------------------------------------------------- API

def _is_pil(im) -> bool:
    return not isinstance(im, np.ndarray) and not torch.is_tensor(im)


def _size(im):
    """(width, height), as PIL's `size`."""
    return im.size if _is_pil(im) else (im.shape[1], im.shape[0])


class RIFEInterpolater:
    """2x frame interpolation (RIFE/__init__.py:119-196)."""

    def __init__(self, params, device=None):
        self.device = resolve_device(device)
        self.params = params

    def _process(self, images) -> torch.Tensor:
        arrs = []
        for im in images:
            w, h = _size(im)
            if w % 32 or h % 32:
                from PIL import Image
                im = im if _is_pil(im) else Image.fromarray(np.asarray(
                    im.cpu() if torch.is_tensor(im) else im))
                im = im.resize(((w + 31) // 32 * 32, (h + 31) // 32 * 32))
            t = torch.as_tensor(np.array(im) if not torch.is_tensor(im) else im)
            arrs.append(t.to(self.device, torch.float32).flip(-1) / 255.0)  # BGR, as ref
        return torch.stack(arrs).permute(0, 3, 1, 2)

    def _decode(self, arr, size, as_pil: bool):
        arr = arr.clamp(0, 1)
        frames = (arr.flip(1).permute(0, 2, 3, 1) * 255).clamp(0, 255).to(torch.uint8)
        out = list(frames.cpu().numpy())
        if as_pil or out[0].shape[1::-1] != size:
            from PIL import Image
            out = [Image.fromarray(a) for a in out]
            out = [im if im.size == size else im.resize(size) for im in out]
            if not as_pil:
                out = [np.asarray(im) for im in out]
        return out

    def _run(self, pairs, scales, batch_size):
        outs = []
        with torch.no_grad():
            for i in range(0, pairs.shape[0], batch_size):
                outs.append(ifnet_forward(self.params, pairs[i:i + batch_size], scales)[2][2])
        return torch.cat(outs)

    def interpolate(self, images: List, scale: float = 1.0, batch_size: int = 4,
                    num_iter: int = 1):
        proc = self._process(images)
        scales = (4 / scale, 2 / scale, 1 / scale)
        for _ in range(num_iter):
            mid = self._run(torch.cat([proc[:-1], proc[1:]], dim=1), scales,
                            batch_size).clamp(0, 1)
            woven = torch.empty((2 * len(proc) - 1,) + tuple(proc.shape[1:]),
                                dtype=proc.dtype, device=proc.device)
            woven[0::2], woven[1::2] = proc, mid
            proc = woven
        return self._decode(proc, _size(images[0]), _is_pil(images[0]))


class RIFESmoother(RIFEInterpolater):
    """Temporal smoothing by interpolate-then-blend (RIFE/__init__.py:199-242)."""

    def __call__(self, rendered_frames, scale: float = 1.0, batch_size: int = 4,
                 num_iter: int = 1, **kwargs):
        proc = self._process(rendered_frames)
        scales = (4 / scale, 2 / scale, 1 / scale)
        for _ in range(num_iter):
            mid = self._run(torch.cat([proc[:-2], proc[2:]], dim=1), scales, batch_size)
            blended = self._run(torch.cat([proc[1:-1], mid], dim=1), scales, batch_size)
            proc[1:-1] = blended
        return self._decode(proc, _size(rendered_frames[0]), _is_pil(rendered_frames[0]))
