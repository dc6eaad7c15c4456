"""PatchMatch NNF estimation (FastBlend's core) with the field, the errors
and the images resident on the device.

Counterpart of `video_styler_tpu/extensions/fastblend/patch_match.py:17-236`
with the same orchestration: propagation in a random order of the four
directions, random search, tracking across the batch, coarse to fine over
a pyramid, `patch_size` shrinking by 2 each iteration while `pad_size`
stays that of the first. The kernels are F1 and F2 (F3 with
`use_pairwise_patch_error`) of `kernels.py`.

Random draws come from a numpy `Generator` (default `default_rng(0)`, one
per pyramid level, its state carried across batches, as in JAX): the
direction order is host control flow, and the random-search steps are
drawn as int64 and cast to int32 on the host, then copied to the device
from pinned memory without a sync. The card and the CPU thus see the JAX
package's draws. Nothing else crosses from the host while the field is
refined: the neighbour steps add their unit on the device, the resample
tables are copied once per size, and an update keeps a candidate with
`torch.where`, which, unlike boolean indexing, does not wait for the host.

The JAX package resamples with cv2 (`INTER_AREA` for the pyramid levels,
`INTER_LINEAR` for the upsampled field, :190-224), which the card's machine
lacks. `resize_area` and `resize_linear` compute what cv2 computes, in its
order and roundings, in torch on the images' device.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from .kernels import pairwise_patch_error, patch_error, remap


def host_to(array, device, dtype=None):
    """A numpy array (cast to `dtype` as numpy's astype would) as a tensor on
    `device`: on a card written into pinned memory and copied without
    waiting for the host (the pinned buffer is held until the copy is done)."""
    array = np.asarray(array)
    dtype = np.dtype(dtype or array.dtype)
    if device.type != "cuda":
        return torch.from_numpy(array.astype(dtype, copy=False))
    host = torch.empty(array.shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True)
    np.copyto(host.numpy(), array, casting="unsafe")
    return host.to(device, non_blocking=True)


# ------------------------------------------------------------ cv2 resamples

def _area_fast(images, sh: int, sw: int):
    """Box average over an sh x sw integer cell: the area summed in row-major
    order four at a time, sum += ((a + b) + c) + d, then times 1/area
    (cv2's `resizeAreaFast_`; its 1- and 4-channel halving is vectorised in
    another order, which FastBlend's 3-channel images never take)."""
    b, h, w, c = images.shape
    cells = images[:, :h // sh * sh, :w // sw * sw].reshape(b, h // sh, sh, w // sw, sw, c)
    taps = [cells[:, :, i, :, j] for i in range(sh) for j in range(sw)]
    acc = torch.zeros_like(taps[0])
    k = 0
    while k <= len(taps) - 4:
        acc = acc + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
        k += 4
    for t in taps[k:]:
        acc = acc + t
    return acc * (1.0 / len(taps))


def _area_table(ssize: int, dsize: int, scale: float):
    """cv2's `computeResizeAreaTab`: for each destination cell, the source
    indices it overlaps and their float32 weights, as (index, weight)
    arrays padded to the longest cell with weight 0."""
    cells = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        cell = []
        if s1 - f1 > 1e-3:
            cell.append((s1 - 1, (s1 - f1) / width))
        cell += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            cell.append((s2, min(min(f2 - s2, 1.0), width) / width))
        cells.append(cell)
    n = max(len(c) for c in cells)
    idx = np.zeros((n, dsize), np.int64)
    wt = np.zeros((n, dsize), np.float32)
    for d, cell in enumerate(cells):
        for j, (s, a) in enumerate(cell):
            idx[j, d], wt[j, d] = s, a
    return idx, wt


@functools.lru_cache(maxsize=64)
def _area_tables(h: int, w: int, height: int, width: int, device):
    """`_area_table`'s indices and weights along x and y, on `device`."""
    xi, xw = _area_table(w, width, 1.0 / (width / w))
    yi, yw = _area_table(h, height, 1.0 / (height / h))
    return ([host_to(a, device) for a in xi], [host_to(a, device) for a in xw],
            [host_to(a, device) for a in yi], [host_to(a, device) for a in yw])


def resize_area(images, height: int, width: int):
    """cv2.resize(img, (width, height), INTER_AREA) of each (H, W, C)
    float32 image of a (B, H, W, C) batch, for a downscale (or the same
    size, which cv2 copies)."""
    b, h, w, c = images.shape
    if (h, w) == (height, width):
        return images
    if height > h or width > w:
        raise ValueError(f"resize_area downscales: {h}x{w} -> {height}x{width}")
    sx, sy = 1.0 / (width / w), 1.0 / (height / h)
    if abs(sx - round(sx)) < np.finfo(np.float64).eps and \
            abs(sy - round(sy)) < np.finfo(np.float64).eps:
        return _area_fast(images, round(sy), round(sx))
    xi, xw, yi, yw = _area_tables(h, w, height, width, images.device)
    # horizontal: buf += src * alpha, cell entry by entry; then vertical:
    # sum = beta * buf for the first row of a cell, sum += beta * buf after
    buf = torch.zeros((b, h, width, c), dtype=torch.float32, device=images.device)
    for idx, a in zip(xi, xw):
        buf = buf + images[:, :, idx] * a[None, None, :, None]
    out = None
    for idx, bt in zip(yi, yw):
        term = bt[None, :, None, None] * buf[:, idx]
        out = term if out is None else out + term
    return out


def _linear_taps(ssize: int, dsize: int, clamp_weights: bool):
    """cv2's INTER_LINEAR coefficients: fx = float((d + 0.5) * scale - 0.5),
    sx = floor(fx), weights (1 - fx, fx) in float32. Along x, a tap left of
    the image takes (0, 1.0) and one at the right edge the edge pixel alone;
    along y the rows are clamped and the weights kept."""
    scale = 1.0 / (dsize / ssize)
    fx = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        left = sx < 0
        fx[left], sx[left] = 0.0, 0
        right = sx >= ssize - 1
        fx[right], sx[right] = 0.0, ssize - 1
    i0 = np.clip(sx, 0, ssize - 1)
    i1 = np.clip(sx + 1, 0, ssize - 1)
    return i0, i1, (np.float32(1.0) - fx).astype(np.float32), fx


@functools.lru_cache(maxsize=64)
def _linear_tables(h: int, w: int, height: int, width: int, device):
    """`_linear_taps` along x (weights clamped) and y, and the columns at
    the right edge, on `device` (None where there is no such column)."""
    x0, x1, a0, a1 = _linear_taps(w, width, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h, height, clamp_weights=False)
    edge = np.nonzero(x0 + 1 >= w)[0]
    t = lambda a: host_to(np.ascontiguousarray(a), device)
    edges = (t(edge), t(x0[edge])) if edge.size else None
    return (t(x0), t(x1), t(a0)[None, None, :, None], t(a1)[None, None, :, None],
            t(y0), t(y1), t(b0)[None, :, None, None], t(b1)[None, :, None, None], edges)


def resize_linear(images, height: int, width: int):
    """cv2.resize(img, (width, height), INTER_LINEAR) of each (H, W, 2)
    float32 field of a (B, H, W, 2) batch: the horizontal pass
    s0 * a0 + s1 * a1 (the edge pixel alone at the right edge), then the
    vertical r0 * b0 + r1 * b1, each product rounded. This is cv2's order
    for two channels, which is what `update_nnf` resizes."""
    b, h, w, c = images.shape
    x0, x1, a0, a1, y0, y1, b0, b1, edges = _linear_tables(h, w, height, width,
                                                           images.device)
    rows = images[:, :, x0] * a0 + images[:, :, x1] * a1
    if edges is not None:  # index_put with indices: no host sync on a card
        rows[:, :, edges[0]] = images[:, :, edges[1]]
    return rows[:, y0] * b0 + rows[:, y1] * b1


def _draw_to(rng: np.random.Generator, low: int, high: int, shape, device):
    """rng.integers(low, high, shape, int64) cast to int32 (wrapping, as
    numpy's astype), written into pinned memory on a card and copied there
    without a sync."""
    return host_to(rng.integers(low, high, size=shape, dtype=np.int64), device, np.int32)


def _mean0(x):
    """numpy's x.mean(axis=0, keepdims=True) for float32: rows summed in
    order, then divided by their count."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return (acc / x.shape[0])[None]


class PatchMatcher:
    def __init__(self, height, width, channel, minimum_patch_size, num_iter=5,
                 guide_weight=10.0, random_search_steps=3, random_search_range=4,
                 use_mean_target_style=False, use_pairwise_patch_error=False,
                 tracking_window_size=0, rng: Optional[np.random.Generator] = None,
                 device=None, **kwargs):
        self.height = height
        self.width = width
        self.channel = channel
        self.minimum_patch_size = minimum_patch_size
        self.num_iter = num_iter
        self.guide_weight = guide_weight
        self.random_search_steps = random_search_steps
        self.random_search_range = random_search_range
        self.use_mean_target_style = use_mean_target_style
        self.use_pairwise_patch_error = use_pairwise_patch_error
        self.tracking_window_size = tracking_window_size
        self.patch_size_list = [minimum_patch_size + i * 2 for i in range(num_iter)][::-1]
        self.pad_size = self.patch_size_list[0] // 2
        self.patch_size = self.patch_size_list[0]
        self.rng = rng or np.random.default_rng(0)
        self.device = resolve_device(device)

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    def pad_image(self, image):
        p = self.pad_size
        return F.pad(image, (0, 0, p, p, p, p))

    def unpad_image(self, image):
        p = self.pad_size
        return image[:, p:-p, p:-p, :]

    def apply_nnf_to_image(self, nnf, source):
        return remap(self.height, self.width, self.channel, self.patch_size,
                     self.pad_size, source, nnf)

    def get_patch_error(self, source, nnf, target):
        return patch_error(self.height, self.width, self.channel, self.patch_size,
                           self.pad_size, source, nnf, target)

    def get_pairwise_patch_error(self, source, nnf):
        err = pairwise_patch_error(
            self.height, self.width, self.channel, self.patch_size, self.pad_size,
            source[0::2].contiguous(), nnf[0::2].contiguous(),
            source[1::2].contiguous(), nnf[1::2].contiguous())
        return err.repeat_interleave(2, dim=0)

    def get_error(self, source_guide, target_guide, source_style, target_style, nnf):
        error_guide = self.get_patch_error(source_guide, nnf, target_guide)
        if self.use_mean_target_style:
            target_style = self.apply_nnf_to_image(nnf, source_style)
            target_style = _mean0(target_style).repeat(source_guide.shape[0], 1, 1, 1)
        if self.use_pairwise_patch_error:
            error_style = self.get_pairwise_patch_error(source_style, nnf)
        else:
            error_style = self.get_patch_error(source_style, nnf, target_style)
        return error_guide * self.guide_weight + error_style

    def clamp_bound(self, nnf):
        return torch.stack([nnf[..., 0].clamp(0, self.height - 1),
                            nnf[..., 1].clamp(0, self.width - 1)], dim=-1)

    def random_step(self, nnf, r):
        step = _draw_to(self.rng, -r, r + 1, tuple(nnf.shape), nnf.device)
        return self.clamp_bound(nnf + step)

    def neighboor_step(self, nnf, d):
        """The neighbour's match one pixel on: d 0/1 from the row/column
        before (+1 on that axis), d 2/3 from the one after (-1)."""
        axis = 1 if d in (0, 2) else 2
        n = nnf.shape[axis]
        if d < 2:
            moved = torch.cat([nnf.narrow(axis, 0, 1), nnf.narrow(axis, 0, n - 1)], dim=axis)
        else:
            moved = torch.cat([nnf.narrow(axis, 1, n - 1), nnf.narrow(axis, n - 1, 1)],
                              dim=axis)
        rows, cols = moved[..., 0], moved[..., 1]
        if axis == 1:
            rows = rows + (1 if d < 2 else -1)
        else:
            cols = cols + (1 if d < 2 else -1)
        return torch.stack([rows.clamp(0, self.height - 1),
                            cols.clamp(0, self.width - 1)], dim=-1)

    def shift_nnf(self, nnf, d):
        if d > 0:
            d = min(nnf.shape[0], d)
            return torch.cat([nnf[d:]] + [nnf[-1:]] * d, dim=0)
        d = max(-nnf.shape[0], d)
        return torch.cat([nnf[:1]] * (-d) + [nnf[:d]], dim=0)

    def track_step(self, nnf, d):
        if self.use_pairwise_patch_error:
            upd = torch.zeros_like(nnf)
            upd[0::2] = self.shift_nnf(nnf[0::2], d)
            upd[1::2] = self.shift_nnf(nnf[1::2], d)
            return upd
        return self.shift_nnf(nnf, d)

    def update(self, source_guide, target_guide, source_style, target_style, nnf, err,
               upd_nnf):
        upd_err = self.get_error(source_guide, target_guide, source_style, target_style,
                                 upd_nnf)
        better = upd_err < err
        return (torch.where(better[..., None], upd_nnf, nnf),
                torch.where(better, upd_err, err))

    def iteration(self, source_guide, target_guide, source_style, target_style, nnf, err):
        args = (source_guide, target_guide, source_style, target_style)
        for d in self.rng.permutation(4):
            nnf, err = self.update(*args, nnf, err, self.neighboor_step(nnf, d))
        for _ in range(self.random_search_steps):
            nnf, err = self.update(*args, nnf, err,
                                   self.random_step(nnf, self.random_search_range))
        for d in range(1, self.tracking_window_size + 1):
            nnf, err = self.update(*args, nnf, err, self.track_step(nnf, d))
            nnf, err = self.update(*args, nnf, err, self.track_step(nnf, -d))
        return nnf, err

    def estimate_nnf(self, source_guide, target_guide, source_style, nnf):
        """(B, H, W, C) images (arrays or tensors) and an int32 (B, H, W, 2)
        NNF -> the refined NNF and the unpadded remapped style, on the
        matcher's device."""
        source_guide = self.pad_image(self._tensor(source_guide, torch.float32))
        target_guide = self.pad_image(self._tensor(target_guide, torch.float32))
        source_style = self.pad_image(self._tensor(source_style, torch.float32))
        nnf = self._tensor(nnf, torch.int32)
        for it in range(self.num_iter):
            self.patch_size = self.patch_size_list[it]
            target_style = self.apply_nnf_to_image(nnf, source_style)
            err = self.get_error(source_guide, target_guide, source_style, target_style,
                                 nnf)
            nnf, err = self.iteration(source_guide, target_guide, source_style,
                                      target_style, nnf, err)
        target_style = self.unpad_image(self.apply_nnf_to_image(nnf, source_style))
        return nnf, target_style


class PyramidPatchMatcher:
    def __init__(self, image_height, image_width, channel, minimum_patch_size,
                 num_iter=5, guide_weight=10.0, use_mean_target_style=False,
                 use_pairwise_patch_error=False, tracking_window_size=0,
                 initialize="identity", device=None, **kwargs):
        maximum_patch_size = minimum_patch_size + (num_iter - 1) * 2
        self.pyramid_level = max(1, int(np.log2(
            min(image_height, image_width) / maximum_patch_size)))
        self.pyramid_heights = []
        self.pyramid_widths = []
        self.patch_matchers = []
        self.initialize = initialize
        self.device = resolve_device(device)
        for level in range(self.pyramid_level):
            height = image_height // (2 ** (self.pyramid_level - 1 - level))
            width = image_width // (2 ** (self.pyramid_level - 1 - level))
            self.pyramid_heights.append(height)
            self.pyramid_widths.append(width)
            self.patch_matchers.append(PatchMatcher(
                height, width, channel, minimum_patch_size=minimum_patch_size,
                num_iter=num_iter, guide_weight=guide_weight,
                use_mean_target_style=use_mean_target_style,
                use_pairwise_patch_error=use_pairwise_patch_error,
                tracking_window_size=tracking_window_size, device=self.device))

    def resample_image(self, images, level):
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if images.dim() == 3:
            images = images[..., None]
        return resize_area(images, self.pyramid_heights[level], self.pyramid_widths[level])

    def initialize_nnf(self, batch_size):
        height, width = self.pyramid_heights[0], self.pyramid_widths[0]
        if self.initialize == "random":
            rng = np.random.default_rng(0)
            nnf = np.stack([rng.integers(0, height, (batch_size, height, width)),
                            rng.integers(0, width, (batch_size, height, width))],
                           axis=3).astype(np.int32)
            return host_to(nnf, self.device)
        grid = torch.stack(torch.meshgrid(
            torch.arange(height, dtype=torch.int32, device=self.device),
            torch.arange(width, dtype=torch.int32, device=self.device), indexing="ij"),
            dim=2)
        return grid[None].repeat(batch_size, 1, 1, 1)

    def update_nnf(self, nnf, level):
        nnf = nnf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2
        nnf[:, 1::2, :, 0] += 1
        nnf[:, :, 1::2, 1] += 1
        height, width = self.pyramid_heights[level], self.pyramid_widths[level]
        if height != nnf.shape[1] or width != nnf.shape[2]:
            nnf = resize_linear(nnf.float(), height, width).to(torch.int32)
            nnf = self.patch_matchers[level].clamp_bound(nnf)
        return nnf

    def estimate_nnf(self, source_guide, target_guide, source_style):
        nnf = None
        for level in range(self.pyramid_level):
            nnf = (self.initialize_nnf(len(source_guide)) if level == 0
                   else self.update_nnf(nnf, level))
            sg = self.resample_image(source_guide, level)
            tg = self.resample_image(target_guide, level)
            ss = self.resample_image(source_style, level)
            nnf, target_style = self.patch_matchers[level].estimate_nnf(sg, tg, ss, nnf)
        return nnf, target_style
