"""ControlNet units, their manager and the annotators, in PyTorch.

Counterpart of `video_styler_tpu/controlnets.py` (:19-106): a
`ControlNetUnit` bundles an annotator, a ControlNet and a scale;
`MultiControlNetManager` annotates the control image per unit (RGB in [0,
1] at the output size) and sums the units' scaled residual stacks. The JAX
canny annotator calls `cv2.Canny(image, 100, 200)`; the port uses no cv2,
and `canny` here computes what cv2 computes for an 8-bit RGB image: 3x3
Sobel gradients (replicated border) per channel, at each pixel the
channel of the largest L1 magnitude (the first on a tie), non-maximum
suppression along the gradient's octant (cv2's tan 22.5 test in 15-bit
fixed point, its strict and non-strict neighbour comparisons), and
hysteresis: the pixels above the low threshold that connect (8-neighbours)
to one above the high. The neural annotators need controlnet_aux and stay
gated, as in JAX; tile, none and inpaint pass the image through.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .pipelines.wan_video import _image_array

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def _sobel(img: np.ndarray):
    """uint8 (H, W, C) -> int32 (dx, dy), 3x3 Sobel with a replicated border."""
    p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = img.shape[:2]

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    return gx, gy


def canny(img: np.ndarray, low: float = 100, high: float = 200) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> uint8 (H, W) edges, 255 on an edge."""
    if img.ndim == 2:
        img = img[:, :, None]
    low, high = sorted((low, high))
    low, high = int(np.floor(low)), int(np.floor(high))
    gx, gy = _sobel(img)
    mag = np.abs(gx) + np.abs(gy)
    best = np.argmax(mag, axis=2)[..., None]
    dx = np.take_along_axis(gx, best, 2)[..., 0]
    dy = np.take_along_axis(gy, best, 2)[..., 0]
    m = np.take_along_axis(mag, best, 2)[..., 0]
    h, w = m.shape
    pm = np.pad(m, 1)

    def nb(oy, ox):
        return pm[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    x = np.abs(dx).astype(np.int64)
    y = np.abs(dy).astype(np.int64) << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    s = np.where((dx ^ dy) < 0, -1, 1)
    keep_h = (m > nb(0, -1)) & (m >= nb(0, 1))
    keep_v = (m > nb(-1, 0)) & (m >= nb(1, 0))
    diag_a = (m > nb(-1, -1)) & (m > nb(1, 1))        # s = 1
    diag_b = (m > nb(-1, 1)) & (m > nb(1, -1))        # s = -1
    keep_d = np.where(s > 0, diag_a, diag_b)
    keep = np.where(horizontal, keep_h, np.where(vertical, keep_v, keep_d)) & (m > low)
    # hysteresis: the 8-connected pieces of `keep` that hold a strong pixel
    from scipy import ndimage
    labels, _ = ndimage.label(keep, structure=np.ones((3, 3), bool))
    strong = np.unique(labels[keep & (m > high)])
    return np.isin(labels, strong[strong > 0]).astype(np.uint8) * 255


@dataclass
class ControlNetConfigUnit:
    processor_id: str
    model_path: str
    scale: float = 1.0
    skip_processor: bool = False


class Annotator:
    """canny runs here; the neural annotators need controlnet_aux and are
    gated; tile, none and inpaint (or skip_processor) pass the image
    through."""

    def __init__(self, processor_id: str, detect_resolution=None, skip_processor: bool = False):
        self.processor_id = processor_id
        self.detect_resolution = detect_resolution
        self.skip = skip_processor or processor_id in ("tile", "none", "inpaint")
        if not self.skip and processor_id != "canny":
            try:
                import controlnet_aux  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    f"annotator '{processor_id}' needs controlnet_aux, which is not "
                    "available here; pass skip_processor=True and provide pre-processed "
                    "control images") from e

    def __call__(self, image):
        """A PIL image or uint8 (H, W, 3) array -> the annotated image as a
        uint8 (H, W, 3) array (PIL resizes, as in JAX)."""
        arr = np.asarray(image)
        if self.skip:
            return arr
        if self.processor_id == "canny":
            h, w = arr.shape[:2]
            dr = self.detect_resolution or min(w, h)
            edges = canny(_image_array(arr, dr, dr), 100, 200)
            return _image_array(np.repeat(edges[:, :, None], 3, axis=2), w, h)
        raise ValueError(self.processor_id)


class ControlNetUnit:
    def __init__(self, processor: Annotator, model, scale: float = 1.0, xl: bool = False,
                 global_pool: bool = False):
        self.processor = processor
        self.model = model
        self.scale = scale
        self.xl = xl
        self.global_pool = global_pool


class MultiControlNetManager:
    """Per-unit forward, the scaled residual stacks summed."""

    def __init__(self, controlnet_units: List[ControlNetUnit] = ()):
        self.units = list(controlnet_units)

    def process_image(self, image, width: int, height: int, units=None) -> np.ndarray:
        """-> (n_units, 3, H, W) float32 conditioning in [0, 1] (of `units`,
        by default every unit)."""
        conds = []
        for unit in self.units if units is None else units:
            img = _image_array(unit.processor(image), width, height)
            conds.append(np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
        return np.stack(conds)

    def __call__(self, sample, timestep, text_emb, conditionings, **kwargs):
        from .models.controlnet import sd_controlnet_forward, sdxl_controlnet_union_forward
        res_stack = None
        for unit, cond in zip(self.units, conditionings):
            cond = torch.as_tensor(np.asarray(cond)[None], device=sample.device)
            if unit.xl:
                stack = sdxl_controlnet_union_forward(
                    unit.model, sample, timestep, text_emb, cond, unit.processor.processor_id,
                    kwargs["add_time_id"], kwargs["add_text_embeds"],
                    global_pool=unit.global_pool)
            else:
                stack = sd_controlnet_forward(unit.model, sample, timestep, text_emb, cond,
                                              global_pool=unit.global_pool)
            stack = [r * unit.scale for r in stack]
            res_stack = stack if res_stack is None else [a + b for a, b in zip(res_stack, stack)]
        return res_stack
