"""UnifiedDataset: metadata rows through composable operators.

Counterpart of `video_styler_tpu/trainers/unified_dataset.py`: operators
compose with >> (ToAbsolutePath >> LoadVideo >> ImageCropAndResize),
metadata comes from CSV/JSON/JSONL, and each sample is the row's dict with
its file columns loaded. Frames are uint8 (H, W, 3) numpy arrays, where the
JAX package hands PIL images on; video goes through the port's own
`data.video`. PIL is imported only when an image is loaded or resized.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


class DataProcessingOperator:
    def __rshift__(self, other):
        return OperatorChain(self, other)

    def __call__(self, data):
        raise NotImplementedError


class OperatorChain(DataProcessingOperator):
    def __init__(self, *ops):
        self.ops = []
        for op in ops:
            if isinstance(op, OperatorChain):
                self.ops.extend(op.ops)
            else:
                self.ops.append(op)

    def __call__(self, data):
        for op in self.ops:
            data = op(data)
        return data


class ToAbsolutePath(DataProcessingOperator):
    def __init__(self, base_path: str):
        self.base_path = base_path

    def __call__(self, data):
        return os.path.join(self.base_path, data)


class LoadImage(DataProcessingOperator):
    """An image file -> uint8 (H, W, 3) (RGB unless convert_RGB=False)."""

    def __init__(self, convert_RGB: bool = True):
        self.convert_RGB = convert_RGB

    def __call__(self, path) -> np.ndarray:
        from PIL import Image
        with Image.open(path) as image:
            return np.asarray(image.convert("RGB") if self.convert_RGB else image)


class LoadVideo(DataProcessingOperator):
    """A video file -> its first frames, as many as `num_frames` allows
    and `time_division_factor * k + time_division_remainder`."""

    def __init__(self, num_frames: int = 81, time_division_factor: int = 4,
                 time_division_remainder: int = 1, frame_processor=None):
        self.num_frames = num_frames
        self.time_division_factor = time_division_factor
        self.time_division_remainder = time_division_remainder
        self.frame_processor = frame_processor

    def _target_frames(self, total: int) -> int:
        n = min(self.num_frames, total)
        while n % self.time_division_factor != self.time_division_remainder and n > 1:
            n -= 1
        return n

    def __call__(self, path) -> List[np.ndarray]:
        from ..data.video import VideoData
        vd = VideoData(path)
        try:
            frames = [vd[i] for i in range(self._target_frames(len(vd)))]
        finally:
            vd.close()
        if self.frame_processor is not None:
            frames = [self.frame_processor(f) for f in frames]
        return frames


class ImageCropAndResize(DataProcessingOperator):
    """Dynamic-resolution bucketing: a fixed (height, width), or a downscale
    to at most `max_pixels` snapped down to the division factors; then a
    center crop and Lanczos resize (`data.video.crop_and_resize`)."""

    def __init__(self, height=None, width=None, max_pixels=1920 * 1080,
                 height_division_factor=16, width_division_factor=16):
        self.height = height
        self.width = width
        self.max_pixels = max_pixels
        self.hdiv = height_division_factor
        self.wdiv = width_division_factor

    def target_shape(self, h, w):
        if self.height is not None and self.width is not None:
            return self.height, self.width
        if h * w > self.max_pixels:
            scale = (self.max_pixels / (h * w)) ** 0.5
            h, w = int(h * scale), int(w * scale)
        h = max(h // self.hdiv * self.hdiv, self.hdiv)
        w = max(w // self.wdiv * self.wdiv, self.wdiv)
        return h, w

    def __call__(self, data):
        from ..data.video import crop_and_resize
        if isinstance(data, list):
            if not data:
                return data
            h, w = self.target_shape(*data[0].shape[:2])
            return [crop_and_resize(f, h, w) for f in data]
        h, w = self.target_shape(*data.shape[:2])
        return crop_and_resize(data, h, w)


class RouteByExtension(DataProcessingOperator):
    """{".mp4|.mov": op, ".png|.jpg": op} -> the op of the path's extension."""

    def __init__(self, routes: Dict[str, DataProcessingOperator]):
        self.routes = {k.lower(): v for k, v in routes.items()}

    def __call__(self, path):
        ext = os.path.splitext(path)[1].lower()
        for exts, op in self.routes.items():
            if ext in exts.split("|"):
                return op(path)
        raise ValueError(f"no route for extension {ext}")


def load_metadata(path: str) -> List[Dict]:
    """CSV/JSON/JSONL metadata -> list of row dicts."""
    if path.endswith(".csv"):
        import csv
        with open(path, newline="") as f:
            return list(csv.DictReader(f))
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    with open(path) as f:
        data = json.load(f)
    return data if isinstance(data, list) else data.get("data", [])


class UnifiedDataset:
    """metadata rows x per-column operator chains -> sample dicts."""

    def __init__(self, base_path: str = "", metadata_path: Optional[str] = None,
                 data: Optional[List[Dict]] = None, repeat: int = 1,
                 data_file_keys: tuple = (), main_data_operator=None,
                 special_operators: Optional[Dict] = None):
        self.base_path = base_path
        self.rows = data if data is not None else load_metadata(metadata_path)
        self.repeat = repeat
        self.data_file_keys = data_file_keys
        self.main_data_operator = main_data_operator
        self.special_operators = special_operators or {}

    @staticmethod
    def default_video_operator(base_path: str, num_frames: int = 81,
                               height=None, width=None,
                               max_pixels=1920 * 1080):
        return (ToAbsolutePath(base_path)
                >> LoadVideo(num_frames=num_frames)
                >> ImageCropAndResize(height=height, width=width,
                                      max_pixels=max_pixels))

    @staticmethod
    def default_image_operator(base_path: str, height=None, width=None,
                               max_pixels=1920 * 1080):
        return (ToAbsolutePath(base_path)
                >> LoadImage()
                >> ImageCropAndResize(height=height, width=width,
                                      max_pixels=max_pixels))

    def __len__(self):
        return len(self.rows) * self.repeat

    def __getitem__(self, idx):
        row = dict(self.rows[idx % len(self.rows)])
        for key in self.data_file_keys:
            if key not in row or row[key] in (None, ""):
                continue
            op = self.special_operators.get(key, self.main_data_operator)
            if op is not None:
                row[key] = op(row[key])
        return row

    def shuffled_indices(self, seed: int = 0) -> List[int]:
        idx = list(range(len(self)))
        random.Random(seed).shuffle(idx)
        return idx
