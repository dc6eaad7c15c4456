"""Video IO for the CLI: lazy frame reading with center crop + resize, one
image read whole, and an mp4 writer. Frames are uint8 (H, W, 3) numpy
arrays. `imageio`, `cv2` and PIL are imported only when a file is read or
written.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def crop_and_resize(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    """Center crop to the target aspect ratio, then resize (Lanczos)."""
    from PIL import Image
    image = Image.fromarray(frame)
    w, h = image.size
    scale = max(width / w, height / h)
    image = image.resize((round(w * scale), round(h * scale)), Image.LANCZOS)
    w2, h2 = image.size
    left = (w2 - width) // 2
    top = (h2 - height) // 2
    return np.asarray(image.crop((left, top, left + width, top + height)).convert("RGB"))


def read_image(path: str) -> np.ndarray:
    """One image file as uint8 (H, W, 3) RGB, at its own size (the pipeline
    resizes it, as the JAX CLIs pass `Image.open(path).convert("RGB")`)."""
    from PIL import Image
    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))


class VideoData:
    """Frames of a video file, read on access, optionally cropped/resized."""

    def __init__(self, video_file: str, height: Optional[int] = None,
                 width: Optional[int] = None):
        self.height = height
        self.width = width
        self._reader = None
        self._cap = None
        try:
            import imageio
            self._reader = imageio.get_reader(video_file)
            self._n = self._reader.count_frames()
        except (ImportError, OSError, RuntimeError, ValueError):
            # no imageio, or no ffmpeg backend for it: read with cv2
            import cv2
            self._reader = None
            self._cap = cv2.VideoCapture(video_file)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video {video_file}")
            self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __len__(self):
        return self._n

    def _raw(self, item: int) -> np.ndarray:
        if self._reader is not None:
            return np.asarray(self._reader.get_data(item))[..., :3]
        import cv2
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, item)
        ok, frame = self._cap.read()
        if not ok:
            raise IndexError(f"frame {item} unreadable")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def __getitem__(self, item: int) -> np.ndarray:
        frame = self._raw(item)
        if self.height is not None and self.width is not None:
            frame = crop_and_resize(frame, self.height, self.width)
        return frame

    def close(self):
        if self._reader is not None:
            self._reader.close()
        if self._cap is not None:
            self._cap.release()


def save_video(frames: Sequence[np.ndarray], save_path: str, fps: int = 25,
               quality: int = 5):
    """Write uint8 (H, W, 3) frames as a video: imageio-ffmpeg, or cv2 when
    imageio has no ffmpeg backend."""
    try:
        import imageio
        writer = imageio.get_writer(save_path, fps=fps, quality=quality)
    except (ImportError, OSError, RuntimeError, ValueError):
        writer = None
    if writer is not None:
        with writer:
            for frame in frames:
                writer.append_data(np.asarray(frame))
        return
    import cv2
    h, w = np.asarray(frames[0]).shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*("mp4v" if save_path.endswith(".mp4") else "XVID"))
    vw = cv2.VideoWriter(save_path, fourcc, fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"no available video writer for {save_path}")
    try:
        for frame in frames:
            vw.write(cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR))
    finally:
        vw.release()
