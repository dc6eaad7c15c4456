"""Sequential video post-processing chain.

Counterpart of `video_styler_tpu/processors.py`: a chain of processors
applied to rendered frames, each taking and returning a list of frames.
`from_config` builds FastBlend (`extensions.fastblend.FastBlendSmoother`,
on the card unless its config says `device="cpu"`) and PIL's contrast and
sharpness enhancers (PIL imported when they run, as in JAX; uint8 arrays
in, arrays out); RIFE and ESRGAN join a chain as callables (`extensions.rife.RIFESmoother`,
`extensions.esrgan.ESRGANUpscaler`).
"""
from __future__ import annotations

from typing import List


def _enhance(kind: str, frames: List, rate: float) -> List:
    """PIL's enhancer on each frame; uint8 arrays come back as arrays."""
    import numpy as np
    from PIL import Image, ImageEnhance
    out = []
    for f in frames:
        image = Image.fromarray(f) if isinstance(f, np.ndarray) else f
        image = getattr(ImageEnhance, kind)(image).enhance(rate)
        out.append(np.asarray(image) if isinstance(f, np.ndarray) else image)
    return out


class ContrastProcessor:
    def __init__(self, rate: float = 1.5):
        self.rate = rate

    def __call__(self, rendered_frames: List, **kwargs):
        return _enhance("Contrast", rendered_frames, self.rate)


class SharpnessProcessor:
    def __init__(self, rate: float = 1.5):
        self.rate = rate

    def __call__(self, rendered_frames: List, **kwargs):
        return _enhance("Sharpness", rendered_frames, self.rate)


class SequencialProcessor:
    """Chain processors; each takes and returns a list of frames."""

    PROCESSOR_BUILDERS = {
        "contrast": ContrastProcessor,
        "sharpness": SharpnessProcessor,
    }

    def __init__(self, processors: List):
        self.processors = processors

    @classmethod
    def from_config(cls, configs: List[dict]):
        """[{'processor_type': 'contrast', 'rate': 1.2}, ...]"""
        procs = []
        for cfg in configs:
            cfg = dict(cfg)
            kind = cfg.pop("processor_type")
            if kind == "fastblend":
                from .extensions.fastblend import FastBlendSmoother
                procs.append(FastBlendSmoother(**cfg))
            elif kind in cls.PROCESSOR_BUILDERS:
                procs.append(cls.PROCESSOR_BUILDERS[kind](**cfg))
            else:
                raise ValueError(f"unknown processor {kind}")
        return cls(procs)

    def __call__(self, rendered_frames: List, original_frames: List = None, **kwargs):
        for proc in self.processors:
            rendered_frames = proc(rendered_frames, original_frames=original_frames,
                                   **kwargs)
        return rendered_frames
