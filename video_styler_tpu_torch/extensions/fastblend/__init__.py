"""FastBlend: PatchMatch video deflickering and style blending on the device.

Counterpart of `video_styler_tpu/extensions/fastblend/__init__.py`: the
balanced and accurate sliding-window blenders, keyframe interpolation and
the processor-chain entry `FastBlendSmoother`, over `PyramidPatchMatcher`
(F1/F2 on the card, their plain versions on the CPU).

Frames are (H, W, 3) uint8 arrays or tensors (or PIL images for
`FastBlendSmoother`, which then returns PIL images: PIL is imported only
then). A runner moves the frames to its device once, blends there in
float32 as the JAX runners do in numpy, and returns uint8 numpy frames.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...device import resolve_device
from .patch_match import PatchMatcher, PyramidPatchMatcher, host_to  # noqa: F401

DEFAULT_EBSYNTH_CONFIG = dict(minimum_patch_size=5, num_iter=5, guide_weight=10.0)


def _stack(frames, device) -> torch.Tensor:
    """A list of (H, W, C) frames -> float32 (N, H, W, C) on `device`."""
    return torch.stack([f if torch.is_tensor(f) else torch.from_numpy(np.array(f))
                        for f in frames]).to(device=device, dtype=torch.float32)


def _to_uint8(frame) -> torch.Tensor:
    return frame.clamp(0, 255).to(torch.uint8)


def _to_host(frames) -> List[np.ndarray]:
    """uint8 frames on the device -> numpy, in one copy at the end of a run
    (a copy per frame would wait for the card each time)."""
    return list(torch.stack(frames).cpu().numpy())


class BalancedModeRunner:
    """Average NNF-remapped neighbours in a +-window (runners/balanced.py)."""

    def run(self, frames_guide, frames_style, batch_size, window_size, ebsynth_config,
            desc="Balanced Mode", device=None):
        device = resolve_device(device)
        guide, style = _stack(frames_guide, device), _stack(frames_style, device)
        engine = PyramidPatchMatcher(image_height=style.shape[1], image_width=style.shape[2],
                                     channel=3, device=device, **ebsynth_config)
        n = len(style)
        tasks = [(s, t) for t in range(n) for s in range(t - window_size, t + window_size + 1)
                 if 0 <= s < n and s != t]
        frames = [(None, 1) for _ in range(n)]
        outputs = [None] * n
        for batch_id in range(0, len(tasks), batch_size):
            batch = tasks[batch_id:batch_id + batch_size]
            src = host_to(np.array([s for s, _ in batch]), device)
            tgt = host_to(np.array([t for _, t in batch]), device)
            _, target_style = engine.estimate_nnf(guide[src], guide[tgt], style[src])
            for (s, t), result in zip(batch, target_style):
                frame, weight = frames[t]
                if frame is None:
                    frame = style[t]
                frames[t] = (frame * (weight / (weight + 1)) + result / (weight + 1),
                             weight + 1)
                full = min(n, t + window_size + 1) - max(0, t - window_size)
                if weight + 1 == full:
                    outputs[t] = _to_uint8(frames[t][0])
        for t in range(n):
            if outputs[t] is None:
                f = frames[t][0]
                outputs[t] = _to_uint8(style[t] if f is None else f)
        return _to_host(outputs)


class AccurateModeRunner:
    """use_mean_target_style blending over the window (runners/accurate.py)."""

    def run(self, frames_guide, frames_style, batch_size, window_size, ebsynth_config,
            desc="Accurate Mode", device=None):
        device = resolve_device(device)
        guide, style = _stack(frames_guide, device), _stack(frames_style, device)
        engine = PyramidPatchMatcher(image_height=style.shape[1], image_width=style.shape[2],
                                     channel=3, use_mean_target_style=True, device=device,
                                     **ebsynth_config)
        n = len(style)
        outputs = []
        for target in range(n):
            sources = list(range(max(target - window_size, 0), min(target + window_size + 1, n)))
            remapped = []
            for batch_id in range(0, len(sources), batch_size):
                batch = host_to(np.array(sources[batch_id:batch_id + batch_size]), device)
                tg = guide[target][None].repeat(len(batch), 1, 1, 1)
                _, ts = engine.estimate_nnf(guide[batch], tg, style[batch])
                remapped.append(ts)
            remapped = torch.cat(remapped)
            acc = remapped[0]
            for r in remapped[1:]:  # numpy's mean over axis 0: in order, then / n
                acc = acc + r
            outputs.append(_to_uint8(acc / len(remapped)))
        return _to_host(outputs)


class InterpolationModeRunner:
    """Propagate styled keyframes to the frames between them
    (runners/interpolation.py): each frame blends the left and right
    keyframes remapped through NNFs, weighted by distance (in float64, as
    numpy promotes there)."""

    def run(self, frames_guide, frames_style, index_style, batch_size, ebsynth_config,
            device=None):
        device = resolve_device(device)
        guide, style = _stack(frames_guide, device), _stack(frames_style, device)
        engine = PyramidPatchMatcher(image_height=style.shape[1], image_width=style.shape[2],
                                     channel=3, device=device, **ebsynth_config)
        n = len(guide)
        outputs = [None] * n
        for i, idx in enumerate(index_style):
            outputs[idx] = np.asarray(frames_style[i].cpu() if torch.is_tensor(frames_style[i])
                                      else frames_style[i], np.uint8)
        for t in range(n):
            if outputs[t] is not None:
                continue
            left = max([i for i in index_style if i <= t], default=None)
            right = min([i for i in index_style if i >= t], default=None)
            parts, weights = [], []
            for kf in (left, right):
                if kf is None:
                    continue
                _, ts = engine.estimate_nnf(guide[kf][None], guide[t][None],
                                            style[index_style.index(kf)][None])
                parts.append(ts[0])
                weights.append(1.0 / (abs(t - kf) + 1e-3))
            w = np.asarray(weights) / sum(weights)
            frame = 0
            for p, wi in zip(parts, w):
                frame = frame + p.double() * float(wi)
            outputs[t] = _to_uint8(frame)
        blended = [t for t in range(n) if torch.is_tensor(outputs[t])]
        if blended:
            for t, frame in zip(blended, _to_host([outputs[t] for t in blended])):
                outputs[t] = frame
        return outputs


class FastBlendSmoother:
    """Processor-chain entry (api.py usage): smooth rendered frames."""

    def __init__(self, batch_size: int = 8, window_size: int = 15, mode: str = "balanced",
                 ebsynth_config: Optional[dict] = None, device=None):
        self.batch_size = batch_size
        self.window_size = window_size
        self.mode = mode
        self.ebsynth_config = ebsynth_config or dict(DEFAULT_EBSYNTH_CONFIG)
        self.device = resolve_device(device)

    def __call__(self, rendered_frames: List, original_frames: List = None, **kwargs):
        guide = original_frames if original_frames is not None and len(original_frames) \
            else rendered_frames
        as_pil = not isinstance(rendered_frames[0], np.ndarray) and \
            not torch.is_tensor(rendered_frames[0])
        runner = {"balanced": BalancedModeRunner,
                  "accurate": AccurateModeRunner}[self.mode]()
        out = runner.run([np.asarray(f) if as_pil else f for f in guide],
                         [np.asarray(f) if as_pil else f for f in rendered_frames],
                         batch_size=self.batch_size, window_size=self.window_size,
                         ebsynth_config=self.ebsynth_config, device=self.device)
        if as_pil:
            from PIL import Image
            return [Image.fromarray(f) for f in out]
        return out
