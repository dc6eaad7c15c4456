"""Tracing and per-step timing.

Counterpart of `video_styler_tpu/utils/profiling.py`:

- `trace(dir)` runs `torch.profiler` over the enclosed block (the CPU, and
  the card when there is one) and writes a Chrome trace into `dir`;
- `annotate(name)` names a range on the profiler's timeline
  (`torch.profiler.record_function`), and on the card an NVTX range too;
- `StepTimer` records per-step wall times and prints a JSON summary with
  the JAX package's keys; `sync` (`torch.cuda.synchronize` on the card)
  runs before each step's clock stops, so that queued kernels count;
- `make_step_timer` returns a timer only when VIDEO_STYLER_STEP_TIMING is
  set (and not "0"): the pipelines' always-available, off-by-default path.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the enclosed block; a Chrome trace
    (`trace.json`) is written into `log_dir` when it ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline (and NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Per-step wall times.

    >>> timer = StepTimer("denoise", sync=torch.cuda.synchronize)
    >>> with timer.step():
    ...     run_one_step()
    >>> timer.summary()   # {'name': 'denoise', 'steps': N, 'mean_ms': ...}
    """

    def __init__(self, name: str, sync: Optional[Callable[[], None]] = None):
        self.name = name
        self.times: List[float] = []
        self._sync = sync

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if self._sync is not None:
            self._sync()
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict:
        if not self.times:
            return {"name": self.name, "steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "name": self.name,
            "steps": n,
            "mean_ms": round(sum(ts) / n * 1e3, 2),
            "p50_ms": round(ts[n // 2] * 1e3, 2),
            "min_ms": round(ts[0] * 1e3, 2),
            "max_ms": round(ts[-1] * 1e3, 2),
            "total_s": round(sum(ts), 3),
        }

    def report(self, file=None):
        print(json.dumps(self.summary()), file=file, flush=True)


def step_timing_enabled() -> bool:
    return os.environ.get("VIDEO_STYLER_STEP_TIMING", "") not in ("", "0")


def make_step_timer(name: str, sync: Optional[Callable[[], None]] = None
                    ) -> Optional[StepTimer]:
    """A `StepTimer` when VIDEO_STYLER_STEP_TIMING is set, else None."""
    if not step_timing_enabled():
        return None
    return StepTimer(name, sync=sync)
