"""The port's tracing and step timing (`video_styler_tpu_torch/utils/
profiling.py`) against the JAX package's (`tests/test_profiling.py`): the
step timer's summary keys, the VIDEO_STYLER_STEP_TIMING gate, a trace
written to a directory, and the pipeline's denoise loop reporting its
steps."""
import json
import os

import numpy as np
import pytest
import torch

from video_styler_tpu.utils import profiling as JP
from video_styler_tpu_torch.utils.profiling import (StepTimer, annotate, make_step_timer,
                                                    step_timing_enabled, trace)

from test_torch_pipeline import cpu_share  # noqa: F401


def test_step_timer_summary_keys_match_jax():
    t, j = StepTimer("unit", sync=lambda: None), JP.StepTimer("unit")
    for timer in (t, j):
        for _ in range(5):
            with timer.step():
                pass
    assert t.summary()["steps"] == 5
    assert set(t.summary()) == set(j.summary())
    assert set(StepTimer("empty").summary()) == set(JP.StepTimer("empty").summary())


def test_step_timer_runs_its_sync_before_the_clock_stops():
    calls = []
    t = StepTimer("sync", sync=lambda: calls.append(len(t.times)))
    with t.step():
        pass
    assert calls == [0] and len(t.times) == 1


@pytest.mark.parametrize("value,enabled", [("1", True), ("0", False), ("", False)])
def test_make_step_timer_env_gate_matches_jax(monkeypatch, value, enabled):
    monkeypatch.setenv("VIDEO_STYLER_STEP_TIMING", value)
    assert step_timing_enabled() is JP.step_timing_enabled() is enabled
    assert (make_step_timer("x") is not None) is enabled
    assert (JP.make_step_timer("x") is not None) is enabled


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("unit-matmul"):
            x = torch.ones((128, 128))
            (x @ x).sum().item()
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "unit-matmul" in names


def test_pipeline_reports_its_denoise_steps(monkeypatch, capsys):
    """With the gate set the port's denoise loop prints one summary line of
    its steps, as the JAX pipeline does (`wan_denoise_step`)."""
    from video_styler_tpu_torch import infer_ditto
    monkeypatch.setenv("VIDEO_STYLER_STEP_TIMING", "1")
    pipe = infer_ditto.build_smoke_pipeline(device="cpu")
    pipe(prompt="x", vace_video=infer_ditto.smoke_frames(5, 32, 32), num_frames=5,
         height=32, width=32, cfg_scale=1.0, num_inference_steps=2, tiled=False,
         return_latents=True)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [(r["name"], r["steps"]) for r in lines] == [("wan_denoise_step", 2)]
    assert np.isfinite(lines[0]["mean_ms"])
