"""The Wan2.2 dual-expert enhancer and the multistep schedulers against
the JAX package: `enhance` with two distinct experts on a window that
crosses the expert boundary (fp32 and bf16), which expert runs each step,
two calls in a row, the UniPC and DPM++ trajectories and `add_noise`, the
enhance CLI, and `from_pretrained` with a `dit2` file.

The pipelines are those of `test_torch_pipeline.py` (smoke widths, the same
weights through `from_jax_params`, the same CPU noise) as enhancers, with a
second DiT of the same shape from another seed as the high-noise expert.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
from video_styler_tpu.pipelines.wan_enhancer import WanEnhancerPipeline as JEnhancer
from video_styler_tpu.schedulers.flow_dpm import FlowDPMSolverMultistepScheduler as JDPM
from video_styler_tpu.schedulers.flow_unipc import FlowUniPCMultistepScheduler as JUniPC
from video_styler_tpu.utils.model_config import ModelConfig as JModelConfig

import video_styler_tpu_torch.models.wan_dit as TD
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.pipelines.wan_enhancer import WanEnhancerPipeline as TEnhancer
from video_styler_tpu_torch.schedulers.flow_dpm import FlowDPMSolverMultistepScheduler as TDPM
from video_styler_tpu_torch.schedulers.flow_unipc import FlowUniPCMultistepScheduler as TUniPC
from video_styler_tpu_torch.utils.model_config import ModelConfig

from test_torch_ckpt import DIT as FILE_DIT
from test_torch_ckpt import _assert_bit_equal, _np, _reference_files, small_t5_vae  # noqa: F401
from test_torch_pipeline import DIT, _frames, _pipelines, _tree, cpu_share  # noqa: F401

# 8 steps of shift 5, the last 6: timesteps 937, 892, 833, 749, 624, 416;
# the boundary 875 puts the first two on the high-noise expert
CROSSING = dict(prompt="sharp and clean", negative_prompt="blurry", sampling_steps=8,
                forward_step=6, skip_backward_step=6, shift=5.0,
                guide_scale=(3.0, 4.0), boundary=0.875, seed=42)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _enhancers(jd, td):
    jp, tp = _pipelines(jd, td)
    je = JEnhancer(dtype=jd)
    je.__dict__.update(jp.__dict__)
    je.dit2_cfg = JD.WanDiTConfig(**DIT)
    je.dit2_params = JD.init_wan_dit(jax.random.PRNGKey(5), je.dit2_cfg, jd)
    te = TEnhancer(device="cpu", dtype=td)
    te.__dict__.update(tp.__dict__)
    te.dit2 = from_jax_params("dit", _tree(je.dit2_params), TD.WanDiTConfig(**DIT),
                              device="cpu")
    return je, te


@pytest.fixture(scope="module")
def fp32_enhancers():
    return _enhancers(jnp.float32, torch.float32)


def _enhance(je, te, **kw):
    kw = dict(CROSSING, **kw)
    video = _frames()
    want = np.asarray(jnp.asarray(je.enhance(video, return_latents=True, **kw),
                                  jnp.float32))
    got = te.enhance(video, return_latents=True, **kw).float().numpy()
    assert got.shape == want.shape == (1, 4, 3, 4, 4)
    return got, want


def test_crossing_window_timesteps():
    s = JUniPC(num_train_timesteps=1000, shift=1)
    s.set_timesteps(8, shift=5.0)
    assert s.timesteps[-6:].tolist() == [937, 892, 833, 749, 624, 416]
    s.set_timesteps(50, shift=5.0)
    # the default window never reaches the high-noise expert
    assert s.timesteps[-4:].tolist() == [302, 241, 172, 92]
    t = TUniPC(num_train_timesteps=1000, shift=1)
    t.set_timesteps(8, shift=5.0)
    assert t.timesteps[-6:].tolist() == [937, 892, 833, 749, 624, 416]


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_enhance_matches_jax(which):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[which]
    je, te = _enhancers(jd, td)
    got, want = _enhance(je, te)
    # fp32: measured 6.8e-7 over 6 UniPC steps x 2 CFG passes; bf16: each
    # side rounds at its own points, measured 1.1%
    assert _rel(got, want) < (2e-5 if which == "fp32" else 5e-2)
    assert te.experts == [(937, "dit2"), (892, "dit2"), (833, "dit"), (749, "dit"),
                          (624, "dit"), (416, "dit")]


def test_enhance_uses_both_experts(fp32_enhancers):
    """Without the high-noise expert (or with the boundary above every
    timestep) every step runs `dit`, and the latents differ."""
    je, te = fp32_enhancers
    got, _ = _enhance(je, te)
    dit2 = te.dit2
    te.dit2 = None
    try:
        low_only = te.enhance(_frames(), return_latents=True, **CROSSING).numpy()
    finally:
        te.dit2 = dit2
    assert [w for _, w in te.experts] == ["dit"] * 6
    assert _rel(got, low_only) > 1e-3
    above = te.enhance(_frames(), return_latents=True,
                       **dict(CROSSING, boundary=0.99)).numpy()
    np.testing.assert_array_equal(above, low_only)


def test_enhance_twice_in_a_row(fp32_enhancers):
    _, te = fp32_enhancers
    a = te.enhance(_frames(), return_latents=True, **CROSSING)
    b = te.enhance(_frames(), return_latents=True, **CROSSING)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_enhance_default_window_and_frames_match_jax(fp32_enhancers):
    """The CLI's default window (50 steps, forward and backward 4) and the
    decoded frames."""
    je, te = fp32_enhancers
    kw = dict(CROSSING, sampling_steps=50, forward_step=4, skip_backward_step=4)
    video = _frames()
    frames_j = np.stack([np.asarray(im) for im in je.enhance(video, **kw)])
    frames_t = te.enhance(video, **kw)
    assert [w for _, w in te.experts] == ["dit"] * 4
    assert frames_t.shape == (9, 32, 32, 3) and frames_t.dtype == np.uint8
    assert np.abs(frames_t.astype(np.int16) - frames_j.astype(np.int16)).max() <= 2


def test_quantize_reaches_both_experts():
    """`quantize` turns the linears of both experts into int8 layers (the
    head, modulation and time embedding stay); the enhancer still runs."""
    from video_styler_tpu_torch.ops.quant import QuantLinear, quantized_fraction
    _, te = _enhancers(jnp.float32, torch.float32)
    base = te.enhance(_frames(), return_latents=True, **CROSSING).numpy()
    te.quantize("int8")
    for dit in (te.dit, te.dit2):
        assert isinstance(dit.blocks[1].ffn.fc2, QuantLinear)
        assert not isinstance(dit.head.head, QuantLinear)
        assert quantized_fraction(dit) > 0.9
    got = te.enhance(_frames(), return_latents=True, **CROSSING).numpy()
    assert [w for _, w in te.experts].count("dit2") == 2
    # int8 weights and activations move the latents a little: measured 1.1%
    assert 0 < _rel(got, base) < 5e-2


# ------------------------------------------------------------ schedulers

def _trajectory(steps):
    """A sample, `steps` pseudo-model outputs and `steps` noises."""
    rng = np.random.default_rng(1)
    sample = rng.standard_normal((1, 4, 2, 4, 4), dtype=np.float32)
    outs = [rng.standard_normal(sample.shape, dtype=np.float32) for _ in range(steps)]
    noises = [rng.standard_normal(sample.shape, dtype=np.float32) for _ in range(steps)]
    return sample, outs, noises


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("shift", [1.0, 5.0])
@pytest.mark.parametrize("kind", ["unipc_bh2", "unipc_bh1", "dpm_midpoint",
                                  "dpm_heun", "sde_dpm_midpoint"])
def test_scheduler_trajectories_match_jax(kind, order, shift):
    steps = 10
    if kind.startswith("unipc"):
        kw = dict(solver_order=order, solver_type=kind.split("_")[1])
        jcls, tcls = JUniPC, TUniPC
    else:
        kw = dict(solver_order=order, solver_type=kind.split("_")[-1],
                  algorithm_type="sde-dpmsolver++" if kind.startswith("sde")
                  else "dpmsolver++")
        if kind.startswith("sde") and order == 3:
            kw["solver_order"] = 2   # no SDE third order in either package
        jcls, tcls = JDPM, TDPM
    js, ts = jcls(shift=1.0, **kw), tcls(shift=1.0, **kw)
    js.set_timesteps(steps, shift=shift)
    ts.set_timesteps(steps, shift=shift)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    sample, outs, noises = _trajectory(steps)
    xj, xt = jnp.asarray(sample), torch.from_numpy(sample)
    for i, t in enumerate(ts.timesteps):
        extra_j, extra_t = {}, {}
        if kind.startswith("sde"):
            extra_j["noise"] = jnp.asarray(noises[i])
            extra_t["noise"] = torch.from_numpy(noises[i])
        xj = js.step(jnp.asarray(outs[i]), t, xj, **extra_j)
        xt = ts.step(torch.from_numpy(outs[i]), t, xt, **extra_t)
        # fp32, the same coefficients and operations: measured 0 (bit-equal)
        assert _rel(xt.numpy(), np.asarray(xj)) < 2e-5, (i, t)
    t_mid = int(ts.timesteps[3])
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(sample), torch.from_numpy(noises[0]), t_mid).numpy(),
        np.asarray(js.add_noise(jnp.asarray(sample), jnp.asarray(noises[0]), t_mid)),
        rtol=1e-6, atol=1e-6)


def test_set_timesteps_resets_history():
    s = TUniPC(shift=1.0, solver_order=3)
    sample, outs, _ = _trajectory(6)
    runs = []
    for _ in range(2):
        s.set_timesteps(6, shift=5.0)
        assert s.model_outputs == [None] * 3 and s.last_sample is None
        x = torch.from_numpy(sample)
        for i, t in enumerate(s.timesteps):
            x = s.step(torch.from_numpy(outs[i]), t, x)
        runs.append(x)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_sde_dpm_draws_from_the_generator():
    """sde-dpmsolver++ without `noise` draws it from the caller's generator:
    the same generator state gives the step of that noise passed in."""
    sample, outs, _ = _trajectory(4)
    a, b = (TDPM(algorithm_type="sde-dpmsolver++") for _ in range(2))
    a.set_timesteps(4, shift=5.0)
    b.set_timesteps(4, shift=5.0)
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(sample.shape, generator=torch.Generator().manual_seed(3))
    got = a.step(torch.from_numpy(outs[0]), a.timesteps[0], torch.from_numpy(sample),
                 generator=gen)
    want = b.step(torch.from_numpy(outs[0]), b.timesteps[0], torch.from_numpy(sample),
                  noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        a.step(torch.from_numpy(outs[1]), a.timesteps[1], torch.from_numpy(sample))


# ------------------------------------------------------------ CLI and files

def test_enhance_cli_smoke_on_cpu(tmp_path):
    from video_styler_tpu_torch.enhance_video import main
    args = ["--smoke", "--output_dir", str(tmp_path), "--sampling_steps", "8",
            "--forward_step", "6", "--skip_backward_step", "6"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
    (frames,) = main(args + ["--device", "cpu"])
    assert frames.shape == (5, 32, 32, 3) and frames.dtype == np.uint8
    out = tmp_path / "synthetic.mp4"
    assert out.exists() and out.stat().st_size > 0
    assert "synthetic.mp4" in (tmp_path / "enhancing_time.txt").read_text()


def test_from_pretrained_with_dit2_matches_jax(tmp_path, small_t5_vae):
    """A low-noise and a high-noise DiT file (model kinds `dit` and `dit2`),
    the VAE and umT5 through both packages' `from_pretrained`: each expert
    bit-equal to `from_jax_params` of the JAX converter's output."""
    (tmp_path / "low").mkdir()
    (tmp_path / "high").mkdir()
    low, vae_path, t5_path = _reference_files(str(tmp_path / "low"), seed=0)
    high, _, _ = _reference_files(str(tmp_path / "high"), seed=9)
    mcs = [(low, "dit"), (high, "dit2"), (vae_path, None), (t5_path, None)]
    jp = JEnhancer.from_pretrained([JModelConfig(path=p, model_kind=k) for p, k in mcs],
                                   dtype=jnp.float32)
    tp = TEnhancer.from_pretrained([ModelConfig(path=p, model_kind=k) for p, k in mcs],
                                   device="cpu", dtype=torch.float32)
    assert tp.vace is None and jp.vace_params is None
    assert tp.dit2.cfg == tp.dit.cfg == TD.WanDiTConfig(**FILE_DIT)
    _assert_bit_equal(tp.dit, from_jax_params("dit", _np(jp.dit_params), tp.dit.cfg,
                                              device="cpu"))
    _assert_bit_equal(tp.dit2, from_jax_params("dit", _np(jp.dit2_params), tp.dit2.cfg,
                                               device="cpu"))
    assert not torch.equal(tp.dit.blocks[0].ffn.fc1.weight, tp.dit2.blocks[0].ffn.fc1.weight)
