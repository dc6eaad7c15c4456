"""RIFE and ESRGAN in the port against the JAX package, on the same weights.

The JAX package has no init for either network: the weights are drawn from
a numpy seed as the checkpoints' torch-layout state dicts (IFNet at its
full width, c=90; RRDBNet at nf 64, gc 32 with 2 blocks) and fed to both
packages' converters. fp32 on both sides; convolutions sum in other
orders (XLA's and oneDNN's), so outputs agree to 1e-4 of their largest
magnitude.
"""
import numpy as np
import pytest
import torch
from PIL import Image

import video_styler_tpu.extensions.esrgan as JE
import video_styler_tpu.extensions.rife as JR

import video_styler_tpu_torch.extensions.esrgan as TE
import video_styler_tpu_torch.extensions.rife as TR

from test_torch_pipeline import cpu_share  # noqa: F401  (autouse)

TOL = 1e-4


def random_state_dict(shapes, seed):
    """Convolution weights N(0, 1/fan_in), biases N(0, 0.1^2), PReLU
    slopes 0.25 + N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) > 1:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(".1.weight"):  # PReLU
            v = 0.25 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def ifnet():
    sd = random_state_dict(TR.ifnet_shapes(), seed=0)
    sd = {f"module.{k}": v for k, v in sd.items()}  # the checkpoint's DataParallel prefix
    return JR.convert_ifnet(sd), TR.convert_ifnet(sd, device="cpu")


@pytest.fixture(scope="module")
def rrdb():
    sd = random_state_dict(TE.rrdbnet_shapes(num_blocks=2), seed=1)
    return JE.convert_rrdbnet(sd), TE.convert_rrdbnet(sd, device="cpu")


def test_warp_and_resize_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 3, 16, 20)).astype(np.float32)
    flow = (rng.standard_normal((2, 2, 16, 20)) * 4).astype(np.float32)
    _close(TR.warp(torch.from_numpy(img), torch.from_numpy(flow)),
           JR.warp(img, flow))
    for hw in ((4, 5), (8, 10), (32, 40), (16, 20)):
        _close(TR.resize_bilinear(torch.from_numpy(img), hw), JR.resize_bilinear(img, hw))


def test_ifnet_forward_full_width(ifnet):
    jp, tp = ifnet
    assert tp["block0"]["convblock0"]["0"]["0"]["weight"].shape == (90, 90, 3, 3)
    x = np.random.default_rng(3).random((1, 6, 64, 64)).astype(np.float32)
    jf, jm, jo = JR.ifnet_forward(jp, x, (4, 2, 1))
    with torch.no_grad():
        tf, tm, to = TR.ifnet_forward(tp, torch.from_numpy(x), (4, 2, 1))
    for i in range(3):
        _close(tf[i], jf[i])
        _close(to[i], jo[i])
    _close(tm, jm)


def _pil_frames(n, size=32, seed=4):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)) for _ in range(n)]


def _within_one_level(got, want):
    """uint8 frames decoded from fp32 results that agree to 1e-4: a value
    on a rounding edge may land one level apart."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g).astype(int), np.asarray(w).astype(int)
        assert g.shape == w.shape and np.abs(g - w).max() <= 1


def test_interpolate_and_smoother(ifnet):
    jp, tp = ifnet
    frames = _pil_frames(3)
    want = JR.RIFEInterpolater(jp).interpolate(frames)
    got = TR.RIFEInterpolater(tp, device="cpu").interpolate(frames)
    assert len(got) == 5 and all(isinstance(g, Image.Image) for g in got)
    _within_one_level(got, want)
    # uint8 arrays in, arrays out, no PIL on the way (32 divides the sides)
    arrays = TR.RIFEInterpolater(tp, device="cpu").interpolate(
        [np.asarray(f) for f in frames])
    _within_one_level(arrays, want)
    assert isinstance(arrays[0], np.ndarray)
    want = JR.RIFESmoother(jp)(frames)
    got = TR.RIFESmoother(tp, device="cpu")(frames)
    _within_one_level(got, want)


def test_rife_pads_sides_to_32(ifnet):
    """A 40x36 frame goes through PIL's resize to 64x64 and back, as in JAX."""
    jp, tp = ifnet
    rng = np.random.default_rng(5)
    frames = [Image.fromarray(rng.integers(0, 255, (36, 40, 3), np.uint8)) for _ in range(2)]
    want = JR.RIFEInterpolater(jp).interpolate(frames)
    got = TR.RIFEInterpolater(tp, device="cpu").interpolate(frames)
    assert got[0].size == (40, 36)
    _within_one_level(got, want)


def test_rrdbnet_forward_full_width(rrdb):
    jp, tp = rrdb
    x = np.random.default_rng(6).random((1, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = TE.rrdbnet_forward(tp, torch.from_numpy(x), num_blocks=2)
    assert got.shape == (1, 3, 64, 64)
    _close(got, JE.rrdbnet_forward(jp, x, num_blocks=2))


def test_esrgan_upscaler(rrdb):
    jp, tp = rrdb
    frames = _pil_frames(2, size=16, seed=7)
    want = JE.ESRGANUpscaler(jp, num_blocks=2).upscale(frames)
    got = TE.ESRGANUpscaler(tp, num_blocks=2, device="cpu")(frames)
    assert got[0].size == (64, 64)
    _within_one_level(got, want)
    arrays = TE.ESRGANUpscaler(tp, num_blocks=2, device="cpu")([np.asarray(f) for f in frames])
    assert arrays[0].dtype == np.uint8 and arrays[0].shape == (64, 64, 3)
    _within_one_level(arrays, want)
