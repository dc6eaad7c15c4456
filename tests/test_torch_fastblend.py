"""FastBlend in the port against the JAX package: the plain versions of the
kernels F1-F3 against `JaxKernels` and the native `CppKernels`, the cv2
resamples that the pyramid needs, `PatchMatcher` and `PyramidPatchMatcher`
NNFs bit for bit, the three runners' uint8 frames and the processor chain.

The JAX matchers run on `backend="jax"` (the XLA form), whose summation
order the plain versions follow: the NNFs then agree bit for bit. The C++
oracle sums a patch in another order (element by element), so it is held
at rtol 1e-5. Sizes: 24x24 (one pyramid level) and 50x70 (three levels:
12x17 is a fractional area resample, 25x35 needs the field resized).
"""
import cv2
import numpy as np
import pytest
import torch

from video_styler_tpu.extensions import fastblend as JF
from video_styler_tpu.extensions.fastblend.kernels import CppKernels, JaxKernels
from video_styler_tpu.extensions.fastblend.patch_match import (
    PatchMatcher as JPatchMatcher, PyramidPatchMatcher as JPyramid)
from video_styler_tpu.processors import SequencialProcessor as JChain

from video_styler_tpu_torch.extensions import fastblend as TF
from video_styler_tpu_torch.extensions.fastblend import kernels as K
from video_styler_tpu_torch.extensions.fastblend import patch_match as TPM
from video_styler_tpu_torch.processors import SequencialProcessor as TChain

from test_torch_pipeline import cpu_share  # noqa: F401  (autouse)


def _pad(x, p):
    return np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kernel_inputs(rng, h, w, pad, nnf_kind, b=2, c=3):
    src = _pad(rng.standard_normal((b, h, w, c)).astype(np.float32) * 40, pad)
    tgt = _pad(rng.standard_normal((b, h, w, c)).astype(np.float32) * 40, pad)
    if nnf_kind == "random":
        nnf = np.stack([rng.integers(0, h, (b, h, w)), rng.integers(0, w, (b, h, w))], 3)
    elif nnf_kind == "borders":  # every entry on an edge row or column
        nnf = np.stack([rng.choice([0, h - 1], (b, h, w)),
                        rng.choice([0, w - 1], (b, h, w))], 3)
    else:  # "outside": shifted identity, so border votes fall outside the image
        ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        nnf = np.stack([np.clip(ii + 3, 0, h - 1), np.clip(jj - 4, 0, w - 1)], 2)
        nnf = np.broadcast_to(nnf, (b, h, w, 2))
    return src, tgt, np.ascontiguousarray(nnf, np.int32)


CASES = [(12, 10, ps, kind) for ps in (3, 5, 13) for kind in ("random", "borders", "outside")]
CASES += [(17, 23, 5, "random"), (17, 23, 13, "outside")]


@pytest.mark.parametrize("h,w,ps,kind", CASES)
def test_kernels_plain_match_jax_and_cpp(h, w, ps, kind):
    rng = np.random.default_rng(h * 100 + ps)
    pad = 6  # the largest patch's radius: patch_size changes, pad stays
    src, tgt, nnf = _kernel_inputs(rng, h, w, pad, kind)
    jx, cpp = JaxKernels(), CppKernels()
    got = K.remap(h, w, 3, ps, pad, _t(src), _t(nnf)).numpy()
    np.testing.assert_array_equal(got, jx.remap(h, w, 3, ps, pad, src, nnf))
    np.testing.assert_allclose(got, cpp.remap(h, w, 3, ps, pad, src, nnf), rtol=1e-5,
                               atol=1e-5)
    got = K.patch_error(h, w, 3, ps, pad, _t(src), _t(nnf), _t(tgt)).numpy()
    np.testing.assert_array_equal(got, jx.patch_error(h, w, 3, ps, pad, src, nnf, tgt))
    np.testing.assert_allclose(got, cpp.patch_error(h, w, 3, ps, pad, src, nnf, tgt),
                               rtol=1e-5)
    a, b = (src[0::2], nnf[0::2]), (tgt[1::2], nnf[1::2])
    got = K.pairwise_patch_error(h, w, 3, ps, pad, *map(_t, a + b)).numpy()
    np.testing.assert_array_equal(got, jx.pairwise_patch_error(h, w, 3, ps, pad, *a, *b))
    np.testing.assert_allclose(got, cpp.pairwise_patch_error(h, w, 3, ps, pad, *a, *b),
                               rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take():
    src = torch.zeros(1, 8, 8, 3)
    nnf = torch.zeros(1, 4, 4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="odd"):
        K._check(4, 4, 3, 7, 2, [src], [nnf])
    with pytest.raises(ValueError, match="channels"):
        K._check(4, 4, 5, 3, 2, [src], [nnf])
    with pytest.raises(ValueError, match="need"):
        K._check(4, 4, 3, 3, 2, [src], [nnf.long()])
    with pytest.raises(ValueError, match="contiguous"):
        K._check(4, 4, 3, 3, 2, [src], [nnf.transpose(1, 2)])
    with pytest.raises(RuntimeError, match="CUDA or"):
        K.remap(4, 4, 3, 3, 2, src.to("meta"), nnf.to("meta"))


@pytest.mark.parametrize("hw,out", [((50, 70), (25, 35)), ((50, 70), (12, 17)),
                                    ((480, 832), (30, 52)), ((480, 832), (240, 416)),
                                    ((37, 53), (11, 13)), ((50, 70), (50, 70))])
def test_resize_area_matches_cv2(hw, out):
    img = (np.random.default_rng(0).random((2,) + hw + (3,)) * 255).astype(np.float32)
    want = np.stack([cv2.resize(i, out[::-1], interpolation=cv2.INTER_AREA) for i in img])
    np.testing.assert_array_equal(TPM.resize_area(_t(img), *out).numpy(), want)


@pytest.mark.parametrize("hw,out", [((24, 34), (25, 35)), ((12, 17), (25, 35)),
                                    ((50, 70), (12, 17)), ((60, 104), (61, 105)),
                                    ((7, 9), (20, 30))])
def test_resize_linear_matches_cv2(hw, out):
    rng = np.random.default_rng(1)
    for field in (rng.random((2,) + hw + (2,)) * 255,
                  rng.integers(0, 60, (2,) + hw + (2,))):
        field = field.astype(np.float32)
        want = np.stack([cv2.resize(f, out[::-1], interpolation=cv2.INTER_LINEAR)
                         for f in field])
        np.testing.assert_array_equal(TPM.resize_linear(_t(field), *out).numpy(), want)


def _frames(n, h, w, seed=0):
    """A moving smooth pattern with noise: real correspondences."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    out = []
    for t in range(n):
        base = 127 + 100 * np.sin(7 * xx + 4 * yy + 0.5 * t)[..., None] * \
            np.array([1.0, 0.7, 0.4])
        out.append((base + rng.integers(-12, 12, (h, w, 3))).clip(0, 255).astype(np.uint8))
    return out


MATCHER_FLAGS = [dict(), dict(use_mean_target_style=True),
                 dict(use_pairwise_patch_error=True), dict(tracking_window_size=1)]


@pytest.mark.parametrize("flags", MATCHER_FLAGS, ids=lambda f: ",".join(f) or "plain")
def test_patch_matcher_nnf_bit_equal(flags):
    fr = np.stack(_frames(2, 24, 24)).astype(np.float32)
    sg, tg, ss = fr, fr[::-1].copy(), 255 - fr
    ident = np.stack(np.meshgrid(np.arange(24), np.arange(24), indexing="ij"), 2)
    nnf0 = np.stack([ident] * 2).astype(np.int32)
    kw = dict(minimum_patch_size=3, num_iter=2, random_search_steps=2, **flags)
    jm = JPatchMatcher(24, 24, 3, backend="jax", **kw)
    tm = TPM.PatchMatcher(24, 24, 3, device="cpu", **kw)
    for _ in range(2):  # the generator's state carries across batches
        jn, js = jm.estimate_nnf(sg, tg, ss, nnf0.copy())
        tn, ts = tm.estimate_nnf(sg, tg, ss, nnf0.copy())
        np.testing.assert_array_equal(tn.numpy(), jn)
        np.testing.assert_array_equal(ts.numpy(), js)
    assert (jn != nnf0).any()


@pytest.mark.parametrize("hw,flags", [((24, 24), dict()), ((50, 70), dict()),
                                      ((50, 70), dict(use_mean_target_style=True)),
                                      ((50, 70), dict(use_pairwise_patch_error=True,
                                                      tracking_window_size=1)),
                                      ((24, 24), dict(initialize="random"))])
def test_pyramid_nnf_bit_equal(hw, flags):
    fr = np.stack(_frames(2, *hw, seed=3)).astype(np.float32)
    sg, tg, ss = fr, np.roll(fr, 1, axis=0), fr[:, :, ::-1].copy()
    kw = dict(minimum_patch_size=3, num_iter=2, **flags)
    jp = JPyramid(hw[0], hw[1], 3, backend="jax", **kw)
    tp = TPM.PyramidPatchMatcher(hw[0], hw[1], 3, device="cpu", **kw)
    assert tp.pyramid_heights == jp.pyramid_heights
    assert tp.pyramid_widths == jp.pyramid_widths
    jn, js = jp.estimate_nnf(sg, tg, ss)
    tn, ts = tp.estimate_nnf(sg, tg, ss)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.fixture
def jax_xla_kernels(monkeypatch):
    """The JAX runners build their matchers with backend "auto" (the C++
    oracle): hold them on the XLA form, whose order the port follows."""
    import video_styler_tpu.extensions.fastblend.patch_match as jpm
    monkeypatch.setattr(jpm, "get_kernels", lambda backend="auto": JaxKernels())


EBSYNTH = dict(minimum_patch_size=3, num_iter=2, guide_weight=10.0)


@pytest.mark.parametrize("mode", ["balanced", "accurate"])
def test_runners_uint8_equal(jax_xla_kernels, mode):
    n = 3 if mode == "balanced" else 2  # every batch holds 2 pairs
    guide, style = _frames(n, 24, 24, seed=1), _frames(n, 24, 24, seed=2)
    runner = {"balanced": (JF.BalancedModeRunner, TF.BalancedModeRunner),
              "accurate": (JF.AccurateModeRunner, TF.AccurateModeRunner)}[mode]
    kw = dict(batch_size=2, window_size=1, ebsynth_config=EBSYNTH)
    want = runner[0]().run(guide, style, **kw)
    got = runner[1]().run(guide, style, device="cpu", **kw)
    for g, w_ in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w_)


def test_interpolation_runner_uint8_equal(jax_xla_kernels):
    guide = _frames(3, 24, 24, seed=4)
    keys = [0, 2]
    style = [255 - guide[i] for i in keys]
    want = JF.InterpolationModeRunner().run(guide, style, keys, 1, EBSYNTH)
    got = TF.InterpolationModeRunner().run(guide, style, keys, 1, EBSYNTH, device="cpu")
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


def test_chain_from_config_equal(jax_xla_kernels):
    from PIL import Image
    frames = [Image.fromarray(f) for f in _frames(3, 24, 24, seed=5)]
    cfg = [dict(processor_type="fastblend", batch_size=2, window_size=1,
                ebsynth_config=EBSYNTH),
           dict(processor_type="contrast", rate=1.3),
           dict(processor_type="sharpness", rate=1.2)]
    want = JChain.from_config(cfg)(frames)
    got = TChain.from_config([dict(c, device="cpu") if c["processor_type"] == "fastblend"
                              else c for c in cfg])(frames)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))
    with pytest.raises(ValueError, match="unknown processor"):
        TChain.from_config([dict(processor_type="rife")])


def test_smoother_on_uint8_arrays_needs_no_pil():
    frames = _frames(3, 24, 24, seed=6)
    out = TF.FastBlendSmoother(batch_size=2, window_size=1, ebsynth_config=EBSYNTH,
                               device="cpu")(frames)
    assert all(isinstance(f, np.ndarray) and f.dtype == np.uint8 and f.shape == (24, 24, 3)
               for f in out)


def test_fastblend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.FastBlendSmoother()
