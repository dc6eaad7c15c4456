"""The wav2vec2 audio tower and the S2V audio front end against the JAX
package: the tiny tower (the JAX init) through both converters with the
positional conv's weight norm in each storage layout, one full-width
XLSR-53 block behind the full 7-layer conv front end, the host-side
bucketing helpers (bit-equal), `extract_audio_features` and `load_model`
on a synthetic checkpoint written here, and `load_audio` through a stub
decoder (no soundfile or ffmpeg here).

Widths: `WAV2VEC2_TINY` (32 wide, 4 heads, 2 blocks, 2 convs of 8), and
the XLSR-53 widths cut to one block (1024, 16 heads of 64, the 4096 FFN,
7 convs of 512, the 128-tap positional conv in 16 groups). Inputs: numpy
seeds. fp32 within 2e-5 relative (max abs over max abs); the helpers and
the converted weights bit-equal.
"""
import dataclasses
import functools
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.audio_features as JAF
import video_styler_tpu.models.wav2vec as JW
import video_styler_tpu.utils.ckpt as JC

import video_styler_tpu_torch.models.audio_features as TAF
import video_styler_tpu_torch.models.wav2vec as TW
from video_styler_tpu_torch import safetensors_io
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TINY_J, TINY_T = JW.WAV2VEC2_TINY, TW.WAV2VEC2_TINY
_TOWERS = {}


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _wave(seconds, seed=0, rate=16000):
    return np.random.default_rng(seed).standard_normal(int(seconds * rate)).astype(np.float32)


def _tower(cfg_j, cfg_t, seed=0):
    """The JAX init of `cfg_j` (biases and LayerNorms made non-trivial) and
    the port's tower holding it; kept per config."""
    if cfg_t not in _TOWERS:
        init = jax.jit(JW.init_wav2vec, static_argnums=(1,))
        params = _tree(init(jax.random.PRNGKey(seed), cfg_j))
        rng = np.random.default_rng(seed + 1)

        def perturb(path, a):
            name = jax.tree_util.keystr(path)
            if name.endswith("['b']") or name.endswith("['bias']"):
                return (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
            if name.endswith("['scale']"):
                return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a
        params = jax.tree_util.tree_map_with_path(perturb, params)
        _TOWERS[cfg_t] = params, from_jax_params("wav2vec", params, cfg_t, device="cpu")
    return _TOWERS[cfg_t]


def _hf_state_dict(tower, layout):
    """The tower under the HF names (`wav2vec2.` prefix), the positional
    conv stored weight-normed in `layout` (g = 1.3 ||v|| per tap)."""
    sd = TW.export_wav2vec(tower)
    v = sd.pop("encoder.pos_conv_embed.conv.weight")
    g = torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True) * 1.3
    names = {"weight_g": ("weight_g", "weight_v"),
             "parametrizations": ("parametrizations.weight.original0",
                                  "parametrizations.weight.original1")}[layout]
    sd[f"encoder.pos_conv_embed.conv.{names[0]}"] = g
    sd[f"encoder.pos_conv_embed.conv.{names[1]}"] = v
    return {f"wav2vec2.{k}": t.clone() for k, t in sd.items()}


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_tiny_tower_matches_jax(layout):
    """The tiny tower's L + 1 states on 0.25 s of audio, fp32, each package
    converting the same HF state dict (the weight-norm fold in float64)."""
    _, tower = _tower(TINY_J, TINY_T)
    sd = _hf_state_dict(tower, layout)
    jp = JW.convert_wav2vec({k: v.numpy() for k, v in sd.items()}, TINY_J)
    tp = TC.build_module(TW.Wav2Vec2, TINY_T, TW.convert_wav2vec(sd, TINY_T), "cpu",
                         torch.float32)
    np.testing.assert_array_equal(tp.pos_conv.weight.detach().numpy(),
                                  np.asarray(jp["pos_conv"]["w"]))
    wav = _wave(0.25)[None]
    want = np.asarray(JW.wav2vec_forward(jp, TINY_J, jnp.asarray(wav)))
    with torch.no_grad():
        got = TW.wav2vec_forward(tp, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (TINY_T.num_layers + 1, 1, 399, 32)
    assert _rel_max(got, want) < 2e-5


def test_full_width_block_and_front_end_match_jax():
    """The XLSR-53 widths with one block (the full conv front end, the
    128-tap grouped positional conv with its even-kernel trim) on 0.5 s of
    audio, fp32: 24 frames of 1024 after a 320x downsampling."""
    cfg_j = dataclasses.replace(JW.WAV2VEC2_XLSR_53, num_layers=1)
    cfg_t = dataclasses.replace(TW.WAV2VEC2_XLSR_53, num_layers=1)
    params, tower = _tower(cfg_j, cfg_t, seed=3)
    wav = _wave(0.5, seed=4)[None]
    fwd = jax.jit(functools.partial(JW.wav2vec_forward, cfg=cfg_j))
    want = np.asarray(fwd(params, input_values=jnp.asarray(wav)))
    with torch.no_grad():
        got = TW.wav2vec_forward(tower, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 1, 24, 1024)
    assert _rel_max(got, want) < 2e-5


def test_bucketing_helpers_bit_equal():
    rng = np.random.default_rng(5)
    wav = rng.standard_normal(12345).astype(np.float32) * 3 + 1
    np.testing.assert_array_equal(TW.normalize_waveform(wav), JW.normalize_waveform(wav))
    feats = rng.standard_normal((3, 57, 8)).astype(np.float32)
    for out_len in (None, 1, 40):
        np.testing.assert_array_equal(TW.linear_interpolation(feats, 50, 30, out_len),
                                      JW.linear_interpolation(feats, 50, 30, out_len))
    np.testing.assert_array_equal(TW.get_sample_indices(30, 200, 16, 80, 0),
                                  JW.get_sample_indices(30, 200, 16, 80, 0))
    for batch_frames, m in ((12, 0), (80, 0), (20, 1)):
        (bt, nt), (bj, nj) = (mod.get_audio_embed_bucket_fps(feats, 16, batch_frames, m)
                              for mod in (TW, JW))
        assert nt == nj
        np.testing.assert_array_equal(bt, bj)
    with pytest.raises(ValueError, match="less than video length"):
        TW.get_sample_indices(30, 10, 16, 80, 0)


@pytest.fixture
def tiny_file(tmp_path, monkeypatch):
    """The tiny tower as an HF checkpoint directory (`model.safetensors`,
    weight_g/weight_v), with both packages' XLSR-53 config names pointed at
    the tiny config (their loaders build that config whatever the file)."""
    _, tower = _tower(TINY_J, TINY_T)
    folder = tmp_path / "wav2vec2"
    folder.mkdir()
    safetensors_io.save_file(_hf_state_dict(tower, "weight_g"),
                             str(folder / "model.safetensors"))
    monkeypatch.setattr(JW, "WAV2VEC2_XLSR_53", TINY_J)
    convert = JW.convert_wav2vec
    monkeypatch.setattr(JW, "convert_wav2vec",
                        lambda sd, cfg=TINY_J, dtype=jnp.float32: convert(sd, cfg, dtype))
    monkeypatch.setattr(TW, "WAV2VEC2_XLSR_53", TINY_T)
    return folder


def test_extract_audio_features_from_file_matches_jax(tiny_file):
    """1.5 s of 22.05 kHz audio (resampled to 16 kHz) -> the first chunk of
    12 video frames of every state, from the checkpoint directory and from
    its file, against the JAX front door on the same file."""
    wav = _wave(1.5, seed=6, rate=22050)
    want = JAF.extract_audio_features(wav, sample_rate=22050, num_frames=12,
                                      model_path=str(tiny_file))
    for path in (tiny_file, tiny_file / "model.safetensors"):
        got = TAF.extract_audio_features(wav, sample_rate=22050, num_frames=12,
                                         model_path=str(path), device="cpu")
        assert got.shape == want.shape == (1, TINY_T.num_layers + 1, 32, 12)
        assert _rel_max(got, want) < 2e-5
    with pytest.raises(ValueError, match="model_path"):
        TAF.extract_audio_features(wav, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TAF.extract_audio_features(wav, model_path=str(tiny_file))


def test_load_model_wav2vec_matches_jax(tiny_file):
    """`load_model` detects the file as `wav2vec` and builds the tower in
    its dtype (bf16 by default), equal to the JAX loader's params."""
    path = str(tiny_file / "model.safetensors")
    kind_j, params = JC.load_model(path)
    kind_t, tower = TC.load_model(path, device="cpu")
    assert kind_j == kind_t == "wav2vec"
    assert tower.proj.weight.dtype == torch.bfloat16
    want = from_jax_params("wav2vec", _tree(params), TINY_T, device="cpu").state_dict()
    got = tower.state_dict()
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_load_audio_through_a_decoder_stub(monkeypatch):
    """Stereo 8 kHz from the decoder -> mono 16 kHz, as in the JAX package
    (both import soundfile when called)."""
    data = np.random.default_rng(7).standard_normal((4000, 2)).astype(np.float32)
    stub = types.SimpleNamespace(read=lambda path, dtype: (data, 8000))
    monkeypatch.setitem(sys.modules, "soundfile", stub)
    got = TAF.load_audio("speech.wav")
    want = JAF.load_audio("speech.wav")
    assert got.shape == want.shape == (8000,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
