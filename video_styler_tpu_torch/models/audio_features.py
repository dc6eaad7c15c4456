"""Audio feature extraction for S2V.

Counterpart of `video_styler_tpu/models/audio_features.py`: a waveform
and a wav2vec2 checkpoint in, the S2V model's `audio_input` out (every
hidden state of the tower stacked per layer, bucketed to one column per
video frame: (1, num_layers, dim, num_frames)). The tower
(`models.wav2vec`) runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import wav2vec as W


def _resample(audio: np.ndarray, sample_rate: int, target: int) -> np.ndarray:
    n_out = int(len(audio) * target / sample_rate)
    return np.interp(np.linspace(0, len(audio) - 1, n_out),
                     np.arange(len(audio)), audio).astype(np.float32)


def load_wav2vec(model_path: str, device=None):
    """A wav2vec2 checkpoint file (safetensors / pt) or an HF-style
    directory holding `model.safetensors` or `pytorch_model.bin` -> a
    `Wav2Vec2` in fp32 on `device` (the card unless "cpu"), built with
    `WAV2VEC2_XLSR_53` (read when called), as the JAX front door builds it."""
    from ..device import resolve_device
    from ..utils import ckpt as C
    if os.path.isdir(model_path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(model_path, name)
            if os.path.exists(cand):
                model_path = cand
                break
    cfg = W.WAV2VEC2_XLSR_53
    sd = W.convert_wav2vec(C.load_state_dict(model_path, lazy=True), cfg)
    return C.build_module(W.Wav2Vec2, cfg, sd, resolve_device(device), torch.float32)


def extract_audio_features(audio: np.ndarray, sample_rate: int = 16000,
                           num_frames: int = 80, fps: float = 16.0,
                           model_path: Optional[str] = None, model=None,
                           device=None) -> np.ndarray:
    """audio (T_samples,) float waveform -> (1, num_layers, dim, num_frames)
    float32, the first chunk of `get_audio_feats_per_inference`.

    The tower: `model` (a built `Wav2Vec2`, run on its own device), else
    the checkpoint at `model_path` loaded on `device` (`load_wav2vec`)."""
    if sample_rate != 16000:
        audio = _resample(audio, sample_rate, 16000)
    if model is None:
        if model_path is None:
            raise ValueError("pass model_path to a local wav2vec2 checkpoint")
        model = load_wav2vec(model_path, device)
    chunks = W.get_audio_feats_per_inference(
        model, np.asarray(audio, np.float32), fps=int(fps), batch_frames=num_frames, m=0)
    return chunks[0]


def load_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Decode an audio file to a mono float32 waveform at `sample_rate`
    (soundfile, else the ffmpeg binary)."""
    try:
        import soundfile as sf
        data, sr = sf.read(path, dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
        if sr != sample_rate:
            data = _resample(data, sr, sample_rate)
        return data
    except ImportError:
        pass
    import subprocess
    proc = subprocess.run(
        ["ffmpeg", "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(sample_rate), "-"],
        capture_output=True, check=True)
    return np.frombuffer(proc.stdout, np.float32)
