"""Offline latent caching: preprocess once, train from cached tensors.

Counterpart of `video_styler_tpu/trainers/latent_cache.py`, in the same
format, so that a cache written by either package loads in the other: a
pass over the dataset runs the encoders (VAE, umT5) once and writes each
sample's model inputs as `{output_path}/{process_index}/{data_id}.npz`,
floating tensors as fp32 arrays (a bf16 value is exact in fp32) and
strings/numbers as JSON under `__meta__`; training then reads them back
(`CachedLatentDataset`) and runs the DiT step only.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List

import numpy as np
import torch


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def save_cached_sample(folder: str, idx: int, sample: Dict) -> str:
    """Write one preprocessed sample (flat dict of tensors, arrays, scalars
    or strings) as `{folder}/{idx}.npz`. None values are dropped."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{idx}.npz")
    arrays, meta = {}, {}
    for k, v in sample.items():
        if v is None:
            continue
        if isinstance(v, (str, int, float, bool)):
            meta[k] = v
        else:
            arrays[k] = _array(v)
    if meta:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8).copy()
    np.savez(path, **arrays)
    return path


def load_cached_sample(path: str) -> Dict:
    """{name: numpy array}, plus the `__meta__` entries."""
    with np.load(path) as z:
        sample = {k: z[k] for k in z.files if k != "__meta__"}
        if "__meta__" in z.files:
            sample.update(json.loads(z["__meta__"].tobytes().decode()))
    return sample


def launch_data_process_task(dataset, preprocess_fn: Callable[[Dict], Dict],
                             output_path: str, process_index: int = 0,
                             num_processes: int = 1,
                             progress_bar=None) -> List[str]:
    """One preprocessing pass: every `num_processes`-th sample (from
    `process_index`) goes through `preprocess_fn` and is saved under
    `{output_path}/{process_index}/{data_id}.npz`."""
    folder = os.path.join(output_path, str(process_index))
    indices = range(process_index, len(dataset), num_processes)
    if progress_bar is not None:
        indices = progress_bar(indices)
    written = []
    for data_id in indices:
        sample = preprocess_fn(dataset[data_id])
        if sample is None:
            continue
        written.append(save_cached_sample(folder, data_id, sample))
    return written


class CachedLatentDataset:
    """Every {shard}/{id}.npz under the cache root, in sorted path order,
    `repeat` times over; items are dicts of numpy arrays."""

    load_from_cache = True

    def __init__(self, cache_path: str, repeat: int = 1):
        self.paths = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(cache_path)
            for f in files if f.endswith(".npz"))
        if not self.paths:
            raise FileNotFoundError(f"no cached .npz samples under {cache_path}")
        self.repeat = repeat

    def __len__(self):
        return len(self.paths) * self.repeat

    def __getitem__(self, idx) -> Dict:
        return load_cached_sample(self.paths[idx % len(self.paths)])
