"""Measure the checkpoint reader's design choices on one card.

    python -m video_styler_tpu_torch.probe_loader [--dir DIR]

Writes a safetensors file (36 bf16 tensors of the 14B DiT's ffn shape,
5.10 GB) and a .pth (umT5-XXL's token embedding and 20 of those tensors,
4.93 GB), drops each from the page cache before each read, and reads it
onto the card:

  write     the write rate of `safetensors_io.save_file` and `torch.save`
  mapped    through a memory mapping of the file, tensor by tensor: the
            safetensors bytes from `torch.from_file`, the .pth tensors of
            `torch.load(mmap=True)` (the design `utils.ckpt` replaced)
  staging   `utils.ckpt.read_tensors` with 16, 64 and 256 MiB staging
            buffers, 4 reads in flight
  workers   the same with 1, 2, 4 and 8 reads in flight, 64 MiB buffers

Each line is one JSON object: GB, seconds, GB/s, the host's resident set
before the read and its peak over that level (VmRSS every 5 ms), then the
card's name and power limit. The files are removed at the end.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from .safetensors_io import save_file
from .utils import ckpt
from .utils.host_memory import RssPeak, drop_from_page_cache


def _emit(**row):
    print(json.dumps(row), flush=True)


def _read(tag: str, path: str, read):
    """Time `read()` (which returns the card's tensors) from a cold page
    cache, with the resident set's peak over its level before."""
    drop_from_page_cache([path])
    gc.collect()
    torch.cuda.synchronize()
    with RssPeak() as rss:
        before = rss.peak
        t0 = time.perf_counter()
        out = read()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size() for t in out.values()) / 1e9
    _emit(read=tag, file=os.path.basename(path), gb=gb, s=seconds, gb_per_s=gb / seconds,
          rss_before_gb=before / 1e9, rss_peak_over_before_gb=(rss.peak - before) / 1e9)
    del out
    torch.cuda.empty_cache()


def _mapped(path: str):
    """Every tensor copied to the card from a memory mapping of the file."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        return {k: v.to("cuda") for k, v in sd.items()}
    lazy = ckpt.load_state_dict(path, lazy=True)
    mapping = torch.from_file(path, shared=False, size=os.path.getsize(path),
                              dtype=torch.uint8)
    out = {}
    for k, v in lazy.items():
        out[k] = torch.empty(v.shape, dtype=v.dtype, device="cuda")
        out[k].view(-1).view(torch.uint8).copy_(mapping[v.offset:v.offset + v.nbytes])
    return out


def _reader(path: str, staging_mib: int, workers: int):
    def read():
        ckpt._STAGING_BYTES, ckpt._READ_WORKERS = staging_mib << 20, workers
        return ckpt.read_tensors(ckpt.load_state_dict(path, lazy=True), "cuda")
    return read


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None, help="where to write the files "
                    "(a new folder, removed at the end; default: the temporary directory)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_loader: no CUDA device")
    torch.empty(1, device="cuda")
    folder = tempfile.mkdtemp(prefix="probe_loader_", dir=args.dir)
    defaults = ckpt._STAGING_BYTES, ckpt._READ_WORKERS
    try:
        files = {"st": os.path.join(folder, "a.safetensors"),
                 "pth": os.path.join(folder, "b.pth")}
        ffn = [torch.full((5120, 13824), i + 1.0, dtype=torch.bfloat16) for i in range(36)]
        for key, write in (
                ("st", lambda p: save_file({f"w{i}": t for i, t in enumerate(ffn)}, p)),
                ("pth", lambda p: torch.save(
                    {"tok": torch.ones(256384, 4096, dtype=torch.bfloat16),
                     **{f"w{i}": ffn[i] for i in range(20)}}, p))):
            t0 = time.perf_counter()
            write(files[key])
            drop_from_page_cache([files[key]])
            seconds = time.perf_counter() - t0
            gb = os.path.getsize(files[key]) / 1e9
            _emit(write=os.path.basename(files[key]), gb=gb, s=seconds, gb_per_s=gb / seconds)
        del ffn
        for path in files.values():
            _read("mapped", path, lambda: _mapped(path))
        for mib in (16, 64, 256):
            for path in files.values():
                _read(f"staging {mib} MiB, 4 workers", path, _reader(path, mib, 4))
        for workers in (1, 2, 4, 8):
            for path in files.values():
                _read(f"staging 64 MiB, {workers} workers", path, _reader(path, 64, workers))
    finally:
        ckpt._STAGING_BYTES, ckpt._READ_WORKERS = defaults
        shutil.rmtree(folder, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
