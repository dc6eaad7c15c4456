"""A small writer and reader of the safetensors format.

The card's machine has no `safetensors` package, so the port keeps its own
copy of the public format: an 8-byte little-endian header length N, N bytes
of JSON header ({name: {"dtype", "shape", "data_offsets": [begin, end]}},
plus an optional "__metadata__" of strings), then the raw little-endian
tensor bytes, offsets counted from the end of the header. Files written
here load with `safetensors.numpy.load_file`/`safetensors.torch.load_file`,
and theirs load with `utils.ckpt.load_state_dict`.

`read_header` reads the header alone (names, dtypes, shapes and where each
tensor's bytes lie), so that the port's one reader, `utils.ckpt`, reads
each tensor's bytes straight into its destination; `save_file` writes one
tensor at a time, so a 14B shard is never held whole on the host.
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
}
_TORCH = {v: k for k, v in _DTYPES.items()}
# raw tensor bytes are written and read in the host's order
assert sys.byteorder == "little", "safetensors data is little-endian"


def _as_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (torch tensors on any device, or numpy arrays) to
    `path`, one tensor's bytes on the host at a time."""
    header: Dict[str, object] = {}
    items = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in items:
            f.write(_as_bytes(t))


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """({name: {"dtype": torch dtype, "shape": [...], "data_offsets":
    [begin, end]}}, the file offset of the data), reading the header only."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    for info in header.values():
        info["dtype"] = _TORCH[info["dtype"]]
    return header, 8 + n

