"""A small writer and reader of the safetensors format.

The card's machine has no `safetensors` package, so the port keeps its own
copy of the public format: an 8-byte little-endian header length N, N bytes
of JSON header ({name: {"dtype", "shape", "data_offsets": [begin, end]}},
plus an optional "__metadata__" of strings), then the raw little-endian
tensor bytes, offsets counted from the end of the header. Files written
here load with `safetensors.numpy.load_file`/`safetensors.torch.load_file`,
and theirs load here.
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Mapping

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
    """Write `tensors` (torch tensors or numpy arrays) to `path`."""
    header: Dict[str, object] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        data = _as_bytes(t)
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file as CPU torch tensors."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _TORCH[info["dtype"]]
        begin, end = info["data_offsets"]
        np_dtype = torch.empty((), dtype=torch.int16 if dtype == torch.bfloat16
                               else dtype).numpy().dtype
        t = torch.from_numpy(np.frombuffer(body[begin:end], dtype=np_dtype).copy())
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(info["shape"])
    return out
