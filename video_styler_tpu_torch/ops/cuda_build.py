"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` compiles with `nvcc` into a shared library with a plain C
interface, loaded through `ctypes`. The build happens at first use, never at
import: one `nvcc` per source, all started together, into `_build/` beside
the package (listed in `.gitignore`). A library's file name carries a hash
of its source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

`Kernel` wraps one C entry point: it declares the argument types (every
pointer and the stream as `c_void_p`), raises on a non-zero
`cudaGetLastError()` from the launch, and counts its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_paths() -> Dict[str, Path]:
    """Source stem -> the hash-named shared library it builds into."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS).encode()
    out = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest = hashlib.sha256(src.read_bytes() + headers + flags).hexdigest()
        out[src.stem] = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
    return out


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Compiler output (including `-Xptxas=-v` register and spill counts) is
    kept next to each library as `<name>.log`."""
    paths = library_paths()
    jobs = []
    for stem, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, proc, tmp, so))
    failures = []
    for stem, proc, tmp, so in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {stem}.cu:\n{log}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent load sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(stem: str) -> ctypes.CDLL:
    if stem not in _libraries:
        paths = build_all()
        _libraries[stem] = ctypes.CDLL(str(paths[stem]))
    return _libraries[stem]


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    `launches` goes up by one for every launch that the CUDA runtime
    accepted, and nowhere else."""

    def __init__(self, library: str, symbol: str, argtypes: Sequence,
                 error_symbol: str):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.error_symbol = error_symbol
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = load_library(self.library)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, self.error_symbol)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args):
        if self._fn is None:
            self._bind()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {code} "
                               f"({self._err(code).decode()})")
        self.launches += 1


P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float
