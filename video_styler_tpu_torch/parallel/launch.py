"""Spawn the ranks of a multi-GPU run on one machine.

JAX runs one process that sees every local device; torch.distributed runs
a process per rank. `run_local` starts `world_size` of them (the `spawn`
method: each starts from a fresh import), joins each to a process group on
`backend` through a `file://` store at `init_file`, calls `fn(*args)` in
every one and returns their results in rank order. It is how the tests and
`chip_smoke.py` run a mesh; users launch with torchrun, which the entry
points read through `distributed.initialize`.

`fn` must be importable by name (a module-level function) and its result
picklable: numpy arrays rather than tensors. The first rank that raises, or
dies, or the deadline, stops every rank, and `run_local` raises with the
failing rank's traceback.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback
from typing import Callable, List, Optional

from . import distributed


def _rank_main(fn, rank, world_size, backend, init_file, device, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    try:
        distributed.initialize(backend=backend, init_method=f"file://{init_file}",
                               world_size=world_size, rank=rank, device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        distributed.destroy()


def run_local(fn: Callable, world_size: int, backend: str, init_file: str, *args,
              device: Optional[str] = None, timeout_s: float = 900.0) -> List:
    """Results of fn(*args) on ranks 0..world_size-1 of a new group.
    init_file: a path that does not exist yet (the store's file); device:
    each rank's (`distributed.rank_device`: None is cuda:rank, "cpu", or
    "cuda:0" for ranks sharing one card)."""
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file}: the store's file must be new")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, init_file, device, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = f"rank {dead[0]} died (exit code {procs[dead[0]].exitcode})"
                elif time.monotonic() > deadline:
                    failure = f"ranks {sorted(set(range(world_size)) - set(out))} " \
                              f"still running after {timeout_s} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"run_local({getattr(fn, '__name__', fn)}): {failure}")
    return [out[r] for r in range(world_size)]
