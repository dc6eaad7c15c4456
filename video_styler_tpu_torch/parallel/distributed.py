"""Process groups for the port's multi-GPU runs (torch.distributed).

Counterpart of `video_styler_tpu/parallel/distributed.py`. JAX brings up
one runtime over every process's devices; here each rank is a process with
one device, and `initialize()` joins it to the default process group:

  * the rendezvous comes from the arguments, else from torchrun's variables
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`), else
    from the JAX package's (`COORDINATOR_ADDRESS` as host:port,
    `NUM_PROCESSES`, `PROCESS_ID`); with none of them the process is a group
    of one (an in-memory store, no socket);
  * the backend is NCCL for a CUDA device and gloo for the CPU unless the
    caller names one. A backend that fails to come up raises: nothing drops
    to another backend or device by itself;
  * the rank's device is `cuda:LOCAL_RANK` (`resolve_device`: it raises
    without a GPU) unless the caller names one: "cpu", or an explicit
    "cuda:i", as when several ranks share one card over gloo.

Without an initialised group every query answers for a single process.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: `device` as given, except that "cuda" without an
    index (and None) means `cuda:LOCAL_RANK`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return resolve_device(dev)


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None,
               timeout_s: float = 1800.0) -> torch.device:
    """Join the default process group (once per process) and return this
    rank's device, made current on CUDA."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE",
                                                                    "NUM_PROCESSES")
    rank = rank if rank is not None else _env_int("RANK", "PROCESS_ID")
    kwargs = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif "COORDINATOR_ADDRESS" in os.environ:
            init_method = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    if init_method is None and (world_size or 1) == 1:
        kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
    elif init_method is None:
        raise ValueError(f"{world_size} processes and no rendezvous: pass init_method "
                         "or launch with torchrun (MASTER_ADDR/MASTER_PORT)")
    else:
        kwargs.update(init_method=init_method, world_size=world_size, rank=rank)
    if backend == "nccl":
        # bind the group to this rank's card
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    return dev


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Whether this rank writes files and logs (rank 0, or no group)."""
    return process_index() == 0


def sync_processes() -> None:
    """A barrier over every rank; nothing without a group."""
    if is_distributed():
        dist.barrier()


def broadcast_object(obj, root: int = 0):
    """`obj` of rank `root` on every rank (a small picklable object: a
    seed, a prompt)."""
    if not is_distributed():
        return obj
    box = [obj if process_index() == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]
