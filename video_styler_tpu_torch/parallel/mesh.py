"""Device mesh of a multi-GPU run.

Counterpart of `video_styler_tpu/parallel/mesh.py`: the mesh has the
same three named dims, over the ranks of the default process group (one
device per rank; `distributed.initialize` first):

  dp   - data parallel: each dp index runs its own requests or batch rows
  fsdp - parameter sharding (`fsdp.shard_params_fsdp`)
  sp   - sequence parallel (Ulysses all-to-all, or the ring)

The reference's "USP degree = world size, ring = 1" is sp = world size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "fsdp", "sp")


def local_device_count() -> int:
    """GPUs this process sees (a rank uses one of them)."""
    return torch.cuda.device_count()


def parse_mesh(spec: str):
    """"dp,fsdp,sp" -> (dp, fsdp, sp), as `--mesh` takes it."""
    sizes = tuple(int(x) for x in spec.split(","))
    if len(sizes) != 3 or min(sizes) < 1:
        raise ValueError(f"--mesh takes three positive sizes dp,fsdp,sp, got {spec!r}")
    return sizes


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, fsdp, sp) mesh over every rank; their product must be the
    world size."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if dp * fsdp * sp != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{sp} needs {dp * fsdp * sp} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, (dp, fsdp, sp), mesh_dim_names=AXES)


# the JAX package's name for a mesh over every process; this one always is
make_global_mesh = make_mesh
