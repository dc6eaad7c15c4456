"""Parameter sharding: FSDP2 over the mesh's fsdp dim.

Counterpart of `video_styler_tpu/parallel/fsdp.py`, where each leaf of 2^16
elements or more is sharded on its largest divisible dim and XLA inserts
the all-gathers. Here `shard_params_fsdp` wraps each DiT or VACE block, then
the root, with FSDP2's `fully_shard`, which shards every parameter on dim 0
(the last rank's piece may be short or empty). The layout differs from the
JAX package's; the function computed and each rank's ~1/fsdp share of the
bytes are the same.

The port's models run as functions of their modules (`wan_dit.dit_block`
reads `blk.self_attn.q.weight`), never through `module.forward`, so
FSDP2's forward hooks would not fire. The gather is explicit instead:
`with gathered(blk):` all-gathers the block's parameters
(`FSDPModule.unshard`) and frees them again on leaving (`reshard`). On a
module that `shard_params_fsdp` did not wrap it does nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch
from torch import nn

try:
    from torch.distributed.fsdp import fully_shard
except ImportError:  # torch < 2.6
    from torch.distributed._composable.fsdp import fully_shard

_DEPTH = "_fsdp_gather_depth"


def shard_params_fsdp(module: nn.Module, mesh, axis_name: str = "fsdp") -> nn.Module:
    """fully_shard each module of `module.blocks`, then `module`, over the
    mesh's `axis_name` dim; nothing when that dim has size 1."""
    names = mesh.mesh_dim_names
    if axis_name not in names or mesh.size(names.index(axis_name)) == 1:
        return module
    sub = mesh[axis_name]
    for blk in getattr(module, "blocks", ()):
        fully_shard(blk, mesh=sub)
        setattr(blk, _DEPTH, 0)
    fully_shard(module, mesh=sub)
    setattr(module, _DEPTH, 0)
    return module


@torch.no_grad()
def replicate_params(module: nn.Module) -> nn.Module:
    """Every rank's parameters and buffers made rank 0's (a broadcast), for
    a module that each rank built alone."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@contextlib.contextmanager
def gathered(*modules):
    """The whole parameters of each FSDP-wrapped module inside the block
    (None and unwrapped modules are skipped); nested uses gather once."""
    wrapped = [m for m in modules if m is not None and hasattr(m, _DEPTH)]
    for m in wrapped:
        depth = getattr(m, _DEPTH)
        if depth == 0:
            m.unshard()
        setattr(m, _DEPTH, depth + 1)
    try:
        yield
    finally:
        for m in wrapped:
            depth = getattr(m, _DEPTH) - 1
            setattr(m, _DEPTH, depth)
            if depth == 0:
                m.reshard()


def _units(module: nn.Module, prefix: str = "") -> Iterator[Tuple[str, nn.Module]]:
    """The module's children in order, a ModuleList's children in its place."""
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            yield from _units(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", child


@torch.no_grad()
def _copy_shard(target: torch.Tensor, full: torch.Tensor):
    """Copy this rank's dim-0 piece of `full` into an FSDP2 parameter (a
    DTensor sharded on dim 0), or all of it into a plain tensor."""
    if not hasattr(target, "to_local"):
        target.copy_(full)
        return
    local = target.to_local()
    mesh = target.device_mesh
    pieces = full.chunk(mesh.size(), dim=0)
    rank = mesh.get_local_rank()
    if rank < len(pieces):
        local.copy_(pieces[rank])


@torch.no_grad()
def materialize_sharded_(module: nn.Module, template: nn.Module,
                         init: Callable[[nn.Module, torch.Generator], nn.Module],
                         generator: torch.Generator, device) -> nn.Module:
    """Random weights for a module that `shard_params_fsdp` wrapped on the
    meta device, equal to `init(template.to_empty(device), generator)` on
    one process, without a whole copy: each unit of `template` (an unsharded
    meta twin of `module`; its children in order, a ModuleList's one by one)
    is made on `device`, drawn, its shard of every tensor copied into
    `module`, and freed. This needs `init` to draw a module as it draws its
    units in order, which holds for the port's inits: they walk
    `module.modules()` and draw nothing for a container."""
    module.to_empty(device=device)
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    for name, unit in _units(template):
        init(unit.to_empty(device=device), generator)
        for key, full in list(unit.named_parameters()) + list(unit.named_buffers()):
            _copy_shard(targets[f"{name}.{key}"], full)
        unit.to_empty(device="meta")
    return module
