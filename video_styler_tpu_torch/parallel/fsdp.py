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

Quantised layers (`ops.quant.QuantLinear`) keep their weights in buffers,
which FSDP2 does not shard. `shard_params_fsdp` shards them itself: each
of `w_q` / `w_q4`, `w_scale` and `b` on its output dim (the row of the
(out, in) weight, the dim of its per-row scale), the rank keeping piece r
of fsdp equal pieces, as FSDP2 keeps piece r of the float weight's dim 0.
`gathered` all-gathers each unit's quantised pieces in one collective and
puts the whole (in, out) weight back column-major, the operand layout
`torch._int_mm` and `torch._scaled_mm` take. The two orders of the API:
`quantize_params` then `shard_params_fsdp` shards the quantised buffers;
`shard_params_fsdp` then `quantize_params` rebuilds the module
(`quantize_sharded`: each rank quantises its own rows of every float
weight, a per-row scale needing no other rank's rows).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch
from torch import nn

try:
    from torch.distributed.fsdp import FSDPModule, fully_shard
except ImportError:  # torch < 2.6
    from torch.distributed._composable.fsdp import FSDPModule, fully_shard

_DEPTH = "_fsdp_gather_depth"
_QUANT = "_fsdp_quant_layers"
_QUANT_NAMES = ("w_q", "w_q4", "w_scale", "b")


def is_sharded(module: nn.Module) -> bool:
    """Whether `shard_params_fsdp` wrapped `module`."""
    return hasattr(module, _DEPTH)


def _quant_layers(unit: nn.Module, stop) -> list:
    """The quantised layers under `unit` that are not under a module of
    `stop` (the units wrapped on their own)."""
    from ..ops.quant import QuantLinear
    found, todo = [], [unit]
    while todo:
        m = todo.pop()
        if isinstance(m, QuantLinear):
            found.append(m)
        else:
            todo.extend(c for c in m.children() if all(c is not u for u in stop))
    return found


def _shard_quant(layers, mesh) -> None:
    """Keep this rank's piece of each quantised buffer, cut on its output
    (last) dim: a copy, so that the whole tensor is freed."""
    size, rank = mesh.size(), mesh.get_local_rank()
    for layer in layers:
        out = layer.w_scale.shape[-1]
        if out % size:
            raise ValueError(f"a quantised layer's {out} outputs do not split over "
                             f"fsdp={size}")
        for name in _QUANT_NAMES:
            t = getattr(layer, name)
            if t is not None:
                rows = t.movedim(-1, 0).chunk(size)[rank].clone(
                    memory_format=torch.contiguous_format)
                setattr(layer, name, rows.movedim(0, -1))


def shard_params_fsdp(module: nn.Module, mesh, axis_name: str = "fsdp") -> nn.Module:
    """fully_shard each module of `module.blocks`, then `module`, over the
    mesh's `axis_name` dim, each unit's quantised layers sharded with it;
    nothing when that dim has size 1."""
    names = mesh.mesh_dim_names
    if axis_name not in names or mesh.size(names.index(axis_name)) == 1:
        return module
    sub = mesh[axis_name]
    blocks = list(getattr(module, "blocks", ()))
    for unit, stop in [(blk, ()) for blk in blocks] + [(module, blocks)]:
        layers = _quant_layers(unit, stop)
        _shard_quant(layers, sub)
        fully_shard(unit, mesh=sub)
        setattr(unit, _DEPTH, 0)
        setattr(unit, _QUANT, (layers, sub))
    return module


def _gather_quant(unit: nn.Module) -> None:
    """Put the whole quantised buffers of `unit`'s layers in place, their
    pieces kept aside: one all-gather of every piece's bytes."""
    import torch.distributed as dist
    layers, mesh = getattr(unit, _QUANT)
    pieces = [(layer, name, getattr(layer, name)) for layer in layers
              for name in _QUANT_NAMES if getattr(layer, name) is not None]
    if not pieces:
        return
    flat = [t.movedim(-1, 0).contiguous().reshape(-1).view(torch.uint8) for _, _, t in pieces]
    sizes = [f.numel() for f in flat]
    size = mesh.size()
    every = torch.empty((size, sum(sizes)), dtype=torch.uint8, device=flat[0].device)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        every.view(-1), torch.cat(flat), group=mesh.get_group())
    offset = 0
    for (layer, name, t), n in zip(pieces, sizes):
        rows = t.movedim(-1, 0)
        whole = every[:, offset:offset + n].contiguous().view(t.dtype).reshape(
            (size * rows.shape[0],) + rows.shape[1:])
        layer._fsdp_pieces = getattr(layer, "_fsdp_pieces", {})
        layer._fsdp_pieces[name] = t
        setattr(layer, name, whole.movedim(0, -1))
        offset += n


def _reshard_quant(unit: nn.Module) -> None:
    for layer in getattr(unit, _QUANT)[0]:
        for name, t in getattr(layer, "_fsdp_pieces", {}).items():
            setattr(layer, name, t)
        layer._fsdp_pieces = {}


def local_bytes(module: nn.Module) -> int:
    """The bytes of `module`'s parameters and buffers this rank holds (its
    shards where the module is sharded)."""
    tensors = list(module.parameters()) + list(module.buffers())
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
               for t in tensors)


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
            _gather_quant(m)
        setattr(m, _DEPTH, depth + 1)
    try:
        yield
    finally:
        for m in wrapped:
            depth = getattr(m, _DEPTH) - 1
            setattr(m, _DEPTH, depth)
            if depth == 0:
                m.reshard()
                _reshard_quant(m)


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


@torch.no_grad()
def quantize_sharded(module: nn.Module, quantize: Callable[[nn.Module], nn.Module],
                     quantize_rows: Callable) -> nn.Module:
    """`module` (wrapped by `shard_params_fsdp`, built as `cls(module.cfg)`)
    quantised: a new sharded module, `quantize` applied to an unsharded
    meta twin of it (so the keep rules see the whole shapes) and sharded
    over the same mesh, holding `module`'s values. Every parameter keeps
    its shard; a quantised layer's pieces are quantize_rows(this rank's
    (out/fsdp, in) rows of the float weight, transposed) -> (w_q or w_q4,
    w_scale), and its bias rows. No rank gathers a weight: a per-row
    (output-channel) scale needs only that row."""
    from ..ops.quant import QuantLinear
    if any(isinstance(m, QuantLinear) for m in module.modules()):
        raise ValueError("a sharded module is quantised once")
    cls = type(module).__bases__[-1] if isinstance(module, FSDPModule) else type(module)
    with torch.device("meta"):
        twin = cls(module.cfg)
    source = dict(module.named_parameters())
    for name, p in twin.named_parameters():
        p.data = p.data.to(source[name].dtype)
    twin = quantize(twin)
    mesh = getattr(module, _QUANT)[1]
    local = next(iter(source.values())).to_local()
    new = shard_params_fsdp(twin, mesh, mesh.mesh_dim_names[0]).to_empty(device=local.device)
    for name, p in new.named_parameters():
        p.to_local().copy_(source[name].to_local())
    plain = dict(module.named_buffers())
    for name, b in new.named_buffers():
        if name in plain:
            b.copy_(plain[name])
    for path, layer in new.named_modules():
        if isinstance(layer, QuantLinear):
            src = module.get_submodule(path)
            q, scale = quantize_rows(src.weight.to_local().t())
            (layer.w_q if layer.w_q is not None else layer.w_q4).copy_(q)
            layer.w_scale.copy_(scale)
            if layer.b is not None:
                layer.b.copy_(src.bias.to_local())
    return new.train(module.training)
