"""Sharding context: which mesh the model code runs under.

Counterpart of `video_styler_tpu/parallel/context.py`. There, model code
declares shardings (`constrain`) and GSPMD inserts the collectives. Eager
PyTorch has no such pass, so the sequence split is explicit: the DiT pads
its tokens to a multiple of sp (`seq_pad_amount`), each rank keeps its rows
(`split_seq`), self-attention exchanges them (`ulysses`, `ring`) and the
head's rows are gathered back (`gather_seq`). The VAE is split on the
frame width instead (`split_w`, `gather_w`): each convolution takes its
neighbours' edge columns first (`halo_exchange_w`). A width that does not
split is run whole, warned once and counted (`drop_count`), as JAX's
`constrain` drops a sharding it cannot apply. With no active context every
function here is the identity, so the single-GPU path runs exactly what it
ran before.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

_state = threading.local()


class ShardingContext:
    """A mesh and the sequence-parallel attention to use on it: Ulysses
    (all-to-all over heads) by default, the ring with ulysses=False."""

    def __init__(self, mesh, ulysses: bool = True):
        self.mesh = mesh
        self.ulysses = ulysses

    def axis_size(self, name: str) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index(name)) if name in names else 1

    def group(self, name: str):
        return self.mesh.get_group(name)

    def local_rank(self, name: str) -> int:
        return self.mesh.get_local_rank(name)


def current_sharding() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    prev = current_sharding()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def axis_size(ax: str) -> int:
    """Size of a mesh axis under the active context; 1 with no context or
    no such axis."""
    ctx = current_sharding()
    return 1 if ctx is None else ctx.axis_size(ax)


def seq_pad_amount(seq_len: int, *axes) -> int:
    """Zero rows needed so `seq_len` divides the product of the axes (the
    reference's chunk+pad before rank slicing). The padded keys are masked
    exactly (`kv_valid`), so the padded, split output equals the
    single-device one up to summation order. (The DiT pads further, to
    whole shares of 8 rows: `models.wan_dit.mesh_padded_length`.)"""
    total = 1
    for ax in axes:
        total *= axis_size(ax)
    return (-seq_len) % total


def pad_rows(x: torch.Tensor, length: int, dim: int = 1, value: float = 0.0) -> torch.Tensor:
    """x padded with `value` along `dim` to `length` rows."""
    pad = length - x.shape[dim]
    if pad <= 0:
        return x
    spec = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, spec, value=value)


def split_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Rank r's rows [r*S/sp, (r+1)*S/sp) of a (padded) sequence of S rows
    along `dim`; the identity without sp."""
    ctx = current_sharding()
    sp = axis_size("sp")
    if sp == 1:
        return x
    n, rem = divmod(x.shape[dim], sp)
    if rem:
        raise ValueError(f"{x.shape[dim]} rows do not split over sp={sp}: pad first")
    return x.narrow(dim, ctx.local_rank("sp") * n, n).contiguous()


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole sequence from every rank's rows (all-gather over sp); the
    identity without sp."""
    ctx = current_sharding()
    sp = axis_size("sp")
    if sp == 1:
        return x
    rows = x.movedim(dim, 0).contiguous()
    out = torch.empty((sp * rows.shape[0],) + rows.shape[1:], dtype=x.dtype, device=x.device)
    # all_gather_single where torch has it (all_gather_into_tensor's new name)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, rows, group=ctx.group("sp"))
    return out.movedim(0, dim)


_warned_drops = set()
_drop_count = 0


def drop_count() -> int:
    """Tensors run whole since the last reset because their width did not
    split over sp (JAX's `constrain` counts its ragged drops the same way)."""
    return _drop_count


def reset_drop_count() -> None:
    global _drop_count
    _drop_count = 0
    _warned_drops.clear()


def w_shardable(width: int, multiple: int = 1) -> bool:
    """Whether a width of `width` columns splits over the active sp axis
    into shares that are multiples of `multiple`. False without sp; where
    it does not split, also warned once per (sp, width, multiple) and
    counted: the tensor then runs whole on every rank."""
    global _drop_count
    sp = axis_size("sp")
    if sp == 1:
        return False
    if width % (sp * multiple) == 0:
        return True
    _drop_count += 1
    key = (sp, width, multiple)
    if key not in _warned_drops:
        _warned_drops.add(key)
        warnings.warn(f"width {width} does not split over sp={sp} into shares of a "
                      f"multiple of {multiple} columns: that tensor runs whole on every "
                      f"rank", stacklevel=2)
    return False


def split_w(x: torch.Tensor) -> torch.Tensor:
    """Rank r's share [r*W/sp, (r+1)*W/sp) of the last (width) dim of a
    (B, C, T, H, W) tensor; the identity without sp."""
    return split_seq(x, dim=x.dim() - 1)


def gather_w(x: torch.Tensor) -> torch.Tensor:
    """The whole width from every rank's share (all-gather over sp)."""
    return gather_seq(x, dim=x.dim() - 1)


def halo_exchange_w(x: torch.Tensor, left: int = 1, right: int = 1) -> torch.Tensor:
    """This rank's (..., W/sp) columns -> (..., left + W/sp + right): the
    last `left` columns of the rank before it and the first `right` of the
    rank after it, zeros past the frame's edges (a convolution's own zero
    padding). One all-gather of every rank's edge columns: gloo takes no
    CUDA tensor for send/recv, and this collective is the one that Ulysses
    and the FSDP gathers already run there. Without sp, the zero padding
    alone."""
    sp = axis_size("sp")
    if sp == 1:
        return F.pad(x, (left, right))
    w = x.shape[-1]
    if w < max(left, right):
        raise ValueError(f"a share of {w} columns is narrower than its halo "
                         f"({left}, {right})")
    edges = torch.cat([x[..., :right], x[..., w - left:]], dim=-1)
    every = gather_seq(edges, dim=edges.dim() - 1)       # rank j: [first right | last left]
    rank, span = current_sharding().local_rank("sp"), left + right
    parts = []
    if left:
        parts.append(every[..., (rank - 1) * span + right:rank * span] if rank > 0
                     else x.new_zeros(x.shape[:-1] + (left,)))
    parts.append(x)
    if right:
        parts.append(every[..., (rank + 1) * span:(rank + 1) * span + right]
                     if rank < sp - 1 else x.new_zeros(x.shape[:-1] + (right,)))
    return torch.cat(parts, dim=-1)
