"""Host-resident block streaming: the block store and its copy pipeline.

Counterpart of `video_styler_tpu/parallel/streaming.py`. A block's
tensors are a flat tree `{dotted name: tensor}` in the port's module
naming (`self_attn.q.weight`, or `self_attn.q.w_q`, `.w_scale`, `.b` once
quantised). The streamed blocks of a model live in host memory, each
packed into ONE contiguous buffer (`pack_host_block`; pinned when the
blocks stream to a card) with a spec of (name, dtype, byte offset, shape,
transposed) per tensor at 512-byte aligned offsets, so that the device
side takes views of one copied buffer and makes no tensor of its own.

The copy pipeline (`SlotRing`, `PrefetchQueue`) is the Hopper form of the
JAX package's multi-stream `device_put` pool: one copy `torch.cuda.Stream`
moves a block's buffer with one `cudaMemcpyAsync` into a device slot of a
ring of `depth + 1` slots, each the size of the largest packed block,
allocated once. Each copy records an event that the compute stream waits
on before it reads the slot; a slot is written again only after an event
that the compute stream recorded after the last read of its block. So
`depth` copies run ahead of the compute, and no host wait is made. The
serial walk (`overlap=False`, the JAX package's gated mode) keeps one copy
in flight and starts the next only after the host has waited for the
previous block's compute: it is what the overlapped walk is held against.

On the CPU the same classes run on plain tensors: the copies are
synchronous and no stream or event is made.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.quant import quantize_weight_int4, quantize_weight_int8

__all__ = [
    "tree_bytes", "block_tree", "host_quantize_int8", "host_quantize_int4",
    "host_cast_bf16", "split_host_blocks", "PackedBlock", "pack_host_block",
    "unpack", "pinned_empty", "SlotRing", "PrefetchQueue",
]

ALIGN = 512          # byte alignment of each tensor in a packed buffer (the
                     # caching allocator's, so a view sits as an allocation does)


def tree_bytes(tree) -> int:
    """Bytes of a packed block's tensors, of a tree's, or of a module's
    parameters and buffers."""
    if isinstance(tree, PackedBlock):
        return tree.nbytes
    if isinstance(tree, nn.Module):
        tree = block_tree(tree)
    return sum(t.numel() * t.element_size() for t in tree.values())


def block_tree(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers as a flat tree (no copy)."""
    return {k: v.detach() for k, v in module.state_dict(keep_vars=True).items()
            if v is not None}


def _is_linear(name: str, t: torch.Tensor) -> bool:
    """A full-precision linear weight: the port's linears hold (out, in)
    `weight`s, and no other tensor of a block is a 2-D `weight`."""
    return name.endswith(".weight") and t.dim() == 2


def _quantize_tree(tree, quant, packed_key: str, stack: int, min_size: int,
                   min_dim: int):
    """Rewrite each eligible linear `{p.weight, p.bias}` of `tree` into the
    `QuantLinear` names `{p.<packed_key>, p.w_scale, p.b}`, with the values
    of `ops.quant.quantize_params`: the (in, out) weight quantised per
    output column, skipped by its size rule (elements times `stack`, the
    length of the block list the JAX stacks would hold, under `min_size`,
    or a dimension under `min_dim`). Leaves already quantised pass through.
    The quantiser runs on the device each tensor is on."""
    eligible = {n[:-len(".weight")] for n, t in tree.items()
                if _is_linear(n, t) and t.numel() * stack >= min_size
                and min(t.shape) >= min_dim}
    out = {}
    for name, t in tree.items():
        prefix, _, leaf = name.rpartition(".")
        if prefix not in eligible:
            out[name] = t
        elif leaf == "weight":
            q, scale = quant(t.t())
            out[f"{prefix}.{packed_key}"] = q.t().contiguous().t() if packed_key == "w_q" else q
            out[f"{prefix}.w_scale"] = scale
        elif leaf == "bias":
            out[f"{prefix}.b"] = t
    return out


def host_quantize_int8(tree: Dict[str, torch.Tensor], stack: int = 1,
                       min_size: int = 1 << 16, min_dim: int = 128):
    """int8 (w8a8) store of one block: `quantize_weight_int8` per output
    channel, `w_q` (in, out) kept column-major as `QuantLinear` keeps it."""
    return _quantize_tree(tree, quantize_weight_int8, "w_q", stack, min_size, min_dim)


def host_quantize_int4(tree: Dict[str, torch.Tensor], stack: int = 1,
                       min_size: int = 1 << 16, min_dim: int = 128):
    """int4 (w4a8, per column) store of one block: `quantize_weight_int4`,
    packed nibbles in `w_q4` at 0.5 byte a parameter."""
    return _quantize_tree(tree, quantize_weight_int4, "w_q4", stack, min_size, min_dim)


def host_cast_bf16(tree: Dict[str, torch.Tensor]):
    """mode="bf16": every floating tensor cast to bf16, integers kept (an
    f32 checkpoint must not stream at twice the advertised bytes)."""
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
            for k, v in tree.items()}


def split_host_blocks(blocks: Sequence, start: int, stop: int) -> List[Dict[str, torch.Tensor]]:
    """Blocks [start, stop) of a block list (modules or trees) as trees."""
    return [b if isinstance(b, dict) else block_tree(b) for b in list(blocks)[start:stop]]


class PackedBlock:
    """One block's tensors in one contiguous host buffer (uint8), with
    `spec`: (name, dtype, byte offset, shape, transposed) per tensor.
    `nbytes` counts the tensors' bytes (the buffer adds the alignment)."""

    __slots__ = ("buf", "spec", "nbytes")

    def __init__(self, buf: torch.Tensor, spec: Tuple, nbytes: int):
        self.buf = buf
        self.spec = spec
        self.nbytes = nbytes


def _storage_order(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(the tensor in its memory order, whether that is its transpose): a
    column-major 2-D weight keeps its layout through the buffer."""
    if t.dim() == 2 and not t.is_contiguous() and t.t().is_contiguous():
        return t.t(), True
    return t.contiguous(), False


def _unregister(ptr: int):
    """Unpin a buffer that `pinned_empty` registered, once no copy from it
    can still be in flight."""
    torch.cuda.synchronize()
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_empty(nbytes: int) -> torch.Tensor:
    """A page-locked host buffer of exactly `nbytes`: a plain allocation
    page-locked in place (`cudaHostRegister`), unpinned when the tensor
    goes. (PyTorch's pinned allocator rounds each size up to a power of
    two and keeps its pages cached after the tensor goes;
    `probe_pinning.py` measures both ways.) Raises where
    the host cannot pin: a pageable copy would not run beside the compute,
    and would hide it."""
    import weakref
    buf = torch.empty(nbytes, dtype=torch.uint8)
    err = torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: {err}")
    weakref.finalize(buf, _unregister, buf.data_ptr())
    if not buf.is_pinned():
        raise RuntimeError(f"could not pin {nbytes} bytes of host memory")
    return buf


def pack_host_block(tree: Dict[str, torch.Tensor], pin: bool = False,
                    cache: Optional[Dict] = None,
                    seconds: Optional[Dict[str, float]] = None) -> PackedBlock:
    """Copy a block's tree (from any device) into one host buffer, pinned
    with `pin` (`pinned_empty`). `cache` de-duplicates trees whose tensors are the same
    memory (aliased slices of one store pack once). `seconds` accumulates
    the time to allocate (and pin) the buffer ("pin_s") and to fill it
    ("copy_s")."""
    key = None
    if cache is not None:
        key = tuple((t.data_ptr(), tuple(t.shape), str(t.dtype)) for t in tree.values())
        hit = cache.get(key)
        if hit is not None:
            return hit
    spec, off, nbytes = [], 0, 0
    ordered = {}
    for name, t in tree.items():
        t_mem, transposed = _storage_order(t)
        ordered[name] = t_mem
        spec.append((name, t.dtype, off, tuple(t.shape), transposed))
        n = t.numel() * t.element_size()
        nbytes += n
        off += -(-n // ALIGN) * ALIGN
    t0 = time.perf_counter()
    buf = pinned_empty(off) if pin else torch.empty(off, dtype=torch.uint8)
    t1 = time.perf_counter()
    for (name, dtype, o, _, _), t_mem in zip(spec, ordered.values()):
        view = buf[o:o + t_mem.numel() * t_mem.element_size()].view(dtype).view(t_mem.shape)
        view.copy_(t_mem)
    if seconds is not None:
        seconds["pin_s"] = seconds.get("pin_s", 0.0) + t1 - t0
        seconds["copy_s"] = seconds.get("copy_s", 0.0) + time.perf_counter() - t1
    out = PackedBlock(buf, tuple(spec), nbytes)
    if cache is not None:
        cache[key] = out
    return out


def unpack(buf: torch.Tensor, spec: Tuple) -> Dict[str, torch.Tensor]:
    """Views of a packed block's tensors in `buf` (a host buffer or a device
    slot holding its bytes), each with its own shape and layout."""
    out = {}
    for name, dtype, off, shape, transposed in spec:
        size = 1
        for s in shape:
            size *= s
        n = size * torch.empty((), dtype=dtype).element_size()
        flat = buf[off:off + n].view(dtype)
        out[name] = flat.view(shape[::-1]).t() if transposed else flat.view(shape)
    return out


class SlotRing:
    """`count` device buffers of `nbytes` each, allocated once, with a copy
    stream and per-slot events on a card: `ready` (recorded on the copy
    stream after a block's bytes land) and `free` (recorded on the compute
    stream after the last read of the slot's block)."""

    def __init__(self, count: int, nbytes: int, device: torch.device):
        self.device = torch.device(device)
        self.slots = [torch.empty(nbytes, dtype=torch.uint8, device=self.device)
                      for _ in range(count)]
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.ready = [torch.cuda.Event() if self.cuda else None for _ in range(count)]
        self.free = [None] * count
        self.next = 0
        self.copies = 0          # blocks copied into a slot (all forwards)
        self.bytes_copied = 0

    def load(self, item: PackedBlock) -> int:
        """Copy `item` into the next slot (on the copy stream, after the
        slot's last reader); returns the slot index."""
        i = self.next
        self.next = (i + 1) % len(self.slots)
        dst = self.slots[i][:item.buf.numel()]
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if self.free[i] is not None:
                    self.stream.wait_event(self.free[i])
                dst.copy_(item.buf, non_blocking=True)
                self.ready[i].record(self.stream)
        else:
            dst.copy_(item.buf)
        self.copies += 1
        self.bytes_copied += item.buf.numel()
        return i

    def acquire(self, i: int, item: PackedBlock) -> Dict[str, torch.Tensor]:
        """The compute stream waits for slot i's copy; the block's views."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.ready[i])
        return unpack(self.slots[i], item.spec)

    def release(self, i: int):
        """Slot i may be written again once the compute enqueued so far has
        run (an event on the compute stream; no host wait)."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.free[i] = ev


class PrefetchQueue:
    """`depth` upcoming blocks in flight on a `SlotRing`, consumed strictly
    in the order of `items`. `pop()` gives (slot, views) of the next one;
    `done(slot)` releases it and, in the overlapped walk, starts the next
    copy. With overlap=False at most one copy is in flight and `done`
    waits (on the host) for the compute of the block before it starts it."""

    def __init__(self, items: Sequence[PackedBlock], ring: SlotRing, depth: int = 3,
                 overlap: bool = True):
        if depth + 1 > len(ring.slots):
            raise ValueError(f"depth {depth} needs {depth + 1} slots, the ring "
                             f"has {len(ring.slots)}")
        self.items = list(items)
        self.ring = ring
        self.depth = depth if overlap else 1
        self.overlap = overlap
        self.inflight: List[Tuple[int, PackedBlock]] = []
        self.next_submit = 0
        self._fill()

    def _fill(self):
        while self.next_submit < len(self.items) and len(self.inflight) < self.depth:
            item = self.items[self.next_submit]
            self.inflight.append((self.ring.load(item), item))
            self.next_submit += 1

    def pop(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        if not self.inflight:
            self._fill()
        i, item = self.inflight.pop(0)
        return i, self.ring.acquire(i, item)

    def done(self, i: int):
        self.ring.release(i)
        if not self.overlap and self.ring.cuda:
            torch.cuda.current_stream(self.ring.device).synchronize()
        self._fill()
