"""Streaming executor for the Wan DiT: run a DiT and VACE bigger than the
card's memory budget.

Counterpart of `video_styler_tpu/models/wan_streaming.py`, the analogue of
the reference's vram_management layer (the fp8 Wan-14B VACE edit in 11 GB
streams every layer from the host per call). Here, at block granularity:

  * the embeddings, head and modulation tables (`small`) and as many trunk
    blocks as fit `hbm_budget_gb` stay resident on the device (int8 by
    default: `torch._int_mm` runs int8 at twice the bf16 rate);
  * the other trunk blocks and the VACE blocks live in host memory, each
    packed into one pinned buffer (`parallel.streaming.pack_host_block`),
    and are copied ahead of the compute on a side stream into a fixed ring
    of device slots (`SlotRing`, `PrefetchQueue`): the copy of block i + 1
    .. i + depth overlaps block i's compute;
  * VACE block i runs just before its hint is added after trunk layer
    vace_layers[i] (the hint chain does not read the trunk, so this
    reorders nothing: one hint is alive instead of all of them).

Every block, resident or streamed, runs the port's own `dit_block` on a
shell module whose tensors are swapped in by `torch.func.functional_call`
(the resident tensors, or views of the slot its bytes were copied to), so
the streamed forward is the resident `wan_dit_forward_with_residual`'s
arithmetic: in f32 it is bit-equal to it, in int8 to the `quantize_params`
path on the same weights. The pipeline routes the T2V, VACE, I2V and
editor paths and skip-layer guidance through it; per-layer adapters
(Animate, Fun camera and reference, the speed controller) stay resident.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..ops.basic import patchify
from ..ops.quant import QuantLinear, _replace_linears
from ..ops.rope import assemble_freqs_grid
from ..parallel.context import pad_rows
from ..parallel.streaming import (
    PrefetchQueue, SlotRing, block_tree, host_cast_bf16, host_quantize_int4,
    host_quantize_int8, pack_host_block, split_host_blocks, tree_bytes,
)
from .wan_dit import (DiTBlock, Linear, WanDiT, WanDiTConfig, assemble_tokens, dit_block,
                      head, image_inputs, text_embed, time_embed, unpatchify)
from .wan_vace import WanVace

MODES = ("int4", "int8", "bf16", "f32")


def _without(module: nn.Module, names) -> nn.Module:
    """A shallow copy of `module` without the children `names`: it shares
    every other parameter and buffer (the source module is left whole)."""
    shell = copy.copy(module)
    shell._modules = {k: v for k, v in module._modules.items() if k not in names}
    shell._parameters = dict(module._parameters)
    shell._buffers = dict(module._buffers)
    return shell


class _Runner(nn.Module):
    """A block (and a VACE block's `after` projection) as one callable for
    `functional_call`: the tensors of the tree named `block.*` / `after.*`."""

    def __init__(self, block: DiTBlock, cfg: WanDiTConfig, after: Optional[nn.Module]):
        super().__init__()
        self.block = block
        self.after = after
        self.cfg = cfg

    def forward(self, x, context, t_mod, cos, sin):
        x = dit_block(self.block, x, context, t_mod, cos, sin, self.cfg)
        return x if self.after is None else (x, self.after(x))


def _shell(cfg: WanDiTConfig, tree: Dict[str, torch.Tensor]) -> _Runner:
    """A meta-device runner whose linears are `QuantLinear`s wherever the
    tree holds quantised names, plain `Linear`s elsewhere."""
    def meta(name):
        t = tree[name]
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def swap(path, layer, stack):
        if not isinstance(layer, nn.Linear):
            return layer
        for key in ("w_q", "w_q4"):
            if f"{path}.{key}" in tree:
                b = f"{path}.b"
                return QuantLinear(**{key: meta(f"{path}.{key}")},
                                   w_scale=meta(f"{path}.w_scale"),
                                   b=meta(b) if b in tree else None)
        return layer

    with torch.device("meta"):
        runner = _Runner(DiTBlock(cfg),
                         cfg, Linear(cfg.dim, cfg.dim) if "after.weight" in tree
                         or "after.w_q" in tree or "after.w_q4" in tree else None)
    return _replace_linears(runner, swap)


def _prefixed(prefix: str, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tree.items()}


class WanBlockStreamer:
    """Host-resident Wan DiT (+ optional VACE branch) with streamed blocks.

    Split at construction:
      small (embeddings, head, modulation tables; VACE's patch embedding
        and before_proj) -> resident, as given (cast to bf16 in "bf16");
      trunk blocks [0, R) -> resident on `device` (quantised in int4/int8);
      trunk blocks [R, N) and the VACE blocks -> host, one packed buffer
        each (pinned for a card), streamed per forward.

    mode: "int8" / "int4" quantise the block linears (`ops.quant`'s values
    and size rules; leaves quantised already pass through), "bf16" casts
    every floating tensor, "f32" streams the tensors as they are.
    resident_blocks: None derives R from the budget as the JAX package
    does; an explicit value is clamped to [0, N]. overlap=False is the
    serial walk (`PrefetchQueue`).

    The source modules are left whole; a block is quantised on the device
    it lies on, then kept there (resident) or copied to its host buffer."""

    def __init__(self, dit: WanDiT, vace: Optional[WanVace] = None, *,
                 mode: str = "int8", hbm_budget_gb: float = 13.5,
                 activation_headroom_gb: float = 2.5,
                 resident_blocks: Optional[int] = None, prefetch_depth: int = 3,
                 device=None, quant_min_size: int = 1 << 16, quant_min_dim: int = 128,
                 overlap: bool = True):
        if mode not in MODES:
            raise ValueError(f"unsupported streaming mode {mode!r}")
        t_start = time.perf_counter()
        # the host store's making: buffers allocated and pinned, filled
        self.store_seconds: Dict[str, float] = {"pin_s": 0.0, "copy_s": 0.0}
        self.cfg = dit.cfg
        self.vace_cfg = None if vace is None else vace.cfg
        self.mode = mode
        self.overlap = overlap
        self.prefetch_depth = prefetch_depth
        self.device = torch.device(device) if device is not None else \
            next(dit.parameters()).device
        pin = self.device.type == "cuda"

        def convert(tree, stack):
            if mode == "int8":
                return host_quantize_int8(tree, stack, quant_min_size, quant_min_dim)
            if mode == "int4":
                return host_quantize_int4(tree, stack, quant_min_size, quant_min_dim)
            return host_cast_bf16(tree) if mode == "bf16" else tree

        # small too in "bf16": left in an f32 checkpoint's dtype it would
        # promote the bf16 walk's tokens to f32 and double the modulation work
        self.small = self._resident_part(dit, ("blocks",))

        n = len(dit.blocks)
        self.num_layers = n
        trees = split_host_blocks(dit.blocks, 0, n)
        per_block = tree_bytes(convert(trees[0], n))
        small_bytes = tree_bytes(self.small)

        self.vace_small = None
        self.num_vace = 0
        vace_trees = []
        if vace is not None:
            self.num_vace = len(self.vace_cfg.vace_layers)
            self.vace_small = self._resident_part(vace, ("blocks", "after_proj"))
            vace_trees = [{**_prefixed("block", block_tree(b)),
                           **_prefixed("after", block_tree(a))}
                          for b, a in zip(vace.blocks, vace.after_proj)]

        if resident_blocks is None:
            budget = (hbm_budget_gb - activation_headroom_gb) * 1e9
            budget -= small_bytes * 2             # small + its working copies
            # the slots in flight beside the one computed, and one spare
            budget -= (prefetch_depth + 2) * per_block
            resident_blocks = int(budget // per_block)
        # explicit values are clamped too: a resident count above N would
        # leave blocks that no schedule position covers
        resident_blocks = max(0, min(n, resident_blocks))
        self.resident_blocks = resident_blocks

        # trunk blocks [0, R) on the device, [R, N) in the host store
        self.resident: List[Dict[str, torch.Tensor]] = []
        self.streamed_host = []
        pack_cache: Dict = {}

        def store(src, stack):
            """One streamed block converted and packed into its host buffer."""
            tree = convert(src, stack)
            # de-duplicate aliased source tensors only: a converted tree's
            # memory is freed after packing and may be reused by the next
            same = tree.keys() == src.keys() and all(tree[k] is v for k, v in src.items())
            return pack_host_block(tree, pin, pack_cache if same else None,
                                   self.store_seconds)

        for i, src in enumerate(trees):
            if i < resident_blocks:
                self.resident.append({k: v.to(self.device)
                                      for k, v in convert(src, n).items()})
            else:
                self.streamed_host.append(store(src, n))
        del trees

        self.vace_resident_blocks = None
        self.vace_streamed_host = None
        if vace is not None:
            vace_bytes = self.num_vace * tree_bytes(convert(vace_trees[0], self.num_vace))
            spare = ((hbm_budget_gb - activation_headroom_gb) * 1e9
                     - resident_blocks * per_block - small_bytes * 2
                     - (prefetch_depth + 2) * per_block)
            if spare >= vace_bytes and resident_blocks == n:
                self.vace_resident_blocks = [
                    {k: v.to(self.device) for k, v in convert(t, self.num_vace).items()}
                    for t in vace_trees]
            else:
                self.vace_streamed_host = [store(t, self.num_vace) for t in vace_trees]
        del vace_trees

        self._shells: Dict = {}
        self.ring = None
        items = self.streamed_host + (self.vace_streamed_host or [])
        if items:
            self.ring = SlotRing(prefetch_depth + 1, max(b.buf.numel() for b in items),
                                 self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.store_seconds["build_s"] = time.perf_counter() - t_start

    def _resident_part(self, module: nn.Module, drop) -> nn.Module:
        """`module` without its block lists, on the device: sharing the
        source's tensors where nothing changes, else a copy (the source
        module is left as it was)."""
        part = _without(module, drop)
        # (a quantised part may hold buffers only)
        devices = {t.device for t in part.state_dict().values() if t is not None}
        if self.mode == "bf16" or devices != {self.device}:
            part = copy.deepcopy(part)
        if self.mode == "bf16":
            part = part.to(torch.bfloat16)
        return part.to(self.device)

    # ------------------------------------------------------------------
    # walk schedule
    # ------------------------------------------------------------------

    def build_schedule(self, use_vace: bool) -> List[Tuple[str, int]]:
        """Program-order schedule: trunk block j at position j; VACE block i
        right after trunk layer vace_layers[i]. Inference and training walk
        the same one."""
        schedule: List[Tuple[str, int]] = []
        vace_layers = self.vace_cfg.vace_layers if use_vace else ()
        vi = 0
        for j in range(self.num_layers):
            schedule.append(("trunk", j))
            if vi < len(vace_layers) and vace_layers[vi] == j:
                schedule.append(("vace", vi))
                vi += 1
        return schedule

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host-made tensor to the device without a host wait (through a
        pinned staging copy on a card)."""
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _run(self, cfg: WanDiTConfig, prefix: str, tree, x, ctx, t_mod, cos, sin):
        """One block on its tensors: `prefix` "block" for a trunk tree, ""
        for a VACE tree (its names carry `block.` / `after.`)."""
        key = (cfg, tuple((k, v.dtype) for k, v in tree.items()))
        shell = self._shells.get(key)
        named = _prefixed(prefix, tree) if prefix else tree
        if shell is None:
            shell = self._shells[key] = _shell(cfg, named)
        return functional_call(shell, named, (x, ctx, t_mod, cos, sin), strict=True)

    def _embed(self, latents, timestep, context, clip_feature, y, rope_indices):
        small, cfg = self.small, self.cfg
        t, t_mod = time_embed(small, timestep)
        x, ctx = image_inputs(small, latents, text_embed(small, context), clip_feature, y)
        tokens, grid, _ = assemble_tokens(small, x)
        cos, sin = assemble_freqs_grid(cfg.head_dim, *grid, rope_indices)
        return tokens, ctx, t, t_mod, self._to_device(cos), self._to_device(sin), grid

    def _vace_embed(self, vace_context, tokens):
        vs = self.vace_small
        c, _ = patchify(vs.patch_embedding, vace_context, self.vace_cfg.patch_size)
        return vs.before_proj(pad_rows(c, tokens.shape[1])) + tokens

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    @torch.no_grad()
    def forward(self, latents, timestep, context, vace_context=None, vace_scale=1.0,
                clip_feature=None, y=None, rope_indices=None, want_residual: bool = False,
                layer_gate=None):
        """The DiT forward with streamed blocks: the arithmetic of
        `wan_dit_forward_with_residual` (only the independent VACE chain's
        walk order differs). layer_gate: optional (num_layers, B) keep-gate
        of skip-layer guidance, applied as `run_blocks` applies it. Returns
        (velocity, t_mod, residual or None)."""
        use_vace = vace_context is not None and self.vace_cfg is not None
        if vace_context is not None and self.vace_cfg is None:
            raise ValueError("VACE inputs reached a streamed DiT that holds no VACE "
                             "branch of its own")
        cfg = self.cfg
        tokens, ctx, t, t_mod, cos, sin, grid = self._embed(
            latents, timestep, context, clip_feature, y, rope_indices)
        c = self._vace_embed(vace_context, tokens) if use_vace else None
        scale = None
        if use_vace:
            # made as `run_blocks` makes it (on the host), without a host wait
            scale = self._to_device(torch.tensor(float(vace_scale), dtype=tokens.dtype))

        schedule = self.build_schedule(use_vace)
        host_items = []
        for kind, idx in schedule:
            if kind == "trunk" and idx >= self.resident_blocks:
                host_items.append(self.streamed_host[idx - self.resident_blocks])
            elif kind == "vace" and self.vace_streamed_host is not None:
                host_items.append(self.vace_streamed_host[idx])
        queue = (PrefetchQueue(host_items, self.ring, self.prefetch_depth, self.overlap)
                 if host_items else None)

        bcfg = self.vace_cfg.block_cfg() if use_vace else None
        x = tokens
        for kind, idx in schedule:
            if kind == "trunk":
                if idx < self.resident_blocks:
                    tree = self.resident[idx]
                    x_next = self._run(cfg, "block", tree, x, ctx, t_mod, cos, sin)
                else:
                    slot, tree = queue.pop()
                    x_next = self._run(cfg, "block", tree, x, ctx, t_mod, cos, sin)
                    queue.done(slot)
                if layer_gate is not None:
                    x_next = x + layer_gate[idx].to(x.dtype)[:, None, None] * (x_next - x)
                x = x_next
            else:
                if self.vace_resident_blocks is not None:
                    c, hint = self._run(bcfg, "", self.vace_resident_blocks[idx],
                                        c, ctx, t_mod, cos, sin)
                else:
                    slot, tree = queue.pop()
                    c, hint = self._run(bcfg, "", tree, c, ctx, t_mod, cos, sin)
                    queue.done(slot)
                x = x + hint.to(x.dtype) * scale

        residual = x - tokens if want_residual else None
        out = unpatchify(head(self.small, x, t), grid, cfg.patch_size, cfg.out_dim)
        return out, t_mod, residual

    @torch.no_grad()
    def t_mod_only(self, timestep):
        """TeaCache probe: t_mod of the step."""
        return time_embed(self.small, timestep)[1]

    @torch.no_grad()
    def skip_forward(self, latents, timestep, context, residual, y=None):
        """TeaCache replay: the cached trunk residual added to the step's
        tokens, then the head; no block is touched. `context` is taken for
        the signature of `forward` and not read."""
        del context
        cfg = self.cfg
        t, _ = time_embed(self.small, timestep)
        latents, _ = image_inputs(self.small, latents, None, y=y)
        tokens, grid, _ = assemble_tokens(self.small, latents)
        return unpatchify(head(self.small, tokens + residual, t), grid, cfg.patch_size,
                          cfg.out_dim)

    # diagnostics ------------------------------------------------------

    def resident_block(self, idx: int) -> Dict[str, torch.Tensor]:
        """One resident trunk block's tensors."""
        if not 0 <= idx < self.resident_blocks:
            raise IndexError(f"block {idx} is not resident")
        return self.resident[idx]

    def plan_summary(self) -> dict:
        streamed = sum(tree_bytes(b) for b in self.streamed_host)
        if self.vace_streamed_host is not None:
            streamed += sum(tree_bytes(b) for b in self.vace_streamed_host)
        resident = sum(tree_bytes(t) for t in self.resident)
        if self.vace_resident_blocks is not None:
            resident += sum(tree_bytes(t) for t in self.vace_resident_blocks)
        return {
            "mode": self.mode,
            "num_layers": self.num_layers,
            "resident_blocks": self.resident_blocks,
            "vace_resident": self.vace_resident_blocks is not None,
            "resident_gb": resident / 1e9,
            "streamed_gb_per_pass": streamed / 1e9,
        }
