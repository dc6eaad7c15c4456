"""LoRA training over a streamed (bigger than the card) Wan trunk and VACE.

Counterpart of `video_styler_tpu/trainers/streaming_train.py` (the
reference trains Wan-14B LoRA on small cards with per-block gradient
checkpointing, activations offloaded to the host, and weights streamed per
layer). On the port's `WanBlockStreamer`:

  * the frozen blocks stay where the streamer keeps them (resident, or in
    its pinned host store) and stream through its ring of device slots for
    the forward walk, and again, in reverse order, for the backward walk;
  * boundary activations are kept one of two ways:
      - activation_ckpt="device": every k-th (x, c) boundary of the walk
        (k = ceil(sqrt(n)) or `segment`) stays on the card; the reverse walk
        takes the segments last to first, recomputes the inputs of a
        segment's items from its boundary (streaming those blocks once
        more), then runs the items' backward in reverse, the VACE backward
        interleaved with the trunk's;
      - activation_ckpt="host": every boundary is copied to pinned host
        memory on a side stream as the forward walk passes it, and brought
        back one at a time in the reverse walk (O(1) activations on the
        card); the VACE chain's backward follows the trunk's;
      - "auto" picks "device" where the JAX arithmetic of the stash
        (`_pick_ckpt`) fits `device_stash_budget_gb`, else "host";
  * each block's backward recomputes the block from its boundary input with
    autograd on, then `torch.autograd.grad` of its output with respect to
    (its input, its LoRA A and B), seeded with the carry's cotangent. With
    sub_remat=True (the default) self-attention, cross-attention and the FFN
    each run under their own `torch.utils.checkpoint`, with the dequantise
    and LoRA merge inside the stage: the merged weights and one sublayer's
    activations exist at a time;
  * a block from an int8 or int4 store is dequantised to the activations'
    dtype before it runs (the JAX `dequantize_params` values), the LoRA
    merged as `lora_train.apply_lora` merges it: W' = (W.f32 + scale *
    (B @ A).f32) rounded to W's dtype. The int8 GEMMs of the inference path
    have no backward; the LoRA gradients here are exact.

The JAX walk holds a segment's weights between its recompute and its
backward. The port's ring releases slots in walk order, so a segment's
blocks (all but its last) are streamed once for the recompute and once more
for the backward: the reverse walk copies up to twice the bytes of the
forward walk, and the card holds the ring's `depth + 1` slots, not k.

LoRA dicts are the port's per-block layout (`trainers.lora_train`): trunk
paths `blocks.{i}.<linear>` of the `WanDiT`, VACE paths `blocks.{i}.<linear>`
of the `WanVace`; the gradients come back in the same layout (zeros where a
block had no contribution). With `vace_lora=None` the VACE chain is not
walked backward (nothing upstream of it trains).
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models import wan_dit as M
from ..models.wan_streaming import WanBlockStreamer
from ..ops.quant import _dequant_int4_g, unpack_int4
from ..parallel.streaming import PrefetchQueue, tree_bytes
from .lora_train import LoRA

CKPT_MODES = ("auto", "device", "host")
STAGES = ("sa", "ca", "ff")
# the tensors of a block each sub-remat stage reads
_STAGE_PREFIXES = {"sa": ("self_attn.", "modulation"), "ca": ("cross_attn.", "norm3."),
                   "ff": ("ffn.", "modulation")}


class _StageRunner(nn.Module):
    """A block (and a VACE block's `after` projection) on meta tensors, for
    `functional_call`: stage "all" runs the block (and the projection),
    "sa" / "ca" / "ff" one residual sublayer of `dit_block`, "after" the
    projection alone. The sublayers are `dit_block`'s own expressions."""

    def __init__(self, cfg: M.WanDiTConfig, with_after: bool):
        super().__init__()
        self.cfg = cfg
        self.block = M.DiTBlock(cfg)
        self.after = M.Linear(cfg.dim, cfg.dim) if with_after else None

    def forward(self, stage: str, x, ctx, t_mod, cos, sin):
        p, cfg = self.block, self.cfg
        if stage == "all":
            x = M.dit_block(p, x, ctx, t_mod, cos, sin, cfg)
            return x if self.after is None else (x, self.after(x))
        if stage == "after":
            return self.after(x)
        if stage == "ca":
            return x + M.cross_attention(p.cross_attn,
                                         M.layer_norm(x, p.norm3.scale, p.norm3.bias, cfg.eps),
                                         ctx, cfg.num_heads, cfg.eps, cfg.has_image_input)
        mods = M._split_mod(p.modulation, t_mod, 6)
        shift, scale, gate = mods[:3] if stage == "sa" else mods[3:]
        h = M.modulate(M.layer_norm(x, eps=cfg.eps), shift, scale)
        if stage == "sa":
            return x + gate * M.self_attention(p.self_attn, h, cos, sin, cfg.num_heads,
                                               cfg.eps)
        return x + gate * p.ffn(h)


def dense_tree(tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """A block tree with every quantised linear ({p.w_q | p.w_q4, p.w_scale,
    p.b}) as a plain one ({p.weight (out, in) in `dtype`, p.bias}), with the
    JAX `dequant_leaf` values; other tensors pass through."""
    out = {}
    for name, t in tree.items():
        path, _, leaf = name.rpartition(".")
        if leaf in ("w_q", "w_q4"):
            scale = tree[f"{path}.w_scale"]
            if leaf == "w_q4":
                if scale.dim() == t.dim() + 1:
                    w = _dequant_int4_g(t, scale)
                else:
                    w = unpack_int4(t).float() * scale
            else:
                w = t.float() * scale
            out[f"{path}.weight"] = w.to(dtype).t()
            if f"{path}.b" in tree:
                out[f"{path}.bias"] = tree[f"{path}.b"]
        elif leaf == "w_scale" or (leaf == "b" and (f"{path}.w_q" in tree
                                                    or f"{path}.w_q4" in tree)):
            continue
        else:
            out[name] = t
    return out


def merge_lora(tree: Dict[str, torch.Tensor], lora: Dict[str, Tuple], scale: float
               ) -> Dict[str, torch.Tensor]:
    """`tree` with W' = (W.f32 + scale * (B @ A).f32).to(W.dtype) on each
    linear `{path}.weight` that `lora` ({path: (A, B)}) names."""
    out = dict(tree)
    for path, (a, b) in lora.items():
        w = tree[f"{path}.weight"]
        out[f"{path}.weight"] = (w.float() + scale * (b.float() @ a.float())).to(w.dtype)
    return out


def _slice(lora: Optional[LoRA], idx: int) -> Dict[str, Tuple]:
    """Block idx's factors of a per-block LoRA, keyed by their linear's
    name in `_StageRunner` (`block.self_attn.q`, ...)."""
    if lora is None:
        return {}
    head = f"blocks.{idx}."
    return {"block." + name[len(head):]: (ab["A"], ab["B"]) for name, ab in lora.items()
            if name.startswith(head)}


class StreamingTrainer:
    """LoRA gradients over a `WanBlockStreamer`'s trunk (and VACE branch).

    activation_ckpt: "device", "host" or "auto" (above); segment: the
    device mode's k (None: ceil(sqrt(n))); sub_remat: each sublayer under
    its own checkpoint in the block backward."""

    def __init__(self, streamer: WanBlockStreamer, lora_scale: float = 1.0,
                 activation_ckpt: str = "auto", segment: Optional[int] = None,
                 device_stash_budget_gb: float = 8.0, sub_remat: bool = True):
        if activation_ckpt not in CKPT_MODES:
            raise ValueError(f"unknown activation_ckpt {activation_ckpt!r}")
        self.s = streamer
        self.scale = lora_scale
        self.activation_ckpt = activation_ckpt
        self.segment = segment
        self.device_stash_budget = device_stash_budget_gb * 1e9
        self.sub_remat = sub_remat
        self._shells: Dict = {}
        self._side = None            # the host mode's copy stream
        self._pinned: Dict = {}      # host mode: reused pinned buffers
        self.last_ckpt = None        # (mode, k) of the last step
        self.bytes_copied = 0        # bytes the ring copied in the last step
        self.pin_seconds = 0.0       # host mode: spent allocating pinned buffers

    # ---------------- blocks ----------------

    def _cfg(self, kind: str) -> M.WanDiTConfig:
        return self.s.cfg if kind == "trunk" else self.s.vace_cfg.block_cfg()

    def _shell(self, kind: str) -> _StageRunner:
        if kind not in self._shells:
            with torch.device("meta"):
                self._shells[kind] = _StageRunner(self._cfg(kind), kind == "vace")
        return self._shells[kind]

    def _named(self, kind: str, tree) -> Dict[str, torch.Tensor]:
        """The block's tensors under the runner's names."""
        return {f"block.{k}": v for k, v in tree.items()} if kind == "trunk" else dict(tree)

    def _run_stage(self, kind: str, stage: str, raw, lora: Dict[str, Tuple], x, ctx, t_mod,
                   cos, sin):
        """Dequantise and merge the tensors `raw` (the runner's names), then
        run `stage`."""
        named = merge_lora(dense_tree(raw, x.dtype), lora, self.scale)
        return functional_call(self._shell(kind), named, (stage, x, ctx, t_mod, cos, sin),
                               strict=False)

    def block_forward(self, kind: str, idx: int, tree, lora: Optional[LoRA], x, ctx, t_mod,
                      cos, sin):
        """One block's forward (a VACE block: (c, hint)), no autograd."""
        with torch.no_grad():
            return self._run_stage(kind, "all", self._named(kind, tree),
                                   _slice(lora, idx), x, ctx, t_mod, cos, sin)

    def _block_graph(self, kind: str, raw, lora: Dict[str, Tuple], x, ctx, t_mod, cos, sin):
        if not self.sub_remat:
            return self._run_stage(kind, "all", raw, lora, x, ctx, t_mod, cos, sin)
        for stage in STAGES:
            pre = tuple("block." + p for p in _STAGE_PREFIXES[stage])
            sub = {k: v for k, v in raw.items() if k.startswith(pre)}
            sub_lora = {k: v for k, v in lora.items() if k.startswith(pre)}
            x = checkpoint(self._stage_fn(kind, stage, sub, sub_lora), x, ctx, t_mod, cos,
                           sin, *[t for ab in sub_lora.values() for t in ab],
                           use_reentrant=False)
        if kind == "trunk":
            return x
        sub = {k: v for k, v in raw.items() if k.startswith("after.")}
        hint = checkpoint(self._stage_fn(kind, "after", sub, {}), x, ctx, t_mod, cos, sin,
                          use_reentrant=False)
        return x, hint

    def _stage_fn(self, kind, stage, sub, sub_lora):
        names = list(sub_lora)

        def fn(x, ctx, t_mod, cos, sin, *factors):
            lora = {n: (factors[2 * i], factors[2 * i + 1]) for i, n in enumerate(names)}
            return self._run_stage(kind, stage, sub, lora, x, ctx, t_mod, cos, sin)
        return fn

    def block_backward(self, kind: str, idx: int, tree, lora: Optional[LoRA], x_in, ctx,
                       t_mod, cos, sin, cotangents):
        """Recompute one block from its input and differentiate it: ->
        (d input, {lora name: (dA, dB)}). cotangents: (dx,) for a trunk
        block, (d_c, d_hint) for a VACE block."""
        named_lora = _slice(lora, idx)
        factors = [t for ab in named_lora.values() for t in ab]
        x = x_in.detach().requires_grad_(True)
        with torch.enable_grad():
            out = self._block_graph(kind, self._named(kind, tree), named_lora, x, ctx, t_mod,
                                    cos, sin)
            outs = (out,) if kind == "trunk" else out
            grads = torch.autograd.grad(outs, [x] + factors, cotangents)
        head = f"blocks.{idx}."
        dlora = {head + n[len("block."):]: (grads[1 + 2 * i], grads[2 + 2 * i])
                 for i, n in enumerate(named_lora)}
        return grads[0], dlora

    # ---------------- walks ----------------

    def _host_item(self, kind: str, idx: int):
        s = self.s
        if kind == "trunk":
            return None if idx < s.resident_blocks else s.streamed_host[idx - s.resident_blocks]
        return None if s.vace_resident_blocks is not None else s.vace_streamed_host[idx]

    def _queue(self, order) -> Optional[PrefetchQueue]:
        """A prefetch queue over the streamed blocks of a walk, in its order."""
        items = [it for it in (self._host_item(k, i) for k, i in order) if it is not None]
        if not items:
            return None
        return PrefetchQueue(items, self.s.ring, self.s.prefetch_depth, self.s.overlap)

    def _fetch(self, kind: str, idx: int, queue):
        """-> (slot or None, tree): a resident block's tensors, or the next
        streamed one from the walk's queue."""
        s = self.s
        if kind == "trunk" and idx < s.resident_blocks:
            return None, s.resident[idx]
        if kind == "vace" and s.vace_resident_blocks is not None:
            return None, s.vace_resident_blocks[idx]
        return queue.pop()

    @staticmethod
    def _release(queue, slot):
        if slot is not None:
            queue.done(slot)

    def _pick_ckpt(self, schedule, tokens, c) -> Tuple[str, int]:
        """-> ("device" | "host", k), by the JAX arithmetic: ceil(n/k) (x, c)
        boundary pairs, one segment of recomputed inputs and k + depth + 1
        blocks of weights against the stash budget."""
        k = self.segment or max(1, int(math.ceil(math.sqrt(len(schedule)))))
        if self.activation_ckpt != "auto":
            return self.activation_ckpt, k
        xb = tokens.numel() * tokens.element_size()
        cb = 0 if c is None else c.numel() * c.element_size()
        per_block = tree_bytes(self.s.streamed_host[0]) if self.s.streamed_host else 0
        need = (math.ceil(len(schedule) / k) * (xb + cb) + k * max(xb, cb)
                + (k + self.s.prefetch_depth + 1) * per_block)
        return ("device" if need <= self.device_stash_budget else "host"), k

    def _stash(self, key, t: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Copy `t` to (reused) pinned host memory on the side stream."""
        if t.device.type != "cuda":
            return t.clone(), None
        if self._side is None:
            self._side = torch.cuda.Stream(t.device)
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            t0 = time.perf_counter()
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.pin_seconds += time.perf_counter() - t0
        self._side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self._side):
            buf.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        t.record_stream(self._side)
        return buf, done

    def _unstash(self, entry, device) -> torch.Tensor:
        buf, done = entry
        if done is None:
            return buf
        torch.cuda.current_stream(device).wait_event(done)
        return buf.to(device, non_blocking=True)

    # ---------------- the step ----------------

    def loss_and_grads(self, latents_noisy, timestep, context, target, vace_context=None,
                       vace_scale: float = 1.0, trunk_lora: Optional[LoRA] = None,
                       vace_lora: Optional[LoRA] = None, loss_weight: float = 1.0):
        """-> (loss, trunk LoRA grads or None, VACE LoRA grads or None).

        The flow-match MSE of the velocity against `target` (noise -
        latents), times `loss_weight` (the timestep's weight)."""
        s = self.s
        copied = s.ring.bytes_copied if s.ring is not None else 0
        use_vace = vace_context is not None and s.vace_cfg is not None
        bwd_vace = use_vace and vace_lora is not None
        need_bwd = trunk_lora is not None or bwd_vace
        with torch.no_grad():
            tokens, ctx, t, t_mod, cos, sin, grid = s._embed(latents_noisy, timestep,
                                                             context, None, None, None)
            c = s._vace_embed(vace_context, tokens) if use_vace else None
        scale = (torch.tensor(float(vace_scale), dtype=tokens.dtype).to(tokens.device)
                 if use_vace else None)
        schedule = s.build_schedule(use_vace)
        ckpt, seg_k = self._pick_ckpt(schedule, tokens, c)
        self.last_ckpt = (ckpt, seg_k)
        # trunk blocks before the first item that trains need no backward
        first = (0 if trunk_lora is not None else
                 min((si for si, (k, _) in enumerate(schedule) if k == "vace"),
                     default=len(schedule)))

        saved: Dict[int, Tuple] = {}
        stash: Dict[int, Tuple] = {}
        queue = self._queue(schedule)
        x = tokens
        with torch.no_grad():
            for si, (kind, idx) in enumerate(schedule):
                if need_bwd and ckpt == "device" and si % seg_k == 0:
                    saved[si] = (x, c)
                if need_bwd and ckpt == "host" and (
                        (kind == "trunk" and si >= first) or (kind == "vace" and bwd_vace)):
                    stash[si] = self._stash(si, x if kind == "trunk" else c)
                slot, tree = self._fetch(kind, idx, queue)
                if kind == "trunk":
                    x = self.block_forward(kind, idx, tree, trunk_lora, x, ctx, t_mod, cos,
                                           sin)
                else:
                    c, hint = self.block_forward(kind, idx, tree, vace_lora, c, ctx, t_mod,
                                                 cos, sin)
                    x = x + hint.to(x.dtype) * scale
                self._release(queue, slot)

        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = M.unpatchify(M.head(s.small, xr, t), grid, s.cfg.patch_size, s.cfg.out_dim)
            loss = torch.mean(torch.square(out.float() - target.float())) * loss_weight
            dx = torch.autograd.grad(loss, xr)[0] if need_bwd else None
        loss = loss.detach()
        if not need_bwd:
            if s.ring is not None:
                self.bytes_copied = s.ring.bytes_copied - copied
            return loss, None, None

        grads: Dict[str, Dict[str, Tuple]] = {"trunk": {}, "vace": {}}
        walk = dict(ctx=ctx, t_mod=t_mod, cos=cos, sin=sin, scale=scale, first=first,
                    trunk_lora=trunk_lora, vace_lora=vace_lora, bwd_vace=bwd_vace,
                    grads=grads)
        if ckpt == "device":
            self._reverse_device(schedule, seg_k, saved, dx, c, **walk)
        else:
            self._reverse_host(schedule, stash, dx, c, **walk)
        if s.ring is not None:
            self.bytes_copied = s.ring.bytes_copied - copied
        return (loss, _layout(grads["trunk"], trunk_lora), _layout(grads["vace"], vace_lora))

    def _backward_item(self, kind, idx, tree, x_in, dx, d_c, w):
        """One item of a reverse walk: -> (dx, d_c)."""
        if kind == "vace":
            if not w["bwd_vace"]:
                return dx, d_c
            d_hint = (dx * w["scale"].to(dx.dtype)).to(d_c.dtype)
            d_c, dl = self.block_backward(kind, idx, tree, w["vace_lora"], x_in, w["ctx"],
                                          w["t_mod"], w["cos"], w["sin"], (d_c, d_hint))
            w["grads"]["vace"].update(dl)
            return dx, d_c
        dx, dl = self.block_backward(kind, idx, tree, w["trunk_lora"], x_in, w["ctx"],
                                     w["t_mod"], w["cos"], w["sin"], (dx,))
        w["grads"]["trunk"].update(dl)
        return dx, d_c

    def _reverse_device(self, schedule, seg_k, saved, dx, c_final, **w):
        """Segments last to first: recompute the items' inputs from the
        saved boundary (the blocks streamed in walk order), then each item's
        backward in reverse (the blocks streamed again, last first)."""
        starts = list(range(0, len(schedule), seg_k))
        order = []
        for s0 in reversed(starts):
            items = [(si, schedule[si]) for si in range(s0, min(s0 + seg_k, len(schedule)))]
            items = [(si, it) for si, it in items if self._needs_bwd(si, it, w)]
            if not items:
                continue
            last = items[-1][0]
            order.append((s0, [it for si, it in
                               ((si, schedule[si]) for si in range(s0, last))], items))
        queue = self._queue([it for _, fwd, items in order
                             for it in fwd + [it for _, it in reversed(items)]])
        d_c = torch.zeros_like(c_final) if w["bwd_vace"] else None
        for s0, fwd, items in order:
            x_r, c_r = saved.pop(s0)
            inputs = {}
            with torch.no_grad():
                for j, (kind, idx) in enumerate(fwd + [schedule[items[-1][0]]]):
                    si = s0 + j
                    inputs[si] = x_r if kind == "trunk" else c_r
                    if si == items[-1][0]:
                        break
                    slot, tree = self._fetch(kind, idx, queue)
                    if kind == "trunk":
                        x_r = self.block_forward(kind, idx, tree, w["trunk_lora"], x_r, w["ctx"],
                                                 w["t_mod"], w["cos"], w["sin"])
                    else:
                        c_r, hint = self.block_forward(kind, idx, tree, w["vace_lora"], c_r,
                                                       w["ctx"], w["t_mod"], w["cos"], w["sin"])
                        x_r = x_r + hint.to(x_r.dtype) * w["scale"]
                    self._release(queue, slot)
            del x_r, c_r
            for si, (kind, idx) in reversed(items):
                slot, tree = self._fetch(kind, idx, queue)
                dx, d_c = self._backward_item(kind, idx, tree, inputs.pop(si), dx, d_c, w)
                self._release(queue, slot)

    def _needs_bwd(self, si, item, w) -> bool:
        kind = item[0]
        return (w["bwd_vace"] if kind == "vace" else si >= w["first"])

    def _reverse_host(self, schedule, stash, dx, c_final, **w):
        """The trunk's items last to first from their stashed inputs (the
        hint cotangents kept), then the VACE chain last to first."""
        dev = dx.device
        trunk = [(si, it) for si, it in reversed(list(enumerate(schedule)))
                 if it[0] == "trunk" and si >= w["first"]]
        queue = self._queue([it for _, it in trunk])
        d_hints = {}
        vace_pos = {si: idx for si, (k, idx) in enumerate(schedule) if k == "vace"}
        todo = sorted(vace_pos, reverse=True)
        for si, (kind, idx) in trunk:
            while todo and todo[0] > si:
                if w["bwd_vace"]:
                    d_hints[vace_pos[todo[0]]] = dx
                todo.pop(0)
            slot, tree = self._fetch(kind, idx, queue)
            dx, _ = self._backward_item(kind, idx, tree, self._unstash(stash.pop(si), dev), dx,
                                        None, w)
            self._release(queue, slot)
        while todo:
            if w["bwd_vace"]:
                d_hints[vace_pos[todo[0]]] = dx
            todo.pop(0)
        if not w["bwd_vace"]:
            return
        n_vace = len(vace_pos)
        vq = self._queue([("vace", i) for i in reversed(range(n_vace))])
        d_c = torch.zeros_like(c_final)
        sis = sorted(vace_pos)
        for i in reversed(range(n_vace)):
            slot, tree = self._fetch("vace", i, vq)
            c_in = self._unstash(stash.pop(sis[i]), dev)
            _, d_c = self._backward_item("vace", i, tree, c_in, d_hints[i], d_c, w)
            self._release(vq, slot)


def _layout(grads: Dict[str, Tuple], lora: Optional[LoRA]):
    """Per-block gradients -> {name: {"A", "B"}} over every name of `lora`,
    zeros where a block had no contribution."""
    if lora is None:
        return None
    out = {}
    for name, ab in lora.items():
        if name in grads:
            da, db = grads[name]
        else:
            da, db = torch.zeros_like(ab["A"]), torch.zeros_like(ab["B"])
        out[name] = {"A": da.detach(), "B": db.detach()}
    return out
