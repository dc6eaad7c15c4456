"""Ring attention over torch.distributed.

Counterpart of `video_styler_tpu/parallel/ring.py`: q stays on its rank
while the k/v blocks travel round the sp group (`batch_isend_irecv` to the
next rank, from the previous; the next block is in flight while the current
one is computed), and each rank accumulates its rows' attention over every
block.

The JAX body keeps fp32 scores of a whole block (`_ring_body`, :31-62). At
7,410 x 7,410 queries and keys and 40 heads that is 8.8 GB a block, so on
the card a block is K1 with its stats output instead: o_i (bf16) and the
base-2 log-sum-exp L2_i of each row, merged in fp32 as
o = sum_i 2^(L2_i - L2) o_i with L2 = log2 sum_i 2^(L2_i). On the CPU a
block is the JAX body's own online softmax (`ring_step_plain`).

Unlike Ulysses there is no head-count rule. `kv_valid` (absent from the JAX
ring) masks the padding of a sequence that does not divide sp: a block
keeps its real keys only, and a block of padding alone is skipped.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import attention
from ..ops.flash_attention import _flash_forward


def ring_step_plain(state, q, k, v, scale: float):
    """One block of the JAX body's online softmax in fp32; state (o, m, l)
    with o (B, N, Sq, D), m and l (B, N, Sq), or None before the first."""
    qf = q.float() * scale
    s = torch.einsum("bqnd,bknd->bnqk", qf, k.float())
    if state is None:
        m_new = s.amax(dim=-1)
        p = torch.exp(s - m_new[..., None])
        return (torch.einsum("bnqk,bknd->bnqd", p, v.float()), m_new, p.sum(dim=-1))
    o, m, l = state
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (o * corr[..., None] + torch.einsum("bnqk,bknd->bnqd", p, v.float()),
            m_new, l * corr + p.sum(dim=-1))


def ring_step_kernel(state, q, k, v, scale: float):
    """One block through K1 with stats, merged into state (o (B, Sq, N, D)
    fp32, L2 (B, N, Sq)) by the blocks' log-sum-exps."""
    o_i, l2_i = _flash_forward(q, k, v, scale, with_stats=True)
    if state is None:
        return o_i.float(), l2_i
    o, l2 = state
    l2_new = torch.logaddexp2(l2, l2_i)
    w_old = torch.exp2(l2 - l2_new).transpose(1, 2)[..., None]   # (B, Sq, N, 1)
    w_new = torch.exp2(l2_i - l2_new).transpose(1, 2)[..., None]
    return o * w_old + o_i.float() * w_new, l2_new


def ring_step(state, q, k, v, scale: float):
    """K1 with stats on a CUDA tensor, the JAX body on a CPU tensor."""
    return (ring_step_kernel if q.is_cuda else ring_step_plain)(state, q, k, v, scale)


def ring_finish(state, dtype) -> torch.Tensor:
    o, *rest = state
    if len(rest) == 1:                                           # the kernel's merge
        return o.to(dtype)
    return (o / rest[1][..., None]).transpose(1, 2).to(dtype)


def ring_body(q, blocks: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              scale: Optional[float] = None) -> torch.Tensor:
    """One rank's work: its (B, Sq, N, D) queries against each (k, v) block
    in turn, as the ring hands them over."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    state = None
    for k, v in blocks:
        state = ring_step(state, q, k, v, scale)
    return ring_finish(state, q.dtype)


def ring_body_plain(q, blocks, scale: Optional[float] = None) -> torch.Tensor:
    """`ring_body` through the JAX body on any device."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    state = None
    for k, v in blocks:
        state = ring_step_plain(state, q, k, v, scale)
    return ring_finish(state, q.dtype)


def _pass_on(k, v, group, me: int, n: int):
    """Start sending k, v to the next rank of the group and receiving the
    previous rank's; returns a function that waits and gives the received
    pair. gloo's send and receive read and write host memory only (a CUDA
    pointer fails in its TCP transport), so over gloo a CUDA block goes
    through host copies."""
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    device = k.device
    if k.is_cuda and dist.get_backend(group) == "gloo":
        k, v = k.cpu(), v.cpu()
    k_in, v_in = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
           dist.P2POp(dist.irecv, k_in, prv, group), dist.P2POp(dist.irecv, v_in, prv, group)]
    reqs = dist.batch_isend_irecv(ops)

    def received():
        for r in reqs:
            r.wait()
        return k_in.to(device), v_in.to(device)
    return received


def ring_attention(q, k, v, ctx, scale: Optional[float] = None,
                   kv_valid: Optional[int] = None, axis: str = "sp"):
    """q, k, v: this rank's (B, S/sp, N, D) rows; kv_valid: the count of
    real keys of the whole sequence. At sp = 1 it is `attention`."""
    n = ctx.axis_size(axis)
    if n == 1:
        return attention(q, k, v, scale=scale, kv_valid=kv_valid)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    group, me = ctx.group(axis), ctx.local_rank(axis)
    rows = k.shape[1]
    k, v = k.contiguous(), v.contiguous()
    state = None
    for step in range(n):
        pending = _pass_on(k, v, group, me, n) if step < n - 1 else None
        owner = (me - step) % n                       # whose rows this block holds
        real = rows if kv_valid is None else min(max(kv_valid - owner * rows, 0), rows)
        if real:
            state = ring_step(state, q, k[:, :real], v[:, :real], scale)
        if pending is not None:
            k, v = pending()
    return ring_finish(state, q.dtype)
