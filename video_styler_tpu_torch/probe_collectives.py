"""Probe of the card for the multi-GPU path: which gloo collectives take
CUDA tensors, and at which row offsets K1 keeps a query row's bits.

    python -m video_styler_tpu_torch.probe_collectives      # one GPU

Two ranks share cuda:0 over gloo (NCCL refuses two ranks on one device),
spawned by `parallel.run_local`, one session per collective so that a
refusal stops only its own: all_to_all_single, all_gather_into_tensor,
broadcast, all_reduce, an FSDP2 gather (`shard_params_fsdp` + `gathered`)
against the unsharded layer, and send/recv. Each is held against the
values the ranks sent. Then K1 on one rank's query rows of a cross-
attention (rows from an offset, 512 keys) against the same rows of one
call over all rows: the offsets a sequence split can give. Prints one JSON
line.
"""
from __future__ import annotations

import json
import os
import tempfile

COLLECTIVES = ("all_to_all_single", "all_gather_into_tensor", "broadcast", "all_reduce",
               "fsdp2_gather", "send_recv")


def _try(name: str):
    """One collective on CUDA tensors, on both ranks: True if every rank
    received what was sent."""
    import torch
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())

    def filled(v, size=1024):
        return torch.full((size,), float(v), device=dev, dtype=torch.bfloat16)

    if name == "all_to_all_single":
        out = torch.empty(n * 1024, device=dev, dtype=torch.bfloat16)
        dist.all_to_all_single(out, torch.cat([filled(10 * r + j) for j in range(n)]))
        return bool(torch.equal(out, torch.cat([filled(10 * j + r) for j in range(n)])))
    if name == "all_gather_into_tensor":
        out = torch.empty(n * 1024, device=dev, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, filled(r))
        return bool(torch.equal(out, torch.cat([filled(j) for j in range(n)])))
    if name == "broadcast":
        x = filled(r + 5)
        dist.broadcast(x, src=0)
        return bool(torch.equal(x, filled(5)))
    if name == "all_reduce":
        x = filled(r + 1)
        dist.all_reduce(x)
        return bool(torch.equal(x, filled(n * (n + 1) // 2)))
    if name == "fsdp2_gather":
        from torch import nn
        from .parallel import gathered, make_mesh, shard_params_fsdp
        torch.manual_seed(0)
        model = nn.Module()
        model.blocks = nn.ModuleList([nn.Linear(256, 256)]).to(dev, torch.bfloat16)
        x = torch.randn(8, 256, device=dev, dtype=torch.bfloat16)
        want = model.blocks[0](x)
        shard_params_fsdp(model, make_mesh(1, n, 1, device_type="cuda"))
        with torch.no_grad(), gathered(model, model.blocks[0]):
            blk = model.blocks[0]
            got = torch.nn.functional.linear(x, blk.weight, blk.bias)
        return bool(torch.equal(got, want))
    if name == "send_recv":
        buf = torch.empty(1024, device=dev, dtype=torch.bfloat16)
        ops = [dist.P2POp(dist.isend, filled(r), (r + 1) % n),
               dist.P2POp(dist.irecv, buf, (r - 1) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bool(torch.equal(buf, filled((r - 1) % n)))
    raise ValueError(name)


def k1_row_offsets(offsets=(4, 8, 2340, 2344), rows: int = 4688, heads: int = 12):
    """Max abs difference between K1 on the rows from each offset alone and
    the same rows of one call over all rows (cross-attention to 512 keys)."""
    import torch
    from .ops import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(1, s, heads, 128, generator=gen, device="cuda").to(torch.bfloat16)
               for s in (rows, 512, 512))
    whole = fa.flash_attention(q, k, v)
    return {o: (fa.flash_attention(q[:, o:].contiguous(), k, v).float()
                - whole[:, o:].float()).abs().max().item() for o in offsets}


def main():
    import torch
    from .ops import cuda_build
    from .parallel import run_local
    if not torch.cuda.is_available():
        raise SystemExit("probe_collectives: no CUDA device")
    cuda_build.build_all()
    store = tempfile.mkdtemp(prefix="probe-")
    gloo_cuda = {}
    for name in COLLECTIVES:
        try:
            ok = run_local(_try, 2, "gloo", os.path.join(store, name), name,
                           device="cuda:0", timeout_s=120)
            gloo_cuda[name] = "exact" if all(ok) else "wrong values"
        except RuntimeError as e:
            gloo_cuda[name] = "refused: " + str(e).strip().splitlines()[-1][:160]
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          device=torch.cuda.get_device_name(0), gloo_cuda_tensors=gloo_cuda,
                          k1_row_offset_max_abs_diff=k1_row_offsets())), flush=True)


if __name__ == "__main__":
    main()
