"""Probe of the host's page-locking for the block store: PyTorch's pinned
allocator against `cudaHostRegister` of a plain allocation.

    python -m video_styler_tpu_torch.probe_pinning [--blocks 24]   # one GPU

The buffer size is one streamed block of the 14B int8 store (a
`WAN_T2V_14B` block drawn on the card, quantised by `host_quantize_int8`
and packed as `pack_host_block` packs it). For each way, `--blocks`
buffers are pinned and filled: seconds to pin, the bytes asked for, the
bytes the pinned allocator reserves (`torch.cuda.host_memory_stats`), the
host's own counters (`/proc/meminfo`, `/proc/self/status`) before, with the
buffers and after they are dropped, and the host-to-device rate from one
of them (median of 5 CUDA-event timed copies). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time

MEMINFO = ("MemAvailable", "Mlocked", "Unevictable", "Shmem", "Committed_AS")
STATUS = ("VmRSS", "VmLck", "VmPin")


def host_counters() -> dict:
    """The host counters in bytes (a field the kernel does not give is left out)."""
    out = {}
    for path, keys in (("/proc/meminfo", MEMINFO), ("/proc/self/status", STATUS)):
        try:
            with open(path) as f:
                for line in f:
                    name, _, rest = line.partition(":")
                    if name in keys:
                        out[name] = int(rest.split()[0]) * 1024
        except OSError:
            pass
    return out


def counters_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if k in before}


def _host_stats(torch) -> dict:
    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):
        return {}
    return {k: v for k, v in stats.items() if "bytes" in k and k.endswith("current")}


def _pin(torch, nbytes: int, method: str):
    if method == "alloc":
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    from .parallel.streaming import pinned_empty
    return pinned_empty(nbytes)


def block_bytes(torch) -> int:
    """The packed bytes of one int8 14B trunk block."""
    from .models.wan_dit import WAN_T2V_14B, DiTBlock
    from .parallel.streaming import block_tree, host_quantize_int8, pack_host_block
    block = DiTBlock(WAN_T2V_14B, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.02)
    tree = host_quantize_int8(block_tree(block), stack=WAN_T2V_14B.num_layers)
    return pack_host_block(tree).buf.numel()


def probe(torch, nbytes: int, blocks: int, method: str) -> dict:
    gc.collect()
    before, stats0 = host_counters(), _host_stats(torch)
    bufs, pin_s = [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        bufs.append(_pin(torch, nbytes, method))
        pin_s.append(time.perf_counter() - t0)
        bufs[-1].fill_(1)
    held, stats1 = host_counters(), _host_stats(torch)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(bufs[0], non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    pinned = all(b.is_pinned() for b in bufs)
    del bufs, dev
    gc.collect()
    dropped, stats2 = host_counters(), _host_stats(torch)
    return dict(method=method, pinned=pinned, requested_bytes=nbytes * blocks,
                pin_s_total=sum(pin_s), pin_s_median=statistics.median(pin_s),
                h2d_gb_per_s=nbytes / statistics.median(times[1:]) / 1e9,
                allocator_held=stats1, allocator_after_drop=stats2, allocator_before=stats0,
                host_delta_held=counters_delta(held, before),
                host_delta_after_drop=counters_delta(dropped, before))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--out", default="chiprun_out/probe_pinning.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_pinning needs a CUDA device")
    nbytes = block_bytes(torch)
    torch.cuda.empty_cache()
    res = dict(card=torch.cuda.get_device_name(0), torch=torch.__version__,
               block_bytes=nbytes, blocks=args.blocks,
               runs=[probe(torch, nbytes, args.blocks, m) for m in ("register", "alloc")])
    line = json.dumps(res)
    print(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
