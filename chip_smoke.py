#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_styler_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # all phases, one card
    python3 chip_smoke.py --frames 73 --steps 1    # the full Ditto clip size

Phases, each printing one JSON line (any failure raises and exits non-zero):
  device     nvidia-smi name and power limit, torch/CUDA versions, the
             kernel build time (every csrc/*.cu, one nvcc each, in parallel)
  kernel     K1 (flash attention, self and cross), K4 (RMSNorm+RoPE) and K5
             (RMSNorm) held against their plain PyTorch versions on the card
             at the Ditto shapes of a 73-frame 480x832 edit (29,640 tokens)
             and of this run's request (--frames, default 9: 4,680 tokens):
             max abs/rel error against the stated tolerance, median kernel
             time over CUDA-event timed runs (L2 flushed before each), plain
             and library times, and the bound from the work and the card's
             data-sheet rates
  reference  the smoke-size pipeline on the card against the same weights
             on the CPU (plain versions), latents and decoded frames
  e2e        one VACE edit at Wan2.1-VACE-14B width (40 DiT + 8 VACE blocks,
             umT5-XXL, Wan2.1 VAE; random bf16 weights from a seed) of a
             480x832 clip: stage times, peak memory, output shape, and each
             kernel's launch count in this run; then the same request again
             under torch.profiler for device time by kernel category
Then the `kernels` summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# DiT token grids (latent frames, H/16, W/16) after the (1, 2, 2) patchify
DITTO_FRAMES = 73            # 73 frames 480x832 -> 29,640 tokens
RUN_FRAMES = 9               # 9 frames 480x832 -> 4,680 tokens
TEXT_LEN = 512


def token_grid(frames: int):
    """DiT token grid of a 480x832 clip: (latent frames, H/16, W/16)."""
    return ((frames - 1) // 4 + 1, 30, 52)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, reps: int, warmup: int = 2):
    """Median CUDA-event time of fn, with L2 flushed before each run."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(torch, got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, scale


def check_kernels(torch, grid, tag):
    """K1 self/cross, K4, K5 at the Ditto 14B widths on this token grid."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid

    f, h, w = grid
    s, n, d = f * h * w, 40, 128
    dm = n * d
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    rows = []
    # tolerance: two bf16 ULPs at the output's largest magnitude (the kernel
    # and the plain version round at the same points; exp2/rsqrt differ in
    # the last fp32 bits, which can move a bf16 rounding by one ULP)
    tol_ulps = 2.0 ** -7

    # K1: self (Sk = S) and cross (Sk = 512 text tokens)
    q = randn(1, s, n, d)
    for kind, sk in (("self", s), ("cross", TEXT_LEN)):
        k = randn(1, sk, n, d)
        v = randn(1, sk, n, d)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        sub = torch.cat([torch.arange(0, min(1024, s)),
                         torch.arange(max(0, s - 1024), s)]).unique().cuda()
        want = fa.flash_attention_plain(q[:, sub], k, v)
        err, scale = max_err(torch, out[:, sub], want)
        tol = tol_ulps * scale
        flops = 4.0 * n * s * sk * d
        nbytes = 2.0 * (2 * s * dm + 2 * sk * dm)
        b_ms, b_by = bound(flops, nbytes)
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v),
                           reps=3, warmup=1)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         reps=10)
        rows.append(dict(
            name=f"K1 flash_attention {kind} S={s} Sk={sk} N={n} D={d} [{tag}]",
            kernel="K1", route="cuda",
            source="video_styler_tpu_torch/csrc/flash_attention.cu",
            replaces="video_styler_tpu/ops/flash_attention.py:213",
            max_abs_err=err, max_rel_err=err / scale, tol=tol,
            checked_rows=int(sub.numel()),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, tflops=flops / ms / 1e9))
        del k, v, out, want

    # K4: RMSNorm + RoPE on q and k in one launch
    cos, sin = assemble_freqs_grid(d, f, h, w, device="cuda")
    xq, xk = randn(1, s, dm), randn(1, s, dm) * 0.7
    wq = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    wk = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    eq, sq_ = max_err(torch, oq, pq)
    ek, sk_ = max_err(torch, ok, pk)
    err, scale = max(eq, ek), max(sq_, sk_)
    tol = tol_ulps * scale
    nbytes = 2.0 * 4 * s * dm + 4.0 * 2 * s * d // 2 + 2.0 * 2 * dm
    b_ms, b_by = bound(0.0, nbytes)
    rows.append(dict(
        name=f"K4 fused_rmsnorm_rope S={s} Dm={dm} [{tag}]", kernel="K4",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:51",
        max_abs_err=err, max_rel_err=err / scale, tol=tol,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_rope_plain(
            xq, xk, wq, wk, cos, sin), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K5: RMSNorm of the cross-attention q
    o5 = fnr.fused_rmsnorm(xq, wq)
    err, scale = max_err(torch, o5, fnr.fused_rmsnorm_plain(xq, wq))
    b_ms, b_by = bound(0.0, 2.0 * 2 * s * dm + 2.0 * dm)
    rows.append(dict(
        name=f"K5 fused_rmsnorm S={s} Dm={dm} [{tag}]", kernel="K5",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:154",
        max_abs_err=err, max_rel_err=err / scale, tol=tol_ulps * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm(xq, wq), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_plain(xq, wq), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq, 1e-6), 10)))
    for r in rows:
        emit({"phase": "kernel", **r})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def check_reference(torch):
    """Smoke-size pipeline: card (kernels) vs CPU (plain), same weights."""
    import numpy as np
    from video_styler_tpu_torch.infer_ditto import (SMOKE_TEXT_LEN,
                                                    build_smoke_pipeline,
                                                    smoke_frames)
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import (StubTokenizer,
                                                               WanPrompter)
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = WanVideoPipeline(device="cuda")
    gpu.dit = copy.deepcopy(cpu.dit).to("cuda")
    gpu.vace = copy.deepcopy(cpu.vace).to("cuda")
    gpu.vae = copy.deepcopy(cpu.vae).to("cuda")
    gpu.prompter = WanPrompter(StubTokenizer(SMOKE_TEXT_LEN), SMOKE_TEXT_LEN,
                               copy.deepcopy(cpu.prompter.text_encoder).to("cuda"))
    kw = dict(prompt="a watercolor city at dusk", vace_video=smoke_frames(9, 32, 32),
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, tiled=True)
    lat_c = cpu(return_latents=True, **kw).float()
    lat_g = gpu(return_latents=True, **kw).float().cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    vid_c = cpu.vae_output_to_video(cpu.decode_video(lat_c.to(torch.bfloat16)))
    vid_g = gpu.vae_output_to_video(gpu.decode_video(lat_c.to(torch.bfloat16).cuda()))
    frame_diff = float(np.abs(vid_g.astype(np.int16) - vid_c.astype(np.int16)).max())
    # tolerance: bf16 DiT (cuBLAS vs CPU GEMMs, kernels vs plain) over 2 steps
    # x 2 CFG passes; the fp32 VAE decode of the same latents agrees to 1 level
    res = dict(phase="reference", latents_rel_l2=rel, latents_tol=5e-2,
               frames_max_abs_diff=frame_diff, frames_tol=2.0)
    emit(res)
    if not (rel <= 5e-2 and frame_diff <= 2.0):
        raise AssertionError(f"card vs CPU disagree: {res}")


def run_e2e(torch, kernels, steps: int, frames: int):
    import numpy as np
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer

    dit_cfg, vace_cfg = WAN_T2V_14B, VACE_14B
    t0 = time.perf_counter()
    pipe = WanVideoPipeline.from_configs(dit_cfg, vace_cfg, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN,
                                         seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    f, h, w = frames, 480, 832
    tt = np.linspace(0.0, 1.0, f, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, None, :, None]
    cc = np.array([0.2, 0.5, 0.8], np.float32)[None, None, None, :]
    frames_in = (255 * (0.5 + 0.5 * np.sin(6.28 * (xx + yy * cc + tt * 0.3)))
                 ).astype(np.uint8)

    request = dict(prompt="turn the scene into a watercolor painting",
                   negative_prompt="", vace_video=frames_in, num_frames=f,
                   height=h, width=w, seed=42, cfg_scale=5.0,
                   num_inference_steps=steps, tiled=True)
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    frames = pipe(**request)
    total_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}

    n_layers = dit_cfg.num_layers + len(vace_cfg.vace_layers)
    forwards = 2 * steps
    expected = {"K1": 2 * n_layers * forwards, "K4": n_layers * forwards,
                "K5": n_layers * forwards}
    res = dict(phase="e2e", dit_layers=dit_cfg.num_layers,
               vace_layers=list(vace_cfg.vace_layers), frames=f,
               tokens=int(np.prod(token_grid(f))),
               steps=steps, cfg="two-pass 5.0", init_s=init_s, total_s=total_s,
               stages=dict(pipe.stage_times),
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               output_shape=list(frames.shape), output_dtype=str(frames.dtype),
               # the pipeline raises on a non-finite decoded value
               # (WanVideoPipeline.vae_output_to_video)
               decoded_video_finite=True,
               launches=launches, expected_launches=expected)
    emit(res)
    if frames.shape != (f, h, w, 3):
        raise AssertionError(f"output shape {frames.shape}")
    for name, count in launches.items():
        if count == 0 or count != expected[name]:
            raise AssertionError(f"{name}: {count} launches in the run, "
                                 f"expected {expected[name]}")
    emit({"phase": "e2e_profile", **profile_request(torch, lambda: pipe(**request),
                                                     total_s)})
    return launches


KERNEL_CATEGORIES = (  # (category, substrings of the device kernel's name)
    ("K1", ("flash_fwd_capped_kernel",)),
    ("K4", ("rmsnorm_rope_kernel",)),
    ("K5", ("rmsnorm_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d", "conv3d")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
)


def profile_request(torch, run, unprofiled_s: float):
    """Device time by kernel category over one more identical request,
    under torch.profiler. idle_share compares the summed kernel time with
    the unprofiled request's wall time (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    totals, per_kernel = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in evt.name for k in keys)), "other")
        totals[cat] = totals.get(cat, 0.0) + us / 1e3
        per_kernel[evt.name[:90]] = per_kernel.get(evt.name[:90], 0.0) + us / 1e3
    busy_ms = sum(totals.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ms_by_category=totals, device_busy_ms=busy_ms,
                unprofiled_wall_ms=unprofiled_s * 1e3,
                idle_share=(1.0 - busy_ms / (unprofiled_s * 1e3)) if busy_ms else None,
                top_kernels_ms=dict(top))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--frames", type=int, default=RUN_FRAMES,
                    help="frames (4k+1) of the 480x832 end-to-end request")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "video_styler_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from video_styler_tpu_torch.ops import cuda_build
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for log in sorted(cuda_build.BUILD_DIR.glob("*.log")):
        ptxas[log.stem] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas))

    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL}
    rows = check_kernels(torch, token_grid(DITTO_FRAMES), f"ditto-{DITTO_FRAMES}f")
    if args.frames != DITTO_FRAMES:
        rows += check_kernels(torch, token_grid(args.frames), f"run-{args.frames}f")
    torch.cuda.empty_cache()

    check_reference(torch)
    launches = run_e2e(torch, kernels, args.steps, args.frames)

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{k: r[k] for k in keys}, "launches": launches[r["kernel"]]}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
