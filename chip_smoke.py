#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_styler_tpu_torch) on one GPU.

    python3 chip_smoke.py                          # all phases, one card
    python3 chip_smoke.py --frames 73 --steps 1    # the full Ditto clip size
    python3 chip_smoke.py --train-frames 73        # LoRA steps at 29,640 tokens

Phases, each printing one JSON line (any failure raises and exits non-zero):
  device     nvidia-smi name and power limit, torch/CUDA versions, the
             kernel build time (every csrc/*.cu, one nvcc each, in parallel),
             each kernel's registers and spills (-Xptxas=-v)
  kernel     K1 (flash attention, self and cross), K4 (RMSNorm+RoPE) and K5
             (RMSNorm), then K1 with its stats output and K3 (the flash
             backward: dq, dk and dv in one kernel, and its dq-only twin)
             through the autograd Function that training uses, then K2 and K8 (online softmax, single and
             dual, self and cross; K2 also with stats, on its 3-D entry,
             under a q x24 stress and feeding K3), K6 (int8 Q K^T, capped and online;
             beside the bf16 kernel of the same body on the same inputs) and
             K7 (its 3-D twin), held against their plain PyTorch versions
             on the card
             at the Ditto shapes of a 73-frame 480x832 edit (29,640 tokens)
             and of this run's requests (--frames and --train-frames,
             default 9: 4,680 tokens), and K1 cross to 257 and 769 keys
             (I2V's image branch, FLF2V's text branch) at this run's and
             the I2V recipe's 81-frame (32,760) query rows, K1/K4/K5 at
             TI2V-5B's 24 heads (Dm 3072) over 5,070 tokens:
             max abs/rel error against the stated tolerance, median kernel
             time over CUDA-event timed runs (L2 flushed before each), plain
             and library times, the bound from the work and the card's
             data-sheet rates, the time over the library call's; the
             attention kernels and K5 also their registers and spills from
             the build log
  reference  the smoke-size pipeline on the card against the same weights
             on the CPU (plain versions), latents and decoded frames
  reference_quant  the same after quantize(): int8 linears with int8
             attention, then fp8, int4 and group-wise int4 linears, the card
             against the CPU on the same quantised weights
  train_reference  2 LoRA steps of the smoke-size model on the card and on
             the CPU from the same weights, LoRA, inputs, tid and noise:
             losses, gradients and updated LoRA
  e2e        one VACE edit at Wan2.1-VACE-14B width (40 DiT + 8 VACE blocks,
             umT5-XXL, Wan2.1 VAE; random bf16 weights from a seed) of a
             480x832 clip: stage times, peak memory, output shape, and each
             kernel's launch count in this run; then the same request again
             under torch.profiler for device time by kernel category
  load       that pipeline written in the layout of the Wan2.1-VACE-14B
             release (DiT+VACE as 7 bf16 safetensors shards under the
             reference's names, umT5 and the VAE as .pth) to --ckpt-dir,
             freed, and built again by `from_pretrained` on the card:
             detected kinds and configs, seconds, GB read, GB/s, the host's
             peak RSS and the device's peak; every tensor bit-equal to what
             was written (per-tensor checksums on the card); the e2e request
             again (`load_edit`, counted): frames identical to e2e's; then a
             random rank-128 Ditto-style LoRA hotloaded on the VACE branch,
             its scale set to 0 and unloaded (weights bit-equal to the base
             each time) and the time of one re-apply. Every later phase runs
             on the loaded pipeline; the files are removed at the end
  train      2 steps of the Ditto LoRA recipe (rank 128 on the VACE q, k, v,
             o, ffn.0, ffn.2; AdamW) on the loaded 14B-width pipeline, on the
             --train-frames request (default 9: 4,680 tokens), through the
             training CLI's data path (video_styler_tpu_torch/train.py): its
             `preprocess` with umT5 parked on the host between encodes,
             `launch_data_process_task` writing the clip's encodes,
             `CachedLatentDataset` reading them back (bit-equal to the
             in-memory ones, the same loss on both), umT5 and the VAE parked
             for the cache-fed steps; seconds per cached sample and the
             encodes' peak memory, losses, step times, peak memory, LoRA size, each
             kernel's launches against the count derived from the
             configuration; then one more step under torch.profiler
  e2e_online one step of the same edit on the online-softmax route
             (FLASH_CAPPED=0: K2), then one with FLASH_DUAL=1 (K8)
  train_precision  one LoRA loss and gradient on the train clip with bf16
             activations (the kernels) and with the recipe's fp32
             activations (bf16 weights, the plain versions): how far the
             loss and the LoRA gradients move, and the fp32 run's peak memory
             (up to 9 train frames: beyond, the fp32 run does not fit)
  editor_reference  the smoke-size keyframe-guided editor (9 frames of
             32x32, keyframes at frames 0 and 8, CFG 5 two-pass, 2 steps) on
             the card against the same weights on the CPU
  enhance_reference  the smoke-size Wan2.2 enhancer with two distinct tiny
             experts on a window crossing the expert boundary (8 steps of
             shift 5, the last 6: 2 high-noise, 4 low-noise), card vs CPU
  editor     the keyframe-guided editor on the loaded pipeline's DiT: the
             --frames clip with keyframes at its first and last frame (and
             the middle one from 73 frames on), --steps steps, CFG 5
             two-pass, alpha 10: the joint [main | keyframes] token count,
             stage and step times, peak memory, compute_metrics, K1/K4/K5
             launches against 2/1/1 per block and CFG pass; the request
             again under torch.profiler; then K1, K4 and K5 held against
             their plain versions at the joint sequence's length with its
             RoPE ids
  enhance    the Wan2.2 enhancer at A14B width: the loaded DiT as the
             low-noise expert, a second WAN_T2V_14B DiT from a seed as the
             high-noise expert (both resident; umT5 and VACE parked on the
             host), the --frames clip, the boundary-crossing window, guide
             scales (3, 4): each step's expert and seconds, peak memory,
             launches (above --frames 9, running out of memory is reported,
             not raised); the request again under torch.profiler
  i2v_reference  the FLF2V smoke recipe of `wan_video_gen` (a tiny
             257-token CLIP tower, y, a first and an end image) on the card
             against the same weights on the CPU
  ti2v_reference  the TI2V smoke recipe (the first frame's latent fused
             into the noise, a tiny Wan2.2-family VAE), card vs CPU
  e2e_quant  the trained LoRA merged, then quantize("int8",
             quantize_attention=True) and the same edit again: int8 GEMMs
             and K6 for every attention; profiled like e2e; then one step
             with FLASH_CAPPED=0 (K6's online body)
  entry_3d   the (BH, S, D) entry points driven as a caller would:
             flash_attention_3d without and with grad (K2, K2 + K3) and
             flash_attention_int8_3d (K7)
  i2v        Wan2.1-I2V-14B-480P at full width in the VACE pipeline's
             place (its DiT and VACE freed; umT5-XXL and the Wan2.1 VAE
             kept): a random WAN_I2V_14B DiT and CLIP ViT-H/14 tower, the
             --frames clip's first frame as the image, --steps steps, CFG 5
             two-pass: stage times (clip_encode, vae_encode_image, steps,
             decode), peak memory, K1/K4/K5 launches against 3/1/1 per
             block and pass; profiled; then an FLF2V request (a 514-row
             position table, the clip's last frame as the end image) and a
             2-step dual-expert request (a second I2V expert below
             switch_DiT_boundary, umT5 and CLIP parked on the host)
  ti2v       Wan2.2-TI2V-5B at full width: a random WAN_TI2V_5B DiT and
             Wan2.2 VAE, 49 frames of 480x832 (5,070 tokens), --steps
             steps, CFG 5 two-pass, streaming encode and decode: stage and
             step times, peak memory, launches (2/1/1 per block and pass),
             the first latent frame bit-equal to the image's encode
Then the `kernels` summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# DiT token grids (latent frames, H/16, W/16) after the (1, 2, 2) patchify
DITTO_FRAMES = 73            # 73 frames 480x832 -> 29,640 tokens
RUN_FRAMES = 9               # 9 frames 480x832 -> 4,680 tokens
I2V_RECIPE_FRAMES = 81       # Wan2.1 I2V's 81 frames 480x832 -> 32,760 tokens
TI2V_FRAMES = 49             # Wan2.2 TI2V-5B's 49 frames 480x832 (16x VAE) ->
TI2V_GRID = (13, 15, 26)     # 13 x 15 x 26 = 5,070 tokens
TEXT_LEN = 512
CLIP_ROWS = 257              # the image branch's keys; FLF2V's text branch
FLF2V_TEXT_ROWS = 512 + 257  # takes the end image's 257 rows: 769 keys


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
    """Median CUDA-event time of fn, with L2 flushed before each run. After
    the flush the card spins for ~100 us before the start event, while the
    host enqueues fn's launches, so the time is the device's: a wrapper's
    host time per launch (17 us for K5's, 14 us for F.rms_norm's on the
    H100's host) would otherwise land inside a kernel of tens of us."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# two bf16 ULPs at the output's largest magnitude: the kernels and their
# plain versions round at the same points; exp2/rsqrt and the order of fp32
# sums differ in the last bits, which can move one bf16 rounding by one ULP
TOL_ULPS = 2.0 ** -7


def frames_480x832(f: int):
    """A smooth synthetic uint8 clip (f, 480, 832, 3)."""
    import numpy as np
    h, w = 480, 832
    tt = np.linspace(0.0, 1.0, f, dtype=np.float32)[:, None, None, None]
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, None, :, None]
    cc = np.array([0.2, 0.5, 0.8], np.float32)[None, None, None, :]
    return (255 * (0.5 + 0.5 * np.sin(6.28 * (xx + yy * cc + tt * 0.3)))
            ).astype(np.uint8)


def gpu_clocks() -> str:
    """SM clock, its maximum, power draw and temperature, as nvidia-smi
    reads them now (the card slows down under a power or heat limit)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def max_err(torch, got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, scale


def ptxas_usage(build_dir):
    """Registers and spill bytes of every kernel, from the -Xptxas=-v lines
    of the build logs: {function name: {"registers": n, "spill_stores": b,
    "spill_loads": b}}. Kernels that raise their register limit with
    setmaxnreg report the launch-bound count here."""
    import re
    usage, current = {}, None
    for log in sorted(build_dir.glob("*.log")):
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                current = m.group(1)
                usage[current] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and current:
                usage[current].update(spill_stores=int(m.group(1)),
                                      spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and current:
                usage[current]["registers"] = int(m.group(1))
    return usage


PTXAS = {}  # filled by main() from the build logs


def kernel_usage(*names):
    """The ptxas usage of the kernels whose mangled names contain `names`."""
    return {fn: u for fn, u in PTXAS.items() if any(n in fn for n in names)}


def check_kernels(torch, grid, tag, rope_ids=None, heads: int = 40,
                  cross_lens=(TEXT_LEN,), self_attn: bool = True, norms: bool = True):
    """K1 self and cross (to each of `cross_lens` keys), K4 and K5 at `heads`
    heads of 128 (the Ditto 14B width by default) on this token grid
    (rope_ids: the temporal RoPE index of each latent frame, as the editor
    gives its joint sequence). self_attn/norms: whether to hold K1 self and
    K4/K5 too."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid

    f, h, w = grid
    s, n, d = f * h * w, heads, 128
    dm = n * d
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    rows = []
    tol_ulps = TOL_ULPS

    # K1: self (Sk = S) and cross (Sk = 512 text tokens; 257 CLIP rows and
    # FLF2V's 769-row text branch on the I2V path)
    q = randn(1, s, n, d)
    for kind, sk in ([("self", s)] if self_attn else []) + [("cross", c) for c in cross_lens]:
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
            library_ms=lib_ms, ratio_to_library=ms / lib_ms, tflops=flops / ms / 1e9,
            ptxas=kernel_usage("flash_fwd_capped_kernel"), clocks=gpu_clocks()))
        del k, v, out, want
    if not norms:
        return emit_rows(rows)

    # K4: RMSNorm + RoPE on q and k in one launch
    cos, sin = assemble_freqs_grid(d, f, h, w, rope_ids, device="cuda")
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
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq, 1e-6), 10),
        ptxas=kernel_usage("rmsnorm_kernel"), clocks=gpu_clocks()))
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
    return emit_rows(rows)


def emit_rows(rows):
    """Print each kernel row; raise on the first outside its tolerance."""
    for r in rows:
        emit({"phase": "kernel", **r})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def card_copy(torch, cpu, cls):
    """A `cls` pipeline on the card holding copies of the CPU pipeline's
    models (the same weights)."""
    from video_styler_tpu_torch.prompters.wan_prompter import WanPrompter
    gpu = cls(device="cuda")
    for name in ("dit", "dit2", "vace", "vae", "image_encoder"):
        m = getattr(cpu, name)
        setattr(gpu, name, None if m is None else copy.deepcopy(m).to("cuda"))
    p = cpu.prompter
    gpu.prompter = WanPrompter(p.tokenizer, p.text_len,
                               copy.deepcopy(p.text_encoder).to("cuda"))
    return gpu


def check_reference(torch):
    """Smoke-size pipeline: card (kernels) vs CPU (plain), same weights."""
    import numpy as np
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoPipeline)
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


def check_reference_quant(torch):
    """The smoke-size pipeline quantised on the CPU, then the same quantised
    weights on the card: int8 linears with int8 attention (K6), then fp8,
    int4 and group-wise int4 linears alone. The group is 32 here: the smoke
    VACE patch embedding has 288 inputs, which 128 does not divide.

    Two checks per mode. One quantised linear (the first block's fc1) on the
    same input on both devices: the library GEMM multiplies the same
    integers (or e4m3 values), so it holds to the kernels' two bf16 ULPs.
    Then the pipeline's latents, card against CPU, within 5% as `reference`,
    or within 1.5x the mode's own quantisation noise (the CPU's quantised
    latents against its unquantised ones) where that is larger: a coarse
    activation grid (e4m3 keeps 3 mantissa bits, steps of 6-12%) turns a
    bf16-ULP difference between the devices into a flip to a neighbouring
    value, so two runs of such a mode differ by about its own noise."""
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.ops.attention import set_quantized_attention
    from video_styler_tpu_torch.ops.quant import QuantLinear, quantized_fraction

    kw = dict(prompt="a watercolor city at dusk", vace_video=smoke_frames(9, 32, 32),
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, tiled=True, return_latents=True)
    lat_ref = build_smoke_pipeline(device="cpu", seed=0)(**kw).float()
    x = torch.randn((1, 12, 256), generator=torch.Generator().manual_seed(7)
                    ).to(torch.bfloat16)
    res = dict(phase="reference_quant", latents_rel_l2={}, latents_tol={},
               quantisation_noise_rel_l2={}, linear_max_abs_err={}, linear_tol={},
               quantized_fraction={})
    for mode, attn in (("int8", True), ("fp8", False), ("int4", False), ("int4_g32", False)):
        cpu = build_smoke_pipeline(device="cpu", seed=0)
        try:
            cpu.quantize(mode, quantize_attention=attn)
            gpu = copy.copy(cpu)
            gpu.device = torch.device("cuda")
            gpu.dit, gpu.vace, gpu.vae = (copy.deepcopy(m).to("cuda")
                                          for m in (cpu.dit, cpu.vace, cpu.vae))
            gpu.prompter = copy.copy(cpu.prompter)
            gpu.prompter.text_encoder = copy.deepcopy(cpu.prompter.text_encoder).to("cuda")
            lat_c = cpu(**kw).float()
            lat_g = gpu(**kw).float().cpu()
        finally:
            set_quantized_attention(False)
        name = mode + (" + int8 attention" if attn else "")
        layer_c, layer_g = cpu.dit.blocks[0].ffn.fc1, gpu.dit.blocks[0].ffn.fc1
        if not (isinstance(layer_g, QuantLinear) and layer_g.mode == mode):
            raise AssertionError(f"{name}: fc1 is {layer_g}")
        with torch.no_grad():
            err, scale = max_err(torch, layer_g(x.cuda()).cpu(), layer_c(x))
        noise = ((lat_c - lat_ref).norm() / lat_ref.norm()).item()
        res["linear_max_abs_err"][name] = err
        res["linear_tol"][name] = TOL_ULPS * scale
        res["quantisation_noise_rel_l2"][name] = noise
        res["latents_rel_l2"][name] = ((lat_g - lat_c).norm() / lat_c.norm()).item()
        res["latents_tol"][name] = max(5e-2, 1.5 * noise)
        res["quantized_fraction"][name] = quantized_fraction(gpu.dit)
    emit(res)
    bad = [k for k in res["latents_rel_l2"]
           if not (res["latents_rel_l2"][k] <= res["latents_tol"][k]
                   and res["linear_max_abs_err"][k] <= res["linear_tol"][k])]
    if bad:
        raise AssertionError(f"quantised pipeline, card vs CPU: {bad}")


def build_pipeline(torch):
    """The 14B-width pipeline (random bf16 weights from seed 0) and the
    seconds it took to make."""
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer

    t0 = time.perf_counter()
    pipe = WanVideoPipeline.from_configs(WAN_T2V_14B, VACE_14B, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN,
                                         seed=0, device="cuda")
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def check_launches(launches, expected, phase):
    """Each kernel's launches in a run against the derived count (0 for a
    kernel the run must not reach)."""
    for name, count in launches.items():
        if count != expected.get(name, 0) or (name in expected and count == 0):
            raise AssertionError(f"{name}: {count} launches in the {phase} run, "
                                 f"expected {expected.get(name, 0)}")


def run_edit(torch, pipe, kernels, steps: int, frames: int, phase: str,
             attention_kernels: dict, profile: bool = True, outputs=None, **extra):
    """One VACE edit of a 480x832 clip on `pipe`, with every launch count set
    to 0 just before and read just after. `attention_kernels` names the
    kernel(s) that the run's attention calls must go through and their share
    of them (two attention calls per block and forward); K4 and K5 run once
    per block and forward; every other kernel must stay at 0. `outputs`
    (a list) receives the frames of each run of the request."""
    import numpy as np
    dit_cfg, vace_cfg = pipe.dit.cfg, pipe.vace.cfg
    f, h, w = frames, 480, 832
    request = dict(prompt="turn the scene into a watercolor painting",
                   negative_prompt="", vace_video=frames_480x832(f), num_frames=f,
                   height=h, width=w, seed=42, cfg_scale=5.0,
                   num_inference_steps=steps, tiled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = pipe(**request)
    total_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}

    n_layers = dit_cfg.num_layers + len(vace_cfg.vace_layers)
    forwards = 2 * steps
    expected = {"K4": n_layers * forwards, "K5": n_layers * forwards}
    expected.update({name: int(share * 2 * n_layers * forwards)
                     for name, share in attention_kernels.items()})
    res = dict(phase=phase, dit_layers=dit_cfg.num_layers,
               vace_layers=list(vace_cfg.vace_layers), frames=f,
               tokens=int(np.prod(token_grid(f))),
               steps=steps, cfg="two-pass 5.0", total_s=total_s,
               stages=dict(pipe.stage_times),
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               output_shape=list(out.shape), output_dtype=str(out.dtype),
               # the pipeline raises on a non-finite decoded value
               # (WanVideoPipeline.vae_output_to_video)
               decoded_video_finite=True,
               launches=launches, expected_launches=expected, **extra)
    emit(res)
    if out.shape != (f, h, w, 3):
        raise AssertionError(f"output shape {out.shape}")
    check_launches(launches, expected, phase)
    if outputs is not None:
        outputs.append(out)
    if profile:
        def again():
            frames_again = pipe(**request)
            if outputs is not None:
                outputs.append(frames_again)
        emit({"phase": f"{phase}_profile", **profile_request(torch, again, total_s)})
    return launches


def run_e2e_online(torch, pipe, kernels, frames: int):
    """One step of the edit on the online-softmax route, then one with the
    dual kernel, switched the way a user switches them: the environment."""
    launches = {}
    for phase, env, name in (("e2e_online", {"FLASH_CAPPED": "0"}, "K2"),
                             ("e2e_online_dual", {"FLASH_DUAL": "1"}, "K8")):
        os.environ.update(env)
        try:
            launches[name] = run_edit(torch, pipe, kernels, 1, frames, phase, {name: 1.0},
                                      profile=False, environment=env)[name]
        finally:
            for key in env:
                del os.environ[key]
    return launches


def run_e2e_quant(torch, pipe, kernels, steps: int, frames: int):
    """The edit after quantize("int8", quantize_attention=True). The LoRA of
    the train phase is merged first (quantize must run after LoRA merging),
    and umT5 and the VAE, parked on the host for training, come back."""
    from torch.nn.utils import parametrize
    from video_styler_tpu_torch.ops.attention import set_quantized_attention
    from video_styler_tpu_torch.ops.quant import QuantLinear, quantized_fraction

    for m in pipe.vace.modules():
        if parametrize.is_parametrized(m, "weight"):
            with torch.no_grad():
                parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
    pipe.prompter.text_encoder.to("cuda")
    pipe.vae.to("cuda")
    t0 = time.perf_counter()
    pipe.quantize("int8", quantize_attention=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    try:
        return run_edit(
            torch, pipe, kernels, steps, frames, "e2e_quant", {"K6": 1.0},
            quantize="int8 linears + int8 attention", quantize_s=quantize_s,
            quantized_fraction=dict(dit=quantized_fraction(pipe.dit),
                                    vace=quantized_fraction(pipe.vace)),
            quant_linears=sum(isinstance(m, QuantLinear) for m in
                              list(pipe.dit.modules()) + list(pipe.vace.modules())),
            weights_gib=sum(t.numel() * t.element_size() for m in (pipe.dit, pipe.vace)
                            for t in list(m.parameters()) + list(m.buffers())) / 2**30)
    finally:
        set_quantized_attention(False)


# ---------------------------------------------------------------- load phase

def checksums(torch, modules: dict) -> dict:
    """{"<module>.<tensor>": [s1, s2]} of every tensor of `modules`, taken on
    the card over the tensor's bytes as 16-bit words w: s1 = sum(w), s2 =
    sum(w * (position % 65521 + 1)), in int64 (no overflow below 2^31
    words). Two tensors with the same sums hold the same bits unless a
    change cancels in both."""
    names, sums = [], []
    chunk = 1 << 24
    for mname, module in modules.items():
        for key, t in module.state_dict().items():
            words = t.detach().contiguous().reshape(-1).view(torch.int16)
            s1 = torch.zeros((), dtype=torch.int64, device=t.device)
            s2 = torch.zeros((), dtype=torch.int64, device=t.device)
            for begin in range(0, words.numel(), chunk):
                w = words[begin:begin + chunk].to(torch.int64) & 0xFFFF
                pos = torch.arange(begin, begin + w.numel(), device=t.device)
                s1 += w.sum()
                s2 += (w * (pos % 65521 + 1)).sum()
            names.append(f"{mname}.{key}")
            sums.append(torch.stack([s1, s2]))
    return dict(zip(names, torch.stack(sums).tolist()))


def pipeline_modules(pipe) -> dict:
    return {"dit": pipe.dit, "vace": pipe.vace, "t5": pipe.prompter.text_encoder,
            "vae": pipe.vae}


def random_ditto_lora(torch, vace_cfg, rank: int = 128, seed: int = 7):
    """A rank-`rank` LoRA under the reference's names on every VACE block's
    q, k, v, o (self and cross), ffn.0 and ffn.2, bf16, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    dim, ffn = vace_cfg.dim, vace_cfg.ffn_dim
    shapes = {f"{a}.{n}": (dim, dim) for a in ("self_attn", "cross_attn") for n in "qkvo"}
    shapes.update({"ffn.0": (ffn, dim), "ffn.2": (dim, ffn)})
    sd = {}
    for i in range(len(vace_cfg.vace_layers)):
        for name, (out_f, in_f) in shapes.items():
            pre = f"vace_blocks.{i}.{name}"
            sd[f"{pre}.lora_A.weight"] = (torch.randn((rank, in_f), generator=gen)
                                          / math.sqrt(in_f)).to(torch.bfloat16)
            sd[f"{pre}.lora_B.weight"] = (torch.randn((out_f, rank), generator=gen)
                                          * 1e-3).to(torch.bfloat16)
    return sd


def run_load(torch, holder: list, kernels, frames: int, steps: int, e2e_frames: list,
             ckpt_root):
    """Export the e2e pipeline (holder[0]) in the release layout, free it,
    build it again from the files with `from_pretrained`, check every
    tensor, the edit and the LoRA hotload stack. Returns the loaded pipeline
    and the launches of its edit."""
    import numpy as np
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    from video_styler_tpu_torch.safetensors_io import save_file
    from video_styler_tpu_torch.utils import ckpt as C
    from video_styler_tpu_torch.utils.convert import save_release_files
    from video_styler_tpu_torch.utils.host_memory import RssPeak, drop_from_page_cache
    from video_styler_tpu_torch.utils.model_config import ModelConfig

    pipe = holder.pop()
    folder = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ckpt_root)
    res = dict(phase="load", ckpt_dir=folder)
    try:
        want = checksums(torch, pipeline_modules(pipe))
        nbytes = {name: sum(t.numel() * t.element_size() for t in m.state_dict().values())
                  for name, m in pipeline_modules(pipe).items()}
        free = shutil.disk_usage(folder).free
        res.update(disk_free_gb=free / 1e9, weights_gb={k: v / 1e9 for k, v in nbytes.items()})
        if free < 1.05 * sum(nbytes.values()):
            raise RuntimeError(f"{free / 1e9:.1f} GB free under {folder}: the release's "
                               f"files need {sum(nbytes.values()) / 1e9:.1f} (--ckpt-dir)")
        t0 = time.perf_counter()
        paths = save_release_files(pipe, folder)
        written = paths["dit"] + [paths["t5"], paths["vae"]]
        drop_from_page_cache(written)
        export_s = time.perf_counter() - t0
        file_bytes = sum(os.path.getsize(p) for p in written)
        res.update(export_s=export_s, files=[os.path.basename(p) for p in written],
                   files_gb=file_bytes / 1e9, export_gb_per_s=file_bytes / 1e9 / export_s)

        del pipe
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res["device_allocated_before_gib"] = torch.cuda.memory_allocated() / 2**30

        groups = [paths["dit"], [paths["vae"]], [paths["t5"]]]
        res["detected_kinds"] = [C.detect_model_kind(C.load_state_dict_files(g, lazy=True))
                                 for g in groups]
        torch.cuda.reset_peak_memory_stats()
        read0 = C.BYTES_READ
        maxrss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        with RssPeak() as rss:
            rss_before = rss.peak
            t0 = time.perf_counter()
            pipe = WanVideoPipeline.from_pretrained([ModelConfig(path=g) for g in groups],
                                                    device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        read = C.BYTES_READ - read0
        # the card's machine has no umT5 tokenizer files: e2e's stand-in
        pipe.prompter.tokenizer = StubTokenizer(TEXT_LEN)
        res.update(load_s=load_s, read_gb=read / 1e9, read_gb_per_s=read / 1e9 / load_s,
                   host_rss_before_gb=rss_before / 1e9, host_rss_peak_gb=rss.peak / 1e9,
                   host_rss_peak_over_before_gb=(rss.peak - rss_before) / 1e9,
                   ru_maxrss_life_gb=max(maxrss0, resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss * 1024) / 1e9,
                   device_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   device_allocated_gib=torch.cuda.memory_allocated() / 2**30,
                   tokenizer="StubTokenizer (as e2e)")
        configs = dict(dit=pipe.dit.cfg == WAN_T2V_14B, vace=pipe.vace.cfg == VACE_14B,
                       t5=pipe.prompter.text_encoder.cfg == UMT5_XXL,
                       vae=pipe.vae.cfg == WAN21_VAE)
        res.update(dit_cfg=str(pipe.dit.cfg), vace_cfg=str(pipe.vace.cfg),
                   configs_equal_14b=configs)

        got = checksums(torch, pipeline_modules(pipe))
        bad = sorted(k for k in want if got.get(k) != want[k])
        res.update(tensors_checked=len(want), tensors_bit_equal=len(want) - len(bad),
                   tensors_differing=bad[:10], tensors_missing=sorted(set(want) ^ set(got)))
        emit(res)
        if res["detected_kinds"] != ["dit+vace", "vae", "t5"]:
            raise AssertionError(f"detected kinds {res['detected_kinds']}")
        if not all(configs.values()):
            raise AssertionError(f"loaded configs differ from the 14B ones: {configs}")
        if bad or set(want) != set(got):
            raise AssertionError(f"{len(bad)} loaded tensors differ from the written ones")

        # the e2e request on the loaded pipeline: the same frames
        edit = []
        launches = run_edit(torch, pipe, kernels, steps, frames, "load_edit", {"K1": 1.0},
                            profile=False, outputs=edit)
        e2e_runs_differ = float(max(np.abs(a.astype(np.int16) - e2e_frames[0]).max()
                                    for a in e2e_frames))
        diff = float(np.abs(edit[0].astype(np.int16) - e2e_frames[0]).max())
        check = dict(phase="load_edit_check", frames_identical_to_e2e=diff == 0.0,
                     max_abs_diff_to_e2e=diff, e2e_runs_max_abs_diff=e2e_runs_differ,
                     e2e_runs=len(e2e_frames))
        emit(check)
        if diff > e2e_runs_differ:
            raise AssertionError(f"the loaded pipeline's edit differs from e2e's: {check}")

        # LoRA hotload on the VACE branch at 14B width
        lora_path = os.path.join(folder, "ditto_lora_rank128.safetensors")
        save_file(random_ditto_lora(torch, pipe.vace.cfg), lora_path)
        base = {k: v for k, v in want.items() if k.startswith("vace.")}

        def vace_equal_to_base():
            return checksums(torch, {"vace": pipe.vace}) == base

        hot = dict(phase="load_hotload", lora_rank=128, lora_file_gb=os.path.getsize(
            lora_path) / 1e9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.load_lora("vace", path=lora_path, alpha=1.0, hotload=True)
        torch.cuda.synchronize()
        hot["load_lora_s"] = time.perf_counter() - t0
        hot["lora_targets"] = len(pipe._lora_stacks["vace"]["base"])
        hot["base_copy_gib"] = sum(w.numel() * w.element_size() for w in
                                   pipe._lora_stacks["vace"]["base"].values()) / 2**30
        hot["merged_differs_from_base"] = not vace_equal_to_base()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.set_lora_scale("vace", 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        hot["reapply_scale_0.5_s"] = times
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.set_lora_scale("vace", 0.0)
        torch.cuda.synchronize()
        hot["reapply_scale_0_s"] = time.perf_counter() - t0
        hot["scale_0_bit_equal_to_base"] = vace_equal_to_base()
        pipe.set_lora_scale("vace", 1.0)
        pipe.unload_loras("vace")
        torch.cuda.synchronize()
        hot["unloaded_bit_equal_to_base"] = vace_equal_to_base()
        hot["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        emit(hot)
        if not (hot["merged_differs_from_base"] and hot["scale_0_bit_equal_to_base"]
                and hot["unloaded_bit_equal_to_base"]):
            raise AssertionError(f"LoRA hotload: {hot}")
        return pipe, launches
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def time_sdpa_bwd(torch, q, k, v, g, reps: int = 5):
    """Median time of PyTorch's SDPA backward alone: torch.autograd.grad after
    an untimed forward, L2 flushed before each (the K3 yardstick)."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    gt = g.transpose(1, 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(reps + 1):
        out = F.scaled_dot_product_attention(qt, kt, vt)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, (qt, kt, vt), gt)
        end.record()
        torch.cuda.synchronize()
        if i:  # the first is warm-up
            times.append(start.elapsed_time(end))
        del out
    return statistics.median(times)


def check_attention_training(torch, s, sk, tag, kind, mag=1.0, check_heads=None):
    """K1 with its stats output and K3 at 40 heads of 128, through
    `flash_attention` on tensors that require grad (the autograd Function
    of the training path: K1 with stats forward, K3 backward): q (1, s, 40,
    128) scaled by `mag`, k/v (1, sk, 40, 128). The plain check covers every
    row of the first `check_heads` heads (a head-sliced view: for dK/dV
    every query row contributes), all heads when None. K3's dq-only twin
    (no dK/dV wanted) is checked and timed on the same inputs."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    q, k, v = randn(1, s, n, d, m=mag), randn(1, sk, n, d), randn(1, sk, n, d)
    g = randn(1, s, n, d)
    hs = slice(0, check_heads or n)
    heads = check_heads or n
    label = f"{kind} S={s} Sk={sk} N={n} D={d} [{tag}]"
    rows = []

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qr, kr, vr, scale)
    if not isinstance(o.grad_fn, fa.FlashAttentionFunction._backward_cls):
        raise AssertionError(f"flash_attention under grad ran {o.grad_fn}")
    l2 = o.grad_fn.saved_tensors[4]
    o = o.detach()
    po, pl2 = fa.flash_attention_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs],
                                       scale, return_stats=True)
    err_o, scale_o = max_err(torch, o[:, :, hs], po)
    err_l2 = (l2[:, hs] - pl2).abs().max().item()
    # L2 is fp32 on both sides: m2 from the same rounded q, l summed in
    # another order
    tol_l2 = 1e-4 * max(1.0, pl2.abs().max().item())
    del po, pl2
    flops = 4.0 * n * s * sk * d
    b_ms, b_by = bound(flops, 2.0 * n * d * (2 * s + 2 * sk) + 4.0 * n * s)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append(dict(
        name=f"K1 flash_attention with stats {label}", kernel="K1s", route="cuda",
        source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err_o, max_rel_err=err_o / scale_o, tol=TOL_ULPS * scale_o,
        l2_max_abs_err=err_l2, l2_tol=tol_l2, checked_heads=heads,
        ms=time_ms(torch, lambda: fa.flash_attention(qr, kr, vr, scale), 10),
        ms_without_stats=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale), 10),
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, scale, return_stats=True), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
        ptxas=kernel_usage("flash_fwd_capped_kernel"), clocks=gpu_clocks()))
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]

    out = fa.flash_attention(qr, kr, vr, scale)
    dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
    del out, qr, kr, vr
    want = fa.flash_attention_bwd_plain(q[:, :, hs], k[:, :, hs], v[:, :, hs],
                                        o[:, :, hs], l2[:, hs].contiguous(),
                                        g[:, :, hs], scale)
    errs = {}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err, sc = max_err(torch, got[:, :, hs], w)
        errs[name] = (err, TOL_ULPS * sc, sc)
    del dq, dk, dv
    got_q = fa.flash_attention_bwd(q, k, v, o, l2, g, scale, need_kv=False)[0]
    err, sc = max_err(torch, got_q[:, :, hs], want[0])
    errs["dq (dq-only)"] = (err, TOL_ULPS * sc, sc)
    del got_q, want
    plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, l2, g, scale), reps=2, warmup=1)
    lib_ms = time_sdpa_bwd(torch, q, k, v, g)
    # the function needs five products of 2*s*sk*d flop per head: S, dP
    # (then P and dS), dV, dK and dQ; it reads q, k, v, o, dO and L2 and
    # writes dq, dk, dv. Without dK/dV: three products, no dk/dv written.
    # Beyond those bytes the design adds the fp32 dQ accumulator: one
    # s x d x 4-byte add per head for every block of 128 keys (bulk
    # reduce-adds that L2 resolves), a zeroing and a read to round it
    work = 2.0 * n * s * sk * d
    in_bytes = 2.0 * n * d * (3 * s + 2 * sk) + 4.0 * n * s
    acc_bytes = 4.0 * n * s * d
    for kern, need_kv, flop_k, nbytes, outs in (
            ("K3", True, 5, in_bytes + 2.0 * n * d * (s + 2 * sk), ("dq", "dk", "dv")),
            ("K3q", False, 3, in_bytes + 2.0 * n * d * s, ("dq (dq-only)",))):
        launch = fa._BwdLaunch(q, k, v, o, l2, g, scale, need_kv=need_kv)
        b_ms, b_by = bound(flop_k * work, nbytes)
        worst = max(outs, key=lambda o_: errs[o_][0] / errs[o_][1])
        ms = time_ms(torch, launch.run, reps=5)
        rows.append(dict(
            name=f"K3 flash_attention_bwd {'dq dk dv' if need_kv else 'dq only'} {label}",
            kernel=kern, route="cuda",
            source="video_styler_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="video_styler_tpu/ops/flash_attention.py:582 and :624",
            max_abs_err=errs[worst][0], tol=errs[worst][1],
            errors={o_: dict(max_abs_err=errs[o_][0], tol=errs[o_][1],
                             max_rel_err=errs[o_][0] / errs[o_][2]) for o_ in outs},
            checked_heads=heads, ms=ms,
            # the plain version and SDPA's backward compute dq, dk and dv
            # together: the same number in both rows
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            ratio_to_library=ms / lib_ms, tflops=flop_k * work / ms / 1e9,
            dq_accumulator_gb=(acc_bytes * math.ceil(sk / 128) + 2 * acc_bytes) / 1e9,
            ptxas=kernel_usage("fa_bwd_kernelILb1" if need_kv else "fa_bwd_kernelILb0"),
            clocks=gpu_clocks()))
        del launch
    for r in rows:
        emit({"phase": "kernel", **r})
    failed = [o_ for o_, (e, t, _) in errs.items() if not e <= t]
    if not (rows[0]["max_abs_err"] <= rows[0]["tol"] and err_l2 <= tol_l2):
        failed.append("o/L2")
    if failed:
        raise AssertionError(f"{label}: {failed} beyond tolerance")
    return rows


def edge_rows(torch, s: int, count: int = 1024):
    """The first and last `count` query rows: full tiles and the ragged tail."""
    return torch.cat([torch.arange(0, min(count, s)),
                      torch.arange(max(0, s - count), s)]).unique().cuda()


def kernel_row(torch, *, name, kernel, source, replaces, got, want, run, plain,
               library, flops, nbytes, int8_ops=0.0, reps=10, **extra):
    """One `kernel` row: error against the plain version on the rows
    compared, median times, and the bound from this call's work (bf16 flops
    at the bf16 peak plus int8 operations at the int8 peak, against bytes)."""
    err, scale = max_err(torch, got, want)
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ms = time_ms(torch, run, reps=reps)
    lib_ms = None if library is None else time_ms(torch, library, reps=10)
    return dict(name=name, kernel=kernel, route="cuda", source=source,
                replaces=replaces, max_abs_err=err, max_rel_err=err / scale,
                tol=TOL_ULPS * scale, ms=ms,
                plain_ms=time_ms(torch, plain, reps=2, warmup=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib_ms, ratio_to_library=None if lib_ms is None else ms / lib_ms,
                tflops=(flops + int8_ops) / ms / 1e9, clocks=gpu_clocks(), **extra)


ONLINE_SRC = "video_styler_tpu_torch/csrc/flash_attention_online.cu"
INT8_SRC = "video_styler_tpu_torch/csrc/flash_attention_int8.cu"
JAX_FA = "video_styler_tpu/ops/flash_attention.py"


def check_online_kernels(torch, s, tag, cross: bool, mag: float = 1.0):
    """K2 (with and without stats, and on its 3-D entry) and K8 at 40 heads
    of 128 on `s` query tokens: self-attention, and with `cross` K2 and K8
    against the 512 text tokens too. `mag` scales q (the magnitude stress
    runs K2's self row alone). Each row carries the kernel's registers and
    spills from the build log."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(2)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    q = randn(1, s, n, d, m=mag)
    sub = edge_rows(torch, s)
    rows = []
    for kind, sk in (("self", s),) + ((("cross", TEXT_LEN),) if cross else ()):
        k, v = randn(1, sk, n, d), randn(1, sk, n, d)
        label = f"{kind}{'' if mag == 1.0 else f' q x{mag:g} (magnitude stress)'} " \
                f"S={s} Sk={sk} N={n} D={d} [{tag}]"
        flops = 4.0 * n * s * sk * d
        nbytes = 2.0 * n * d * (2 * s + 2 * sk)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        want, want_l2 = fa.flash_attention_online_plain(q[:, sub], k, v, scale,
                                                        return_stats=True)
        common = dict(source=ONLINE_SRC, library=sdpa, flops=flops, checked_rows=int(sub.numel()))
        k2 = dict(common, ptxas=kernel_usage("flash_fwd_online_kernel"))
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention online {label}", kernel="K2",
            replaces=f"{JAX_FA}:150", got=fa.flash_attention(q, k, v, scale, capped=False)[:, sub],
            want=want, run=lambda: fa.flash_attention(q, k, v, scale, capped=False),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale),
            nbytes=nbytes, **k2))
        if mag != 1.0:
            continue
        out, l2 = fa._flash_forward(q, k, v, scale, with_stats=True, capped=False)
        err_l2 = (l2[:, :, sub] - want_l2).abs().max().item()
        tol_l2 = 1e-4 * max(1.0, want_l2.abs().max().item())
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention online with stats {label}", kernel="K2",
            replaces=f"{JAX_FA}:150", got=out[:, sub], want=want,
            run=lambda: fa._flash_forward(q, k, v, scale, with_stats=True, capped=False),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale, return_stats=True),
            nbytes=nbytes + 4.0 * n * s, l2_max_abs_err=err_l2, l2_tol=tol_l2, **k2))
        if not err_l2 <= tol_l2:
            raise AssertionError(f"K2 L2 {label}: {err_l2} > {tol_l2}")
        del out, l2
        want8 = fa.flash_attention_online_plain(q[:, sub], k, v, scale, dual=True)
        rows.append(kernel_row(
            torch, name=f"K8 flash_attention online dual {label}", kernel="K8",
            replaces=f"{JAX_FA}:288",
            got=fa.flash_attention(q, k, v, scale, capped=False, dual=True)[:, sub],
            want=want8,
            run=lambda: fa.flash_attention(q, k, v, scale, capped=False, dual=True),
            plain=lambda: fa.flash_attention_online_plain(q, k, v, scale, dual=True),
            nbytes=nbytes, ptxas=kernel_usage("flash_fwd_online_dual_kernel"), **common))
        del want8
        del k, v, want, want_l2
    if mag == 1.0 and cross:
        # the 3-D entry on (heads, S, D): the same memory as a batch of
        # one-head problems; q is scaled beforehand, the kernel takes it as is
        q3, k3, v3 = randn(n, s, d), randn(n, s, d), randn(n, s, d)
        want = fa.flash_attention_online_plain(q3[:, sub, None], k3[:, :, None],
                                               v3[:, :, None], scale)[:, :, 0]
        rows.append(kernel_row(
            torch, name=f"K2 flash_attention_3d BH={n} S={s} D={d} [{tag}]", kernel="K2",
            source=ONLINE_SRC, replaces=f"{JAX_FA}:54",
            got=fa.flash_attention_3d(q3, k3, v3, scale)[:, sub], want=want,
            run=lambda: fa.flash_attention_3d(q3, k3, v3, scale),
            plain=lambda: fa.flash_attention_online_plain(
                q3[:, :, None], k3[:, :, None], v3[:, :, None], scale),
            library=lambda: F.scaled_dot_product_attention(q3[None], k3[None], v3[None]),
            flops=4.0 * n * s * s * d, nbytes=2.0 * n * d * 4 * s,
            checked_rows=int(sub.numel()), ptxas=kernel_usage("flash_fwd_online_kernel")))
    for r in rows:
        emit({"phase": "kernel", **r})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def check_online_training(torch, s, tag):
    """K2 with stats feeding K3 under autograd (`flash_attention(...,
    capped=False)` on tensors that require grad) against the plain pair."""
    from video_styler_tpu_torch.ops import flash_attention as fa
    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v, g = ((torch.randn((1, s, n, d), generator=gen, device="cuda")
                   ).to(torch.bfloat16) for _ in range(4))
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches,
              fa.BWD_DQ_KERNEL.launches, fa.KERNEL.launches)
    out = fa.flash_attention(*ins, scale, capped=False)
    l2 = out.grad_fn.saved_tensors[4]
    got = torch.autograd.grad(out, ins, g)
    after = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches,
             fa.BWD_DQ_KERNEL.launches, fa.KERNEL.launches)
    po, pl2 = fa.flash_attention_online_plain(q, k, v, scale, return_stats=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out.detach(), l2, g, scale)
    errs = {}
    for name, t, w in zip(("o", "dq", "dk", "dv"), (out,) + got, (po,) + want):
        err, sc = max_err(torch, t, w)
        errs[name] = dict(max_abs_err=err, tol=TOL_ULPS * sc)
    err_l2 = (l2 - pl2).abs().max().item()
    res = dict(phase="kernel", name=f"K2 with stats -> K3 under autograd S={s} N={n} "
               f"D={d} [{tag}]", kernel="K2+K3", errors=errs, l2_max_abs_err=err_l2,
               l2_tol=1e-4 * max(1.0, pl2.abs().max().item()),
               launches=dict(zip(("K2", "K3", "K3q", "K1"),
                                 (a - b for a, b in zip(after, before)))))
    emit(res)
    if (res["launches"] != {"K2": 1, "K3": 1, "K3q": 0, "K1": 0}
            or not err_l2 <= res["l2_tol"]
            or any(not e["max_abs_err"] <= e["tol"] for e in errs.values())):
        raise AssertionError(f"online route under autograd: {res}")


def check_int8_kernels(torch, s, tag, cross: bool, three_d: bool, mag: float = 1.0):
    """K6 (capped and online bodies) at 40 heads of 128 on `s` query tokens,
    K carrying a +0.7 mean offset for the token-mean smoothing to absorb;
    with `three_d` K7 on (40, s, 128). Kernel and plain version read the
    same pre-pass outputs (the same integers); the pre-pass is timed on its
    own, and so is the bf16 kernel of the same body on the same q, k, v
    (`bf16_ms`: K1 for the capped rows, K2 for the online ones), whether
    int8 attention pays. Each row carries the kernel's registers and spills."""
    from video_styler_tpu_torch.ops import flash_attention as fa

    n, d = 40, 128
    scale = d ** -0.5
    gen = torch.Generator("cuda").manual_seed(4)

    def randn(*shape, m=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * m).to(torch.bfloat16)

    def pick(pre, sub):
        q8, k8, v, qs, ks, m2 = pre
        return (q8[:, sub], k8, v, qs[:, :, sub].contiguous(), ks,
                None if m2 is None else m2[:, :, sub].contiguous())

    q = randn(1, s, n, d, m=mag)
    sub = edge_rows(torch, s)
    rows = []
    # the capped and online instantiations of K6 (K7 is the online one)
    ptxas = {"capped": kernel_usage("flash_fwd_int8_kernelILb1"),
             "online": kernel_usage("flash_fwd_int8_kernelILb0")}
    for kind, sk in (("self", s),) + ((("cross", TEXT_LEN),) if cross else ()):
        k, v = randn(1, sk, n, d) + 0.7, randn(1, sk, n, d)
        label = f"{kind}{'' if mag == 1.0 else f' q x{mag:g} (magnitude stress)'} " \
                f"S={s} Sk={sk} N={n} D={d} [{tag}]"
        prepass_ms = time_ms(torch, lambda: fa.int8_prepass(q, k, v, scale, True), reps=5)
        for body, replaces in (("capped", f"{JAX_FA}:1025"), ("online", f"{JAX_FA}:980")):
            pre = fa.int8_prepass(q, k, v, scale, body == "capped")
            # q8, k8 (1 byte), v, o (2 bytes), the row scales (and bounds)
            nbytes = n * d * (s + sk) + 2.0 * n * d * (s + sk) \
                + 4.0 * n * (s + sk) + (4.0 * n * s if body == "capped" else 0.0)
            rows.append(kernel_row(
                torch, name=f"K6 flash_attention_int8 {body} {label}",
                kernel="K6" if body == "capped" else "K6o", source=INT8_SRC,
                replaces=replaces, got=fa._flash_int8_cuda(*pre)[:, sub],
                want=fa.flash_attention_int8_core_plain(*pick(pre, sub)),
                run=lambda: fa._flash_int8_cuda(*pre),
                plain=lambda: fa.flash_attention_int8_core_plain(*pre), library=None,
                flops=2.0 * n * s * sk * d, int8_ops=2.0 * n * s * sk * d, nbytes=nbytes,
                checked_rows=int(sub.numel()), prepass_ms=prepass_ms,
                bf16_ms=time_ms(torch, lambda: fa.flash_attention(
                    q, k, v, scale, capped=body == "capped"), reps=10), ptxas=ptxas[body]))
            del pre
        del k, v
    if three_d:
        q3, k3, v3 = randn(n, s, d), randn(n, s, d) + 0.7, randn(n, s, d)
        pre = fa.int8_prepass(q3[:, :, None], k3[:, :, None], v3[:, :, None], scale, False)
        rows.append(kernel_row(
            torch, name=f"K7 flash_attention_int8_3d BH={n} S={s} D={d} [{tag}]",
            kernel="K7", source=INT8_SRC, replaces=f"{JAX_FA}:862",
            got=fa._flash_int8_cuda(*pre, three_d=True)[:, sub],
            want=fa.flash_attention_int8_core_plain(*pick(pre, sub)),
            run=lambda: fa._flash_int8_cuda(*pre, three_d=True),
            plain=lambda: fa.flash_attention_int8_core_plain(*pre), library=None,
            flops=2.0 * n * s * s * d, int8_ops=2.0 * n * s * s * d,
            nbytes=n * d * 2 * s + 2.0 * n * d * 2 * s + 4.0 * n * 2 * s,
            checked_rows=int(sub.numel()), ptxas=ptxas["online"],
            bf16_ms=time_ms(torch, lambda: fa.flash_attention_3d(q3, k3, v3, scale), reps=10)))
        # the public entry runs the same pre-pass and kernel
        if not torch.equal(fa.flash_attention_int8_3d(q3, k3, v3, scale),
                           fa._flash_int8_cuda(*pre, three_d=True)[:, :, 0]):
            raise AssertionError("flash_attention_int8_3d differs from its parts")
    for r in rows:
        emit({"phase": "kernel", **r})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


def check_train_reference(torch):
    """Two LoRA steps of the smoke-size model on the card (kernels) and on
    the CPU (plain versions), from the same weights, LoRA, inputs, tid and
    noise (all made on the CPU)."""
    from torch import nn
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.trainers.lora_train import (
        apply_lora, init_lora, lora_parameters, lora_targets)
    from video_styler_tpu_torch.trainers.training import (
        adamw, make_train_step, training_scheduler)

    cpu = build_smoke_pipeline(device="cpu", seed=0)
    f, h, w = 9, 64, 64
    with torch.no_grad():
        context = cpu.encode_prompt("a watercolor city at dusk")
        vctx = cpu.build_vace_context(smoke_frames(f, h, w), None, None, h, w, f,
                                      tiled=False)
    latents = torch.randn((1, 4, 3, 8, 8), generator=torch.Generator().manual_seed(1)
                          ).to(torch.bfloat16)
    for m in (cpu.dit, cpu.vace):
        m.requires_grad_(False)
    dit_g, vace_g = copy.deepcopy(cpu.dit).to("cuda"), copy.deepcopy(cpu.vace).to("cuda")
    lora_c = init_lora(cpu.vace, rank=32,
                       targets=lora_targets("q,k,v,o,ffn.0,ffn.2", "vace"),
                       generator=torch.Generator().manual_seed(0))
    lora_g = {k: {n: nn.Parameter(p.detach().to("cuda")) for n, p in ab.items()}
              for k, ab in lora_c.items()}
    steps = []
    for dit, vace, lora in ((cpu.dit, cpu.vace, lora_c), (dit_g, vace_g, lora_g)):
        apply_lora(vace, lora)
        params = lora_parameters(lora)
        steps.append((make_train_step(dit, adamw(params, 1e-4), training_scheduler(),
                                      vace=vace), params))
    draws = torch.Generator().manual_seed(2)
    res = dict(phase="train_reference", frames=f, height=h, width=w, lora_rank=32,
               loss_cpu=[], loss_gpu=[], grads_rel_l2=[], lora_rel_l2=[],
               loss_rel_tol=5e-2, grads_tol=5e-2, lora_tol=1e-3)

    def cat(ts):
        return torch.cat([t.detach().float().reshape(-1).cpu() for t in ts])

    for _ in range(2):
        tid = int(torch.randint(0, 1000, (), generator=draws))
        noise = torch.randn(latents.shape, generator=draws)
        out = []
        for (step, params), dev in zip(steps, ("cpu", "cuda")):
            loss = step(latents.to(dev), context.to(dev), vctx.to(dev), tid=tid,
                        noise=noise)
            out.append((float(loss), cat(p.grad for p in params), cat(params)))
        (lc, gc, pc), (lg, gg, pg) = out
        res["loss_cpu"].append(lc)
        res["loss_gpu"].append(lg)
        res["grads_rel_l2"].append(((gg - gc).norm() / gc.norm()).item())
        res["lora_rel_l2"].append(((pg - pc).norm() / pc.norm()).item())
    emit(res)
    # tolerance: the bf16 model rounds at other points on the two devices
    # (cuBLAS vs CPU GEMMs, kernels vs plain); AdamW's step moves each entry
    # by about lr, so the updated LoRA stays within ~lr of the CPU's
    ok = all(abs(g - c) <= 5e-2 * abs(c) for g, c in zip(res["loss_gpu"], res["loss_cpu"]))
    ok = ok and max(res["grads_rel_l2"]) <= 5e-2 and max(res["lora_rel_l2"]) <= 1e-3
    if not ok or not all(map(math.isfinite, res["loss_gpu"])):
        raise AssertionError(f"LoRA steps on the card and the CPU disagree: {res}")


def expected_train_launches(dit_cfg, vace_cfg, targets, steps: int):
    """Kernel launches of `steps` LoRA steps on the VACE branch, from the
    configuration. Trunk blocks up to the first VACE layer see no input that
    needs a gradient: they run forward only, unrecorded. The others and
    every VACE block are rematerialised (one more forward each) and
    differentiated. Self-attention backward needs dq and dK/dV (K3); the
    trunk's cross-attention keys come from the frozen text path, so only dq
    (K3q), while the VACE cross-attention's k/v carry the LoRA when it
    targets them."""
    n_trunk, n_vace = dit_cfg.num_layers, len(vace_cfg.vace_layers)
    trunk_bwd = n_trunk - 1 - vace_cfg.vace_layers[0]
    fwd = n_trunk + n_vace
    recompute = trunk_bwd + n_vace
    cross_kv = bool({"blocks.cross_attn.k", "blocks.cross_attn.v"} & set(targets))
    per_step = {"K1": 2 * (fwd + recompute), "K4": fwd + recompute,
                "K5": fwd + recompute,
                "K3": trunk_bwd + n_vace + (n_vace if cross_kv else 0),
                "K3q": trunk_bwd + (0 if cross_kv else n_vace)}
    return {k: v * steps for k, v in per_step.items()}


def run_train(torch, pipe, kernels, frames: int, steps: int = 2):
    """The Ditto LoRA recipe at 14B width on the loaded pipeline, through the
    training CLI's data path (`video_styler_tpu_torch.train`): its
    `preprocess` of the train clip with umT5 parked on the host between
    encodes (`park_encoders`, as the CLI trains from a dataset), written by
    `launch_data_process_task` and read back by `CachedLatentDataset` and
    `cached_inputs`; then umT5 and the VAE parked as the CLI parks them
    when it trains from a cache."""
    from video_styler_tpu_torch import train as cli
    from video_styler_tpu_torch.trainers.latent_cache import (
        CachedLatentDataset, launch_data_process_task)
    from video_styler_tpu_torch.trainers.lora_train import (
        apply_lora, init_lora, lora_parameters, lora_targets)
    from video_styler_tpu_torch.trainers.training import (
        adamw, flow_match_loss, make_train_step, training_scheduler)

    f, h, w = frames, 480, 832
    args = cli.parse_args(["--height", str(h), "--width", str(w), "--num_frames", str(f),
                           "--lora_base_model", "vace", "--lora_rank", "128",
                           "--extra_inputs", "vace_video"])[1]
    keys = ("latents", "context", "vace_context")
    for m in (pipe.dit, pipe.vace, pipe.vae, pipe.prompter.text_encoder):
        m.requires_grad_(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text_encoder = cli.park_encoders(pipe, cache_fed=False)
    torch.cuda.synchronize()
    park_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with text_encoder:
        torch.cuda.synchronize()
        borrow_s = time.perf_counter() - t0
    in_memory = {}

    def preprocess(row):
        """train.py's preprocess, its result kept as the in-memory inputs."""
        in_memory.update(cli.preprocess(pipe, row, args, text_encoder))
        return dict(in_memory)

    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        t0 = time.perf_counter()
        written = launch_data_process_task(
            [{"prompt": "turn the scene into a watercolor painting",
              "video": frames_480x832(f)}], preprocess, cache)
        torch.cuda.synchronize()
        data_process_s = (time.perf_counter() - t0) / len(written)
        data_process_peak = torch.cuda.max_memory_allocated()
        cache_mb = sum(os.path.getsize(p) for p in written) / 1e6
        sample = cli.cached_inputs(pipe, CachedLatentDataset(cache)[0])
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    latents, context, vace_context = (sample[k] for k in keys)
    cache_bit_equal = {k: bool(torch.equal(in_memory[k], sample[k])) for k in keys}
    cli.park_encoders(pipe, cache_fed=True)
    torch.cuda.synchronize()

    targets = lora_targets("q,k,v,o,ffn.0,ffn.2", "vace")
    gen = torch.Generator().manual_seed(0)
    lora = init_lora(pipe.vace, rank=128, targets=targets, generator=gen)
    apply_lora(pipe.vace, lora)
    params = lora_parameters(lora)
    sched = training_scheduler()
    step = make_train_step(pipe.dit, adamw(params, 1e-4), sched,
                           vace=pipe.vace, remat=True)
    # one loss from the in-memory inputs and one from the cached ones, with
    # the same tid and noise
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        same_loss = [float(flow_match_loss(
            pipe.dit, inputs["latents"], inputs["context"], sched.sigmas, sched.timesteps,
            sched.linear_timesteps_weights, tid=500, noise=noise, vace=pipe.vace,
            vace_context=inputs["vace_context"]))
            for inputs in (in_memory, sample)]
    del in_memory, sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(latents, context, vace_context, generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: kern.launches for name, kern in kernels.items()}
    expected = expected_train_launches(pipe.dit.cfg, pipe.vace.cfg, targets,
                                       steps)
    res = dict(phase="train", dit_layers=pipe.dit.cfg.num_layers,
               vace_layers=list(pipe.vace.cfg.vace_layers), frames=f,
               tokens=int(math.prod(token_grid(f))), latents=list(latents.shape),
               lora_rank=128, lora_targets=list(targets),
               lora_params=sum(p.numel() for p in params), remat="trunk and VACE",
               encoders="umT5 on the host between encodes, then umT5 and the VAE "
                        "on the host for the cache-fed steps (train.park_encoders)",
               inputs="train.preprocess (streaming VAE encodes) -> latent cache "
                      "(launch_data_process_task, CachedLatentDataset, "
                      "train.cached_inputs)",
               park_umt5_s=park_s, umt5_to_card_s=borrow_s,
               data_process_s_per_sample=data_process_s,
               data_process_peak_gib=data_process_peak / 2**30,
               cache_mb_per_sample=cache_mb,
               cache_bit_equal_to_in_memory=cache_bit_equal,
               loss_in_memory_vs_cached=same_loss, losses=losses, step_s=step_s,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, expected_launches=expected)
    emit(res)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(cache_bit_equal.values()) or same_loss[0] != same_loss[1]:
        raise AssertionError("the cached inputs differ from the in-memory ones")
    check_launches(launches, expected, "train")
    emit({"phase": "train_profile", **profile_request(
        torch, lambda: step(latents, context, vace_context, generator=gen),
        step_s[-1])})
    return launches, (latents, context, vace_context, params)


@contextlib.contextmanager
def plain_versions():
    """Send the DiT's attention, RMSNorm+RoPE and RMSNorm through their plain
    PyTorch versions on the card, for activations the kernels do not take
    (fp32). A measurement device of this script: the port itself never runs
    a plain version on a CUDA tensor."""
    from video_styler_tpu_torch.models import wan_dit
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    saved = (wan_dit.attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm)
    wan_dit.attention = fa.flash_attention_plain
    wan_dit.fused_rmsnorm_rope = fnr.fused_rmsnorm_rope_plain
    wan_dit.fused_rmsnorm = fnr.fused_rmsnorm_plain
    try:
        yield
    finally:
        wan_dit.attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm = saved


def run_train_precision(torch, pipe, kernels, inputs, frames: int):
    """One LoRA loss and gradient at 14B width and full depth on the train
    clip, twice from the same tid and noise: bf16 activations through the
    kernels (what the port's trainer runs) and fp32 activations on the bf16
    weights through the plain versions (the recipe, examples/train.py:281)."""
    from video_styler_tpu_torch.trainers.training import (flow_match_loss,
                                                          training_scheduler)
    latents, context, vace_context, params = inputs
    sched = training_scheduler()
    tables = (sched.sigmas, sched.timesteps, sched.linear_timesteps_weights)
    tid = 500
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(5))

    def loss_and_grads(dtype):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        loss = flow_match_loss(pipe.dit, latents.to(dtype), context.to(dtype), *tables,
                               tid=tid, noise=noise, vace=pipe.vace,
                               vace_context=vace_context.to(dtype), remat=True)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return dict(loss=float(loss), seconds=time.perf_counter() - t0,
                    max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                    kernel_launches=sum(k.launches for k in kernels.values())), \
            torch.cat([g.float().reshape(-1) for g in grads])

    bf16, g16 = loss_and_grads(torch.bfloat16)
    with plain_versions():
        fp32, g32 = loss_and_grads(torch.float32)
    res = dict(phase="train_precision", frames=frames,
               tokens=int(math.prod(token_grid(frames))),
               dit_layers=pipe.dit.cfg.num_layers,
               vace_layers=list(pipe.vace.cfg.vace_layers), tid=tid,
               lora_params=int(g32.numel()), bf16_activations=bf16,
               fp32_activations=fp32,
               loss_rel_err=abs(bf16["loss"] - fp32["loss"]) / abs(fp32["loss"]),
               lora_grads_rel_l2=((g16 - g32).norm() / g32.norm()).item(),
               lora_grads_cosine=(torch.dot(g16, g32) / (g16.norm() * g32.norm())).item())
    emit(res)
    if not (math.isfinite(res["loss_rel_err"]) and math.isfinite(res["lora_grads_rel_l2"])
            and bf16["kernel_launches"] > 0 and fp32["kernel_launches"] == 0):
        raise AssertionError(f"train_precision: {res}")


# ------------------------------------------------- editor and enhancer phases

def check_card_against_cpu(torch, phase, cpu, gpu, run, **extra):
    """run(pipe) -> latents on the CPU pipeline and on its card copy, within
    the 5% relative L2 of `reference`."""
    lat_c = run(cpu).float()
    lat_g = run(gpu).float().cpu()
    rel = ((lat_g - lat_c).norm() / lat_c.norm()).item()
    res = dict(phase=phase, latents_shape=list(lat_c.shape), latents_rel_l2=rel,
               latents_tol=5e-2, finite=bool(torch.isfinite(lat_g).all()), **extra)
    return res, rel <= 5e-2 and res["finite"]


def check_editor_reference(torch):
    """The smoke-size editor (9 frames of 32x32, keyframes at frames 0 and
    8, CFG 5 two-pass, 2 steps, no TeaCache), card against CPU."""
    from video_styler_tpu_torch.infer_ditto import smoke_frames
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    from video_styler_tpu_torch.step2_video_editing import build_smoke_pipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoEditorPipeline)
    video = smoke_frames(9, 32, 32)
    kw = dict(prompt="a watercolor city at dusk", source_video=video,
              edited_keyframes=255 - video[[0, 8]], keyframe_indices=[0, 8],
              num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
              num_inference_steps=2, alpha=10.0, tiled=True, verbose=False,
              return_latents=True)
    res, ok = check_card_against_cpu(torch, "editor_reference", cpu, gpu,
                                     lambda pipe: pipe(**kw), keyframes=[0, 8],
                                     steps=2, cfg="two-pass 5.0")
    emit(res)
    if not ok:
        raise AssertionError(f"editor, card vs CPU disagree: {res}")


ENHANCE_WINDOW = dict(sampling_steps=8, forward_step=6, skip_backward_step=6, shift=5.0,
                      guide_scale=(3.0, 4.0), boundary=0.875, seed=42)


def check_enhance_reference(torch):
    """The smoke-size enhancer with two distinct tiny experts on a window
    that crosses the boundary (timesteps 937, 892 on the high-noise expert;
    833, 749, 624, 416 on the low-noise one), card against CPU."""
    from video_styler_tpu_torch.enhance_video import build_smoke_pipeline
    from video_styler_tpu_torch.infer_ditto import smoke_frames
    from video_styler_tpu_torch.pipelines.wan_enhancer import WanEnhancerPipeline
    cpu = build_smoke_pipeline(device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanEnhancerPipeline)
    video = smoke_frames(9, 32, 32)
    res, ok = check_card_against_cpu(
        torch, "enhance_reference", cpu, gpu,
        lambda pipe: pipe.enhance(video, prompt="sharp and clean", return_latents=True,
                                  **ENHANCE_WINDOW), window=ENHANCE_WINDOW)
    res["experts"] = gpu.experts
    emit(res)
    if not ok or {w for _, w in gpu.experts} != {"dit", "dit2"}:
        raise AssertionError(f"enhancer, card vs CPU disagree: {res}")


def step_times(pipe):
    return [s for name, s in pipe.stage_times if name.startswith("denoise_step_")]


def editor_keyframes(frames: int):
    """Pixel frames of the editor phase's keyframes: the first and the last,
    and the middle one from 73 frames on."""
    return [0, frames - 1] if frames < DITTO_FRAMES else [0, (frames - 1) // 2, frames - 1]


def run_editor(torch, pipe, kernels, frames: int, steps: int):
    """The keyframe-guided editor on the loaded 14B pipeline's DiT (no
    VACE): a 480x832 clip, keyframes from `editor_keyframes`, CFG 5 two-pass,
    alpha 10, streaming VAE; launches counted from 0."""
    import numpy as np
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    ed = WanVideoEditorPipeline(device="cuda")
    ed.__dict__.update(pipe.__dict__)
    video = frames_480x832(frames)
    kf = editor_keyframes(frames)
    t_lat = (frames - 1) // 4 + 1
    kf_lat = ed.latent_keyframe_indices(kf, t_lat)
    grid = (t_lat + len(kf_lat), 30, 52)
    n_layers = ed.dit.cfg.num_layers

    def request():
        return ed(prompt="turn the scene into a watercolor painting", source_video=video,
                  edited_keyframes=255 - video[kf], keyframe_indices=kf, seed=42,
                  height=480, width=832, num_frames=frames, cfg_scale=5.0,
                  num_inference_steps=steps, alpha=10.0, tiled=True, verbose=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = request()
    total_s = time.perf_counter() - t0
    forwards = 2 * steps
    expected = {"K1": 2 * n_layers * forwards, "K4": n_layers * forwards,
                "K5": n_layers * forwards}
    launches = {name: kern.launches for name, kern in kernels.items()}
    res = dict(phase="editor", frames=frames, keyframes=kf, latent_keyframes=kf_lat,
               joint_tokens=int(np.prod(grid)), dit_layers=n_layers, steps=steps,
               cfg="two-pass 5.0", alpha=10.0, total_s=total_s,
               stages=dict(ed.stage_times), step_s=step_times(ed),
               stage_peak_gib={k: v / 2**30 for k, v in ed.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               metrics=ed.metrics, output_shape=list(out.shape),
               decoded_video_finite=True, launches=launches,
               expected_launches=expected)
    emit(res)
    check_launches(launches, expected, "editor")
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"editor output shape {out.shape}")
    emit({"phase": "editor_profile", **profile_request(torch, request, total_s)})
    return launches, grid, ed.construct_rope_ids(t_lat, kf_lat)


def run_enhance(torch, pipe, kernels, frames: int):
    """The Wan2.2 enhancer at A14B width: the loaded DiT as the low-noise
    expert and a second WAN_T2V_14B DiT from a seed as the high-noise one,
    both resident; umT5 and VACE parked on the host (`train.HostParked`)
    with umT5 brought back for each prompt encode. A 480x832 clip, the
    boundary-crossing window, guide scales (3, 4), streaming VAE."""
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_enhancer import WanEnhancerPipeline
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.train import HostParked
    enh = WanEnhancerPipeline(device="cuda")
    enh.__dict__.update(pipe.__dict__)
    enh.vace = None
    parked_t5 = HostParked(pipe.prompter.text_encoder)
    parked_vace = HostParked(pipe.vace)

    def encode_prompt(prompt):
        with parked_t5:
            return WanVideoPipeline.encode_prompt(enh, prompt)
    enh.encode_prompt = encode_prompt

    t0 = time.perf_counter()
    with torch.device("meta"):
        dit2 = WanDiT(WAN_T2V_14B, dtype=torch.bfloat16)
    enh.dit2 = init_weights_(dit2.to_empty(device="cuda"),
                             torch.Generator("cuda").manual_seed(1)).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_layers = enh.dit.cfg.num_layers
    steps = ENHANCE_WINDOW["skip_backward_step"]
    res = dict(phase="enhance", frames=frames,
               tokens=int(math.prod(token_grid(frames))), dit_layers=n_layers,
               window=ENHANCE_WINDOW, dit2_build_s=build_s,
               weights_on_card_gib=torch.cuda.memory_allocated() / 2**30,
               parked_on_host=["umT5", "VACE"])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels.values():
            kern.launches = 0
        video = frames_480x832(frames)

        def request():
            return enh.enhance(video, prompt="sharp, clean, detailed",
                               negative_prompt="blurry, noisy", tiled=True,
                               **ENHANCE_WINDOW)
        t0 = time.perf_counter()
        try:
            out = request()
        except torch.cuda.OutOfMemoryError as e:
            if frames <= RUN_FRAMES:
                raise
            res.update(fits=False, error=str(e).splitlines()[0],
                       max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
            emit(res)
            return {}
        total_s = time.perf_counter() - t0
        expected = {"K1": 2 * n_layers * 2 * steps, "K4": n_layers * 2 * steps,
                    "K5": n_layers * 2 * steps}
        launches = {name: kern.launches for name, kern in kernels.items()}
        res.update(fits=True, total_s=total_s, stages=dict(enh.stage_times),
                   steps=[dict(timestep=t, expert=w, seconds=s) for (t, w), s
                          in zip(enh.experts, step_times(enh))],
                   stage_peak_gib={k: v / 2**30 for k, v in enh.stage_peak_bytes},
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                   output_shape=list(out.shape), decoded_video_finite=True,
                   launches=launches, expected_launches=expected)
        emit(res)
        check_launches(launches, expected, "enhance")
        if out.shape != (frames, 480, 832, 3) or \
                {w for _, w in enh.experts} != {"dit", "dit2"}:
            raise AssertionError(f"enhance: {res}")
        emit({"phase": "enhance_profile", **profile_request(torch, request, total_s)})
        return launches
    finally:
        enh.dit2 = dit2 = None
        del enh
        parked_t5.__enter__()    # back on the card for the later phases
        parked_vace.__enter__()
        gc.collect()
        torch.cuda.empty_cache()


def run_entry_3d(torch, kernels, s: int):
    """The (BH, S, D) entry points, as a caller of them would drive them:
    `flash_attention_3d` without and with grad (K2, then K2 with stats and
    K3) and `flash_attention_int8_3d` (K7), at 40 heads of 128."""
    from video_styler_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(6)
    q, k, v = ((torch.randn((40, s, 128), generator=gen, device="cuda")
                ).to(torch.bfloat16) for _ in range(3))
    for kern in kernels.values():
        kern.launches = 0
    out = fa.flash_attention_3d(q, k, v)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention_3d(*ins), ins, out)
    out8 = fa.flash_attention_int8_3d(q, k, v)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    expected = {"K2": 2, "K3": 1, "K7": 1}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, out8) + grads)
    # the exact softmax and its int8 approximation on the same inputs
    cosine = torch.nn.functional.cosine_similarity(
        out.float().reshape(1, -1), out8.float().reshape(1, -1)).item()
    emit(dict(phase="entry_3d", shape=[40, s, 128], launches=launches,
              expected_launches=expected, finite=finite, int8_vs_bf16_cosine=cosine))
    if not finite or cosine < 0.99 or any(
            count != expected.get(name, 0) for name, count in launches.items()):
        raise AssertionError("entry_3d: launches, finiteness or int8 agreement")
    return launches


# ------------------------------------------------ image-conditioned phases

def check_image_references(torch):
    """`i2v_reference`: the FLF2V smoke recipe of `wan_video_gen` (a tiny
    CLIP tower, y, both images); `ti2v_reference`: the TI2V smoke recipe
    (the fused first frame on a tiny Wan2.2-family VAE). 9 frames, CFG 5
    two-pass, 2 steps, card against CPU on the same weights."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    for phase, name in (("i2v_reference", "Wan2.1-FLF2V-14B-720P"),
                        ("ti2v_reference", "Wan2.2-TI2V-5B")):
        recipe = G.RECIPES[name]
        cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
        gpu = card_copy(torch, cpu, WanVideoPipeline)
        h, w, _ = G.smoke_size(recipe)
        images = G.smoke_images(recipe, h, w)
        kw = dict(prompt="a lighthouse in a storm", negative_prompt="blurry",
                  num_frames=9, height=h, width=w, seed=42, cfg_scale=5.0,
                  num_inference_steps=2, tiled=True, return_latents=True, **images)
        res, ok = check_card_against_cpu(torch, phase, cpu, gpu, lambda pipe: pipe(**kw),
                                         recipe=name, images=sorted(images), steps=2,
                                         cfg="two-pass 5.0")
        emit(res)
        if not ok:
            raise AssertionError(f"{name} smoke, card vs CPU disagree: {res}")


def random_module(torch, cls, cfg, init, seed: int, dtype):
    """`cls(cfg)` on the card with random weights from `init` and a seed."""
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    return init(module.to_empty(device="cuda"),
                torch.Generator("cuda").manual_seed(seed)).eval()


def gib(modules) -> float:
    return sum(t.numel() * t.element_size() for m in modules
               for t in list(m.parameters()) + list(m.buffers())) / 2**30


def run_image_request(torch, pipe, kernels, phase: str, steps: int, request: dict,
                      profile: bool = False, **extra):
    """One request of `pipe` with every launch count set to 0 just before
    and read just after; K1 runs per block and CFG pass once for
    self-attention, once for the text and once more for an image branch,
    K4 and K5 once. Returns (result, output, launches)."""
    cfg = pipe.dit.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    out = pipe(**request)
    total_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    forwards = 2 * steps
    expected = {"K1": (3 if cfg.has_image_input else 2) * cfg.num_layers * forwards,
                "K4": cfg.num_layers * forwards, "K5": cfg.num_layers * forwards}
    res = dict(phase=phase, dit_dim=cfg.dim, dit_heads=cfg.num_heads,
               dit_layers=cfg.num_layers, frames=request["num_frames"],
               height=request["height"], width=request["width"], steps=steps,
               cfg="two-pass 5.0", total_s=total_s, stages=dict(pipe.stage_times),
               step_s=step_times(pipe),
               stage_peak_gib={k: v / 2**30 for k, v in pipe.stage_peak_bytes},
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               output_shape=list(out.shape), launches=launches, expected_launches=expected,
               launches_per_two_pass_step={k: v / steps for k, v in launches.items() if v},
               **extra)
    emit(res)
    check_launches(launches, expected, phase)
    if profile:
        emit({"phase": f"{phase}_profile",
              **profile_request(torch, lambda: pipe(**request), total_s)})
    return res, out, launches


def run_i2v(torch, pipe, kernels, frames: int, steps: int):
    """Wan2.1-I2V-14B-480P at full width on the card: a random
    `WAN_I2V_14B` DiT (seed 2) and `CLIP_VIT_H_14` tower (seed 3) beside
    the loaded umT5-XXL and Wan2.1 VAE; the --frames 480x832 clip's first
    frame as the image, --steps steps, CFG 5 two-pass; profiled. Then an
    FLF2V request (a random 514-row position table, the clip's last frame
    as the end image) and a dual-expert request of 2 steps (t = 1000 on
    `dit`, 833 on a second I2V expert from seed 5 below switch_DiT_boundary
    0.875; its latents, not decoded) with umT5 and CLIP parked on the host.
    The caller has freed the VACE pipeline's DiT and VACE."""
    import dataclasses
    from video_styler_tpu_torch.models.clip_vit import CLIP_VIT_H_14, ClipVit, init_clip_vit_
    from video_styler_tpu_torch.models.wan_dit import WAN_I2V_14B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.train import HostParked

    before_gib = torch.cuda.memory_allocated() / 2**30
    ip = WanVideoPipeline(device="cuda")
    ip.vae, ip.prompter = pipe.vae, pipe.prompter
    t0 = time.perf_counter()
    ip.dit = random_module(torch, WanDiT, WAN_I2V_14B, init_weights_, 2, torch.bfloat16)
    ip.image_encoder = random_module(torch, ClipVit, CLIP_VIT_H_14, init_clip_vit_, 3,
                                     torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    video = frames_480x832(frames)
    base = dict(prompt="the camera slowly pushes in as the light changes",
                negative_prompt="blurry, static", height=480, width=832, num_frames=frames,
                seed=42, cfg_scale=5.0, num_inference_steps=steps, tiled=True)
    path = {}
    params_b = sum(p.numel() for p in ip.dit.parameters()) / 1e9
    res, out, path["i2v"] = run_image_request(
        torch, ip, kernels, "i2v", steps, dict(base, input_image=video[0]), profile=True,
        tokens=int(math.prod(token_grid(frames))), dit_params_b=params_b,
        dit_gib=gib([ip.dit]), clip_gib=gib([ip.image_encoder]),
        allocated_before_build_gib=before_gib, build_s=build_s,
        weights_on_card_gib=torch.cuda.memory_allocated() / 2**30)
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"i2v output shape {out.shape}")

    # FLF2V: the same trunk with the CLIP position table of two images
    gen = torch.Generator("cuda").manual_seed(4)
    ip.dit.img_emb.emb_pos = torch.nn.Parameter(
        (torch.randn((1, 2 * CLIP_ROWS, 1280), generator=gen, device="cuda")
         / math.sqrt(1280)).to(torch.bfloat16))
    ip.dit.cfg = dataclasses.replace(WAN_I2V_14B, has_image_pos_emb=True)
    try:
        _, out, _ = run_image_request(
            torch, ip, kernels, "i2v_flf2v", steps,
            dict(base, input_image=video[0], end_image=video[-1]),
            text_branch_keys=FLF2V_TEXT_ROWS, image_branch_keys=CLIP_ROWS)
    finally:
        del ip.dit.img_emb.emb_pos
        ip.dit.cfg = WAN_I2V_14B
    if out.shape != (frames, 480, 832, 3):
        raise AssertionError(f"flf2v output shape {out.shape}")

    # two I2V experts resident: umT5 and CLIP wait on the host between uses
    parked_t5 = HostParked(ip.prompter.text_encoder)
    parked_clip = HostParked(ip.image_encoder)

    def encode_prompt(prompt):
        with parked_t5:
            return WanVideoPipeline.encode_prompt(ip, prompt)

    def encode_clip(image_np):
        with parked_clip:
            return WanVideoPipeline.encode_clip(ip, image_np)
    ip.encode_prompt, ip.encode_clip = encode_prompt, encode_clip
    experts = []

    def expert(which):
        experts.append(which)
        return WanVideoPipeline._expert(ip, which)
    ip._expert = expert
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ip.dit2 = random_module(torch, WanDiT, WAN_I2V_14B, init_weights_, 5, torch.bfloat16)
        torch.cuda.synchronize()
        dit2_s = time.perf_counter() - t0
        res, out, _ = run_image_request(
            torch, ip, kernels, "i2v_dual_expert", 2,
            dict(base, input_image=video[0], num_inference_steps=2, return_latents=True),
            parked_on_host=["umT5", "CLIP"], dit2_build_s=dit2_s,
            weights_on_card_gib=torch.cuda.memory_allocated() / 2**30,
            experts_per_forward=experts, switch_DiT_boundary=0.875,
            timesteps=[float(t) for t in ip.scheduler.timesteps])
        if experts != ["dit", "dit", "dit2", "dit2"] or not torch.isfinite(out.float()).all():
            raise AssertionError(f"dual-expert I2V: experts {experts}, shape {out.shape}")
    finally:
        ip.dit = ip.dit2 = ip.image_encoder = None
        parked_t5.__enter__()    # umT5 back on the card for the TI2V phase
        del ip, parked_clip
        gc.collect()
        torch.cuda.empty_cache()
    return path["i2v"]


def run_ti2v(torch, pipe, kernels, steps: int):
    """Wan2.2-TI2V-5B at full width: a random `WAN_TI2V_5B` DiT (seed 6)
    and `WAN22_VAE` (seed 7, fp32) with the loaded umT5-XXL; the recipe's
    49 frames of 480x832 (5,070 tokens), the first frame as the image,
    `steps` steps, CFG 5 two-pass, streaming encode and decode. The image's
    latent (the pipeline's own encode, captured) must equal the first latent
    frame bit for bit after the loop."""
    from video_styler_tpu_torch.models import wan_vae as V
    from video_styler_tpu_torch.models.wan_dit import WAN_TI2V_5B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline, _preprocess_images

    tp = WanVideoPipeline(device="cuda")
    tp.prompter = pipe.prompter
    t0 = time.perf_counter()
    tp.dit = random_module(torch, WanDiT, WAN_TI2V_5B, init_weights_, 6, torch.bfloat16)
    tp.vae = random_module(torch, V.WanVAE38, V.WAN22_VAE, V.init_wan_vae_, 7, torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    encodes = []

    def encode_video(video_np, **tiler):
        encodes.append(WanVideoPipeline.encode_video(tp, video_np, **tiler))
        return encodes[-1]
    tp.encode_video = encode_video
    image = frames_480x832(TI2V_FRAMES)[0]
    request = dict(prompt="a paper boat drifts down a rainy street",
                   negative_prompt="blurry, static", input_image=image, height=480,
                   width=832, num_frames=TI2V_FRAMES, seed=42, cfg_scale=5.0,
                   num_inference_steps=steps, tiled=True, return_latents=True)
    try:
        res, lat, launches = run_image_request(
            torch, tp, kernels, "ti2v", steps, request,
            tokens=int(math.prod(TI2V_GRID)), build_s=build_s,
            dit_params_b=sum(p.numel() for p in tp.dit.parameters()) / 1e9,
            dit_gib=gib([tp.dit]), vae_gib=gib([tp.vae]))
        first = encodes[0]
        again = tp.encode_video(_preprocess_images([image]), tiled=True)
        with tp._stage("vae_decode"):
            frames = tp.vae_output_to_video(tp.decode_video(lat))
        check = dict(phase="ti2v_check", latents_shape=list(lat.shape),
                     first_frame_bit_equal_to_image_encode=bool(torch.equal(lat[:, :, :1],
                                                                            first)),
                     image_encode_repeats_bit_equal=bool(torch.equal(again, first)),
                     latents_finite=bool(torch.isfinite(lat.float()).all()),
                     decode_s=tp.stage_times[-1][1], frames_shape=list(frames.shape),
                     max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit(check)
        if not (check["first_frame_bit_equal_to_image_encode"] and check["latents_finite"]
                and lat.shape == (1, 48, 13, 30, 52)
                and frames.shape == (TI2V_FRAMES, 480, 832, 3)):
            raise AssertionError(f"ti2v: {check}")
        return launches
    finally:
        tp.dit = tp.vae = None
        del tp, encodes
        gc.collect()
        torch.cuda.empty_cache()


KERNEL_CATEGORIES = (  # (category, substrings of the device kernel's name)
    ("K1", ("flash_fwd_capped_kernel",)),
    ("K2", ("flash_fwd_online_kernel",)),
    ("K8", ("flash_fwd_online_dual_kernel",)),
    ("K6", ("flash_fwd_int8_kernel",)),
    ("K3", ("fa_bwd_kernel<true>",)),
    ("K3q", ("fa_bwd_kernel<false>",)),
    ("K3 stats/convert", ("fa_bwd_stats_kernel", "fa_bwd_convert_kernel")),
    ("K4", ("rmsnorm_rope_kernel",)),
    ("K5", ("rmsnorm_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d", "conv3d")),
    ("int8 gemm", ("i8i8", "_s8_", "int8", "imma", "igemm", "i8816", "i16832")),
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
    ap.add_argument("--train-frames", type=int, default=RUN_FRAMES,
                    help="frames (4k+1) of the 480x832 clip of the LoRA steps")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the load phase writes its ~47 GB of checkpoint "
                         "files (in a new folder it removes; default: the "
                         "temporary directory)")
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
    PTXAS.update(ptxas_usage(cuda_build.BUILD_DIR))
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), build_s=build_s, ptxas=PTXAS))

    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL,
               "K3": fa.BWD_KERNEL, "K3q": fa.BWD_DQ_KERNEL,
               "K2": fa.ONLINE_KERNEL, "K8": fa.DUAL_KERNEL,
               "K6": fa.INT8_CAPPED_KERNEL, "K6o": fa.INT8_ONLINE_KERNEL,
               "K7": fa.INT8_3D_KERNEL}
    ditto, run = token_grid(DITTO_FRAMES), token_grid(args.frames)
    rows = check_kernels(torch, ditto, f"ditto-{DITTO_FRAMES}f")
    if args.frames != DITTO_FRAMES:
        rows += check_kernels(torch, run, f"run-{args.frames}f")
    # the image-conditioned path's new shapes: K1 cross to the 257 CLIP rows
    # and to FLF2V's 769-row text branch at this run's and the I2V recipe's
    # 32,760 query rows; TI2V-5B's 24 heads (Dm 3072) over 5,070 tokens
    image_lens = (CLIP_ROWS, FLF2V_TEXT_ROWS)
    for frames in sorted({args.frames, I2V_RECIPE_FRAMES}):
        rows += check_kernels(torch, token_grid(frames), f"i2v-{frames}f",
                              cross_lens=image_lens, self_attn=False, norms=False)
    rows += check_kernels(torch, TI2V_GRID, f"ti2v-{TI2V_FRAMES}f", heads=24)
    torch.cuda.empty_cache()
    s_ditto = math.prod(ditto)
    s_run = math.prod(run)
    s_train = math.prod(token_grid(args.train_frames))
    train_rows = check_attention_training(torch, s_ditto, s_ditto,
                                          f"ditto-{DITTO_FRAMES}f", "self",
                                          check_heads=2)
    train_rows += check_attention_training(torch, s_ditto, TEXT_LEN,
                                           f"ditto-{DITTO_FRAMES}f", "cross")
    if args.train_frames != DITTO_FRAMES:
        for kind, sk in (("self", s_train), ("cross", TEXT_LEN)):
            train_rows += check_attention_training(torch, s_train, sk,
                                                   f"train-{args.train_frames}f", kind)
    # q x8: logits of std ~11 (RMS-normed q/k give ~1.4). The capped
    # softmax holds up to a largest logit of ~96 + 127 bits; q x24 over
    # 4,680^2 logits per head passes that (both the kernel and its plain
    # version overflow there, as the Pallas kernel would)
    train_rows += check_attention_training(torch, s_train, s_train,
                                           f"train-{args.train_frames}f",
                                           "self q x8 (magnitude stress)", mag=8.0)
    torch.cuda.empty_cache()

    # the online-softmax and int8 kernels, at the Ditto shapes and this run's
    new_rows = check_online_kernels(torch, s_ditto, f"ditto-{DITTO_FRAMES}f", cross=True)
    new_rows += check_int8_kernels(torch, s_ditto, f"ditto-{DITTO_FRAMES}f", cross=True,
                                   three_d=True)
    if args.frames != DITTO_FRAMES:
        new_rows += check_online_kernels(torch, s_run, f"run-{args.frames}f", cross=False)
        new_rows += check_int8_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                       three_d=False)
    # the q x24 logits that the capped softmax cannot take (above): the
    # running max can; the int8 kernels are stressed at q x8 like K1
    new_rows += check_online_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                     mag=24.0)
    new_rows += check_int8_kernels(torch, s_run, f"run-{args.frames}f", cross=False,
                                   three_d=False, mag=8.0)
    check_online_training(torch, s_train, f"train-{args.train_frames}f")
    torch.cuda.empty_cache()

    check_reference(torch)
    check_reference_quant(torch)
    check_train_reference(torch)
    check_editor_reference(torch)
    check_enhance_reference(torch)
    check_image_references(torch)
    pipe, init_s = build_pipeline(torch)
    e2e_frames = []
    run_edit(torch, pipe, kernels, args.steps, args.frames, "e2e", {"K1": 1.0},
             outputs=e2e_frames, init_s=init_s)
    # from here on every phase runs on the pipeline loaded from the files,
    # and the kernels line counts its launches
    holder = [pipe]
    del pipe
    pipe, launches = run_load(torch, holder, kernels, args.frames, args.steps, e2e_frames,
                              args.ckpt_dir)
    del e2e_frames
    launches.update(run_e2e_online(torch, pipe, kernels, args.frames))
    train_launches, train_inputs = run_train(torch, pipe, kernels, args.train_frames)
    if args.train_frames <= RUN_FRAMES:
        run_train_precision(torch, pipe, kernels, train_inputs, args.train_frames)
    else:
        # the fp32 activations through the plain versions do not fit the
        # card's 80 GB at this size (the logits of one chunk of query rows
        # beside the rematerialised fp32 blocks)
        emit(dict(phase="train_precision", frames=args.train_frames,
                  skipped=f"the fp32 run needs more than one card's memory above "
                          f"{RUN_FRAMES} frames"))
    del train_inputs
    # the editor and the enhancer on the loaded pipeline; umT5 and the VAE,
    # parked on the host for the cache-fed LoRA steps, come back
    pipe.prompter.text_encoder.to("cuda")
    pipe.vae.to("cuda")
    path_launches = {}
    path_launches["editor"], editor_grid, editor_rope_ids = run_editor(
        torch, pipe, kernels, args.frames, args.steps)
    rows += check_kernels(torch, editor_grid, f"editor-{args.frames}f", editor_rope_ids)
    torch.cuda.empty_cache()
    path_launches["enhance"] = run_enhance(torch, pipe, kernels, args.frames)
    launches["K6"] = run_e2e_quant(torch, pipe, kernels, args.steps, args.frames)["K6"]
    # the int8 online body on the same quantised pipeline: FLASH_CAPPED=0
    os.environ["FLASH_CAPPED"] = "0"
    try:
        from video_styler_tpu_torch.ops.attention import set_quantized_attention
        set_quantized_attention(True)
        launches["K6o"] = run_edit(torch, pipe, kernels, 1, args.frames, "e2e_quant_online",
                                   {"K6o": 1.0}, profile=False,
                                   environment={"FLASH_CAPPED": "0"})["K6o"]
    finally:
        set_quantized_attention(False)
        del os.environ["FLASH_CAPPED"]
    launches["K7"] = run_entry_3d(torch, kernels, s_run)["K7"]
    # the image-conditioned models in the VACE pipeline's place: its DiT and
    # VACE go; umT5 and the Wan2.1 VAE stay
    pipe.dit = pipe.vace = None
    gc.collect()
    torch.cuda.empty_cache()
    path_launches["i2v"] = run_i2v(torch, pipe, kernels, args.frames, args.steps)
    path_launches["ti2v"] = run_ti2v(torch, pipe, kernels, args.steps)

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_path = {name: {path: counts[name] for path, counts in path_launches.items()
                      if name in counts} for name in ("K1", "K4", "K5")}
    emit({"kernels": [{**{k: r[k] for k in keys}, "launches": launches[r["kernel"]],
                       **({"launches_by_path": by_path[r["kernel"]]}
                          if r["kernel"] in by_path else {})}
                      for r in rows + new_rows]
          + [{**{k: r[k] for k in keys}, "launches": train_launches[
              "K1" if r["kernel"] == "K1s" else r["kernel"]]} for r in train_rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
