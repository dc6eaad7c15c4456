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
             TI2V-5B's 24 heads (Dm 3072) over 5,070 tokens, K1/K4/K5 at
             S2V's 448x832 shapes (self over 5,824 and 30,576 tokens with
             the segment RoPE rows, the text cross at 5,824 rows, the audio
             cross of 3 and 20 batch rows of 1,456 queries against 5 keys
             with K5 on those rows), and FastBlend's F1-F3 (remap, patch
             error, pairwise patch error; fp32) at the post-processing
             path's top pyramid level (8 pairs of 480x832, pad 6, patch 13
             and 5, a coherent field):
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
  fun_reference  the Fun V1.1 Control (a control video and a reference
             image), V1.1 Control-Camera and speed-control smoke recipes
             of `wan_video_gen`, card vs CPU
  animate_reference  the Wan2.2-Animate smoke recipe (a tiny adapter at
             face size 64, pose and face videos cut from the clip), card
             vs CPU
  postprocess_reference  the post-processing chain (FastBlend balanced,
             RIFE 2x at full IFNet width, ESRGAN x4 with 2 blocks, the six
             image-quality metrics at their tiny configs) on 4 frames of
             64x64, card vs CPU on the same weights, stage by stage, and
             the share of NNF entries that differ
  s2v_reference  the Wan2.2-S2V smoke recipe (a tiny S2V model and
             wav2vec2 tower, a synthetic waveform through
             `extract_audio_features` on each device, 12 frames with a pose
             video, CFG 4.5), card vs CPU: audio features and latents
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
  fun        Wan2.1-Fun-14B on the I2V phase's trunk, before its dual
             expert: InP (the trunk as it is, the first and last frames),
             V1.1 Control (a random 48-channel patch embedding and
             `ref_conv`: the clip as the control video, its first frame as
             the reference image, one more leading latent frame: 6,240
             tokens at 9 frames) and V1.1 Control-Camera (a random
             SimpleAdapter 24 -> 5120, the camera moving left, the I2V y):
             stage and step times, peak memory, tokens, K1/K4/K5 launches
             against 3/1/1 per block and pass
  animate    Wan2.2-Animate-14B on the same trunk: a random adapter (the
             pose embedding 16 -> 5120, 8 face blocks of 40 heads, the face
             and motion encoders at face size 512), the clip's frames 1..
             as the pose video, 5 face crops of 512x512: the adapter's
             stage (pose tokens, motion and face encoders once) and one
             face block timed apart, step times, peak, launches (3/1/1; the
             face blocks' 5-key attention is the plain `sdpa`)
  speed      Wan2.1-T2V-1.3B at full width (30 blocks of 1536, 12 heads)
             with a random speed controller (its last layer random, not
             zero), the loaded umT5 and VAE, --frames, --steps, CFG 5
             two-pass: step times, peak, launches (2/1/1); two motion ids
             give different latents
  ti2v       Wan2.2-TI2V-5B at full width: a random WAN_TI2V_5B DiT and
             Wan2.2 VAE, 49 frames of 480x832 (5,070 tokens), --steps
             steps, CFG 5 two-pass, streaming encode and decode: stage and
             step times, peak memory, launches (2/1/1 per block and pass),
             the first latent frame bit-equal to the image's encode
  s2v        Wan2.2-S2V-14B at full width: a random WAN_S2V_14B (the
             40-block trunk, 12 audio injectors and their AdaLN, the audio
             encoder, the frame packer, cond_encoder) and XLSR-53 tower
             beside the loaded umT5 and VAE; 5 s of synthetic audio through
             the tower; 12 frames of 448x832 (5,824 tokens), --steps steps,
             CFG 4.5 two-pass: the tower's and the audio encoder's times,
             stage and step times, peak, launches against 184/80/104 per
             two-pass step; profiled; then one step at the recipe's 80
             frames (30,576 tokens), latents only (`s2v_recipe_frames`)
  postprocess  on a free card, the chain at full width on 9 frames of
             480x832: FastBlend balanced with its defaults (F1/F2 launches
             against the count derived from the config, the host time of
             its random-search draws, the frame-to-frame change before and
             after), RIFE 2x (9 -> 17 frames), ESRGAN x4 (23 blocks) to
             1920x3328 on all 17, the six metrics at full width (random
             towers, stub token ids): each stage's seconds and peak; one
             FastBlend batch profiled (`postprocess_profile`); one pyramid
             estimate with use_pairwise_patch_error, counted for F3
             (`postprocess_pairwise`)
  usp_kernels  (with the kernel rows) one rank's work of the multi-GPU path
             at Wan2.1-14B width over the Ditto clip's 29,640 tokens, in
             this process: K1 on a Ulysses share (20 and 10 heads over the
             whole sequence), K1 cross, K4 and K5 on one rank's 7,410 rows
             with its cos/sin rows, and the ring's per-rank body (7,410
             queries against 4 key blocks of 7,410 through K1 with stats and
             the fp32 merge, held against K1's plain version over the whole
             key sequence within four bf16 ULPs), as kernel rows
  usp        last, on a free card: ranks spawned by `parallel.run_local` on
             cuda:0 over gloo (NCCL refuses two ranks on one device). (a)
             Wan2.1-T2V-1.3B at full width on meshes (1, 1, 2) and (1, 2, 2)
             (--frames, --steps, CFG 5 two-pass); (b) the e2e edit at
             Wan2.1-VACE-14B width on (1, 2, 1), FSDP over 2 ranks, one
             step (its host-staged all-gathers take ~80 s a step), each
             rank drawing only its shards of the e2e weights, umT5 parked
             on the host between encodes; per rank:
             latents against the same weights in one process (5%), peak
             memory, DiT+VACE shard GiB, K1/K4/K5 launches against the
             one-process count, step times (a card shared by the ranks, not
             a multi-card speed); (c) `infer_ditto --smoke --mesh 1,1,1` on
             a one-rank NCCL group: frames and latents bit-equal to the run
             without a mesh
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
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores (FastBlend's F1-F3)

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


def synthetic_clip(f: int, h: int = 480, w: int = 832):
    """A smooth synthetic uint8 clip (f, h, w, 3)."""
    import numpy as np
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
CARD = {}   # the card's name and power limit (nvidia-smi), filled by main()


def kernel_usage(*names):
    """The ptxas usage of the kernels whose mangled names contain `names`."""
    return {fn: u for fn, u in PTXAS.items() if any(n in fn for n in names)}


def check_kernels(torch, grid, tag, rope_ids=None, heads: int = 40,
                  cross_lens=(TEXT_LEN,), self_attn: bool = True, norms: bool = True,
                  rope_tables=None):
    """K1 self and cross (to each of `cross_lens` keys), K4 and K5 at `heads`
    heads of 128 (the Ditto 14B width by default) on this token grid
    (rope_ids: the temporal RoPE index of each latent frame, as the editor
    gives its joint sequence; rope_tables: numpy (cos, sin) rows for the
    grid's tokens in their place, as S2V's segments give them).
    self_attn/norms: whether to hold K1 self and K4/K5 too."""
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
    if rope_tables is None:
        cos, sin = assemble_freqs_grid(d, f, h, w, rope_ids, device="cuda")
    else:
        cos, sin = (torch.from_numpy(t).cuda() for t in rope_tables)
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
        emit({"phase": "kernel", **r, **CARD})
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']}: max abs err {r['max_abs_err']} "
                                 f"> tolerance {r['tol']}")
    return rows


S2V_GRID = (28, 52)         # 448x832 after the 8x VAE and the (1, 2, 2) patchify
S2V_RUN_FRAMES = 12         # 3 latent frames + the reference: 5,824 tokens
S2V_RECIPE_FRAMES = 80      # 20 latent frames + the reference: 30,576 tokens
AUDIO_KEYS = 5              # 4 audio tokens a frame and the padding token


def s2v_grid(frames: int):
    """S2V's token grid at 448x832: the latent frames and the reference's."""
    return ((frames - 1) // 4 + 2,) + S2V_GRID


def s2v_rope_tables(frames: int):
    from video_styler_tpu_torch.models.wan_s2v import s2v_rope_segments, video_segments
    f, (h, w) = (frames - 1) // 4 + 1, S2V_GRID
    return s2v_rope_segments(128, video_segments(f, h, w, h, w))


def check_audio_cross_kernels(torch, frames, tag, heads: int = 40):
    """S2V's audio injection: K5 on the (frames, 1,456, 5120) query rows,
    then K1 with a batch row per latent frame, 1,456 queries against that
    frame's 5 audio keys (one key tile: 5 real keys, 123 of TMA zero-fill)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    b, s, n, d = frames, math.prod(S2V_GRID), heads, 128
    dm, sk = n * d, AUDIO_KEYS
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    xq = randn(b, s, dm)
    wq = (1.0 + 0.1 * randn(dm).float()).to(torch.bfloat16)
    q = fnr.fused_rmsnorm(xq, wq)
    err, scale = max_err(torch, q, fnr.fused_rmsnorm_plain(xq, wq))
    b_ms, b_by = bound(0.0, 2.0 * 2 * b * s * dm + 2.0 * dm)
    rows = [dict(
        name=f"K5 fused_rmsnorm audio-q B={b} S={s} Dm={dm} [{tag}]", kernel="K5",
        route="cuda", source="video_styler_tpu_torch/csrc/fused_norm_rope.cu",
        replaces="video_styler_tpu/ops/fused_norm_rope.py:154",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_ULPS * scale,
        ms=time_ms(torch, lambda: fnr.fused_rmsnorm(xq, wq), 10),
        plain_ms=time_ms(torch, lambda: fnr.fused_rmsnorm_plain(xq, wq), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.rms_norm(xq, (dm,), wq, 1e-6), 10),
        clocks=gpu_clocks())]
    rows[-1]["ratio_to_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
    q = q.view(b, s, n, d)
    k, v = randn(b, sk, n, d), randn(b, sk, n, d)
    out = fa.flash_attention(q, k, v)
    err, scale = max_err(torch, out, fa.flash_attention_plain(q, k, v))
    flops = 4.0 * b * n * s * sk * d
    b_ms, b_by = bound(flops, 2.0 * (2 * b * s * dm + 2 * b * sk * dm))
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=10)
    rows.append(dict(
        name=f"K1 flash_attention audio-cross B={b} S={s} Sk={sk} N={n} D={d} [{tag}]",
        kernel="K1", route="cuda", source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_ULPS * scale,
        checked_rows=b * s, ms=ms,
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ratio_to_library=ms / lib_ms,
        tflops=flops / ms / 1e9, clocks=gpu_clocks()))
    return emit_rows(rows)


def card_copy(torch, cpu, cls):
    """A `cls` pipeline on the card holding copies of the CPU pipeline's
    models (the same weights)."""
    from video_styler_tpu_torch.prompters.wan_prompter import WanPrompter
    gpu = cls(device="cuda")
    for name in ("dit", "dit2", "vace", "vae", "image_encoder", "animate",
                 "motion_controller", "s2v_model"):
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


def edit_request(frames: int, steps: int) -> dict:
    """The e2e phase's VACE edit of a 480x832 clip."""
    return dict(prompt="turn the scene into a watercolor painting",
                negative_prompt="", vace_video=synthetic_clip(frames), num_frames=frames,
                height=480, width=832, seed=42, cfg_scale=5.0,
                num_inference_steps=steps, tiled=True)


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
    request = edit_request(frames, steps)
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
        emit({"phase": "kernel", **r, **CARD})
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
        emit({"phase": "kernel", **r, **CARD})
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
        emit({"phase": "kernel", **r, **CARD})
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
              "video": synthetic_clip(f)}], preprocess, cache)
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
    from video_styler_tpu_torch.ops import attention
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    saved = (attention.flash_attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm)
    attention.flash_attention = fa.flash_attention_plain
    wan_dit.fused_rmsnorm_rope = fnr.fused_rmsnorm_rope_plain
    wan_dit.fused_rmsnorm = fnr.fused_rmsnorm_plain
    try:
        yield
    finally:
        attention.flash_attention, wan_dit.fused_rmsnorm_rope, wan_dit.fused_rmsnorm = saved


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
    video = synthetic_clip(frames)
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
        video = synthetic_clip(frames)

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
        images = G.smoke_inputs(recipe, h, w, 9)
        kw = dict(prompt="a lighthouse in a storm", negative_prompt="blurry",
                  num_frames=9, height=h, width=w, seed=42, cfg_scale=5.0,
                  num_inference_steps=2, tiled=True, return_latents=True, **images)
        res, ok = check_card_against_cpu(torch, phase, cpu, gpu, lambda pipe: pipe(**kw),
                                         recipe=name, images=sorted(images), steps=2,
                                         cfg="two-pass 5.0")
        emit(res)
        if not ok:
            raise AssertionError(f"{name} smoke, card vs CPU disagree: {res}")


def check_fun_references(torch):
    """`fun_reference`: the Fun V1.1 Control (control video, reference
    image), V1.1 Control-Camera and speed-control smoke recipes of
    `wan_video_gen`; `animate_reference`: its Animate smoke recipe. 9
    frames of 32x32, CFG 5 two-pass, 2 steps, the recipe's smoke inputs,
    card against CPU on the same weights."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    for phase, name in (("fun_reference", "Wan2.1-Fun-V1.1-14B-Control"),
                        ("fun_reference", "Wan2.1-Fun-V1.1-14B-Control-Camera"),
                        ("fun_reference", "Wan2.1-1.3b-speedcontrol-v1"),
                        ("animate_reference", "Wan2.2-Animate-14B")):
        recipe = G.RECIPES[name]
        cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
        gpu = card_copy(torch, cpu, WanVideoPipeline)
        h, w, _ = G.smoke_size(recipe)
        inputs = G.smoke_inputs(recipe, h, w, 9)
        kw = dict(prompt="a lighthouse in a storm", negative_prompt="blurry",
                  num_frames=9, height=h, width=w, seed=42, cfg_scale=5.0,
                  num_inference_steps=2, tiled=True, return_latents=True, **inputs)
        res, ok = check_card_against_cpu(torch, phase, cpu, gpu, lambda pipe: pipe(**kw),
                                         recipe=name, inputs=sorted(inputs), steps=2,
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
    as the end image), the Fun and Animate requests on the same trunk
    (`run_fun`, `run_animate`), and a dual-expert request of 2 steps (t =
    1000 on `dit`, 833 on a second I2V expert from seed 5 below
    switch_DiT_boundary 0.875; its latents, not decoded) with umT5 and CLIP
    parked on the host. The caller has freed the VACE pipeline's DiT and
    VACE. Returns the launches of the I2V request and of the Fun and the
    Animate runs by path."""
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
    video = synthetic_clip(frames)
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

    # the Fun and Animate models on the same trunk
    path["fun"] = run_fun(torch, ip, kernels, video, base, steps)
    path["animate"] = run_animate(torch, ip, kernels, video, base, steps)

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
    return path


def _summed(total: dict, launches: dict):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run_fun(torch, ip, kernels, video, base: dict, steps: int):
    """Wan2.1-Fun-14B on the I2V pipeline's `WAN_I2V_14B` trunk (random
    weights): InP with the clip's first and last frames; V1.1 Control with
    a random 48-channel patch embedding (16 latent + 16 control + 16 y
    channels) and `ref_conv` (seed 8), the clip as the control video and
    its first frame as the reference image (CLIP features of the
    reference); V1.1 Control-Camera with a random SimpleAdapter (24 ->
    5120, seed 9), the camera moving left (the DiT takes 36 channels, so
    the camera unit builds the I2V y). The trunk is restored after each.
    Returns the three requests' launches summed."""
    import dataclasses
    from video_styler_tpu_torch.models.wan_controllers import (SimpleAdapter,
                                                               init_simple_adapter_)
    from video_styler_tpu_torch.models.wan_dit import WAN_I2V_14B, Linear, init_weights_
    dit = ip.dit
    frames = base["num_frames"]
    f, h, w = token_grid(frames)
    total = {}

    def check(out, name):
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"{name} output shape {out.shape}")

    _, out, launches = run_image_request(
        torch, ip, kernels, "fun_inp", steps,
        dict(base, input_image=video[0], end_image=video[-1]),
        recipe="Wan2.1-Fun-14B-InP", tokens=f * h * w)
    check(out, "fun_inp")
    _summed(total, launches)

    gen = torch.Generator("cuda").manual_seed(8)

    def linear(cin, cout):
        with torch.device("meta"):
            lin = Linear(cin, cout, dtype=torch.bfloat16)
        return init_weights_(lin.to_empty(device="cuda"), gen)
    patch36 = dit.patch_embedding
    dit.patch_embedding = linear(48 * 4, dit.cfg.dim)
    dit.ref_conv = linear(16 * 4, dit.cfg.dim)
    dit.cfg = dataclasses.replace(WAN_I2V_14B, in_dim=48, has_ref_conv=True)
    try:
        _, out, launches = run_image_request(
            torch, ip, kernels, "fun_control_reference", steps,
            dict(base, control_video=video, reference_image=video[0]),
            recipe="Wan2.1-Fun-V1.1-14B-Control", tokens=(f + 1) * h * w,
            patch_embedding_in=48 * 4)
    finally:
        dit.patch_embedding = patch36
        del dit.ref_conv
        dit.cfg = WAN_I2V_14B
    check(out, "fun_control_reference")
    _summed(total, launches)

    adapter = random_module(torch, lambda cfg, dtype: SimpleAdapter(24, cfg, dtype=dtype),
                            dit.cfg.dim, init_simple_adapter_, 9, torch.bfloat16)
    dit.control_adapter = adapter
    dit.cfg = dataclasses.replace(WAN_I2V_14B, has_control_adapter=True)
    try:
        _, out, launches = run_image_request(
            torch, ip, kernels, "fun_camera", steps,
            dict(base, input_image=video[0], camera_control_direction="Left"),
            recipe="Wan2.1-Fun-V1.1-14B-Control-Camera", tokens=f * h * w,
            adapter_gib=gib([adapter]))
    finally:
        del dit.control_adapter
        dit.cfg = WAN_I2V_14B
        del adapter
        torch.cuda.empty_cache()
    check(out, "fun_camera")
    _summed(total, launches)
    return total


def run_animate(torch, ip, kernels, video, base: dict, steps: int):
    """Wan2.2-Animate-14B on the I2V trunk: a random `WAN_ANIMATE_14B`
    adapter (seed 10), the clip's last 4k - 3 frames as the pose video and
    the same frames rendered at 512x512 as the face video (one pose latent
    and one motion frame per latent frame after the first). Before the request,
    the adapter's stage (pose tokens, the motion encoder on the faces, the
    face encoder) and one face block are timed apart, synchronised."""
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wan_animate as A
    frames = base["num_frames"]
    f, h, w = token_grid(frames)
    t0 = time.perf_counter()
    ip.animate = random_module(torch, A.WanAnimateAdapter, A.WAN_ANIMATE_14B,
                               A.init_wan_animate_, 10, torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pose = G.animate_clip(video)
    faces = G.animate_clip(synthetic_clip(frames, 512, 512))
    try:
        pose_lat, face_values = ip.build_animate_inputs(pose, faces, tiled=True)
        gen = torch.Generator("cuda").manual_seed(11)
        tokens = torch.randn((1, f * h * w, ip.dit.cfg.dim), generator=gen,
                             device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            _, motion_vec = A.animate_after_patch_embedding(ip.animate, tokens, (f, h, w),
                                                            pose_lat, face_values)
            adapter_ms = time_ms(torch, lambda: A.animate_after_patch_embedding(
                ip.animate, tokens, (f, h, w), pose_lat, face_values), reps=3, warmup=1)
            face_block_ms = time_ms(torch, lambda: A.face_block(
                ip.animate.face_adapter.fuser_blocks[0], tokens, motion_vec,
                ip.dit.cfg.num_heads), reps=5, warmup=1)
        del tokens
        _, out, launches = run_image_request(
            torch, ip, kernels, "animate", steps,
            dict(base, input_image=video[0], animate_pose_video=pose,
                 animate_face_video=faces),
            recipe="Wan2.2-Animate-14B", tokens=f * h * w, adapter_build_s=build_s,
            adapter_gib=gib([ip.animate]), adapter_stage_ms=adapter_ms,
            face_block_ms=face_block_ms, face_blocks=len(ip.animate.face_adapter.fuser_blocks),
            pose_latents_shape=list(pose_lat.shape), face_frames=len(faces),
            motion_tokens_shape=list(motion_vec.shape))
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"animate output shape {out.shape}")
        return launches
    finally:
        ip.animate = None
        gc.collect()
        torch.cuda.empty_cache()


def run_speed(torch, pipe, kernels, frames: int, steps: int):
    """Wan2.1-T2V-1.3B with the speed controller at full width: a random
    `WAN_T2V_1_3B` DiT (seed 12) and controller (seed 13; its last layer
    drawn N(0, 1/dim), not the reference's zeros, so the id acts) beside the
    loaded umT5 and VAE; the --frames clip's request, motion id 50,
    counted and profiled; then the latents of ids 50 and 10 must differ."""
    from video_styler_tpu_torch.models.wan_controllers import (MotionController,
                                                               init_motion_controller_)
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_1_3B, WanDiT, init_weights_
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    sp = WanVideoPipeline(device="cuda")
    sp.vae, sp.prompter = pipe.vae, pipe.prompter
    t0 = time.perf_counter()
    sp.dit = random_module(torch, WanDiT, WAN_T2V_1_3B, init_weights_, 12, torch.bfloat16)
    mc = random_module(torch, lambda cfg, dtype: MotionController(*cfg, dtype=dtype),
                       (WAN_T2V_1_3B.dim, WAN_T2V_1_3B.freq_dim), init_motion_controller_,
                       13, torch.bfloat16)
    with torch.no_grad():
        mc.fc3.weight.normal_(0.0, WAN_T2V_1_3B.dim ** -0.5,
                              generator=torch.Generator("cuda").manual_seed(14))
    sp.motion_controller = mc
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    request = dict(prompt="a train rushes through a snowy valley",
                   negative_prompt="blurry, static", height=480, width=832,
                   num_frames=frames, seed=42, cfg_scale=5.0, num_inference_steps=steps,
                   tiled=True, motion_bucket_id=50.0)
    try:
        _, out, launches = run_image_request(
            torch, sp, kernels, "speed", steps, request, profile=True,
            recipe="Wan2.1-1.3b-speedcontrol-v1",
            tokens=int(math.prod(token_grid(frames))), build_s=build_s,
            dit_params_b=sum(p.numel() for p in sp.dit.parameters()) / 1e9,
            dit_gib=gib([sp.dit]), controller_gib=gib([mc]))
        if out.shape != (frames, 480, 832, 3):
            raise AssertionError(f"speed output shape {out.shape}")
        lat = {mid: sp(**dict(request, motion_bucket_id=mid, return_latents=True)).float()
               for mid in (50.0, 10.0)}
        rel = ((lat[50.0] - lat[10.0]).norm() / lat[50.0].norm()).item()
        res = dict(phase="speed_check", motion_ids=[50.0, 10.0], latents_rel_l2_between=rel,
                   finite=all(bool(torch.isfinite(v).all()) for v in lat.values()))
        emit(res)
        if not (res["finite"] and rel > 1e-3):
            raise AssertionError(f"speed control: {res}")
        return launches
    finally:
        sp.dit = sp.motion_controller = None
        del sp, mc
        gc.collect()
        torch.cuda.empty_cache()


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
    image = synthetic_clip(TI2V_FRAMES)[0]
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


# ------------------------------------------------------------ speech to video

def check_s2v_reference(torch):
    """`s2v_reference`: the S2V smoke recipe of `wan_video_gen` (a tiny S2V
    model, a tiny wav2vec2 tower from seed 5), a synthetic 16 kHz waveform
    through `extract_audio_features` on each device, 12 frames of 32x32
    with a 12-frame pose video, CFG 4.5 two-pass, 2 steps, whole-clip VAE:
    the audio features and the latents, card against CPU on the same
    weights."""
    import numpy as np
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wav2vec as W
    from video_styler_tpu_torch.models.audio_features import extract_audio_features
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    recipe = G.RECIPES["Wan2.2-S2V-14B"]
    cpu = G.build_smoke_pipeline(recipe, device="cpu", seed=0)
    gpu = card_copy(torch, cpu, WanVideoPipeline)
    w2v_cpu = random_module(torch, W.Wav2Vec2, G.smoke_s2v_configs()[1], W.init_wav2vec_, 5,
                            torch.float32).cpu()
    w2v_gpu = copy.deepcopy(w2v_cpu).cuda()
    frames = S2V_RUN_FRAMES
    wav = G.smoke_waveform(frames)
    audio = {"cpu": extract_audio_features(wav, num_frames=frames, model=w2v_cpu),
             "cuda": extract_audio_features(wav, num_frames=frames, model=w2v_gpu)}
    audio_rel = float(np.linalg.norm(audio["cuda"] - audio["cpu"])
                      / np.linalg.norm(audio["cpu"]))
    clip = G.smoke_inputs(G.RECIPES["Wan2.1-VACE-14B"], 32, 32, frames)["vace_video"]
    # the pipeline's whole-clip VAE (`s2v`'s default): the streaming encoder
    # takes 4k + 1 frames, the 12-frame pose video is not
    kw = dict(negative_prompt="blurry", num_frames=frames, height=32, width=32, seed=42,
              cfg_scale=4.5, num_inference_steps=2, tiled=False, return_latents=True,
              pose_video=clip)
    res, ok = check_card_against_cpu(
        torch, "s2v_reference", cpu, gpu,
        lambda pipe: pipe.s2v("a woman sings on a rooftop", clip[0],
                              audio[pipe.device.type], **kw),
        recipe=recipe.name, frames=frames, steps=2, cfg="two-pass 4.5",
        audio_shape=list(audio["cpu"].shape), audio_rel_l2=audio_rel)
    emit(res)
    if not ok or not audio_rel <= 5e-2:
        raise AssertionError(f"S2V smoke, card vs CPU disagree: {res}")


def run_s2v(torch, pipe, kernels, steps: int):
    """Wan2.2-S2V-14B at full width on the card: a random `WAN_S2V_14B`
    (seed 20: the 40-block trunk, 12 audio injectors with their AdaLN, the
    audio encoder, the frame packer, `cond_encoder`) and `WAV2VEC2_XLSR_53`
    tower (seed 21, fp32) beside the loaded umT5-XXL and Wan2.1 VAE; 5 s of
    synthetic 16 kHz audio through the tower; a 12-frame 448x832 request
    (5,824 tokens; the reference image cut from `synthetic_clip`), `steps`
    steps, CFG 4.5 two-pass, counted and profiled; then one step at the
    recipe's 80 frames (30,576 tokens), latents only, counted. Returns the
    launches of both runs, summed."""
    import numpy as np
    from video_styler_tpu_torch import wan_video_gen as G
    from video_styler_tpu_torch.models import wan_s2v as S
    from video_styler_tpu_torch.models import wav2vec as W
    from video_styler_tpu_torch.models.audio_features import extract_audio_features
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    sp = WanVideoPipeline(device="cuda")
    sp.vae, sp.prompter = pipe.vae, pipe.prompter
    torch.cuda.synchronize()
    before_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    sp.s2v_model = random_module(torch, S.WanS2V, S.WAN_S2V_14B, S.init_wan_s2v_, 20,
                                 torch.bfloat16)
    w2v = random_module(torch, W.Wav2Vec2, W.WAV2VEC2_XLSR_53, W.init_wav2vec_, 21,
                        torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = sp.s2v_model
    trunk = ("patch_embedding", "text_embedding", "time_embedding", "time_projection",
             "head", "blocks")
    s2v_params = sum(p.numel() for n, p in model.named_parameters()
                     if n.split(".")[0] not in trunk)
    wav = G.smoke_waveform(64)          # 5 s: (64 / 16 + 1) s at 16 kHz
    cfg = S.WAN_S2V_14B
    per_step = {"K1": 2 * (2 * cfg.num_layers + len(cfg.audio_inject_layers)),
                "K4": 2 * cfg.num_layers,
                "K5": 2 * (cfg.num_layers + len(cfg.audio_inject_layers))}
    total = {}
    try:
        audio, wav2vec_s = {}, {}
        for frames in (S2V_RUN_FRAMES, S2V_RECIPE_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio[frames] = extract_audio_features(wav, num_frames=frames, model=w2v)
            torch.cuda.synchronize()
            wav2vec_s[frames] = time.perf_counter() - t0
        with torch.no_grad():
            states_ms = time_ms(torch, lambda: W.wav2vec_forward(
                w2v, torch.from_numpy(W.normalize_waveform(wav)[None]).cuda()), reps=3)
            a12 = torch.from_numpy(audio[S2V_RUN_FRAMES]).cuda().to(torch.bfloat16)
            encoder_ms = time_ms(torch, lambda: S.cal_audio_emb(
                model.casual_audio_encoder, a12, cfg.num_audio_token, cfg.enable_adain),
                reps=5)
        image = synthetic_clip(S2V_RUN_FRAMES, 448, 832)[0]
        request = dict(prompt="a woman sings on a rooftop at dusk", ref_image=image,
                       negative_prompt="blurry, static", num_frames=S2V_RUN_FRAMES,
                       height=448, width=832, seed=42, cfg_scale=4.5,
                       num_inference_steps=steps, tiled=True)
        runs = [("s2v", S2V_RUN_FRAMES, steps, False),
                ("s2v_recipe_frames", S2V_RECIPE_FRAMES, 1, True)]
        for phase, frames, n_steps, latents_only in runs:
            kw = dict(request, audio_input=audio[frames], num_frames=frames,
                      num_inference_steps=n_steps, return_latents=latents_only)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels.values():
                kern.launches = 0
            t0 = time.perf_counter()
            out = sp.s2v(**kw)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = {name: kern.launches for name, kern in kernels.items()}
            expected = {k: v * n_steps for k, v in per_step.items()}
            f_lat = (frames - 1) // 4 + 1
            res = dict(phase=phase, recipe="Wan2.2-S2V-14B", dim=cfg.dim,
                       heads=cfg.num_heads, layers=cfg.num_layers,
                       audio_injections=len(cfg.audio_inject_layers), frames=frames,
                       height=448, width=832, tokens=int(math.prod(s2v_grid(frames))),
                       steps=n_steps, cfg="two-pass 4.5", total_s=total_s,
                       stages=dict(sp.stage_times), step_s=step_times(sp),
                       stage_peak_gib={k: v / 2**30 for k, v in sp.stage_peak_bytes},
                       max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                       output_shape=list(out.shape), launches=launches,
                       expected_launches=expected,
                       launches_per_two_pass_step={k: v / n_steps for k, v in launches.items()
                                                   if v},
                       finite=bool(np.isfinite(out).all()) if isinstance(out, np.ndarray)
                       else bool(torch.isfinite(out.float()).all()),
                       wav2vec_s=wav2vec_s[frames], wav2vec_forward_ms=states_ms,
                       audio_shape=list(audio[frames].shape), audio_seconds=len(wav) / 16000,
                       audio_encoder_ms=encoder_ms, build_s=build_s,
                       s2v_params_b=s2v_params / 1e9, model_gib=gib([model]),
                       wav2vec_gib=gib([w2v]), allocated_before_build_gib=before_gib)
            emit(res)
            check_launches(launches, expected, phase)
            want = ((1, 16, f_lat, 56, 104) if latents_only
                    else (1 + (f_lat - 1) * 4, 448, 832, 3))
            if tuple(out.shape) != want or not res["finite"]:
                raise AssertionError(f"{phase}: output {tuple(out.shape)}, want {want}")
            _summed(total, launches)
            if phase == "s2v":
                emit({"phase": "s2v_profile",
                      **profile_request(torch, lambda: sp.s2v(**kw), total_s)})
        return total
    finally:
        sp.s2v_model = None
        del sp, model, w2v
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------------- post-processing

FASTBLEND_SRC = "video_styler_tpu_torch/csrc/fastblend.cu"
JAX_FASTBLEND = "video_styler_tpu/extensions/fastblend/kernels.py"
# fp32, summed in the plain versions' order without FMA contraction: the
# kernels agree bit for bit; 2^-20 of the largest magnitude is the bound
FASTBLEND_TOL = 2.0 ** -20
POST_FRAMES = 9              # synthetic_clip(9) at 480x832
POST_PROMPT = "a watercolor city at dusk"
# OpenAI CLIP ViT-L/14 (the aesthetic head's 768-wide features, CLIP score)
CLIP_VIT_L_14 = dict(vision_dim=1024, vision_layers=24, vision_heads=16, text_dim=768,
                     text_layers=12, text_heads=12, proj_dim=768, quick_gelu=True)


def coherent_nnf(torch, gen, b: int, h: int, w: int, spread: int = 4):
    """A field like PatchMatch's: identity plus offsets up to +-spread,
    clamped to the image."""
    ii, jj = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    off = torch.randint(-spread, spread + 1, (b, h, w, 2), generator=gen, device="cuda")
    return torch.stack([(ii + off[..., 0]).clamp(0, h - 1),
                        (jj + off[..., 1]).clamp(0, w - 1)], -1).to(torch.int32).contiguous()


def remap_votes(torch, nnf, h: int, w: int, r: int) -> int:
    """F1's data-dependent work: the votes that fall inside the image."""
    xx = torch.arange(h, device=nnf.device)[None, :, None]
    yy = torch.arange(w, device=nnf.device)[None, None, :]
    total = 0
    for px in range(-r, r + 1):
        for py in range(-r, r + 1):
            xn, yn = xx + px, yy + py
            inside = (xn >= 0) & (xn < h) & (yn >= 0) & (yn < w)
            m = nnf[:, xn.clamp(0, h - 1)[0, :, 0]][:, :, yn.clamp(0, w - 1)[0, 0]]
            xs, ys = m[..., 0] - px, m[..., 1] - py
            total += int((inside & (xs >= 0) & (ys >= 0) & (xs < h) & (ys < w)).sum())
    return total


def check_fastblend_kernels(torch, b: int = 8, h: int = 480, w: int = 832, c: int = 3,
                            pad: int = 6):
    """F1-F3 at the main path's top pyramid level (a batch of 8 pairs,
    480x832, pad 6; F3 on the even and odd halves of the batch, B = 4, as
    `PatchMatcher.get_pairwise_patch_error` passes them) with patch 13 (the
    first iteration) and 5 (the last), on a coherent field, against their
    plain versions. The bound: fp32
    operations (a sub, a mul and an add per channel and patch tap; F1 an
    add per channel and vote) at the card's fp32 rate without the tensor
    cores, against each input read once and the output written once."""
    from torch.nn.functional import pad as fpad
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
    gen = torch.Generator("cuda").manual_seed(11)
    imgs = [fpad(torch.rand((b, h, w, c), generator=gen, device="cuda") * 255,
                 (0, 0, pad, pad, pad, pad)) for _ in range(2)]
    src, tgt = imgs
    nnf = coherent_nnf(torch, gen, b, h, w)
    pair = (src[0::2].contiguous(), nnf[0::2].contiguous(), src[1::2].contiguous(),
            nnf[1::2].contiguous())
    img_bytes, nnf_bytes, err_bytes = src.numel() * 4, nnf.numel() * 4, b * h * w * 4
    rows = []
    for ps in (13, 5):
        r, args = (ps - 1) // 2, (h, w, c, ps, pad)
        ssd_flops = b * h * w * ps * ps * 3 * c
        cases = (
            ("F1", "remap", b, "12remap_kernel", 104, lambda: fk.remap(*args, src, nnf),
             lambda: fk.remap_plain(*args, src, nnf),
             remap_votes(torch, nnf, h, w, r) * c + b * h * w * c, 2 * img_bytes + nnf_bytes),
            ("F2", "patch_error", b, "18patch_error_kernel", 139,
             lambda: fk.patch_error(*args, src, nnf, tgt),
             lambda: fk.patch_error_plain(*args, src, nnf, tgt), ssd_flops,
             2 * img_bytes + nnf_bytes + err_bytes),
            ("F3", "pairwise_patch_error", b // 2, "pairwise_patch_error_kernel", 156,
             lambda: fk.pairwise_patch_error(*args, *pair),
             lambda: fk.pairwise_patch_error_plain(*args, *pair), ssd_flops // 2,
             img_bytes + nnf_bytes + err_bytes // 2))
        for kid, fn, batch, sym, line, run, plain, flops, nbytes in cases:
            err, scale = max_err(torch, run(), plain())
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            rows.append(dict(
                name=f"{kid} {fn} B={batch} {h}x{w} C={c} patch={ps} pad={pad}", kernel=kid,
                route="cuda", source=FASTBLEND_SRC, replaces=f"{JAX_FASTBLEND}:{line}",
                max_abs_err=err, max_rel_err=err / scale, tol=FASTBLEND_TOL * scale,
                ms=time_ms(torch, run, 10), plain_ms=time_ms(torch, plain, reps=2, warmup=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
                fp32_gflop=flops / 1e9, mbytes=nbytes / 1e6, ptxas=kernel_usage(sym),
                clocks=gpu_clocks()))
    return emit_rows(rows)


class StubMetricTokenizer:
    """Token ids from a seed of the text (crc32): `length` ids, the EOS id
    last; no vocabulary is on the machine."""

    def __init__(self, vocab: int, eos: int, length: int):
        self.vocab, self.eos, self.length = vocab, eos, length

    def __call__(self, texts, max_length=None, **kw):
        import zlib
        import numpy as np
        n = min(self.length, max_length or self.length)
        rng = np.random.default_rng(zlib.crc32(texts[0].encode()))
        ids = rng.integers(2, self.vocab - 1, (len(texts), n)).astype(np.int64)
        ids[:, -1] = self.eos
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}


def random_tower(torch, cls, cfg, seed: int, device: str):
    """`cls(cfg)` in fp32 with random weights: matrices N(0, 1/in), norms 1,
    biases 0, embeddings and tokens N(0, 0.02^2), logit_scale log 100."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to_empty(device=device)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("scale",)):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() == 2 and name.endswith("weight"):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        if hasattr(module, "logit_scale"):
            module.logit_scale.fill_(math.log(100.0))
    return module.eval()


def random_conv_weights(shapes, seed: int):
    """A checkpoint's tensors from a numpy seed: convolutions N(0, 1/fan_in),
    PReLU slopes 0.25, biases N(0, 0.01^2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) > 1:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(".1.weight"):
            v = np.full(shape, 0.25)
        else:
            v = 0.01 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def post_models(torch, device: str, full: bool):
    """The chain's random weights on `device`: full IFNet width (c=90)
    always; RRDBNet with 23 blocks (full) or 2; the metric towers at their
    published widths (full) or the tiny configs."""
    from video_styler_tpu_torch.extensions import esrgan, rife
    from video_styler_tpu_torch.models import blip_reward as B
    from video_styler_tpu_torch.models import clip_dual as C
    blocks = 23 if full else 2
    cfg_h = C.CLIP_VIT_H_14_DUAL if full else C.CLIP_DUAL_TINY
    cfg_l = C.CLIPDualConfig(**CLIP_VIT_L_14) if full else C.CLIP_DUAL_TINY
    cfg_b = B.IMAGE_REWARD if full else B.BLIP_REWARD_TINY
    cross = C.MPS_CROSS if full else C.CrossModelConfig(dim=cfg_h.proj_dim, heads=2)
    import numpy as np
    rng = np.random.default_rng(30)
    dims = (cfg_l.proj_dim, 1024, 128, 64, 16, 1)
    aes = {str(i): {"w": torch.from_numpy((rng.standard_normal((b, a)) / np.sqrt(a))
                                          .astype(np.float32)).to(device),
                    "b": torch.zeros(b, device=device)}
           for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    return dict(
        ifnet=rife.convert_ifnet(random_conv_weights(rife.ifnet_shapes(), 31), device),
        rrdb=esrgan.convert_rrdbnet(random_conv_weights(esrgan.rrdbnet_shapes(blocks), 32),
                                    device),
        rrdb_blocks=blocks, aes=aes,
        clip_l=random_tower(torch, C.ClipDual, cfg_l, 33, device),
        clip_h=random_tower(torch, C.ClipDual, cfg_h, 34, device),
        cross=random_tower(torch, C.CrossModel, cross, 35, device),
        blip=random_tower(torch, B.BlipReward, cfg_b, 36, device),
        cfg_l=cfg_l, cfg_h=cfg_h, cfg_b=cfg_b, cross_heads=cross.heads)


def score_metrics(torch, m, images, seconds: dict):
    """The six metrics of `extensions.image_quality_metric` on `images`
    (uint8 frames) with `m`'s towers and stub token ids; `seconds` gets
    each metric's wall time."""
    import numpy as np
    from video_styler_tpu_torch.extensions import image_quality_metric as Q
    from video_styler_tpu_torch.models import clip_dual as C
    dev = m["clip_h"].logit_scale.device
    cfg_l, cfg_h, cfg_b = m["cfg_l"], m["cfg_h"], m["cfg_b"]
    tok_l = StubMetricTokenizer(cfg_l.vocab_size, cfg_l.eos_token_id, cfg_l.max_len)
    tok_h = StubMetricTokenizer(cfg_h.vocab_size, cfg_h.eos_token_id, cfg_h.max_len)
    tok_b = StubMetricTokenizer(cfg_b.vocab_size, cfg_b.vocab_size - 1, min(35, cfg_b.max_pos))

    def image_l(ims):
        pix = np.stack([Q.preprocess_metric_image(im, cfg_l.image_size) for im in ims])
        return C.clip_image_features(m["clip_l"], cfg_l, torch.from_numpy(pix).to(dev))

    def text_l(texts):
        return C.clip_text_features(m["clip_l"], cfg_l, tok_l(texts)["input_ids"]).cpu()

    metrics = {
        "aesthetic": lambda: Q.AestheticPredictor(m["aes"], image_l).score(images),
        "clip": lambda: Q.CLIPScore(lambda ims: image_l(ims).cpu(), text_l).score(
            images, POST_PROMPT),
        "pickscore": lambda: Q.PickScore(m["clip_h"], cfg_h, tok_h).score(images, POST_PROMPT),
        "hps": lambda: Q.HPScore(m["clip_h"], cfg_h, tok_h).score(images, POST_PROMPT),
        "mps": lambda: Q.MPScore(m["clip_h"], m["cross"], cfg_h, tok_h,
                                 cross_heads=m["cross_heads"]).score(images, POST_PROMPT),
        "imagereward": lambda: Q.ImageRewardScore(m["blip"], cfg_b, tok_b).score(
            images, POST_PROMPT)}
    scores = {}
    with torch.no_grad():
        for name, fn in metrics.items():
            t0 = time.perf_counter()
            scores[name] = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
    return scores


def run_chain(torch, m, frames, device: str, seconds: dict, peaks: dict,
              kernels=None, counts=None):
    """FastBlend balanced (FastBlendSmoother's defaults) -> RIFE 2x -> ESRGAN
    x4 -> the six metrics, through the extensions' entry points on
    `device`, stage by stage: `seconds` and `peaks` (device GiB) get each
    stage's; with `kernels`, every count is set to 0 before a stage and
    read after it into `counts`."""
    from video_styler_tpu_torch.extensions import esrgan, rife
    from video_styler_tpu_torch.extensions.fastblend import FastBlendSmoother
    cuda = device == "cuda"
    stages = (
        ("fastblend", lambda x: FastBlendSmoother(device=device)(x)),
        ("rife", lambda x: rife.RIFEInterpolater(m["ifnet"], device=device).interpolate(x)),
        ("esrgan", lambda x: esrgan.ESRGANUpscaler(m["rrdb"], m["rrdb_blocks"],
                                                   device=device)(x)))
    outputs, x = {}, list(frames)
    for name, fn in stages + (("metrics", None),):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for kern in (kernels or {}).values():
            kern.launches = 0
        t0 = time.perf_counter()
        if fn is None:
            metric_s = {}
            outputs["scores"] = score_metrics(torch, m, x, metric_s)
            seconds["metric_s"] = metric_s
        else:
            x = outputs[name] = fn(x)
        if cuda:
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        seconds[name] = time.perf_counter() - t0
        if kernels is not None:
            counts[name] = {k: kern.launches for k, kern in kernels.items()}
    return outputs


def _rel_l2(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def check_postprocess_reference(torch):
    """`postprocess_reference`: the chain on 4 frames of 64x64 (FastBlend
    balanced with its defaults, RIFE at full IFNet width, ESRGAN with 2
    blocks, the six metrics at their tiny configs) on the card and on the
    CPU with the same weights: each stage's frames and the scores within 5%
    relative L2; and one pyramid estimate's share of NNF entries that differ
    between the card and the CPU."""
    import numpy as np
    from video_styler_tpu_torch.extensions.fastblend import (DEFAULT_EBSYNTH_CONFIG,
                                                             PyramidPatchMatcher)
    frames = synthetic_clip(4, 64, 64)
    cpu = post_models(torch, "cpu", full=False)
    gpu = {k: copy.deepcopy(v).to("cuda") if isinstance(v, torch.nn.Module)
           else _tree_to(v, "cuda") if isinstance(v, dict) else v for k, v in cpu.items()}
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        seconds = {}
        runs[dev] = (run_chain(torch, m, frames, dev, seconds, {}), seconds)
    (c, c_s), (g, g_s) = runs["cpu"], runs["cuda"]
    rel = {k: _rel_l2(np.stack(g[k]), np.stack(c[k])) for k in ("fastblend", "rife", "esrgan")}
    rel.update({f"score_{k}": _rel_l2(g["scores"][k], v) for k, v in c["scores"].items()})
    nnf = {}
    for dev in ("cpu", "cuda"):
        pm = PyramidPatchMatcher(64, 64, 3, device=dev, **DEFAULT_EBSYNTH_CONFIG)
        nnf[dev] = pm.estimate_nnf(frames[:3], frames[1:], frames[:3])[0].cpu().numpy()
    res = dict(phase="postprocess_reference", frames=4, height=64, width=64,
               rel_l2=rel, tol=5e-2, cpu_s=c_s, cuda_s=g_s,
               nnf_entries_differ_share=float((nnf["cpu"] != nnf["cuda"]).any(-1).mean()),
               output_shapes={k: list(np.stack(g[k]).shape)
                              for k in ("fastblend", "rife", "esrgan")},
               scores_cuda=g["scores"])
    emit(res)
    finite = all(np.isfinite(v).all() for v in g["scores"].values())
    if not (finite and all(v <= 5e-2 for v in rel.values())):
        raise AssertionError(f"postprocess, card vs CPU disagree: {res}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def fastblend_launches(estimates: int, cfg: dict, pairwise: bool = False, levels: int = 5):
    """F1/F2/F3 launches of `estimates` pyramid estimates, derived from the
    config: per level and iteration one remap and a guide and a style error
    for the start and for each update (4 propagation directions, 3 random
    steps, no tracking); one more remap per level. With the pairwise flag
    the style error is F3's."""
    errors = estimates * levels * cfg["num_iter"] * (1 + 4 + 3)
    out = {"F1": estimates * levels * (cfg["num_iter"] + 1),
           "F2": errors * (1 if pairwise else 2)}
    if pairwise:
        out["F3"] = errors
    return out


def balanced_tasks(n: int, window: int = 15) -> int:
    """Source -> target pairs of FastBlend balanced over n frames."""
    return sum(1 for t in range(n) for s in range(t - window, t + window + 1)
               if 0 <= s < n and s != t)


def frame_change(frames) -> float:
    """Mean absolute change between consecutive frames (flicker)."""
    import numpy as np
    f = np.stack(frames).astype(np.float32)
    return float(np.abs(f[1:] - f[:-1]).mean())


def run_postprocess(torch, kernels):
    """`postprocess`: the chain at the published widths on synthetic_clip(9)
    at 480x832, counted stage by stage: FastBlend balanced (window 15,
    batch 8, patch 5..13 over 5 iterations, 5 pyramid levels: 72 pairs in 9
    batches) with its F1/F2 launches against the derived counts; RIFE 2x
    (9 -> 17 frames) with random full-width IFNet weights; ESRGAN x4 (23
    RRDBs, fp32) to 1920x3328 on all 17 frames; the six metrics on them at
    full width (CLIP ViT-H/14 dual for PickScore, HPS and MPS with the
    4-layer cross model, ViT-L/14 for the 768-wide aesthetic head and the
    CLIP score, BLIP ViT-L + BERT-base for ImageReward). Then one FastBlend
    batch profiled, and one pyramid estimate with use_pairwise_patch_error
    (F3) counted. Returns the F1-F3 launches of the counted runs."""
    import numpy as np
    from video_styler_tpu_torch.extensions.fastblend import (DEFAULT_EBSYNTH_CONFIG,
                                                             PyramidPatchMatcher)
    from video_styler_tpu_torch.extensions.fastblend import patch_match as pm_mod
    frames = list(synthetic_clip(POST_FRAMES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = post_models(torch, "cuda", full=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model_gib = gib([models[k] for k in ("clip_l", "clip_h", "cross", "blip")])
    # host time of the random-search draws (numpy, then pinned, then copied)
    draw = {"calls": 0, "s": 0.0}
    original_draw = pm_mod._draw_to

    def timed_draw(*a, **k):
        t = time.perf_counter()
        out = original_draw(*a, **k)
        draw["s"] += time.perf_counter() - t
        draw["calls"] += 1
        return out

    seconds, peaks, counts = {}, {}, {}
    pm_mod._draw_to = timed_draw
    try:
        out = run_chain(torch, models, frames, "cuda", seconds, peaks, kernels, counts)
    finally:
        pm_mod._draw_to = original_draw
    tasks = balanced_tasks(POST_FRAMES)
    batches = -(-tasks // 8)
    expected = fastblend_launches(batches, DEFAULT_EBSYNTH_CONFIG)
    shapes = {k: list(np.stack(out[k]).shape) for k in ("fastblend", "rife", "esrgan")}
    res = dict(phase="postprocess", frames=POST_FRAMES, height=480, width=832,
               fastblend=dict(window=15, batch=8, **DEFAULT_EBSYNTH_CONFIG, tasks=tasks,
                              batches=batches, pyramid_levels=5),
               rife_ifnet_width=90, esrgan_blocks=23, esrgan_frames=len(out["rife"]),
               stage_s=seconds, stage_peak_gib=peaks, build_s=build_s,
               metric_model_gib=model_gib, output_shapes=shapes,
               frame_change_before=frame_change(frames),
               frame_change_after_fastblend=frame_change(out["fastblend"]),
               random_draws=draw["calls"], random_draw_host_s=draw["s"],
               scores=out["scores"], launches=counts, expected_fastblend_launches=expected)
    emit(res)
    check_launches(counts["fastblend"], expected, "postprocess fastblend")
    for stage in ("rife", "esrgan", "metrics"):
        check_launches(counts[stage], {}, f"postprocess {stage}")
    want = {"fastblend": [POST_FRAMES, 480, 832, 3], "rife": [2 * POST_FRAMES - 1, 480, 832, 3],
            "esrgan": [2 * POST_FRAMES - 1, 1920, 3328, 3]}
    finite = all(np.isfinite(v).all() and len(v) == want["esrgan"][0]
                 for v in out["scores"].values())
    if shapes != want or not finite:
        raise AssertionError(f"postprocess outputs {shapes}, want {want}; finite {finite}")
    launches = {k: counts["fastblend"][k] for k in ("F1", "F2")}
    del out, models
    gc.collect()
    torch.cuda.empty_cache()

    # one batch of 8 pairs, profiled: the FastBlend stage's device share
    # (the frames already on the card, as the runner holds them)
    engine = PyramidPatchMatcher(480, 832, 3, device="cuda", **DEFAULT_EBSYNTH_CONFIG)
    clip = torch.from_numpy(np.stack(frames)).cuda().float()
    sg, tg = clip[:8], clip[1:]

    def one_batch():
        engine.estimate_nnf(sg, tg, sg)
        torch.cuda.synchronize()

    one_batch()
    t0 = time.perf_counter()
    one_batch()
    batch_s = time.perf_counter() - t0
    emit({"phase": "postprocess_profile", "batch_s": batch_s,
          **profile_request(torch, one_batch, batch_s)})
    # the pairwise flag, the one path to F3
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nnf, _ = PyramidPatchMatcher(480, 832, 3, use_pairwise_patch_error=True, device="cuda",
                                 **DEFAULT_EBSYNTH_CONFIG).estimate_nnf(sg, tg, sg)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    counted = {k: kern.launches for k, kern in kernels.items()}
    want_pair = fastblend_launches(1, DEFAULT_EBSYNTH_CONFIG, pairwise=True)
    emit(dict(phase="postprocess_pairwise", pairs=8, height=480, width=832, seconds=pair_s,
              nnf_shape=list(nnf.shape), launches=counted, expected_launches=want_pair))
    check_launches(counted, want_pair, "postprocess pairwise")
    launches["F3"] = counted["F3"]
    return launches


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
    ("F3", ("pairwise_patch_error_kernel",)),
    ("F2", ("patch_error_kernel",)),
    ("F1", ("remap_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d", "conv3d")),
    ("int8 gemm", ("i8i8", "_s8_", "int8", "imma", "igemm", "i8816", "i16832")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
)


# ---------------------------------------------------------------------------
# Multi-GPU: one rank's kernels in this process, then ranks sharing the card
# ---------------------------------------------------------------------------

USP_HEADS = 40          # Wan2.1-14B: 40 heads of 128
RING_BLOCKS = 4         # sp = 4 over the Ditto clip's 29,640 tokens: 7,410 a rank
# four bf16 ULPs at the output's largest magnitude: the ring's merge adds
# four bf16-rounded partial outputs (each within two ULPs of its own
# magnitude) with fp32 weights, against K1's one rounding over all keys
TOL_RING = 2.0 ** -6
# steps of the usp phase's 14B FSDP edit: each of its steps gathers ~33.6 GB
# a rank through host memory over gloo (75-88 s a step on one H100), so one
# step keeps the script well inside its time limit
USP_VACE_STEPS = 1


def check_ring_body(torch, rows: int, blocks: int):
    """The ring's per-rank body (`parallel.ring.ring_body`): `rows` query
    rows against `blocks` key blocks of `rows`, each through K1 with its
    stats, merged in fp32; held against K1's plain version over the whole
    key sequence (and reported against the JAX body's online softmax,
    `ring_body_plain`, on the same rows)."""
    import torch.nn.functional as F
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.parallel import ring
    n, d = USP_HEADS, 128
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(1, rows, n, d)
    k, v = randn(1, rows * blocks, n, d), randn(1, rows * blocks, n, d)
    kv = [(k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows])
          for i in range(blocks)]
    out = ring.ring_body(q, kv)
    torch.cuda.synchronize()
    sub = torch.cat([torch.arange(0, 1024), torch.arange(rows - 1024, rows)]).cuda()
    err, scale = max_err(torch, out[:, sub], fa.flash_attention_plain(q[:, sub], k, v))
    err_body, _ = max_err(torch, out[:, sub], ring.ring_body_plain(q[:, sub], kv))
    flops = 4.0 * n * rows * rows * blocks * d
    nbytes = 2.0 * (2 * rows + 2 * rows * blocks) * n * d
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(torch, lambda: ring.ring_body(q, kv), reps=10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=10)
    return emit_rows([dict(
        name=f"K1 ring body Sq={rows} Sk={blocks}x{rows} N={n} D={d} [usp-ring-sp{blocks}]",
        kernel="K1", route="cuda", source="video_styler_tpu_torch/csrc/flash_attention.cu",
        replaces="video_styler_tpu/ops/flash_attention.py:213",
        max_abs_err=err, max_rel_err=err / scale, tol=TOL_RING * scale,
        max_abs_err_vs_ring_plain=err_body, checked_rows=int(sub.numel()),
        ms=ms, plain_ms=time_ms(torch, lambda: ring.ring_body_plain(q, kv), reps=2, warmup=1),
        k1_whole_ms=time_ms(torch, lambda: fa.flash_attention(q, k, v), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ratio_to_library=ms / lib_ms,
        tflops=flops / ms / 1e9, clocks=gpu_clocks())])


def check_usp_kernels(torch):
    """`usp_kernels`: one rank's kernel work at Wan2.1-14B width over the
    Ditto clip (29,640 tokens), in this process: K1 on a Ulysses share (20
    and 10 heads over the whole sequence, sp = 2 and 4), K1 cross, K4 and
    K5 on one rank's 7,410 rows with its cos/sin rows (rank 1 of 4), and
    the ring's body over 4 blocks."""
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid
    ditto = token_grid(DITTO_FRAMES)
    rows = []
    for sp in (2, RING_BLOCKS):
        rows += check_kernels(torch, ditto, f"usp-ulysses-sp{sp}", heads=USP_HEADS // sp,
                              cross_lens=(), norms=False)
    n = math.prod(ditto) // RING_BLOCKS
    cos, sin = assemble_freqs_grid(128, *ditto)
    rows += check_kernels(torch, (1, n, 1), f"usp-rank1-of-{RING_BLOCKS}",
                          cross_lens=(TEXT_LEN,), self_attn=False,
                          rope_tables=(cos[n:2 * n].numpy(), sin[n:2 * n].numpy()))
    rows += check_ring_body(torch, n, RING_BLOCKS)
    torch.cuda.empty_cache()
    return rows


def usp_pipeline(torch, model: str, mesh=None):
    """The usp phase's pipeline from seed 0, on the card: Wan2.1-T2V-1.3B
    ("t2v-1.3B") or the e2e phase's Wan2.1-VACE-14B ("vace-14B", the same
    weights as `build_pipeline`), with umT5-XXL and the Wan2.1 VAE; under
    `mesh`, its DiT and VACE drawn FSDP-sharded."""
    from video_styler_tpu_torch.models.t5 import UMT5_XXL
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B, WAN_T2V_1_3B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    from video_styler_tpu_torch.models.wan_vae import WAN21_VAE
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer
    dit, vace = {"t2v-1.3B": (WAN_T2V_1_3B, None), "vace-14B": (WAN_T2V_14B, VACE_14B)}[model]
    return WanVideoPipeline.from_configs(dit, vace, UMT5_XXL, WAN21_VAE,
                                         StubTokenizer(TEXT_LEN), TEXT_LEN, seed=0,
                                         device="cuda", mesh=mesh)


def usp_request(model: str, frames: int, steps: int) -> dict:
    """The request of the usp phase's model, for latents: the e2e edit, or
    a text-to-video request of the same size."""
    if model == "vace-14B":
        return dict(edit_request(frames, steps), return_latents=True)
    return dict(prompt="a cat boxing on a stage", negative_prompt="", num_frames=frames,
                height=480, width=832, seed=42, cfg_scale=5.0, num_inference_steps=steps,
                tiled=True, return_latents=True)


def park_text_encoder(pipe):
    """umT5 waits on the host and comes to the card for each prompt encode
    (`train.HostParked`), so that the ranks sharing the card leave its
    ~10.6 GiB to the others between encodes."""
    from video_styler_tpu_torch.train import HostParked
    parked = HostParked(pipe.prompter.text_encoder)
    encode = pipe.prompter.encode_prompt

    def encode_parked(*args, **kwargs):
        with parked:
            return encode(*args, **kwargs)
    pipe.prompter.encode_prompt = encode_parked


def usp_rank(spec: dict) -> dict:
    """One rank of a `usp` run (spawned by `parallel.run_local`): the
    pipeline under spec["mesh"], the request with its K1/K4/K5 launches
    counted from 0, the rank's peak memory and step times."""
    import torch
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.ops import fused_norm_rope as fnr
    from video_styler_tpu_torch.parallel import make_mesh, process_index
    t0 = time.perf_counter()
    pipe = usp_pipeline(torch, spec["model"], make_mesh(*spec["mesh"], device_type="cuda"))
    if spec["park_t5"]:
        park_text_encoder(pipe)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shard_gib = sum((p.to_local() if hasattr(p, "to_local") else p).numel() * p.element_size()
                    for m in (pipe.dit, pipe.vace) if m is not None
                    for p in m.parameters()) / 2**30
    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL}
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents = pipe(**usp_request(spec["model"], spec["frames"], spec["steps"]))
    total_s = time.perf_counter() - t0
    return dict(rank=process_index(), latents=latents.float().cpu().numpy(),
                launches={name: kern.launches for name, kern in kernels.items()},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, dit_vace_gib=shard_gib,
                build_s=build_s, total_s=total_s, step_s=step_times(pipe),
                stages=dict(pipe.stage_times))


def ditto_mesh_rank(out_dir: str) -> dict:
    """`usp` (c): `infer_ditto --smoke --mesh 1,1,1` on a one-rank NCCL
    group against the same CLI without --mesh (frames), and the smoke
    pipeline's latents under the (1, 1, 1) mesh against none."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from video_styler_tpu_torch import infer_ditto
    from video_styler_tpu_torch.parallel import make_mesh
    argv = ["--smoke", "--prompt", "a watercolor city at dusk"]
    meshed = infer_ditto.main(argv + ["--mesh", "1,1,1", "--output_path",
                                      os.path.join(out_dir, "mesh.mp4")])
    plain = infer_ditto.main(argv + ["--output_path", os.path.join(out_dir, "plain.mp4")])
    request = dict(prompt="a watercolor city at dusk",
                   vace_video=infer_ditto.smoke_frames(9, 32, 32), num_frames=9, height=32,
                   width=32, seed=42, cfg_scale=5.0, num_inference_steps=4, tiled=False,
                   return_latents=True)
    lat_mesh = infer_ditto.build_smoke_pipeline().shard(make_mesh(1, 1, 1))(**request)
    lat = infer_ditto.build_smoke_pipeline()(**request)
    return dict(backend=dist.get_backend(), world_size=dist.get_world_size(),
                frames_bit_equal=bool(np.array_equal(meshed, plain)),
                latents_bit_equal=bool(torch.equal(lat_mesh, lat)),
                latents_max_abs_diff=(lat_mesh.float() - lat.float()).abs().max().item())


def expected_usp_launches(model: str, steps: int) -> dict:
    """K1/K4/K5 launches of one rank: those of one process (two K1 and one
    K4 and K5 per block, DiT and VACE, and forward; two forwards a step)."""
    from video_styler_tpu_torch.models.wan_dit import WAN_T2V_14B, WAN_T2V_1_3B
    from video_styler_tpu_torch.models.wan_vace import VACE_14B
    layers = (WAN_T2V_1_3B.num_layers if model == "t2v-1.3B"
              else WAN_T2V_14B.num_layers + len(VACE_14B.vace_layers))
    forwards = 2 * steps
    return {"K1": 2 * layers * forwards, "K4": layers * forwards, "K5": layers * forwards}


def run_usp(torch, frames: int, steps: int, vace_reference, smi: str):
    """`usp` (last, on a free card): ranks spawned by `parallel.run_local`
    on cuda:0 with gloo named (NCCL refuses two ranks on one device).
    (a) Wan2.1-T2V-1.3B at full width on meshes (1, 1, 2) and (1, 2, 2),
    against the same weights in this process; (b) the e2e edit at
    Wan2.1-VACE-14B width on (1, 2, 1), FSDP over 2 ranks, for
    USP_VACE_STEPS steps, against the e2e request's latents in one process
    (`vace_reference`); (c) `ditto_mesh_rank` on a one-rank
    NCCL group. Returns rank 0's launches summed over (a) and (b)."""
    import numpy as np
    from video_styler_tpu_torch.parallel import run_local
    store_dir = tempfile.mkdtemp(prefix="usp-")
    pipe = usp_pipeline(torch, "t2v-1.3B")
    t2v_reference = pipe(**usp_request("t2v-1.3B", frames, steps)).float().cpu().numpy()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    total, failures = {}, []
    runs = [("t2v-1.3B", (1, 1, 2), steps, t2v_reference, False),
            ("t2v-1.3B", (1, 2, 2), steps, t2v_reference, False),
            ("vace-14B", (1, 2, 1), USP_VACE_STEPS, vace_reference, True)]
    for model, mesh, n_steps, reference, park in runs:
        world = math.prod(mesh)
        spec = dict(model=model, mesh=mesh, frames=frames, steps=n_steps, park_t5=park)
        t0 = time.perf_counter()
        ranks = run_local(usp_rank, world, "gloo",
                          os.path.join(store_dir, f"{model}-{world}-{mesh[1]}"), spec,
                          device="cuda:0", timeout_s=900)
        wall_s = time.perf_counter() - t0
        expected = expected_usp_launches(model, n_steps)
        rel = [float(np.linalg.norm(r["latents"] - reference) / np.linalg.norm(reference))
               for r in ranks]
        res = dict(phase="usp", model=model, mesh=dict(zip(("dp", "fsdp", "sp"), mesh)),
                   backend="gloo", card=smi,
                   note=f"{world} ranks share one card over gloo: step times are not a "
                        "multi-card speed",
                   frames=frames, tokens=math.prod(token_grid(frames)), steps=n_steps,
                   cfg="two-pass 5.0", latents_rel_l2=rel, latents_tol=5e-2,
                   bit_equal_to_one_process=[bool(np.array_equal(r["latents"], reference))
                                             for r in ranks],
                   ranks_bit_equal=all(np.array_equal(r["latents"], ranks[0]["latents"])
                                       for r in ranks),
                   peak_gib=[r["peak_gib"] for r in ranks],
                   dit_vace_gib=[r["dit_vace_gib"] for r in ranks],
                   launches=[r["launches"] for r in ranks], expected_launches=expected,
                   step_s=[r["step_s"] for r in ranks], total_s=[r["total_s"] for r in ranks],
                   build_s=[r["build_s"] for r in ranks], wall_s=wall_s,
                   stages=ranks[0]["stages"])
        emit(res)
        if any(r["launches"] != expected for r in ranks):
            failures.append(f"{model} mesh {mesh}: launches {res['launches']}, "
                            f"expected {expected} a rank")
        if not max(rel) <= 5e-2:
            failures.append(f"{model} mesh {mesh}: latents {rel} from one process")
        for name, count in ranks[0]["launches"].items():
            total[name] = total.get(name, 0) + count
    res = run_local(ditto_mesh_rank, 1, "nccl", os.path.join(store_dir, "nccl"), store_dir,
                    timeout_s=300)[0]
    emit(dict(phase="usp_nccl_mesh_1_1_1", **res))
    if not (res["backend"] == "nccl" and res["frames_bit_equal"] and res["latents_bit_equal"]):
        failures.append(f"infer_ditto --mesh 1,1,1 differs from the run without: {res}")
    shutil.rmtree(store_dir, ignore_errors=True)
    if failures:
        raise AssertionError("usp: " + "; ".join(failures))
    return total




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
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
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
    CARD["card"] = smi
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), build_s=build_s, ptxas=PTXAS))

    kernels = {"K1": fa.KERNEL, "K4": fnr.ROPE_KERNEL, "K5": fnr.RMS_KERNEL,
               "K3": fa.BWD_KERNEL, "K3q": fa.BWD_DQ_KERNEL,
               "K2": fa.ONLINE_KERNEL, "K8": fa.DUAL_KERNEL,
               "K6": fa.INT8_CAPPED_KERNEL, "K6o": fa.INT8_ONLINE_KERNEL,
               "K7": fa.INT8_3D_KERNEL, "F1": fk.REMAP_KERNEL,
               "F2": fk.PATCH_ERROR_KERNEL, "F3": fk.PAIRWISE_KERNEL}
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
    # the Fun reference frame: one more leading latent frame (6,240 tokens
    # at 9 frames, RoPE rows over f + 1 frames), whose queries also reach
    # the text and the 257 CLIP keys (V1.1 Control keeps the image input);
    # the 1.3B speed-control
    # width: 12 heads of 128, Dm 1536
    rows += check_kernels(torch, (run[0] + 1,) + run[1:], f"fun-ref-{args.frames}f",
                          cross_lens=(TEXT_LEN, CLIP_ROWS))
    rows += check_kernels(torch, run, f"speed-{args.frames}f", heads=12)
    # Wan2.2-S2V at 448x832: self-attention over the latent frames and the
    # reference frame (RoPE rows from its segments) at the run's 12 frames
    # (5,824 tokens, with the text cross) and the recipe's 80 (30,576);
    # the audio cross, a batch row per latent frame against 5 keys
    for frames, cross in ((S2V_RUN_FRAMES, (TEXT_LEN,)), (S2V_RECIPE_FRAMES, ())):
        rows += check_kernels(torch, s2v_grid(frames), f"s2v-{frames}f", cross_lens=cross,
                              rope_tables=s2v_rope_tables(frames))
        rows += check_audio_cross_kernels(torch, (frames - 1) // 4 + 1, f"s2v-{frames}f")
    # FastBlend's F1-F3 at the post-processing path's top pyramid level
    rows += check_fastblend_kernels(torch)
    # one rank's share of the multi-GPU path at 14B width
    rows += check_usp_kernels(torch)
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
    check_fun_references(torch)
    check_s2v_reference(torch)
    check_postprocess_reference(torch)
    pipe, init_s = build_pipeline(torch)
    e2e_frames = []
    run_edit(torch, pipe, kernels, args.steps, args.frames, "e2e", {"K1": 1.0},
             outputs=e2e_frames, init_s=init_s)
    # the e2e request's latents in one process, for the usp phase's FSDP ranks
    usp_reference = pipe(**usp_request("vace-14B", args.frames, USP_VACE_STEPS)
                         ).float().cpu().numpy()
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
    path_launches.update(run_i2v(torch, pipe, kernels, args.frames, args.steps))
    path_launches["speed"] = run_speed(torch, pipe, kernels, args.frames, args.steps)
    path_launches["ti2v"] = run_ti2v(torch, pipe, kernels, args.steps)
    path_launches["s2v"] = run_s2v(torch, pipe, kernels, args.steps)
    # the post-processing chain on a free card: umT5 and the VAE go too
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(run_postprocess(torch, kernels))
    # the multi-GPU path: ranks sharing the free card
    path_launches["usp"] = run_usp(torch, args.frames, args.steps, usp_reference, smi)

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_path = {name: {path: counts[name] for path, counts in path_launches.items()
                      if name in counts} for name in ("K1", "K4", "K5")}
    line = ([{**{k: r[k] for k in keys}, "launches": launches[r["kernel"]],
              **({"launches_by_path": by_path[r["kernel"]]} if r["kernel"] in by_path else {})}
             for r in rows + new_rows]
            + [{**{k: r[k] for k in keys}, "launches": train_launches[
                "K1" if r["kernel"] == "K1s" else r["kernel"]]} for r in train_rows])
    unlaunched = sorted({r["name"].split()[0] for r in line if r["launches"] == 0})
    if unlaunched:
        raise AssertionError(f"kernels never launched on their main-path runs: {unlaunched}")
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
