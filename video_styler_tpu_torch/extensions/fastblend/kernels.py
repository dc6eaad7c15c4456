"""FastBlend's PatchMatch kernels F1-F3, with their plain PyTorch versions.

  remap                 (F1) patch-vote average of `source_style` through the
                        NNF: every pixel averages, over the patch around it,
                        the source pixel its neighbour's match points at,
                        shifted back by the neighbour's offset; votes from
                        outside the image do not count, and a pixel with no
                        vote gets 0
  patch_error           (F2) SSD between each target patch and the source
                        patch its NNF entry points at
  pairwise_patch_error  (F3) SSD between the patches two NNFs point at in two
                        sources

They replace `JaxKernels.remap`, `.patch_error` and `.pairwise_patch_error`
(video_styler_tpu/extensions/fastblend/kernels.py:104, :139, :156), with
the same arguments: images are padded NHWC float32 (B, H + 2 pad,
W + 2 pad, C), NNFs int32 (B, H, W, 2) of (row, column) in the unpadded
image, and `patch_size` may change between calls while `pad_size` stays.
The kernels are hand-written CUDA C++ in `csrc/fastblend.cu` (its header
note says what bounds them and how they are laid out).

On a CPU tensor each function runs its plain version; on a CUDA tensor it
launches its kernel or raises. The plain versions are the XLA form's
shift loops, rounding where it rounds: per shift, the channel sum of
squares (channel 0 first), then accumulate; F1 sums its votes in shift
order and divides by their count. PatchMatch keeps a candidate only where
its error is strictly lower, so the NNFs that they give equal the JAX
package's bit for bit. Source coordinates are clamped into the padded
image, as the XLA gather clamps them.
"""
from __future__ import annotations

import torch

from ...ops.cuda_build import I32, P, Kernel

REMAP_KERNEL = Kernel("fastblend", "fastblend_remap",
                      [P, P, P, I32, I32, I32, I32, I32, I32, P],
                      "fastblend_error_string")
PATCH_ERROR_KERNEL = Kernel("fastblend", "fastblend_patch_error",
                            [P, P, P, P, I32, I32, I32, I32, I32, I32, P],
                            "fastblend_error_string")
PAIRWISE_KERNEL = Kernel("fastblend", "fastblend_pairwise_patch_error",
                         [P, P, P, P, P, I32, I32, I32, I32, I32, I32, P],
                         "fastblend_error_string")
MAX_CHANNELS = 4  # the kernels are instantiated for 1..4 channels


def _gather(img, xs, ys, pad: int):
    """img (B, Hp, Wp, C); xs/ys (B, H, W) unpadded coordinates, clamped
    into the padded image -> (B, H, W, C)."""
    b, hp, wp, _ = img.shape
    bi = torch.arange(b, device=img.device)[:, None, None]
    return img[bi, (xs + pad).clamp(0, hp - 1), (ys + pad).clamp(0, wp - 1)]


def _channel_ssd(a, b):
    """sum over the last axis of (a - b)^2, channel 0 first."""
    d = a - b
    s = d[..., 0] * d[..., 0]
    for c in range(1, d.shape[-1]):
        s = s + d[..., c] * d[..., c]
    return s


def remap_plain(height, width, channel, patch_size, pad_size, source_style, nnf):
    r = (patch_size - 1) // 2
    b, dev = source_style.shape[0], source_style.device
    xx = torch.arange(height, device=dev)[None, :, None]
    yy = torch.arange(width, device=dev)[None, None, :]
    nx = torch.full((b, height + 2 * r, width + 2 * r), -1, dtype=torch.int32, device=dev)
    ny = nx.clone()
    nx[:, r:r + height, r:r + width] = nnf[..., 0]
    ny[:, r:r + height, r:r + width] = nnf[..., 1]
    acc = torch.zeros((b, height, width, channel), dtype=torch.float32, device=dev)
    cnt = torch.zeros((b, height, width, 1), dtype=torch.float32, device=dev)
    for px in range(-r, r + 1):
        for py in range(-r, r + 1):
            x_nb = nx[:, r + px:r + px + height, r + py:r + py + width] - px
            y_nb = ny[:, r + px:r + px + height, r + py:r + py + width] - py
            valid = ((x_nb >= 0) & (y_nb >= 0) & (x_nb < height) & (y_nb < width)
                     & (xx + px >= 0) & (xx + px < height)
                     & (yy + py >= 0) & (yy + py < width))[..., None]
            vals = _gather(source_style, x_nb.clamp(0, height - 1),
                           y_nb.clamp(0, width - 1), pad_size)
            acc = acc + torch.where(valid, vals, 0.0)
            cnt = cnt + valid.float()
    out = torch.zeros_like(source_style)
    out[:, pad_size:pad_size + height, pad_size:pad_size + width] = acc / cnt.clamp(min=1.0)
    return out


def patch_error_plain(height, width, channel, patch_size, pad_size, source, nnf, target):
    r = (patch_size - 1) // 2
    xs, ys = nnf[..., 0], nnf[..., 1]
    err = torch.zeros((source.shape[0], height, width), dtype=torch.float32,
                      device=source.device)
    for px in range(-r, r + 1):
        for py in range(-r, r + 1):
            t = target[:, pad_size + px:pad_size + px + height,
                       pad_size + py:pad_size + py + width]
            err = err + _channel_ssd(t, _gather(source, xs + px, ys + py, pad_size))
    return err


def pairwise_patch_error_plain(height, width, channel, patch_size, pad_size,
                               source_a, nnf_a, source_b, nnf_b):
    r = (patch_size - 1) // 2
    err = torch.zeros((source_a.shape[0], height, width), dtype=torch.float32,
                      device=source_a.device)
    for px in range(-r, r + 1):
        for py in range(-r, r + 1):
            a = _gather(source_a, nnf_a[..., 0] + px, nnf_a[..., 1] + py, pad_size)
            b = _gather(source_b, nnf_b[..., 0] + px, nnf_b[..., 1] + py, pad_size)
            err = err + _channel_ssd(a, b)
    return err


def _check(height, width, channel, patch_size, pad_size, images, nnfs):
    """What the kernels take: padded float32 images and int32 NNFs of one
    batch, contiguous and on one CUDA device, 1..4 channels, an odd patch
    whose radius fits the padding."""
    if patch_size < 1 or patch_size % 2 == 0 or (patch_size - 1) // 2 > pad_size:
        raise ValueError(f"patch_size {patch_size} must be odd with a radius of at "
                         f"most pad_size {pad_size}")
    if not 1 <= channel <= MAX_CHANNELS:
        raise ValueError(f"{channel} channels: the kernels take 1..{MAX_CHANNELS}")
    dev = images[0].device
    batch = images[0].shape[0]
    padded = (batch, height + 2 * pad_size, width + 2 * pad_size, channel)
    for t, shape, dtype in ([(t, padded, torch.float32) for t in images]
                            + [(n, (batch, height, width, 2), torch.int32) for n in nnfs]):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"need {dtype} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("the kernels take contiguous, 8-byte aligned tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(name: str, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA or (plain) CPU, not {t.device}")
    return True


def remap(height, width, channel, patch_size, pad_size, source_style, nnf):
    """F1: (B, H + 2p, W + 2p, C) padded float32, zeros outside the core."""
    if not _on_cuda("remap", source_style):
        return remap_plain(height, width, channel, patch_size, pad_size, source_style, nnf)
    _check(height, width, channel, patch_size, pad_size, [source_style], [nnf])
    out = torch.zeros_like(source_style)
    REMAP_KERNEL(source_style.data_ptr(), nnf.data_ptr(), out.data_ptr(),
                 source_style.shape[0], height, width, channel, patch_size, pad_size,
                 _stream(out))
    return out


def patch_error(height, width, channel, patch_size, pad_size, source, nnf, target):
    """F2: (B, H, W) float32."""
    if not _on_cuda("patch_error", source):
        return patch_error_plain(height, width, channel, patch_size, pad_size, source,
                                 nnf, target)
    _check(height, width, channel, patch_size, pad_size, [source, target], [nnf])
    err = torch.empty(source.shape[:1] + (height, width), dtype=torch.float32,
                      device=source.device)
    PATCH_ERROR_KERNEL(source.data_ptr(), nnf.data_ptr(), target.data_ptr(),
                       err.data_ptr(), source.shape[0], height, width, channel,
                       patch_size, pad_size, _stream(err))
    return err


def pairwise_patch_error(height, width, channel, patch_size, pad_size, source_a,
                         nnf_a, source_b, nnf_b):
    """F3: (B, H, W) float32."""
    if not _on_cuda("pairwise_patch_error", source_a):
        return pairwise_patch_error_plain(height, width, channel, patch_size, pad_size,
                                          source_a, nnf_a, source_b, nnf_b)
    _check(height, width, channel, patch_size, pad_size, [source_a, source_b],
           [nnf_a, nnf_b])
    err = torch.empty(source_a.shape[:1] + (height, width), dtype=torch.float32,
                      device=source_a.device)
    PAIRWISE_KERNEL(source_a.data_ptr(), nnf_a.data_ptr(), source_b.data_ptr(),
                    nnf_b.data_ptr(), err.data_ptr(), source_a.shape[0], height, width,
                    channel, patch_size, pad_size, _stream(err))
    return err
