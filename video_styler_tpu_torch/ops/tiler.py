"""TileWorker: 2-D tiled inference for image models.

Counterpart of `video_styler_tpu/ops/tiler.py`: the input is cut into
overlapping square tiles (the right and bottom edges covered by extra
tiles), `forward_fn` runs on batches of them, and the outputs (scaled by
the model's output/input ratio) are blended back under a mask that rises
linearly over `border_width` from each tile edge. Tensors stay on the
input's device; the blend is fp32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _mask(height: int, width: int, border_width: int) -> np.ndarray:
    x = np.arange(height)[:, None].repeat(width, 1)
    y = np.arange(width)[None, :].repeat(height, 0)
    m = np.stack([x + 1, height - x, y + 1, width - y]).min(axis=0)
    return np.clip(m / border_width, 0, 1).astype(np.float32)


class TileWorker:

    def tiled_forward(self, forward_fn: Callable, model_input, tile_size: int,
                      tile_stride: int, tile_batch_size: int = 1, border_width=None):
        """model_input (B, C, H, W), a tensor or numpy -> the blended output
        (B, C', H * s, W * s), float32, on the input's device."""
        x = torch.as_tensor(model_input).float()
        b, c, H, W = x.shape
        tile_size = min(tile_size, H, W)
        positions = [(h0, w0) for h0 in range(0, max(H - tile_size, 0) + 1, tile_stride)
                     for w0 in range(0, max(W - tile_size, 0) + 1, tile_stride)]
        if (H - tile_size) % tile_stride != 0:
            positions += [(H - tile_size, w0)
                          for w0 in range(0, max(W - tile_size, 0) + 1, tile_stride)]
        if (W - tile_size) % tile_stride != 0:
            positions += [(h0, W - tile_size)
                          for h0 in range(0, max(H - tile_size, 0) + 1, tile_stride)]
        tiles = [x[:, :, h0:h0 + tile_size, w0:w0 + tile_size] for h0, w0 in positions]

        outs = []
        for i in range(0, len(tiles), tile_batch_size):
            y = forward_fn(torch.cat(tiles[i:i + tile_batch_size], dim=0)).float()
            outs.extend(y.split(b, dim=0))

        scale = outs[0].shape[2] / tile_size
        out_c, out_tile = outs[0].shape[1], outs[0].shape[2]
        out_H, out_W = int(H * scale), int(W * scale)
        if border_width is None:
            border_width = int((tile_size - tile_stride) * scale)
        mask = torch.from_numpy(_mask(out_tile, out_tile, max(border_width, 1))).to(
            x.device)[None, None]
        value = torch.zeros((b, out_c, out_H, out_W), dtype=torch.float32, device=x.device)
        weight = torch.zeros((1, 1, out_H, out_W), dtype=torch.float32, device=x.device)
        for (h0, w0), y in zip(positions, outs):
            oh, ow = int(h0 * scale), int(w0 * scale)
            value[:, :, oh:oh + out_tile, ow:ow + out_tile] += y * mask
            weight[:, :, oh:oh + out_tile, ow:ow + out_tile] += mask
        return value / weight.clamp_min(1e-8)
