"""Wan2.2 dual-expert temporal enhancer (SDEdit) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/wan_enhancer.py`: encode the
clip, noise it to `timesteps[-forward_step]` of a UniPC schedule, denoise
only the last `skip_backward_step` steps of that schedule with two-pass
CFG, then decode. Timesteps at or above `boundary` * 1000 run the
high-noise expert (`dit2`, guide scale `guide_scale[1]`), the others the
low-noise expert (`dit`, `guide_scale[0]`). Both experts stay on the
device. The latents and the solver's history stay on the device in fp32.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..schedulers.flow_unipc import FlowUniPCMultistepScheduler
from .wan_video import WanVideoPipeline, _preprocess_images, generate_noise


class WanEnhancerPipeline(WanVideoPipeline):
    """`dit` is the low-noise expert, `dit2` the high-noise expert."""

    @torch.no_grad()
    def enhance(self, video, prompt: str = "", negative_prompt: str = "",
                forward_step: int = 4, skip_backward_step: int = 4,
                sampling_steps: int = 50, shift: float = 5.0,
                guide_scale: Tuple[float, float] = (3.0, 4.0),
                boundary: float = 0.875, seed: Optional[int] = None,
                tiled: bool = False, tile_size: Tuple[int, int] = (30, 52),
                tile_stride: Tuple[int, int] = (15, 26),
                return_latents: bool = False):
        """video: a PIL list or uint8 (T, H, W, 3) array. guide_scale =
        (low-noise scale, high-noise scale); boundary is a fraction of the
        1000 training timesteps. `self.experts` lists (timestep, expert) of
        each step run."""
        self.stage_times = []
        self.stage_peak_bytes = []
        self.experts: List[Tuple[int, str]] = []
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        scheduler = FlowUniPCMultistepScheduler(
            num_train_timesteps=1000, shift=1, use_dynamic_shifting=False)
        scheduler.set_timesteps(sampling_steps, shift=shift)
        boundary_t = boundary * 1000

        with self._stage("vae_encode"):
            latents = self.encode_video(_preprocess_images(video), **tiler).float()
        noise = generate_noise(latents.shape, seed=seed).to(self.device)
        latents = scheduler.add_noise(latents, noise,
                                      int(scheduler.timesteps[-forward_step]))

        with self._stage("t5"):
            ctx_posi = self.encode_prompt(prompt)
            ctx_nega = self.encode_prompt(negative_prompt)

        for i, t in enumerate(scheduler.timesteps[-skip_backward_step:]):
            t_item = int(t)
            if t_item >= boundary_t and self.dit2 is not None:
                which, scale = "dit2", guide_scale[1]
            else:
                which, scale = "dit", guide_scale[0]
            self.experts.append((t_item, which))
            with self._stage(f"denoise_step_{i}"):
                timestep = torch.tensor([float(t_item)], dtype=torch.float32,
                                        device=self.device)
                lat = latents.to(self.dtype)
                v_cond = self._branch_forward(which, None, lat, timestep, ctx_posi,
                                              None, 1.0, None)
                v_uncond = self._branch_forward(which, None, lat, timestep, ctx_nega,
                                                None, 1.0, None)
                v = v_uncond + scale * (v_cond - v_uncond)
                latents = scheduler.step(v.float(), t_item, latents)

        latents = latents.to(self.dtype)
        if return_latents:
            return latents
        with self._stage("vae_decode"):
            video = self.decode_video(latents, **tiler)
        return self.vae_output_to_video(video)
