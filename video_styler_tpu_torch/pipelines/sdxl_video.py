"""SDXL video (AnimateDiff-XL, Kolors video) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/sdxl_video.py` (:31-207): the
SDXL UNet over the frames as its batch with the motion modules after the
blocks of `SDXL_MOTION_CALL_BLOCK_ID`, the windows of `dance_long_video`,
the IP-Adapter from image embeds in full or under InstantStyle (block
28's ten transformers only; the negative pass at scale 1, as in JAX), the
Kolors prompt path and the smoother hook. Without motion modules one noise
sample is repeated over the frames and the schedule falls back to
scaled_linear (Kolors: beta_end 0.014 over 1100 steps), as in JAX.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..models import sdxl as XL
from ..models.motion import SDXL_MOTION_CALL_BLOCK_ID
from ..schedulers.ddim import EnhancedDDIMScheduler
from .sd_image import ddim_update
from .sd_video import dance_long_video, frames_to_latents, latents_to_frames, smooth_step
from .sdxl_image import SDXLImagePipeline
from .wan_video import generate_noise


class SDXLVideoPipeline(SDXLImagePipeline):

    def __init__(self, device=None, dtype=torch.bfloat16, use_original_animatediff: bool = True):
        super().__init__(device=device, dtype=dtype)
        self.scheduler = EnhancedDDIMScheduler(
            beta_schedule="linear" if use_original_animatediff else "scaled_linear")
        self.motion_modules = None
        self.ipadapter = None

    def fetch_motion_modules(self, motion_modules):
        self.motion_modules = motion_modules

    def _maybe_downgrade_scheduler(self):
        if self.motion_modules is None:
            if self.kolors is not None:
                self.scheduler = EnhancedDDIMScheduler(beta_end=0.014, num_train_timesteps=1100)
            else:
                self.scheduler = EnhancedDDIMScheduler(beta_schedule="scaled_linear")

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        clip_skip: int = 1,
        num_frames: int = 16,
        input_frames: Optional[List] = None,
        ipadapter_image_embeds=None,
        ipadapter_scale: float = 1.0,
        ipadapter_use_instant_style: bool = False,
        denoising_strength: float = 1.0,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 20,
        animatediff_batch_size: int = 16,
        animatediff_stride: int = 8,
        smoother=None,
        smoother_progress_ids: Optional[List[int]] = None,
        seed: Optional[int] = None,
        progress_bar_cmd: Optional[Callable] = None,
        return_latents: bool = False,
    ):
        self.stage_times, self.stage_peak_bytes = [], []
        dev, dtype = self.device, self.dtype
        smoother_progress_ids = smoother_progress_ids or []
        self._maybe_downgrade_scheduler()
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        shape = (num_frames, 4, height // 8, width // 8)
        if self.motion_modules is None:
            noise = generate_noise((1,) + shape[1:], seed=seed).to(dev, dtype).expand(shape)
        else:
            noise = generate_noise(shape, seed=seed).to(dev, dtype)
        if input_frames is not None and denoising_strength < 1.0:
            with self._stage("vae_encode"):
                lat = frames_to_latents(self, input_frames, width, height)
            latents = self.scheduler.add_noise(lat, noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise
        ctx_posi, pooled_posi = self.encode_prompt(prompt, clip_skip)
        if cfg_scale != 1.0:
            ctx_nega, pooled_nega = self.encode_prompt(negative_prompt, clip_skip)
        add_time_id = self.add_time_id(height, width)

        ip_posi = ip_nega = None
        if self.ipadapter is not None and ipadapter_image_embeds is not None:
            from ..models.ipadapter import ipadapter_kwargs
            embeds = torch.as_tensor(ipadapter_image_embeds, device=dev).to(dtype)
            ip_posi = ipadapter_kwargs(self.ipadapter, embeds, scale=ipadapter_scale, xl=True,
                                       instant_style=ipadapter_use_instant_style)
            ip_nega = ipadapter_kwargs(self.ipadapter, torch.zeros_like(embeds), xl=True,
                                       instant_style=ipadapter_use_instant_style)
        motion = None if self.motion_modules is None else (self.motion_modules,
                                                           SDXL_MOTION_CALL_BLOCK_ID)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tj = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):

                def unet_fn(ctx, pooled, ip):
                    return lambda b0, b1: XL.sdxl_unet_forward(
                        self.unet, latents[b0:b1], tj, ctx, add_time_id, pooled,
                        ipadapter_kwargs_list=ip, motion=motion)

                eps_posi = dance_long_video(unet_fn(ctx_posi, pooled_posi, ip_posi), latents,
                                            animatediff_batch_size, animatediff_stride)
                if cfg_scale != 1.0:
                    eps_nega = dance_long_video(unet_fn(ctx_nega, pooled_nega, ip_nega), latents,
                                                animatediff_batch_size, animatediff_stride)
                    eps = eps_nega + cfg_scale * (eps_posi - eps_nega)
                else:
                    eps = eps_posi
            if smoother is not None and i in smoother_progress_ids:
                eps = smooth_step(self, eps, t, latents, smoother, input_frames, width, height)
            latents = ddim_update(self.scheduler, eps, t, latents, dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            frames = latents_to_frames(self, latents)
        if smoother is not None and (num_inference_steps in smoother_progress_ids
                                     or -1 in smoother_progress_ids):
            frames = smoother(frames, original_frames=input_frames)
        return frames
