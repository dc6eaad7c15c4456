"""SD 1.5 video (AnimateDiff, and the Diffutoon renderer) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/sd_video.py` (:24-191): the
frames are the UNet's batch, the motion modules run after the blocks of
`SD_MOTION_CALL_BLOCK_ID`; `dance_long_video` passes windows of
`animatediff_batch_size` frames every `animatediff_stride` frames and
blends the overlaps with triangle weights (in fp32, as the JAX package
does on the host); each frame of a window gets its own ControlNet
residuals. At the steps of `smoother_progress_ids` the smoother hook
renders the step's x0, smooths the frames in pixel space and re-encodes
them as the step's target (`return_to_timestep`). The DDIM schedule is
AnimateDiff's linear one unless `use_original_animatediff=False`. Frames
in and out are uint8 (H, W, 3) arrays (PIL images are taken too).

`controlnet_frames` is a list of frames, or (as the Diffutoon runner
gives it, and the reference takes it) a list per ControlNet unit of its
frames; the JAX pipeline takes only the first form. The prompt takes one
77-token chunk of the tokenizer's ids, as in JAX (the image pipeline's
stand-in ids and long-prompt chunks are not used here).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import sd as SD
from ..models.motion import SD_MOTION_CALL_BLOCK_ID
from ..schedulers.ddim import EnhancedDDIMScheduler
from .sd_image import SDImagePipeline, ddim_update
from .wan_video import _image_array, _preprocess_images, generate_noise


def dance_long_video(unet_fn, sample, animatediff_batch_size: int = 16,
                     animatediff_stride: int = 8):
    """Windows of `animatediff_batch_size` frames every `animatediff_stride`
    through `unet_fn(b0, b1)`, blended with triangle weights -> fp32."""
    t = sample.shape[0]
    out = torch.zeros(sample.shape, dtype=torch.float32, device=sample.device)
    num = np.zeros(t, np.float32)
    for b0 in range(0, t, animatediff_stride):
        b1 = min(b0 + animatediff_batch_size, t)
        batch = unet_fn(b0, b1).float()
        for i in range(b0, b1):
            bias = max(1 - abs(i - (b0 + b1 - 1) / 2) / ((b1 - b0 - 1 + 1e-2) / 2), 1e-2)
            out[i] = (out[i] * float(num[i] / (num[i] + bias))
                      + batch[i - b0] * float(bias / (num[i] + bias)))
            num[i] += bias
        if b1 == t:
            break
    return out


VAE_CHUNK_PIXELS = 4 * 512 * 512   # frames a VAE call takes: 4 at 512x512, 1 at 1024x1024


def _chunks(n: int, height: int, width: int):
    step = max(1, VAE_CHUNK_PIXELS // (height * width))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def frames_to_latents(pipe, frames, width: int, height: int):
    """uint8 frames -> their VAE latents (T, 4, h, w) in fp32, a few frames
    a call (the JAX pipeline encodes the clip in one call; the VAE's
    attention at 1024x1024 holds a 1 GB fp32 logit matrix a frame)."""
    arr = _preprocess_images(np.stack([_image_array(f, width, height) for f in frames]))[0]
    arr = arr.transpose(1, 0, 2, 3)
    return torch.cat([pipe.encode_image(arr[a:b]) for a, b in _chunks(len(arr), height, width)])


def latents_to_frames(pipe, latents) -> List[np.ndarray]:
    """(T, 4, h, w) -> uint8 (H, W, 3) frames (the VAE in fp32, a few frames
    a call)."""
    h, w = latents.shape[2] * 8, latents.shape[3] * 8
    out = []
    for a, b in _chunks(latents.shape[0], h, w):
        image = pipe.decode_image(latents[a:b])
        if not bool(torch.isfinite(image).all()):
            raise FloatingPointError("decoded frames hold non-finite values")
        arr = image.float().cpu().numpy().transpose(0, 2, 3, 1)
        out += list(np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8))
    return out


def smooth_step(pipe, eps, t, latents, smoother, input_frames, width: int, height: int):
    """The smoother hook: the step's x0 rendered, smoothed, re-encoded, and
    turned back into the step's noise prediction (fp32)."""
    with pipe._stage("smoother"):
        rendered = pipe.scheduler.step(eps.float(), t, latents.float(), to_final=True)
        frames = smoother(latents_to_frames(pipe, rendered), original_frames=input_frames)
        target = frames_to_latents(pipe, frames, width, height)
        return pipe.scheduler.return_to_timestep(t, latents.float(), target)


class SDVideoPipeline(SDImagePipeline):

    def __init__(self, device=None, dtype=torch.bfloat16, use_original_animatediff: bool = True):
        super().__init__(device=device, dtype=dtype)
        self.scheduler = EnhancedDDIMScheduler(
            beta_schedule="linear" if use_original_animatediff else "scaled_linear")
        self.motion_modules = None
        self.controlnet_manager = None

    @torch.no_grad()
    def encode_prompt(self, prompt: str, clip_skip: int = 1):
        """One 77-token chunk through the tokenizer, which this pipeline
        needs (as in JAX: no stand-in ids, no long-prompt chunks)."""
        if self.tokenizer is None:
            raise RuntimeError("SDVideoPipeline needs a CLIP tokenizer (tokenizer_path)")
        with self._stage("text_encode"):
            ids = self.tokenizer([prompt], padding="max_length", max_length=77,
                                 truncation=True, return_tensors="np")["input_ids"]
            ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
            return SD.sd_text_encoder_forward(self.text_encoder, ids, clip_skip).to(self.dtype)

    def conditionings(self, controlnet_frames, width: int, height: int):
        """-> per frame, (n_units, 3, H, W) float32 in [0, 1]."""
        mgr = self.controlnet_manager
        if isinstance(controlnet_frames[0], (list, tuple)):
            per_unit = [[mgr.process_image(f, width, height, units=[u])[0] for f in frames]
                        for u, frames in zip(mgr.units, controlnet_frames)]
            return [np.stack(c) for c in zip(*per_unit)]
        return [mgr.process_image(f, width, height) for f in controlnet_frames]

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        clip_skip: int = 1,
        num_frames: int = 16,
        input_frames: Optional[List] = None,
        controlnet_frames: Optional[List] = None,
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
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        noise = generate_noise((num_frames, 4, height // 8, width // 8), seed=seed).to(dev, dtype)
        if input_frames is not None and denoising_strength < 1.0:
            with self._stage("vae_encode"):
                lat = frames_to_latents(self, input_frames, width, height)
            latents = self.scheduler.add_noise(lat, noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise
        ctx_posi = self.encode_prompt(prompt, clip_skip)
        ctx_nega = self.encode_prompt(negative_prompt, clip_skip) if cfg_scale != 1.0 else None
        conds = None
        if self.controlnet_manager is not None and controlnet_frames is not None:
            conds = self.conditionings(controlnet_frames, width, height)
        motion = None if self.motion_modules is None else (self.motion_modules,
                                                           SD_MOTION_CALL_BLOCK_ID)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tj = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):

                def unet_fn(ctx):
                    def run(b0, b1):
                        cn = None
                        if conds is not None:
                            stacks = [self.controlnet_manager(latents[f:f + 1], tj, ctx, conds[f])
                                      for f in range(b0, b1)]
                            cn = [torch.cat([s[j] for s in stacks]) for j in range(len(stacks[0]))]
                        return SD.sd_unet_forward(self.unet, latents[b0:b1], tj, ctx,
                                                  controlnet_res_stack=cn, motion=motion)
                    return run

                eps_posi = dance_long_video(unet_fn(ctx_posi), latents, animatediff_batch_size,
                                            animatediff_stride)
                if cfg_scale != 1.0:
                    eps_nega = dance_long_video(unet_fn(ctx_nega), latents,
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
