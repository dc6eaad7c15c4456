"""Stable Video Diffusion image-to-video in PyTorch.

Counterpart of `video_styler_tpu/pipelines/svd_video.py`
(`SVDVideoPipeline.__call__` :95-187): the continuous ODE scheduler over
frames-as-batch latents, the CLIP-H image embedding (zeros for the
negative branch) and the noised VAE encode of the image concatenated on
the channels of every frame (zeros for the negative branch), CFG as a
linspace from `min_cfg_scale` to `max_cfg_scale` across the frames, the
add-time ids [fps - 1, motion_bucket_id, noise_aug_strength], optional
video-to-video (`input_video`, `denoising_strength`) and mask frames
re-noised every step, the latent post-normalisation and contrast
enhancement, then the temporal VAE decode.

The models: the UNet (`models.svd.SVDUNet`, or ExVideo's), the SD VAE
encoder, the SVD temporal VAE decoder (fp32) and the CLIP-H image tower
(`models.svd.SVDImageEncoder`). A request without one of them raises a
RuntimeError naming it (the JAX runner loads the UNet alone).

Runs on `cuda` unless constructed with `device="cpu"`; each stage's wall
time is kept in `stage_times` and, on the card, the running peak in
`stage_peak_bytes`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import sd as SD
from ..models import svd as S
from ..models.clip_vit import preprocess_clip_image
from ..schedulers.continuous_ode import ContinuousODEScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .wan_video import _image_array, _preprocess_images, generate_noise


class SVDVideoPipeline:

    _stage = FluxImagePipeline._stage

    def __init__(self, device=None, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = ContinuousODEScheduler()
        self.unet: Optional[S.SVDUNet] = None
        self.vae_encoder: Optional[SD.SDVAEEncoder] = None
        self.vae_decoder: Optional[S.SVDVAEDecoder] = None
        self.image_encoder: Optional[S.SVDImageEncoder] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, unet_cfg=S.SVD_UNET, image_cfg=S.SVD_IMAGE_ENCODER, seed: int = 0,
                     device=None, dtype=torch.float32,
                     exvideo: bool = False) -> "SVDVideoPipeline":
        """Random weights drawn on the device from one seeded generator: the
        UNet and the image tower in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            unet = S.SVDUNet(unet_cfg, dtype=dtype, exvideo=exvideo)
            image = S.SVDImageEncoder(image_cfg, dtype=dtype)
            enc = SD.SDVAEEncoder(dtype=torch.float32)
            dec = S.SVDVAEDecoder(dtype=torch.float32)
        pipe.unet, pipe.image_encoder, pipe.vae_encoder, pipe.vae_decoder = (
            S.init_svd_module_(m.to_empty(device=dev), gen).eval()
            for m in (unet, image, enc, dec))
        return pipe

    @classmethod
    def from_pretrained(cls, unet_path=None, vae_encoder_path=None, vae_decoder_path=None,
                        image_encoder_path=None, device=None,
                        dtype=torch.float32) -> "SVDVideoPipeline":
        """The UNet (SVD, or ExVideo's by its positional convolutions), the
        VAE's encoder and decoder and the image encoder, the reference's
        module names."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if unet_path:
            sd = C.load_state_dict(unet_path, lazy=True)
            ex = any(".positional_conv." in k for k in sd)
            pipe.unet = C.build_module(lambda cfg, dtype: S.SVDUNet(cfg, dtype=dtype, exvideo=ex),
                                       S.SVD_UNET, S.convert_svd_module(sd), dev, dtype)
        if vae_encoder_path:
            pipe.vae_encoder = C.build_module(SD.SDVAEEncoder, None, SD.convert_sd_module(
                C.load_state_dict(vae_encoder_path, lazy=True)), dev, torch.float32)
        if vae_decoder_path:
            pipe.vae_decoder = C.build_module(S.SVDVAEDecoder, None, S.convert_svd_module(
                C.load_state_dict(vae_decoder_path, lazy=True)), dev, torch.float32)
        if image_encoder_path:
            pipe.image_encoder = C.build_module(
                S.SVDImageEncoder, S.SVD_IMAGE_ENCODER,
                SD.convert_sd_module(C.load_state_dict(image_encoder_path, lazy=True)), dev,
                dtype)
        return pipe

    # ---------------- encoders ----------------

    def _image(self, image, height: int, width: int) -> np.ndarray:
        return _preprocess_images(_image_array(image, width, height)[None])[:, :, 0]

    @torch.no_grad()
    def encode_image_with_clip(self, image, height: int, width: int):
        with self._stage("clip_encode"):
            pre = preprocess_clip_image(self._image(image, height, width), 224)
            return S.svd_image_encoder_forward(self.image_encoder, pre.to(self.device,
                                                                           self.dtype))

    @torch.no_grad()
    def encode_image_with_vae(self, image, noise_aug_strength: float, height: int, width: int,
                              seed=None):
        with self._stage("vae_encode_image"):
            img = self._image(image, height, width)
            noise = generate_noise(img.shape, seed=seed).numpy()
            img = torch.from_numpy(img + noise_aug_strength * noise).to(self.device)
            return S.sd_vae_encode_raw(self.vae_encoder, img).to(self.dtype)

    @torch.no_grad()
    def encode_video_with_vae(self, frames, height: int, width: int):
        with self._stage("vae_encode"):
            imgs = _preprocess_images(np.stack([_image_array(f, width, height) for f in frames]))
            imgs = torch.from_numpy(imgs[0].transpose(1, 0, 2, 3).copy()).to(self.device)
            return S.svd_vae_encode(self.vae_encoder, imgs).to(self.dtype)

    @torch.no_grad()
    def decode_video(self, latents):
        """latents (T, 4, h, w) -> PIL frames."""
        from PIL import Image
        with self._stage("vae_decode"):
            video = S.svd_vae_decode(self.vae_decoder, latents.float().transpose(0, 1))
        if not bool(torch.isfinite(video).all()):
            raise FloatingPointError("decoded video holds non-finite values")
        arr = video.float().cpu().numpy().transpose(1, 2, 3, 0)
        arr = np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
        return [Image.fromarray(f) for f in arr]

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        input_image=None,
        input_video=None,
        mask_frames: List = (),
        mask_frame_ids: List[int] = (),
        min_cfg_scale: float = 1.0,
        max_cfg_scale: float = 3.0,
        denoising_strength: float = 1.0,
        num_frames: int = 25,
        height: int = 576,
        width: int = 1024,
        fps: int = 7,
        motion_bucket_id: int = 127,
        noise_aug_strength: float = 0.02,
        num_inference_steps: int = 20,
        post_normalize: bool = True,
        contrast_enhance_scale: float = 1.2,
        seed: Optional[int] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        missing = [n for n, v in (("unet", self.unet), ("vae_encoder", self.vae_encoder),
                                  ("image_encoder", self.image_encoder)) if v is None]
        if not return_latents and self.vae_decoder is None:
            missing.append("vae_decoder")
        if missing:
            raise RuntimeError(f"the SVD pipeline has no {', '.join(missing)}")
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height = (height + 63) // 64 * 64
        width = (width + 63) // 64 * 64
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        noise = generate_noise((num_frames, 4, height // 8, width // 8), seed=seed).to(dev, dtype)
        if denoising_strength == 1.0:
            latents = noise
        else:
            z = self.encode_video_with_vae(input_video, height, width)
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        mask_latents = (self.encode_video_with_vae(mask_frames, height, width)
                        if len(mask_frames) > 0 else None)

        clip_posi = self.encode_image_with_clip(input_image, height, width)
        clip_posi = clip_posi[:, None] if clip_posi.dim() == 2 else clip_posi
        clip_nega = torch.zeros_like(clip_posi)
        vae_cond = self.encode_image_with_vae(input_image, noise_aug_strength, height, width,
                                              seed=seed)
        vae_posi = vae_cond.repeat(num_frames, 1, 1, 1)
        vae_nega = torch.zeros_like(vae_posi)
        cfg_scales = torch.linspace(min_cfg_scale, max_cfg_scale, num_frames,
                                    device=dev).reshape(num_frames, 1, 1, 1)
        add_time_id = np.asarray([fps - 1, motion_bucket_id, noise_aug_strength], np.float32)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = float(self.scheduler.timesteps[i])
            with self._stage(f"denoise_step_{i}"):
                if mask_latents is not None:
                    latents = latents.clone()
                    for fid, mid in enumerate(mask_frame_ids):
                        latents[mid] = self.scheduler.add_noise(
                            mask_latents[fid].float(), noise[mid].float(), t).to(dtype)
                v_posi = S.svd_unet_forward(self.unet, torch.cat([latents, vae_posi], dim=1), t,
                                            clip_posi, add_time_id)
                v_nega = S.svd_unet_forward(self.unet, torch.cat([latents, vae_nega], dim=1), t,
                                            clip_nega, add_time_id)
                v = v_nega.float() + cfg_scales * (v_posi.float() - v_nega.float())
                latents = self.scheduler.step(v, t, latents.float()).to(dtype)

        lat = latents.float()
        if post_normalize:
            mean, std = lat.mean(), lat.std(correction=0)
            lat = ((lat - lat.mean(dim=(1, 2, 3), keepdim=True))
                   / lat.std(dim=(1, 2, 3), keepdim=True, correction=0) * std + mean)
        latents = (lat * contrast_enhance_scale).to(dtype)
        if return_latents:
            return latents
        return self.decode_video(latents)
