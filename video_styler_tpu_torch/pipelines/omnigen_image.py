"""OmniGen instruction-to-image in PyTorch.

Counterpart of `video_styler_tpu/pipelines/omnigen_image.py`
(`OmnigenImagePipeline.__call__` :86-163): flow matching with the
timesteps inverted over one train timestep (sigma from 0 to 1), the
prompter's branches run one forward each (cond and uncond; with reference
images the image-only branch too, and then
pred = uncond + image_cfg * (img_cond - uncond) + cfg * (cond - img_cond)),
the Euler update in fp32, and the SDXL VAE (fp32, the SD scaling, as the
JAX pipeline encodes and decodes) for the reference images, image-to-image
and the decode. The LongRoPE tables of each branch (`su_factor`, Phi-3's
short factors) are made once on the host.

The VAE file holds the encoder's and decoder's state dicts under
`encoder.` and `decoder.` (`hunyuan_image.split_vae_file`).

Runs on `cuda` unless constructed with `device="cpu"`; each stage's wall
time is kept in `stage_times` and, on the card, the running peak in
`stage_peak_bytes`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import omnigen as O
from ..models import sd as SD
from ..prompters.omnigen_prompter import OmniGenPrompter, crop_arr_size
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .hunyuan_image import split_vae_file
from .wan_video import _image_array, _preprocess_images, generate_noise


class OmnigenImagePipeline:

    _stage = FluxImagePipeline._stage
    vae_output_to_image = staticmethod(FluxImagePipeline.vae_output_to_image)

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(num_train_timesteps=1, shift=1,
                                            inverse_timesteps=True, sigma_min=0, sigma_max=1)
        self.transformer: Optional[O.OmniGen] = None
        self.cfg: O.OmniGenConfig = O.OMNIGEN
        self.su_factor = O.PHI3_SU_SHORT
        self.vae_encoder: Optional[SD.SDVAEEncoder] = None
        self.vae_decoder: Optional[SD.SDVAEDecoder] = None
        self.prompter = OmniGenPrompter()
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, cfg: O.OmniGenConfig, tokenizer, seed: int = 0, device=None,
                     dtype=torch.bfloat16, su_factor=O.PHI3_SU_SHORT) -> "OmnigenImagePipeline":
        """Random weights drawn on the device from one seeded generator: the
        transformer in `dtype`, the SDXL VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        pipe.cfg, pipe.su_factor = cfg, su_factor
        pipe.prompter.tokenizer = tokenizer
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            net = O.OmniGen(cfg, dtype=dtype)
            enc = SD.SDVAEEncoder(dtype=torch.float32)
            dec = SD.SDVAEDecoder(dtype=torch.float32)
        pipe.transformer = O.init_omnigen_(net.to_empty(device=dev), gen).eval()
        pipe.vae_encoder = SD.init_sd_module_(enc.to_empty(device=dev), gen).eval()
        pipe.vae_decoder = SD.init_sd_module_(dec.to_empty(device=dev), gen).eval()
        return pipe

    @classmethod
    def from_pretrained(cls, transformer_path=None, vae_path=None, tokenizer_path=None,
                        device=None, dtype=torch.bfloat16) -> "OmnigenImagePipeline":
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if transformer_path:
            sd = C.load_state_dict(transformer_path, lazy=True)
            pipe.transformer = C.build_module(O.OmniGen, pipe.cfg, O.convert_omnigen(sd, pipe.cfg),
                                              dev, dtype)
        if vae_path:
            enc, dec = split_vae_file(C.load_state_dict(vae_path, lazy=True))
            pipe.vae_encoder = C.build_module(SD.SDVAEEncoder, None, SD.convert_sd_module(enc),
                                              dev, torch.float32)
            pipe.vae_decoder = C.build_module(SD.SDVAEDecoder, None, SD.convert_sd_module(dec),
                                              dev, torch.float32)
        if tokenizer_path:
            pipe.prompter.fetch_tokenizer(tokenizer_path)
        return pipe

    @torch.no_grad()
    def encode_image(self, image_np: np.ndarray):
        return SD.sd_vae_encoder_forward(self.vae_encoder, torch.from_numpy(image_np).to(
            self.device)).to(self.dtype)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        reference_images: Optional[List] = None,
        cfg_scale: float = 2.0,
        image_cfg_scale: float = 2.0,
        input_image=None,
        denoising_strength: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 20,
        seed: Optional[int] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        if self.prompter.tokenizer is None:
            raise RuntimeError("the OmniGen pipeline has no tokenizer (tokenizer_path)")
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height = (height + 15) // 16 * 16
        width = (width + 15) // 16 * 16
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        noise = generate_noise((1, 4, height // 8, width // 8), seed=seed).to(dev, dtype)
        if input_image is not None:
            with self._stage("vae_encode"):
                z = self.encode_image(_preprocess_images(
                    _image_array(input_image, width, height)[None])[:, :, 0])
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise

        ref_latents, ref_sizes_hw = [], []
        for im in reference_images or []:
            w, h = crop_arr_size(im.width, im.height, 1024)
            with self._stage("vae_encode_reference"):
                ref_latents.append(self.encode_image(_preprocess_images(
                    _image_array(im, w, h)[None])[:, :, 0]))
            ref_sizes_hw.append((h, w))

        branches = self.prompter(prompt, ref_sizes_hw, height, width,
                                 use_img_cfg=bool(reference_images))
        use_img_cfg = len(branches) == 3
        for br in branches:
            cos, sin = O.longrope_tables(self.cfg, br["position_ids"], self.su_factor)
            br["cos"], br["sin"] = torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)
            br["ids"] = torch.from_numpy(br["input_ids"]).to(dev)
            br["mask"] = torch.from_numpy(br["attention_mask"]).to(dev)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t_host = float(self.scheduler.timesteps[i])
            t = torch.tensor([t_host], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                preds = []
                for bi, br in enumerate(branches):
                    refs = ref_latents if (bi != 1 and ref_latents) else []
                    preds.append(O.omnigen_forward(self.transformer, latents, t, br["ids"], refs,
                                                   br["image_sizes"], br["mask"],
                                                   cos=br["cos"], sin=br["sin"]))
                if use_img_cfg:
                    cond, uncond, img_cond = preds
                    pred = (uncond + image_cfg_scale * (img_cond - uncond)
                            + cfg_scale * (cond - img_cond))
                else:
                    cond, uncond = preds
                    pred = uncond + cfg_scale * (cond - uncond)
                latents = self.scheduler.step(pred.float(), t_host, latents.float()).to(dtype)
        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = SD.sd_vae_decoder_forward(self.vae_decoder, latents.float())
        return self.vae_output_to_image(image)
