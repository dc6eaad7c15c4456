"""SDXL (and Kolors) text-to-image in PyTorch.

Counterpart of `video_styler_tpu/pipelines/sdxl_image.py` (:23-226): CLIP-L
(11 layers, no final norm) and CLIP-G hidden states side by side as the
context (2048 wide), CLIP-G's pooled embedding and the six sizes
(`add_time_id`) as the micro-conditioning, the DDIM loop with two-pass CFG,
local prompts, the union ControlNet (residuals from the positive prompt)
and the IP-Adapter from image embeds (SDXL's 70 sites), and the SD VAE
(the SDXL VAE differs in its weights only). Kolors (`fetch_kolors_text_encoder`):
ChatGLM3-6B replaces both CLIP towers, its state `clip_skip_2` layers
before the end the context (4096 wide, projected by the UNet) and its last
token the pooled embedding; without a ChatGLM tokenizer the ids are the
CLIP stand-in's. The UNet and the text towers run in `dtype`, the VAE in
fp32.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import sd as SD
from ..models import sdxl as XL
from ..models.sd3_text_encoder import detect_clip_text_config
from ..schedulers.ddim import EnhancedDDIMScheduler
from ..utils import ckpt as C
from .sd_image import SDImagePipeline, ddim_update, merge_local_predictions


class SDXLImagePipeline:

    _stage = SDImagePipeline._stage
    vae_output_to_image = staticmethod(SDImagePipeline.vae_output_to_image)
    encode_image = SDImagePipeline.encode_image
    decode_image = SDImagePipeline.decode_image
    initial_latents = SDImagePipeline.initial_latents
    extend_prompt = staticmethod(SDImagePipeline.extend_prompt)

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = EnhancedDDIMScheduler()
        self.unet: Optional[XL.SDXLUNet] = None
        self.te1: Optional[XL.SDXLTextEncoder] = None
        self.te2: Optional[XL.SDXLTextEncoder2] = None
        self.vae_encoder: Optional[SD.SDVAEEncoder] = None
        self.vae_decoder: Optional[SD.SDVAEDecoder] = None
        self.tokenizer = None
        self.kolors = None
        self.kolors_tokenizer = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    def fetch_kolors_text_encoder(self, model, tokenizer=None):
        """Kolors: a `models.kolors_text_encoder.ChatGLM` replaces both CLIP
        towers."""
        self.kolors = model
        self.kolors_tokenizer = tokenizer

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, unet_cfg: SD.SDUNetConfig, te1_cfg, te2_cfg, tokenizer=None,
                     seed: int = 0, device=None, dtype=torch.bfloat16):
        """Random weights drawn on the device from one seeded generator: the
        UNet and both CLIP towers in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        gen = torch.Generator(pipe.device).manual_seed(seed)
        with torch.device("meta"):
            mods = (XL.SDXLUNet(unet_cfg, dtype=dtype), XL.SDXLTextEncoder(te1_cfg, dtype=dtype),
                    XL.SDXLTextEncoder2(te2_cfg, dtype=dtype),
                    SD.SDVAEEncoder(dtype=torch.float32), SD.SDVAEDecoder(dtype=torch.float32))
        pipe.unet, pipe.te1, pipe.te2, pipe.vae_encoder, pipe.vae_decoder = (
            SD.init_sd_module_(m.to_empty(device=pipe.device), gen).eval() for m in mods)
        pipe.tokenizer = tokenizer
        return pipe

    @classmethod
    def from_state_dicts(cls, unet_sd=None, te1_sd=None, te2_sd=None, vae_encoder_sd=None,
                         vae_decoder_sd=None, tokenizer_path: Optional[str] = None,
                         device=None, dtype=torch.bfloat16):
        """Modules from state dicts under the reference's names, their widths
        read from the tensors (CLIP-L 12 heads, CLIP-G 20)."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if unet_sd is not None:
            sd = XL.convert_sdxl_module(unet_sd)
            pipe.unet = C.build_module(XL.SDXLUNet,
                                       SD.detect_unet_config(sd, XL.SDXL_UNET_PROGRAM), sd, dev,
                                       dtype)
        for name, cls_, heads, sd in (("te1", XL.SDXLTextEncoder, 12, te1_sd),
                                      ("te2", XL.SDXLTextEncoder2, 20, te2_sd)):
            if sd is not None:
                sd = XL.convert_sdxl_module(sd)
                setattr(pipe, name, C.build_module(cls_, detect_clip_text_config(sd, heads), sd,
                                                   dev, dtype))
        if vae_encoder_sd is not None:
            pipe.vae_encoder = C.build_module(SD.SDVAEEncoder, None,
                                              SD.convert_sd_module(vae_encoder_sd), dev,
                                              torch.float32)
        if vae_decoder_sd is not None:
            pipe.vae_decoder = C.build_module(SD.SDVAEDecoder, None,
                                              SD.convert_sd_module(vae_decoder_sd), dev,
                                              torch.float32)
        if tokenizer_path:
            from transformers import CLIPTokenizer
            pipe.tokenizer = CLIPTokenizer.from_pretrained(tokenizer_path)
        return pipe

    @classmethod
    def from_civitai_file(cls, path: str, tokenizer_path: Optional[str] = None, device=None,
                          dtype=torch.bfloat16):
        """A civitai single-file SDXL checkpoint: UNet, both text towers and
        the VAE (`utils.sd_civitai.convert_sdxl_civitai`)."""
        from ..utils.sd_civitai import convert_sdxl_civitai
        parts = convert_sdxl_civitai(C.load_state_dict(path, lazy=True))
        return cls.from_state_dicts(
            unet_sd=parts["unet"], te1_sd=parts["text_encoder"], te2_sd=parts["text_encoder_2"],
            vae_encoder_sd=parts["vae_encoder"], vae_decoder_sd=parts["vae_decoder"],
            tokenizer_path=tokenizer_path, device=device, dtype=dtype)

    # ---------------- helpers ----------------

    def _ids(self, prompt: str) -> np.ndarray:
        if self.tokenizer is not None:
            enc = self.tokenizer([prompt], padding="max_length", truncation=True, max_length=77,
                                 return_tensors="np")
            return np.asarray(enc["input_ids"], np.int64)
        n = min(len(prompt.split()) + 2, 77)
        ids = np.zeros((1, 77), np.int64)
        ids[0, :n] = (np.arange(n) + 1) % 100
        return ids

    @torch.no_grad()
    def encode_prompt(self, prompt: str, clip_skip: int = 1, clip_skip_2: int = 2):
        """-> (context (1, 77, 2048), pooled (1, 1280)); Kolors: (context (1,
        256, 4096), pooled (1, 4096)), in `dtype`."""
        with self._stage("text_encode"):
            if self.kolors is not None:
                from ..models.kolors_text_encoder import KOLORS_TOKENS, kolors_encode
                if self.kolors_tokenizer is not None:
                    enc = self.kolors_tokenizer([prompt], padding="max_length", truncation=True,
                                                max_length=KOLORS_TOKENS, return_tensors="np")
                    ids, mask = np.asarray(enc["input_ids"], np.int64), enc["attention_mask"]
                else:
                    ids, mask = self._ids(prompt), None
                emb, pooled = kolors_encode(self.kolors, torch.from_numpy(ids).to(self.device),
                                            mask, clip_skip=clip_skip_2)
                return emb.to(self.dtype), pooled.to(self.dtype)
            ids = torch.from_numpy(self._ids(prompt)).to(self.device)
            h1 = XL.sdxl_text_encoder_forward(self.te1, ids, clip_skip=clip_skip)
            pooled, h2 = XL.sdxl_text_encoder_2_forward(self.te2, ids, clip_skip=clip_skip_2)
            return torch.cat([h1, h2], dim=-1).to(self.dtype), pooled.to(self.dtype)

    def add_time_id(self, height: int, width: int) -> torch.Tensor:
        return torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                            device=self.device)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        clip_skip: int = 1,
        local_prompts=None,
        masks=None,
        mask_scales=None,
        prompt_extender=None,
        input_image=None,
        denoising_strength: float = 1.0,
        controlnet_image=None,
        controlnet_units=None,
        ipadapter_image_embeds=None,
        ipadapter_params=None,
        ipadapter_scale: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 20,
        seed: Optional[int] = None,
        return_latents: bool = False,
        progress_bar_cmd: Optional[Callable] = None,
    ):
        """ipadapter_params: a `models.ipadapter.IpAdapter` of SDXL's map;
        controlnet_units: `controlnets.ControlNetUnit`s with `xl=True`."""
        self.stage_times, self.stage_peak_bytes = [], []
        dev, dtype = self.device, self.dtype
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        latents = self.initial_latents((1, 4, height // 8, width // 8), seed, input_image,
                                       width, height)
        prompt, local_prompts, masks, mask_scales = self.extend_prompt(
            prompt, local_prompts, masks, mask_scales, prompt_extender)
        ctx_posi, pooled_posi = self.encode_prompt(prompt, clip_skip)
        if cfg_scale != 1.0:
            ctx_nega, pooled_nega = self.encode_prompt(negative_prompt, clip_skip)
        ctx_locals = [self.encode_prompt(p, clip_skip) for p in local_prompts]
        add_time_id = self.add_time_id(height, width)

        cn_manager = conditionings = None
        if controlnet_units and controlnet_image is not None:
            from ..controlnets import MultiControlNetManager
            cn_manager = MultiControlNetManager(controlnet_units)
            conditionings = cn_manager.process_image(controlnet_image, width, height)
        ip_posi = ip_nega = None
        if ipadapter_params is not None and ipadapter_image_embeds is not None:
            from ..models.ipadapter import ipadapter_kwargs
            embeds = torch.as_tensor(ipadapter_image_embeds, device=dev).to(dtype)
            ip_posi = ipadapter_kwargs(ipadapter_params, embeds, scale=ipadapter_scale, xl=True)
            ip_nega = ipadapter_kwargs(ipadapter_params, torch.zeros_like(embeds),
                                       scale=ipadapter_scale, xl=True)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tj = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                cn_stack = None
                if conditionings is not None:
                    cn_stack = cn_manager(latents, tj, ctx_posi, conditionings,
                                          add_time_id=add_time_id, add_text_embeds=pooled_posi)

                def unet(ctx, pooled, ip):
                    return XL.sdxl_unet_forward(self.unet, latents, tj, ctx, add_time_id, pooled,
                                                controlnet_res_stack=cn_stack,
                                                ipadapter_kwargs_list=ip)

                eps_posi = unet(ctx_posi, pooled_posi, ip_posi)
                if ctx_locals:
                    eps_posi = merge_local_predictions(
                        eps_posi, [unet(c, pl, ip_posi) for c, pl in ctx_locals], masks,
                        mask_scales, height // 8, width // 8).to(dtype)
                if cfg_scale != 1.0:
                    eps_nega = unet(ctx_nega, pooled_nega, ip_nega)
                    eps = eps_nega + cfg_scale * (eps_posi - eps_nega)
                else:
                    eps = eps_posi
                latents = ddim_update(self.scheduler, eps, t, latents, dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = self.decode_image(latents)
        return self.vae_output_to_image(image)
