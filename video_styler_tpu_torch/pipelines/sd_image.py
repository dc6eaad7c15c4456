"""SD 1.5 text-to-image (and img2img, local prompts, ControlNet,
IP-Adapter, textual inversion) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/sd_image.py` (:56-309): CLIP-L
with `clip_skip` over 77-token chunks (a whitespace stand-in for the ids
without a tokenizer, as in JAX), noise of (1, 4, H/8, W/8) from
`generate_noise`, the DDIM loop (scaled_linear, 20 steps) with two-pass CFG
(default 7.5; no negative pass at CFG 1), the DDIM update in fp32, and the
SD VAE. img2img noises the encoded `input_image` to the first timestep;
local prompts blend their predictions into the positive one through
blurred binary masks (`merge_local_predictions`); ControlNet units add
their residuals (computed once a step on the positive prompt, as in JAX);
the IP-Adapter adds its decoupled attention from the CLIP-H embedding of
`ipadapter_images` (or `ipadapter_image_embeds`), the negative pass from a
zero embedding. The UNet and the text tower run in `dtype` (bf16 by
default on the card; JAX's default is fp32), the VAE in fp32.

Runs on `cuda` unless constructed with `device="cpu"`; stage times and, on
the card, peaks as `FluxImagePipeline` keeps them.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import sd as SD
from ..models.sd3_text_encoder import ClipTextEncoder, detect_clip_text_config
from ..schedulers.ddim import EnhancedDDIMScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .wan_video import _image_array, _preprocess_images, generate_noise


def _gaussian_blur_mask(mask: np.ndarray, ksize: int = 33, sigma: float = 10.0) -> np.ndarray:
    """Separable gaussian with reflect padding (torchvision's GaussianBlur)."""
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    p = np.pad(mask, ((r, r), (0, 0)), mode="reflect")
    m = np.stack([np.convolve(p[:, j], k, mode="valid") for j in range(p.shape[1])], axis=1)
    p = np.pad(m, ((0, 0), (r, r)), mode="reflect")
    return np.stack([np.convolve(p[i], k, mode="valid") for i in range(p.shape[0])], axis=0)


def local_mask(mask, width: int, height: int) -> np.ndarray:
    """A mask image (PIL or uint8 array) -> its blurred binary weight at
    (height, width), float32: PIL's resize and luma, thresholded at half."""
    from PIL import Image
    image = Image.fromarray(mask) if isinstance(mask, np.ndarray) else mask
    m = np.asarray(image.resize((width, height)).convert("L"), np.float32)
    return _gaussian_blur_mask((m / 255.0 > 0.5).astype(np.float32))


def merge_local_predictions(value, locals_, masks, scales, height: int, width: int):
    """The global prediction and the local ones weighted by their blurred
    masks times their scales, over 1 plus the summed weights (fp32)."""
    value = value.float()
    weight = torch.ones_like(value)
    for latent, mask, scale in zip(locals_, masks, scales):
        m = torch.from_numpy(local_mask(mask, width, height)).to(value.device)
        m = m[None, None].expand(value.shape)
        value = value + latent.float() * m * scale
        weight = weight + m * scale
    return value / weight


def ddim_update(scheduler, eps, t, latents, dtype, to_final: bool = False):
    """The scheduler's step in fp32, cast back to `dtype`."""
    return scheduler.step(eps.float(), t, latents.float(), to_final=to_final).to(dtype)


class SDImagePipeline:

    _stage = FluxImagePipeline._stage
    vae_output_to_image = staticmethod(FluxImagePipeline.vae_output_to_image)

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = EnhancedDDIMScheduler()
        self.text_encoder: Optional[ClipTextEncoder] = None
        self.unet: Optional[SD.SDUNet] = None
        self.vae_encoder: Optional[SD.SDVAEEncoder] = None
        self.vae_decoder: Optional[SD.SDVAEDecoder] = None
        self.image_encoder = None
        self.tokenizer = None
        self._ti_keywords: Dict[str, str] = {}
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, unet_cfg: SD.SDUNetConfig, text_cfg, tokenizer=None, seed: int = 0,
                     device=None, dtype=torch.bfloat16) -> "SDImagePipeline":
        """Random weights drawn on the device from one seeded generator: the
        UNet and CLIP-L in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        gen = torch.Generator(pipe.device).manual_seed(seed)
        with torch.device("meta"):
            mods = (SD.SDUNet(unet_cfg, dtype=dtype), ClipTextEncoder(text_cfg, dtype=dtype),
                    SD.SDVAEEncoder(dtype=torch.float32), SD.SDVAEDecoder(dtype=torch.float32))
        pipe.unet, pipe.text_encoder, pipe.vae_encoder, pipe.vae_decoder = (
            SD.init_sd_module_(m.to_empty(device=pipe.device), gen).eval() for m in mods)
        pipe.tokenizer = tokenizer
        return pipe

    @classmethod
    def from_state_dicts(cls, unet_sd=None, text_encoder_sd=None, vae_encoder_sd=None,
                         vae_decoder_sd=None, tokenizer_path: Optional[str] = None,
                         device=None, dtype=torch.bfloat16) -> "SDImagePipeline":
        """Modules from state dicts under the reference's (DiffSynth) names,
        their widths read from the tensors."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if unet_sd is not None:
            sd = SD.convert_sd_module(unet_sd)
            pipe.unet = C.build_module(SD.SDUNet, SD.detect_unet_config(sd, SD.SD_UNET_PROGRAM),
                                       sd, dev, dtype)
        if text_encoder_sd is not None:
            sd = SD.convert_sd_module(text_encoder_sd)
            pipe.text_encoder = C.build_module(ClipTextEncoder, detect_clip_text_config(sd, 12),
                                               sd, dev, dtype)
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
                          dtype=torch.bfloat16) -> "SDImagePipeline":
        """A civitai single-file SD 1.5 checkpoint (`utils.sd_civitai`)."""
        from ..utils.sd_civitai import convert_sd_civitai
        parts = convert_sd_civitai(C.load_state_dict(path, lazy=True))
        return cls.from_state_dicts(
            unet_sd=parts["unet"], text_encoder_sd=parts["text_encoder"],
            vae_encoder_sd=parts["vae_encoder"], vae_decoder_sd=parts["vae_decoder"],
            tokenizer_path=tokenizer_path, device=device, dtype=dtype)

    @torch.no_grad()
    def load_textual_inversions(self, paths=None, state_dicts=None):
        """Each file's (or state dict's) first 2-D tensor as wide as the
        token embedding becomes new token rows; its name (a file's base
        name) a prompt keyword that expands to those tokens."""
        width = self.text_encoder.token_embedding.weight.shape[1]

        def search(node, out):
            if isinstance(node, dict):
                for v in node.values():
                    search(v, out)
            else:
                arr = np.asarray(node.detach().float().cpu() if hasattr(node, "detach") else node)
                if arr.ndim == 2 and arr.shape[1] == width:
                    out.append(arr.astype(np.float32))

        items = [(os.path.splitext(os.path.basename(p))[0], C.load_state_dict(p))
                 for p in paths or ()]
        items += list((state_dicts or {}).items())
        new_rows = []
        for keyword, sd in items:
            found = []
            search(sd, found)
            for arr in found[:1]:
                tokens = [f"{keyword}_{i}" for i in range(arr.shape[0])]
                if self.tokenizer is not None:
                    self.tokenizer.add_tokens(tokens)
                self._ti_keywords[keyword] = " " + " ".join(tokens) + " "
                new_rows.append(arr)
        if new_rows:
            emb = self.text_encoder.token_embedding
            rows = [torch.from_numpy(r).to(emb.weight.device, emb.weight.dtype) for r in new_rows]
            emb.weight = torch.nn.Parameter(torch.cat([emb.weight] + rows, dim=0),
                                            requires_grad=False)

    # ---------------- helpers ----------------

    def _apply_ti_keywords(self, prompt: str) -> str:
        for kw, rep in self._ti_keywords.items():
            if kw in prompt:
                prompt = prompt.replace(kw, rep)
        return prompt

    def prompt_ids(self, prompt: str) -> np.ndarray:
        """(n, 77) ids: the prompt padded to a multiple of 77 and cut into
        chunks; without a tokenizer, 1..n for the n words and the two ends."""
        prompt = self._apply_ti_keywords(prompt)
        if self.tokenizer is None:
            n = min(len(prompt.split()) + 2, 77)
            ids = np.zeros((1, 77), np.int64)
            ids[0, :n] = (np.arange(n) + 1) % 49408
            return ids
        try:
            raw = self.tokenizer(prompt, return_tensors="np", truncation=False)["input_ids"]
            n = max(1, -(-raw.shape[1] // 77))
        except Exception:       # length-capped and stand-in tokenizers
            n = 1
        enc = self.tokenizer([prompt], padding="max_length", truncation=True,
                             max_length=n * 77, return_tensors="np")
        return np.asarray(enc["input_ids"], np.int64).reshape(n, 77)

    @torch.no_grad()
    def encode_prompt(self, prompt: str, clip_skip: int = 1):
        """-> (1, 77 n, 768) in `dtype`."""
        with self._stage("text_encode"):
            ids = torch.from_numpy(self.prompt_ids(prompt)).to(self.device)
            out = SD.sd_text_encoder_forward(self.text_encoder, ids, clip_skip=clip_skip)
            return out.reshape(1, -1, out.shape[-1]).to(self.dtype)

    @torch.no_grad()
    def encode_image(self, image_np: np.ndarray):
        """(B, 3, H, W) in [-1, 1] -> scaled latents in fp32."""
        return SD.sd_vae_encoder_forward(
            self.vae_encoder, torch.from_numpy(np.ascontiguousarray(image_np)).to(
                self.device, torch.float32))

    @torch.no_grad()
    def decode_image(self, latents):
        return SD.sd_vae_decoder_forward(self.vae_decoder, latents.float())

    @torch.no_grad()
    def encode_ip_images(self, images) -> torch.Tensor:
        """The CLIP-H embedding of the first image (as JAX takes it)."""
        from ..models.clip_vit import preprocess_clip_image
        from ..models.svd import svd_image_encoder_forward
        imgs = images if isinstance(images, list) else [images]
        size = self.image_encoder.cfg.image_size
        arr = _preprocess_images(np.stack([_image_array(im, size, size) for im in imgs]))
        pre = preprocess_clip_image(arr[:, :, 0], size).to(self.device, self.dtype)
        return svd_image_encoder_forward(self.image_encoder, pre)

    def initial_latents(self, shape, seed, input_image, width: int, height: int):
        noise = generate_noise(shape, seed=seed).to(self.device, self.dtype)
        if input_image is None:
            return noise
        with self._stage("vae_encode"):
            z = self.encode_image(_preprocess_images(
                _image_array(input_image, width, height)[None])[:, :, 0])
        return self.scheduler.add_noise(z, noise.float(), self.scheduler.timesteps[0]).to(
            self.dtype)

    @staticmethod
    def extend_prompt(prompt, local_prompts, masks, mask_scales, prompt_extender):
        """An injected extender may add regional prompts and masks, each at
        scale 100."""
        local_prompts, masks, mask_scales = list(local_prompts or []), list(masks or []), \
            list(mask_scales or [])
        if prompt_extender is not None:
            extended = prompt_extender({"prompt": prompt})
            prompt = extended.get("prompt", prompt)
            local_prompts += extended.get("prompts", [])
            masks += extended.get("masks", [])
            mask_scales += [100.0] * len(extended.get("masks", []))
        return prompt, local_prompts, masks, mask_scales

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
        ipadapter_images=None,
        ipadapter_params=None,
        ipadapter_scale: float = 1.0,
        ipadapter_image_embeds=None,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 20,
        seed: Optional[int] = None,
        return_latents: bool = False,
        progress_bar_cmd: Optional[Callable] = None,
    ):
        """ipadapter_params: a `models.ipadapter.IpAdapter`; controlnet_units:
        `controlnets.ControlNetUnit`s."""
        self.stage_times, self.stage_peak_bytes = [], []
        dev, dtype = self.device, self.dtype
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        latents = self.initial_latents((1, 4, height // 8, width // 8), seed, input_image,
                                       width, height)
        prompt, local_prompts, masks, mask_scales = self.extend_prompt(
            prompt, local_prompts, masks, mask_scales, prompt_extender)
        ctx_posi = self.encode_prompt(prompt, clip_skip)
        ctx_nega = self.encode_prompt(negative_prompt, clip_skip) if cfg_scale != 1.0 else None
        ctx_locals = [self.encode_prompt(p, clip_skip) for p in local_prompts]

        cn_manager = conditionings = None
        if controlnet_units and controlnet_image is not None:
            from ..controlnets import MultiControlNetManager
            cn_manager = MultiControlNetManager(controlnet_units)
            conditionings = cn_manager.process_image(controlnet_image, width, height)

        ip_posi = ip_nega = None
        if ipadapter_params is not None and (ipadapter_images is not None
                                             or ipadapter_image_embeds is not None):
            from ..models.ipadapter import ipadapter_kwargs
            with self._stage("ipadapter"):
                if ipadapter_image_embeds is None:
                    ipadapter_image_embeds = self.encode_ip_images(ipadapter_images)
                embeds = torch.as_tensor(ipadapter_image_embeds, device=dev).to(dtype)
                ip_posi = ipadapter_kwargs(ipadapter_params, embeds, scale=ipadapter_scale)
                ip_nega = ipadapter_kwargs(ipadapter_params, torch.zeros_like(embeds),
                                           scale=ipadapter_scale)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tj = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                cn_stack = None
                if conditionings is not None:
                    cn_stack = cn_manager(latents, tj, ctx_posi, conditionings)

                def unet(ctx, ip):
                    return SD.sd_unet_forward(self.unet, latents, tj, ctx,
                                              controlnet_res_stack=cn_stack,
                                              ipadapter_kwargs_list=ip)

                eps_posi = unet(ctx_posi, ip_posi)
                if ctx_locals:
                    eps_posi = merge_local_predictions(
                        eps_posi, [unet(c, ip_posi) for c in ctx_locals], masks, mask_scales,
                        height // 8, width // 8).to(dtype)
                if cfg_scale != 1.0:
                    eps_nega = unet(ctx_nega, ip_nega)
                    eps = eps_nega + cfg_scale * (eps_posi - eps_nega)
                else:
                    eps = eps_posi
                latents = ddim_update(self.scheduler, eps, t, latents, dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = self.decode_image(latents)
        return self.vae_output_to_image(image)
