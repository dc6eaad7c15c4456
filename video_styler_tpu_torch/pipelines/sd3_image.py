"""SD3 / SD3.5 text-to-image (and img2img, local prompts) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/sd3_image.py` (:25-155): the
prompt through CLIP-L, CLIP-G and an optional T5 (`SD3Prompter`), noise of
(1, 16, H/8, W/8) from `generate_noise`, the flow-match Euler loop (shift
3) with two-pass CFG at every step (default 7.5, 20 steps; the negative
pass runs even at CFG 1, as in JAX), the Euler update in fp32, and the
SD3 VAE (`SD3_VAE`: scale 1.5305, shift 0.0609). img2img noises the
encoded `input_image` to the first timestep; local prompts blend their
velocity into the positive one by their masks (at the latent resolution)
times `mask_scales`, divided by 1 plus the summed weights.

`from_pretrained` loads the DiT (a civitai layout renamed, the config
inferred from the tensors) and the VAE, and, as the JAX pipeline does, no
text encoder: the caller sets `prompter`'s towers and tokenizers.

Runs on `cuda` unless constructed with `device="cpu"`; stage times and,
on the card, peaks as `FluxImagePipeline` keeps them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import sd3_dit as D
from ..models import sd3_vae as V
from ..models.sd3_text_encoder import ClipTextConfig, ClipTextEncoder, init_clip_text_
from ..models.sdxl import SDXLTextEncoder2
from ..models.t5 import T5Config, T5Encoder, init_t5_
from ..prompters.sd3_prompter import SD3Prompter
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .wan_video import _image_array, _preprocess_images, generate_noise


class SD3ImagePipeline:

    _stage = FluxImagePipeline._stage
    vae_output_to_image = staticmethod(FluxImagePipeline.vae_output_to_image)

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=3.0)
        self.prompter = SD3Prompter()
        self.dit: Optional[D.SD3DiT] = None
        self.dit_cfg: D.SD3DiTConfig = D.SD3_MEDIUM
        self.vae_encoder: Optional[V.SD3VAEEncoder] = None
        self.vae_decoder: Optional[V.SD3VAEDecoder] = None
        self.vae_cfg: V.SD3VAEConfig = V.SD3_VAE
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: D.SD3DiTConfig, clip_l_cfg: ClipTextConfig,
                     clip_g_cfg: ClipTextConfig, t5_cfg: Optional[T5Config],
                     vae_cfg: V.SD3VAEConfig, tokenizers: Tuple, seed: int = 0, device=None,
                     dtype=torch.bfloat16) -> "SD3ImagePipeline":
        """Random weights drawn on the device from one seeded generator: the
        DiT and text towers in `dtype` (no T5 where `t5_cfg` is None), the
        VAE in fp32. tokenizers: (CLIP-L, CLIP-G, T5 or None)."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg, pipe.vae_cfg = dit_cfg, vae_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)

        def draw(module, init):
            return init(module.to_empty(device=dev), gen).eval()

        with torch.device("meta"):
            dit = D.SD3DiT(dit_cfg, dtype=dtype)
            te1 = ClipTextEncoder(clip_l_cfg, dtype=dtype)
            te2 = SDXLTextEncoder2(clip_g_cfg, dtype=dtype)
            t5 = None if t5_cfg is None else T5Encoder(t5_cfg, dtype=dtype)
            enc = V.SD3VAEEncoder(vae_cfg, dtype=torch.float32)
            dec = V.SD3VAEDecoder(vae_cfg, dtype=torch.float32)
        pipe.dit = draw(dit, D.init_sd3_dit_)
        pipe.prompter = SD3Prompter(*tokenizers, te1=draw(te1, init_clip_text_),
                                    te2=draw(te2, init_clip_text_),
                                    t5=None if t5 is None else draw(t5, init_t5_))
        pipe.vae_encoder = draw(enc, V.init_sd3_vae_)
        pipe.vae_decoder = draw(dec, V.init_sd3_vae_)
        return pipe

    @classmethod
    def from_pretrained(cls, dit_path=None, vae_path=None, device=None,
                        dtype=torch.bfloat16) -> "SD3ImagePipeline":
        """The DiT (DiffSynth or civitai layout, or the bare mmdit names; a
        list of shards or one file) and the VAE (`encoder.` / `decoder.`
        state dicts); no text encoder, as in the JAX pipeline."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_path:
            sd = C.load_state_dict_files(dit_path if isinstance(dit_path, list) else [dit_path],
                                         lazy=True)
            pipe.dit = C.build_image_module("sd3_dit", sd, None, dev, dtype)
            pipe.dit_cfg = pipe.dit.cfg
        if vae_path:
            enc, dec = V.split_vae_state_dict(C.load_state_dict(vae_path, lazy=True))
            pipe.vae_encoder = C.build_module(V.SD3VAEEncoder, pipe.vae_cfg,
                                              V.convert_sd3_vae(enc), dev, torch.float32)
            pipe.vae_decoder = C.build_module(V.SD3VAEDecoder, pipe.vae_cfg,
                                              V.convert_sd3_vae(dec), dev, torch.float32)
        return pipe

    # ---------------- helpers ----------------

    def encode_prompt(self, prompt: str, t5_sequence_length: int = 77):
        with self._stage("text_encode"):
            return self.prompter.encode_prompt(prompt, t5_sequence_length, dtype=self.dtype)

    @torch.no_grad()
    def encode_image(self, image_np: np.ndarray):
        z = V.sd3_vae_encoder_forward(
            self.vae_encoder, torch.from_numpy(image_np).to(self.device, torch.float32),
            self.vae_cfg)
        return z.to(self.dtype)

    @torch.no_grad()
    def decode_image(self, latents):
        return V.sd3_vae_decoder_forward(self.vae_decoder, latents.float(), self.vae_cfg)

    def _mask(self, mask, width: int, height: int) -> torch.Tensor:
        """A mask image -> (1, 1, H/8, W/8) in [0, 1] (its first channel)."""
        arr = _preprocess_images(_image_array(mask, width // 8, height // 8)[None])
        return torch.from_numpy((arr[:, :1, 0] + 1) / 2).to(self.device, torch.float32)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        local_prompts: List[str] = (),
        masks: List = (),
        mask_scales: List[float] = (),
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        input_image=None,
        denoising_strength: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 20,
        t5_sequence_length: int = 77,
        seed: Optional[int] = None,
        progress_bar_cmd: Optional[Callable] = None,
        return_latents: bool = False,
    ):
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height, width = FluxImagePipeline.check_resize(height, width)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)

        noise = generate_noise((1, 16, height // 8, width // 8), seed=seed).to(dev, dtype)
        if input_image is not None:
            with self._stage("vae_encode"):
                z = self.encode_image(_preprocess_images(
                    _image_array(input_image, width, height)[None])[:, :, 0])
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise

        posi = self.encode_prompt(prompt, t5_sequence_length)
        nega = self.encode_prompt(negative_prompt, t5_sequence_length)
        locals_emb = [self.encode_prompt(p, t5_sequence_length) for p in local_prompts]
        mask_arrays = [self._mask(m, width, height) for m in masks]

        def fwd(emb, pooled, t):
            return D.sd3_dit_forward(self.dit, latents, t, emb, pooled)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            timestep = torch.tensor([float(self.scheduler.timesteps[i])], dtype=torch.float32,
                                    device=dev)
            with self._stage(f"denoise_step_{i}"):
                v_posi = fwd(*posi, timestep)
                if locals_emb:
                    weight = torch.ones_like(v_posi[:, :1])
                    blended = v_posi
                    for (emb, pooled), m, s in zip(locals_emb, mask_arrays, mask_scales):
                        m = m.reshape(1, 1, height // 8, width // 8) * s
                        blended = blended + fwd(emb, pooled, timestep) * m
                        weight = weight + m
                    v_posi = blended / weight
                v_nega = fwd(*nega, timestep)
                v = v_nega + cfg_scale * (v_posi - v_nega)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = self.decode_image(latents)
        return self.vae_output_to_image(image)
