"""CogVideoX text-to-video (and video-to-video) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/cog_video.py`
(`CogVideoPipeline.__call__` :75-136): the enhanced DDIM scheduler with
v-prediction and the zero-terminal-SNR rescale, `frames // 4 + 1` latent
frames at 1/8 of the size, T5 v1.1-XXL over 226 tokens (no mask, as in
JAX), two-pass CFG on the negative prompt, the DDIM update in fp32, and the
chunked fp32 VAE (video-to-video encodes `input_video` and noises it to the
first timestep).

The text tower: `fetch_text_encoder(t5, tokenizer)` with the port's
`T5Encoder` (or a file of HF `T5EncoderModel` names) and a tokenizer
callable (or directory, read through `transformers` when called). A
request without one raises a RuntimeError: the JAX runner builds none and
its request calls None.

Runs on `cuda` unless constructed with `device="cpu"`; each stage's wall
time is kept in `stage_times` and, on the card, the running peak in
`stage_peak_bytes`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import cog_video as C
from ..models.t5 import T5_V11_XXL, T5Encoder, convert_hf_t5, t5_encode
from ..schedulers.ddim import EnhancedDDIMScheduler
from ..utils import ckpt as K
from .flux_image import FluxImagePipeline
from .wan_video import WanVideoPipeline, _image_array, _preprocess_images, generate_noise

TEXT_LENGTH = 226


class CogVideoPipeline:

    _stage = FluxImagePipeline._stage

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = EnhancedDDIMScheduler(rescale_zero_terminal_snr=True,
                                               prediction_type="v_prediction")
        self.dit: Optional[C.CogDiT] = None
        self.dit_cfg: C.CogDiTConfig = C.COG_VIDEO_X
        self.vae_encoder: Optional[C.CogVAEEncoder] = None
        self.vae_decoder: Optional[C.CogVAEDecoder] = None
        self.text_encoder: Optional[Callable] = None   # prompt -> (1, L, 4096)
        self.t5: Optional[T5Encoder] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: C.CogDiTConfig, seed: int = 0, device=None,
                     dtype=torch.bfloat16, vae: bool = True) -> "CogVideoPipeline":
        """Random weights drawn on the device from a seeded generator: the
        DiT in `dtype`, the VAE in fp32 (not with vae=False). The text tower
        comes from `fetch_text_encoder`."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg = dit_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            net = C.CogDiT(dit_cfg, dtype=dtype)
            enc = C.CogVAEEncoder(dtype=torch.float32)
            dec = C.CogVAEDecoder(dtype=torch.float32)
        if vae:
            pipe.vae_encoder = C.init_cog_vae_(enc.to_empty(device=dev), gen).eval()
            pipe.vae_decoder = C.init_cog_vae_(dec.to_empty(device=dev), gen).eval()
        pipe.dit = C.init_cog_dit_(net.to_empty(device=dev), gen).eval()
        return pipe

    @classmethod
    def from_pretrained(cls, dit_paths=None, vae_encoder_path=None, vae_decoder_path=None,
                        device=None, dtype=torch.bfloat16) -> "CogVideoPipeline":
        """The DiT (shards) and the VAE's encoder and decoder files, the
        reference's names."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_paths:
            sd = K.load_state_dict_files(dit_paths if isinstance(dit_paths, list)
                                         else [dit_paths], lazy=True)
            pipe.dit = K.build_module(C.CogDiT, pipe.dit_cfg, C.convert_cog_dit(sd, pipe.dit_cfg),
                                      dev, dtype)
        for attr, cls_, path in (("vae_encoder", C.CogVAEEncoder, vae_encoder_path),
                                 ("vae_decoder", C.CogVAEDecoder, vae_decoder_path)):
            if path:
                setattr(pipe, attr, K.build_module(cls_, None, K.load_state_dict(path, lazy=True),
                                                   dev, torch.float32))
        return pipe

    def fetch_text_encoder(self, t5, tokenizer):
        """T5 v1.1-XXL (`T5Encoder`, or its HF file / shards) under
        `tokenizer` (a callable or a directory)."""
        if not isinstance(t5, torch.nn.Module):
            sd = K.load_state_dict_files(t5 if isinstance(t5, list) else [t5], lazy=True)
            t5 = K.build_module(T5Encoder, T5_V11_XXL, convert_hf_t5(sd, T5_V11_XXL),
                                self.device, self.dtype)
        if isinstance(tokenizer, str):
            from transformers import T5TokenizerFast
            tokenizer = T5TokenizerFast.from_pretrained(tokenizer)
        self.t5 = t5

        @torch.no_grad()
        def encode(prompt: str, length: int = TEXT_LENGTH):
            with self._stage("t5_encode"):
                ids = tokenizer([prompt], padding="max_length", max_length=length,
                                truncation=True, return_tensors="np")["input_ids"]
                ids = torch.from_numpy(np.asarray(ids, np.int64)).to(t5.token_embedding.device)
                return t5_encode(t5, ids).to(self.dtype)

        self.text_encoder = encode
        return self

    @torch.no_grad()
    def decode_video(self, latents):
        """latents (1, 16, T, h, w) -> uint8 (T', H, W, 3)."""
        with self._stage("vae_decode"):
            video = C.cog_vae_decode(self.vae_decoder, latents.float())
        return WanVideoPipeline.vae_output_to_video(video.clamp(-1, 1))

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        input_video=None,
        cfg_scale: float = 7.0,
        denoising_strength: float = 1.0,
        num_frames: int = 49,
        height: int = 480,
        width: int = 720,
        num_inference_steps: int = 20,
        seed: Optional[int] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        if self.text_encoder is None:
            raise RuntimeError("the CogVideoX pipeline has no text encoder (fetch_text_encoder)")
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height = (height + 15) // 16 * 16
        width = (width + 15) // 16 * 16
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        t_lat = num_frames // 4 + 1
        noise = generate_noise((1, 16, t_lat, height // 8, width // 8), seed=seed).to(dev, dtype)
        if denoising_strength == 1.0 or input_video is None:
            latents = noise
        else:
            with self._stage("vae_encode"):
                vid = _preprocess_images(np.stack([_image_array(f, width, height)
                                                   for f in input_video]))
                z = C.cog_vae_encode(self.vae_encoder, torch.from_numpy(vid).to(dev))
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        posi = self.text_encoder(prompt)
        nega = self.text_encoder(negative_prompt) if cfg_scale != 1.0 else None

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tt = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                v = C.cog_dit_forward(self.dit, latents, tt, posi)
                if nega is not None:
                    v_nega = C.cog_dit_forward(self.dit, latents, tt, nega)
                    v = v_nega + cfg_scale * (v - v_nega)
                latents = self.scheduler.step(v.float(), t, latents.float()).to(dtype)
        if return_latents:
            return latents
        return self.decode_video(latents)
