"""WanVideoPipeline in PyTorch: the text-to-video / VACE edit path.

Counterpart of the T2V/VACE subset of
`video_styler_tpu/pipelines/wan_video.py`: shape check, seeded noise,
umT5 prompt encode, VACE context (a Wan2.1 VAE encode plus the 64-channel
mask), a flow-match Euler loop with two-pass (or merged) CFG over
`wan_dit_forward` with VACE hints, optional TeaCache step skipping, and the
VAE decode. `load_lora` merges a LoRA into the DiT or the VACE branch;
`quantize` (after any LoRA merge) turns the DiT and VACE linears into int8,
fp8 or int4 layers and can route attention through the int8 kernel.
Checkpoint loading is not ported yet; models come from `from_jax_params`
or from `from_configs` (random weights).

Runs on `cuda` unless constructed with `device="cpu"`. Each stage's wall
time (synchronised with the card) is kept in `stage_times`; on the card,
`stage_peak_bytes` holds `torch.cuda.max_memory_allocated` as each stage
ends (a running maximum: the caller resets it).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..lora import merge_lora
from ..models import wan_vae as V
from ..models.t5 import T5Config, T5Encoder, init_t5_
from ..models.wan_dit import (WanDiT, WanDiTConfig, head, init_weights_,
                              patchify, time_embed, unpatchify,
                              wan_dit_forward_with_residual)
from ..models.wan_vace import VaceConfig, WanVace
from ..prompters.wan_prompter import WanPrompter
from ..schedulers.flow_match import FlowMatchScheduler


def _preprocess_images(images) -> np.ndarray:
    """PIL list or uint8 (T, H, W, 3) array -> (1, 3, T, H, W) float32 in
    [-1, 1]."""
    if isinstance(images, np.ndarray):
        arr = images.astype(np.float32)
    else:
        arr = np.stack([np.asarray(im, dtype=np.float32) for im in images])
    arr = arr * (2.0 / 255.0) - 1.0
    return arr.transpose(3, 0, 1, 2)[None].astype(np.float32)


def generate_noise(shape, seed: Optional[int] = None) -> torch.Tensor:
    """Seeded Gaussian noise drawn on the CPU in float32 (bit-identical with
    the JAX pipeline's noise); the caller moves it to the device."""
    gen = None if seed is None else torch.Generator("cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32)


class TeaCache:
    """Per-branch step skipper: skip the trunk while the accumulated
    polynomial-rescaled relative change of t_mod stays under a threshold."""

    COEFFS = {
        "Wan2.1-T2V-1.3B": [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02, 1.36987616e+01, -4.99875664e-02],
        "Wan2.1-T2V-14B": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03, 5.87365115e+01, -3.15583525e-01],
        "Wan2.1-I2V-14B-480P": [2.57151496e+05, -3.54229917e+04, 1.40286849e+03, -1.35890334e+01, 1.32517977e-01],
        "Wan2.1-I2V-14B-720P": [8.10705460e+03, 2.13393892e+03, -3.72934672e+02, 1.66203073e+01, -4.17769401e-02],
    }

    def __init__(self, num_inference_steps: int, rel_l1_thresh: float, model_id: str):
        if model_id not in self.COEFFS:
            raise ValueError(f"{model_id} is not a supported TeaCache model id "
                             f"(choose from {', '.join(self.COEFFS)})")
        self.num_inference_steps = num_inference_steps
        self.step = 0
        self.accumulated = 0.0
        self.rel_l1_thresh = rel_l1_thresh
        self.coefficients = self.COEFFS[model_id]
        self.previous_t_mod = None
        self.previous_residual = None

    def check(self, t_mod) -> bool:
        """True -> skip the trunk this step and reuse the cached residual."""
        t_mod = t_mod.float().cpu().numpy()
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated = 0.0
        else:
            rel = float(np.abs(t_mod - self.previous_t_mod).mean()
                        / np.abs(self.previous_t_mod).mean())
            self.accumulated += float(np.polyval(self.coefficients, rel))
            should_calc = self.accumulated >= self.rel_l1_thresh
            if should_calc:
                self.accumulated = 0.0
        self.previous_t_mod = t_mod
        self.step = (self.step + 1) % self.num_inference_steps
        return not should_calc

    def store(self, residual):
        self.previous_residual = residual


class WanVideoPipeline:
    """Public call mirrors the JAX pipeline's __call__ (T2V/VACE subset)."""

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=5.0, sigma_min=0.0,
                                            extra_one_step=True)
        self.prompter = WanPrompter()
        self.dit: Optional[WanDiT] = None
        self.vace: Optional[WanVace] = None
        self.vae: Optional[V.WanVAE] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    @classmethod
    def from_configs(cls, dit_cfg: WanDiTConfig, vace_cfg: Optional[VaceConfig],
                     t5_cfg: T5Config, vae_cfg: V.WanVAEConfig,
                     tokenizer: Callable, text_len: int = 512, seed: int = 0,
                     device=None, dtype=torch.bfloat16) -> "WanVideoPipeline":
        """Random weights drawn on the device from one seeded generator, with
        the JAX init's std; the DiT, VACE and T5 in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            dit = WanDiT(dit_cfg, dtype=dtype)
            vace = None if vace_cfg is None else WanVace(vace_cfg, dtype=dtype)
            t5 = T5Encoder(t5_cfg, dtype=dtype)
            vae = V.WanVAE(vae_cfg, dtype=torch.float32)
        pipe.dit = init_weights_(dit.to_empty(device=dev), gen).eval()
        if vace is not None:
            pipe.vace = init_weights_(vace.to_empty(device=dev), gen).eval()
        t5 = init_t5_(t5.to_empty(device=dev), gen).eval()
        pipe.vae = V.init_wan_vae_(vae.to_empty(device=dev), gen).eval()
        pipe.prompter = WanPrompter(tokenizer, text_len, t5)
        return pipe

    def load_lora(self, target: str = "dit", path: Optional[str] = None,
                  state_dict=None, alpha: float = 1.0):
        """Merge a LoRA (a safetensors file or a state dict) into the `dit`
        or `vace` weights, as the JAX pipeline's `load_lora` does."""
        if target not in ("dit", "vace") or getattr(self, target) is None:
            raise ValueError(f"no {target!r} model to merge a LoRA into")
        if state_dict is None:
            from ..safetensors_io import load_file
            state_dict = load_file(path)
        merge_lora(getattr(self, target), state_dict, alpha=alpha)

    def quantize(self, mode: str = "int8", targets: tuple = ("dit", "dit2", "vace"),
                 quantize_attention: bool = False):
        """Quantize the DiT and VACE linear weights in place (the JAX
        pipeline's `quantize`; the analogue of the reference's fp8 path).
        Must run after LoRA merging. The output head, the modulation tables
        and the time embedding stay in high precision; targets the pipeline
        does not hold (`dit2`) are skipped.

        Modes: "int8" (w8a8), "fp8" (e4m3 storage), "int4" (w4a8,
        0.5 byte/param), "int4_g128" (w4a16 group scales).

        quantize_attention also routes every attention call, cross-attention
        included, through the int8 kernel K6 (process-wide:
        `ops.attention.set_quantized_attention`)."""
        from ..ops.quant import quantize_params
        keep = ("head", "modulation", "time_embedding")

        def pred(path, layer):
            return not any(k in path for k in keep)

        for t in targets:
            model = getattr(self, t, None)
            if model is not None:
                quantize_params(model, mode=mode, predicate=pred)
        if quantize_attention:
            from ..ops.attention import set_quantized_attention
            set_quantized_attention(True)

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.stage_peak_bytes.append(
                (name, torch.cuda.max_memory_allocated(self.device)))
        self.stage_times.append((name, time.perf_counter() - t0))

    # ---------------- conditioning units ----------------

    def check_resize(self, height, width, num_frames):
        """Spatial sizes to a multiple of 16, frame count to 4k+1."""
        div = self.vae.cfg.upsampling_factor * 2
        if height % div != 0:
            height = (height + div - 1) // div * div
        if width % div != 0:
            width = (width + div - 1) // div * div
        if num_frames % 4 != 1:
            num_frames = (num_frames + 3) // 4 * 4 + 1
        return height, width, num_frames

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        return self.prompter.encode_prompt(prompt, dtype=self.dtype)

    @torch.no_grad()
    def encode_video(self, video_np: np.ndarray, tiled: bool = True) -> torch.Tensor:
        video = torch.from_numpy(np.ascontiguousarray(video_np, np.float32))
        return V.encode(self.vae, video.to(self.device), tiled=tiled).to(self.dtype)

    @torch.no_grad()
    def decode_video(self, latents: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        return V.decode(self.vae, latents.float(), tiled=tiled)

    def build_vace_context(self, vace_video, vace_video_mask,
                           vace_reference_image, height, width, num_frames,
                           tiled: bool):
        """Inactive/reactive latents + the 64-channel downsampled mask ->
        the 96-channel VACE context."""
        if vace_video is None and vace_video_mask is None and vace_reference_image is None:
            return None
        if vace_video is None:
            video = np.zeros((1, 3, num_frames, height, width), np.float32)
        else:
            video = _preprocess_images(vace_video)
        if vace_video_mask is None:
            mask = np.ones_like(video)
        else:
            mask = (_preprocess_images(vace_video_mask) + 1.0) / 2.0
        inactive = video * (1 - mask)
        reactive = video * mask
        # one batch-2 VAE pass (batch entries are independent)
        both = self.encode_video(np.concatenate([inactive, reactive], axis=0), tiled)
        latents = torch.cat([both[0:1], both[1:2]], dim=1)

        # mask -> (1, 64, T_lat, H/8, W/8): 8x8 shuffle, nearest-exact in time
        m = mask[0, 0]
        T, H, W = m.shape
        m = m.reshape(T, H // 8, 8, W // 8, 8).transpose(0, 2, 4, 1, 3)
        m = m.reshape(1, T, 64, H // 8, W // 8).transpose(0, 2, 1, 3, 4)
        t_lat = (T + 3) // 4
        idx = np.minimum(np.floor((np.arange(t_lat) + 0.5) * (T / t_lat)).astype(int), T - 1)
        mask_lat = torch.from_numpy(np.ascontiguousarray(m[:, :, idx])).to(
            self.device, self.dtype)

        if vace_reference_image is not None:
            refs = (vace_reference_image if isinstance(vace_reference_image, list)
                    else [vace_reference_image])
            ref_lat = self.encode_video(_preprocess_images(refs), tiled)
            ref_lat = torch.cat([ref_lat, torch.zeros_like(ref_lat)], dim=1)
            latents = torch.cat([ref_lat, latents], dim=2)
            mask_lat = torch.cat([torch.zeros_like(mask_lat[:, :, :ref_lat.shape[2]]),
                                  mask_lat], dim=2)
        return torch.cat([latents, mask_lat], dim=1)

    # ---------------- model functions ----------------

    def _skip(self, latents, timestep, residual):
        """TeaCache replay: patchify + cached residual + head."""
        dit = self.dit
        cfg = dit.cfg
        t, _ = time_embed(dit, timestep)
        tokens, grid = patchify(dit.patch_embedding, latents, cfg.patch_size)
        out = head(dit, tokens + residual, t)
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)

    def _branch_forward(self, latents, timestep, context, vace_context,
                        vace_scale, tea_cache: Optional[TeaCache]):
        if tea_cache is not None:
            _, t_mod = time_embed(self.dit, timestep)
            if tea_cache.check(t_mod) and tea_cache.previous_residual is not None:
                return self._skip(latents, timestep, tea_cache.previous_residual)
        v, residual = wan_dit_forward_with_residual(
            self.dit, latents, timestep, context, vace=self.vace,
            vace_context=vace_context, vace_scale=vace_scale)
        if tea_cache is not None:
            tea_cache.store(residual)
        return v

    def _velocity(self, latents, timestep, ctx_posi, ctx_nega, vace_context,
                  vace_scale, cfg_scale, tc_posi, tc_nega, cfg_merge=False):
        """One denoise velocity: CFG by two passes or one merged batch."""
        if cfg_scale == 1.0 or ctx_nega is None:
            return self._branch_forward(latents, timestep, ctx_posi,
                                        vace_context, vace_scale, tc_posi)
        if cfg_merge:
            vc2 = None if vace_context is None else torch.cat([vace_context] * 2)
            v2 = self._branch_forward(torch.cat([latents, latents]), timestep,
                                      torch.cat([ctx_posi, ctx_nega]), vc2,
                                      vace_scale, None)
            v_posi, v_nega = v2[:1], v2[1:]
        else:
            v_posi = self._branch_forward(latents, timestep, ctx_posi,
                                          vace_context, vace_scale, tc_posi)
            v_nega = self._branch_forward(latents, timestep, ctx_nega,
                                          vace_context, vace_scale, tc_nega)
        return v_nega + cfg_scale * (v_posi - v_nega)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "",
                 input_video=None, denoising_strength: float = 1.0,
                 vace_video=None, vace_video_mask=None,
                 vace_reference_image=None, vace_scale: float = 1.0,
                 seed: Optional[int] = None, height: int = 480,
                 width: int = 832, num_frames: int = 81,
                 cfg_scale: float = 5.0, cfg_merge: bool = False,
                 num_inference_steps: int = 50, sigma_shift: float = 5.0,
                 tiled: bool = True,
                 tea_cache_l1_thresh: Optional[float] = None,
                 tea_cache_model_id: str = "",
                 return_latents: bool = False):
        """Frames in as a PIL list or uint8 (T, H, W, 3) arrays; out as a
        uint8 (T, H, W, 3) array, or the latents with return_latents."""
        self.stage_times = []
        self.stage_peak_bytes = []
        height, width, num_frames = self.check_resize(height, width, num_frames)
        self.scheduler.set_timesteps(num_inference_steps,
                                     denoising_strength=denoising_strength,
                                     shift=sigma_shift)
        length = (num_frames - 1) // 4 + 1
        ref_count = 0
        if vace_reference_image is not None:
            ref_count = (len(vace_reference_image)
                         if isinstance(vace_reference_image, list) else 1)
            length += ref_count
        z = self.vae.cfg.z_dim
        up = self.vae.cfg.upsampling_factor
        noise = generate_noise((1, z, length, height // up, width // up), seed=seed)
        if ref_count:
            noise = torch.cat([noise[:, :, -ref_count:], noise[:, :, :-ref_count]], dim=2)
        noise = noise.to(self.device, self.dtype)  # rounded before any mixing

        if input_video is not None:
            with self._stage("vae_encode_input"):
                input_latents = self.encode_video(_preprocess_images(input_video), tiled)
                if vace_reference_image is not None:
                    refs = (vace_reference_image if isinstance(vace_reference_image, list)
                            else [vace_reference_image])
                    ref_lat = self.encode_video(_preprocess_images(refs), tiled=False)
                    input_latents = torch.cat([ref_lat, input_latents], dim=2)
            latents = self.scheduler.add_noise(
                input_latents.float(), noise.float(),
                self.scheduler.timesteps[0]).to(self.dtype)
        else:
            latents = noise

        with self._stage("t5"):
            ctx_posi = self.encode_prompt(prompt)
            ctx_nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None
        with self._stage("vae_encode"):
            vace_context = self.build_vace_context(
                vace_video, vace_video_mask, vace_reference_image, height,
                width, num_frames, tiled)
        if vace_context is not None and self.vace is None:
            raise ValueError("VACE inputs were given but the pipeline has no "
                             "VACE model")

        tc_posi = tc_nega = None
        if tea_cache_l1_thresh is not None:
            tc_posi = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)
            tc_nega = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)

        for i in range(len(self.scheduler.timesteps)):
            with self._stage(f"denoise_step_{i}"):
                timestep = torch.tensor([float(self.scheduler.timesteps[i])],
                                        dtype=torch.float32, device=self.device)
                v = self._velocity(latents, timestep, ctx_posi, ctx_nega,
                                   vace_context, vace_scale, cfg_scale,
                                   tc_posi, tc_nega, cfg_merge=cfg_merge)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)
                           ).to(self.dtype)
        if ref_count:
            latents = latents[:, :, ref_count:]
        if return_latents:
            return latents
        with self._stage("vae_decode"):
            video = self.decode_video(latents, tiled)
        return self.vae_output_to_video(video)

    @staticmethod
    def vae_output_to_video(video: torch.Tensor) -> np.ndarray:
        """(1, 3, T, H, W) in [-1, 1] -> uint8 (T, H, W, 3). Raises on a
        non-finite value rather than writing it out as black pixels."""
        if not bool(torch.isfinite(video).all()):
            raise FloatingPointError("decoded video holds non-finite values")
        arr = video[0].float().cpu().numpy().transpose(1, 2, 3, 0)
        return np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
