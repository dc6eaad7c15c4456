"""Keyframe-guided flow-matching video editor in PyTorch.

Counterpart of `video_styler_tpu/pipelines/wan_video_editor.py`:

  1. coupled noise: the edited keyframes start from the main video's noise
     slices at their latent frames, so both routes start identically;
  2. shared RoPE ids: keyframe tokens keep the temporal rotation of the
     frame they edit (the DiT's `rope_indices`);
  3. velocity correction: v_main[kf] += alpha * r_k with the residual
     r_k = (z_main[kf] - z_edit) - (v_main[kf] - v_edit) * dt, accumulated
     once per occurrence of a repeated index (`index_add`);
  4. each keyframe VAE-encoded as its own 1-frame video (stage
     `vae_encode_keyframes`; the result is not used by the denoise, as in
     the JAX package).

The joint [main | keyframes] latent goes through one DiT forward per CFG
pass; TeaCache, when asked for, runs per CFG branch on that joint
sequence. The correction runs in fp32 on the latents cast up, and each
latent is stepped in fp32 and cast back to the pipeline dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .wan_video import TeaCache, WanVideoPipeline, _preprocess_images, generate_noise


def _index(keyframe_indices, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keyframe_indices, np.int64), device=device)


class WanVideoEditorPipeline(WanVideoPipeline):

    def prepare_coupled_noise(self, latent_shape, keyframe_indices: List[int],
                              seed: Optional[int] = None):
        """(noise_main, noise_edit) on the CPU in fp32: the keyframes' noise
        is the main noise's slices at their latent frames."""
        noise_main = generate_noise(latent_shape, seed=seed)
        noise_edit = noise_main[:, :, list(keyframe_indices)].clone()
        return noise_main, noise_edit

    @staticmethod
    def latent_keyframe_indices(keyframe_indices: List[int], t_lat: int) -> List[int]:
        """Latent frames of the keyframes, as the JAX editor computes them:
        when an index lies past the latent frames, all are pixel frames,
        mapped by min(k // 4, t_lat - 1), deduplicated and sorted; else
        they are taken as latent frames, in order, repeats kept. (The
        causal VAE puts pixel frame k in latent frame (k + 3) // 4: the
        map is the reference's, kept as it is.)"""
        if max(keyframe_indices) >= t_lat:
            return sorted({min(k // 4, t_lat - 1) for k in keyframe_indices})
        return list(keyframe_indices)

    @staticmethod
    def construct_rope_ids(total_frames: int, keyframe_indices: List[int]) -> np.ndarray:
        """[0..T-1] ++ keyframe_indices, int32."""
        return np.concatenate([np.arange(total_frames),
                               np.asarray(keyframe_indices)]).astype(np.int32)

    @staticmethod
    def compute_velocity_correction(z_main, z_edit, v_main, v_edit,
                                    keyframe_indices, dt: float,
                                    alpha: float = 10.0, beta: float = 0.0):
        """r_k = dz - dv*dt; v_main[kf] += alpha*r_k (a repeated index adds
        once per occurrence); v_edit -= beta*alpha*r_k when beta > 0."""
        kf = _index(keyframe_indices, v_main.device)
        z_diff = z_main.index_select(2, kf) - z_edit
        v_diff = v_main.index_select(2, kf) - v_edit
        r_k = z_diff - v_diff * dt
        correction = alpha * r_k
        v_main_corrected = v_main.index_add(2, kf, correction)
        v_edit_corrected = v_edit - beta * correction if beta > 0 else v_edit
        return v_main_corrected, v_edit_corrected

    @staticmethod
    def compute_metrics(z_main, z_edit, v_main, v_edit, keyframe_indices,
                        dt: float) -> Dict[str, float]:
        """Mean |r_k|, mean |v_main[kf] - v_edit| and mean |z_main[kf] - z_edit|
        (host floats: one synchronisation)."""
        kf = _index(keyframe_indices, v_main.device)
        z_diff = z_main.index_select(2, kf) - z_edit
        v_diff = v_main.index_select(2, kf) - v_edit
        r_k = z_diff - v_diff * dt
        vals = torch.stack([r_k.abs().mean(), v_diff.abs().mean(),
                            z_diff.abs().mean()]).tolist()
        return dict(zip(("r_k_norm", "v_diff_norm", "delta_v_norm"), vals))

    def encode_keyframes_independently(self, keyframes, **tiler) -> torch.Tensor:
        """Each keyframe encoded as its own 1-frame video."""
        return torch.cat([self.encode_video(_preprocess_images([kf]), **tiler)
                          for kf in keyframes], dim=2)

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "",
                 source_video=None, edited_keyframes=None,
                 keyframe_indices: Optional[List[int]] = None,
                 seed: Optional[int] = None, height: int = 480,
                 width: int = 832, num_frames: int = 81,
                 cfg_scale: float = 5.0, num_inference_steps: int = 50,
                 sigma_shift: float = 5.0, alpha: float = 10.0,
                 beta: float = 0.0, tiled: bool = True,
                 tile_size: Tuple[int, int] = (30, 52),
                 tile_stride: Tuple[int, int] = (15, 26),
                 verbose: bool = True, return_latents: bool = False,
                 tea_cache_l1_thresh: Optional[float] = None,
                 tea_cache_model_id: str = ""):
        """Frames in as PIL lists or uint8 (T, H, W, 3) arrays; out as uint8
        (T, H, W, 3), or the main latents with return_latents. With verbose,
        every tenth step's `compute_metrics` is printed and kept in
        `self.metrics` as (step, dict)."""
        if source_video is None or edited_keyframes is None or keyframe_indices is None:
            raise ValueError("source_video, edited_keyframes, and keyframe_indices are required")
        if len(edited_keyframes) != len(keyframe_indices):
            raise ValueError(
                f"Number of edited keyframes ({len(edited_keyframes)}) must "
                f"match keyframe_indices ({len(keyframe_indices)})")
        self.stage_times = []
        self.stage_peak_bytes = []
        self.metrics = []
        height, width, num_frames = self.check_resize(height, width, num_frames)
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        self.scheduler.set_timesteps(num_inference_steps, shift=sigma_shift)

        with self._stage("vae_encode"):
            z_main_clean = self.encode_video(_preprocess_images(source_video), **tiler)
        with self._stage("vae_encode_keyframes"):
            # encoded as the pipeline contract has it; the denoise starts from
            # pure coupled noise
            self.encode_keyframes_independently(edited_keyframes, **tiler)

        t_lat = z_main_clean.shape[2]
        kf_lat = self.latent_keyframe_indices(keyframe_indices, t_lat)

        noise_main, noise_edit = self.prepare_coupled_noise(
            z_main_clean.shape, kf_lat, seed=seed)
        z_main = noise_main.to(self.device, self.dtype)
        z_edit = noise_edit.to(self.device, self.dtype)
        del z_main_clean

        with self._stage("t5"):
            ctx_posi = self.encode_prompt(prompt)
            ctx_nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None

        rope_ids = self.construct_rope_ids(t_lat, kf_lat)

        tc_posi = tc_nega = None
        if tea_cache_l1_thresh is not None:
            tc_posi = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)
            tc_nega = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)

        timesteps = self.scheduler.timesteps
        for i in range(len(timesteps)):
            with self._stage(f"denoise_step_{i}"):
                timestep = torch.tensor([float(timesteps[i])], dtype=torch.float32,
                                        device=self.device)
                z_concat = torch.cat([z_main, z_edit], dim=2)
                v = self._branch_forward("dit", None, z_concat, timestep, ctx_posi,
                                         None, 1.0, tc_posi, rope_indices=rope_ids)
                if cfg_scale != 1.0:
                    v_nega = self._branch_forward("dit", None, z_concat, timestep,
                                                  ctx_nega, None, 1.0, tc_nega,
                                                  rope_indices=rope_ids)
                    v = v_nega + cfg_scale * (v - v_nega)
                dt = (float(timesteps[i] - timesteps[i + 1])
                      if i < len(timesteps) - 1 else 0.0)
                v_main, v_edit = self.compute_velocity_correction(
                    z_main.float(), z_edit.float(), v[:, :, :t_lat].float(),
                    v[:, :, t_lat:].float(), kf_lat, dt, alpha, beta)
                if verbose and i % 10 == 0:
                    m = self.compute_metrics(z_main.float(), z_edit.float(),
                                             v_main, v_edit, kf_lat, dt)
                    self.metrics.append((i, m))
                    print(f"Step {i}: r_k={m['r_k_norm']:.6f}, "
                          f"v_diff={m['v_diff_norm']:.6f}, Δv={m['delta_v_norm']:.6f}")
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                ds = sigma_next - sigma
                z_main = (z_main.float() + v_main * ds).to(self.dtype)
                z_edit = (z_edit.float() + v_edit * ds).to(self.dtype)

        if return_latents:
            return z_main
        with self._stage("vae_decode"):
            video = self.decode_video(z_main, **tiler)
        return self.vae_output_to_video(video)
