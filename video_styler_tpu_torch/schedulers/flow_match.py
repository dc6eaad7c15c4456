"""Rectified-flow (flow matching) scheduler; host-side numpy sigmas.

Counterpart of `video_styler_tpu/schedulers/flow_match.py`, the subset the
Wan pipeline drives:
  sigmas    = shift*s / (1 + (shift-1)*s)  over linspace(sigma_start, sigma_min)
  step      = x + v * (sigma_next - sigma)          (Euler)
  add_noise = (1-sigma)*x + sigma*eps
With training=True, set_timesteps also builds the bell-shaped per-timestep
loss weights of the 1000-entry training tables (`linear_timesteps_weights`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class FlowMatchScheduler:

    def __init__(self, num_inference_steps: int = 100,
                 num_train_timesteps: int = 1000, shift: float = 3.0,
                 sigma_max: float = 1.0, sigma_min: float = 0.003 / 1.002,
                 extra_one_step: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.extra_one_step = extra_one_step
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      shift: Optional[float] = None, training: bool = False):
        if shift is not None:
            self.shift = shift
        sigma_start = self.sigma_min + (self.sigma_max - self.sigma_min) * denoising_strength
        if self.extra_one_step:
            sigmas = np.linspace(sigma_start, self.sigma_min, num_inference_steps + 1,
                                 dtype=np.float64)[:-1]
        else:
            sigmas = np.linspace(sigma_start, self.sigma_min, num_inference_steps,
                                 dtype=np.float64)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigmas = sigmas.astype(np.float32)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
        self.training = training
        if training:
            x = self.timesteps.astype(np.float64)
            y = np.exp(-2 * ((x - num_inference_steps / 2) / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            self.linear_timesteps_weights = (
                y_shifted * (num_inference_steps / y_shifted.sum())).astype(np.float32)

    def _timestep_id(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(np.asarray(timestep)))))

    def sigma_pair(self, timestep_id: int, to_final: bool = False):
        """(sigma, sigma_next) of a step index, as Python floats."""
        sigma = float(self.sigmas[timestep_id])
        if to_final or timestep_id + 1 >= len(self.timesteps):
            return sigma, 0.0
        return sigma, float(self.sigmas[timestep_id + 1])

    def step(self, model_output, timestep, sample, to_final: bool = False):
        sigma, sigma_ = self.sigma_pair(self._timestep_id(timestep), to_final)
        return sample + model_output * (sigma_ - sigma)

    def add_noise(self, original_samples, noise, timestep):
        sigma = float(self.sigmas[self._timestep_id(timestep)])
        return (1 - sigma) * original_samples + sigma * noise

    def training_target(self, sample, noise, timestep=None):
        return noise - sample

    def training_weight(self, timestep) -> float:
        return float(self.linear_timesteps_weights[self._timestep_id(timestep)])
