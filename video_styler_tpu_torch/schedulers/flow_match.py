"""Rectified-flow (flow matching) scheduler; host-side numpy sigmas.

Counterpart of `video_styler_tpu/schedulers/flow_match.py`, the subset the
Wan pipeline drives:
  sigmas    = shift*s / (1 + (shift-1)*s)  over linspace(sigma_start, sigma_min)
  step      = x + v * (sigma_next - sigma)          (Euler)
  add_noise = (1-sigma)*x + sigma*eps
With training=True, set_timesteps also builds the bell-shaped per-timestep
loss weights of the 1000-entry training tables (`linear_timesteps_weights`).
Qwen-Image's settings: an exponential shift
(sigmas = e^mu / (e^mu + 1/s - 1)) whose mu is given, or follows the image's
token count (`dynamic_shift_len`, `calculate_shift`), and a terminal-shift
rescale (1 - sigma scaled so that the last sigma is `shift_terminal`). StepVideo's
`reverse_sigmas` (sigma -> 1 - sigma after the shift) and OmniGen's
`inverse_timesteps` (the linspace run backwards before the shift): both
step towards sigma 1 on the final step.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


class FlowMatchScheduler:

    def __init__(self, num_inference_steps: int = 100,
                 num_train_timesteps: int = 1000, shift: float = 3.0,
                 sigma_max: float = 1.0, sigma_min: float = 0.003 / 1.002,
                 extra_one_step: bool = False, exponential_shift: bool = False,
                 exponential_shift_mu: Optional[float] = None,
                 shift_terminal: Optional[float] = None,
                 inverse_timesteps: bool = False, reverse_sigmas: bool = False):
        self.inverse_timesteps = inverse_timesteps
        self.reverse_sigmas = reverse_sigmas
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.extra_one_step = extra_one_step
        self.exponential_shift = exponential_shift
        self.exponential_shift_mu = exponential_shift_mu
        self.shift_terminal = shift_terminal
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      shift: Optional[float] = None, training: bool = False,
                      dynamic_shift_len: Optional[int] = None,
                      exponential_shift_mu: Optional[float] = None):
        if shift is not None:
            self.shift = shift
        sigma_start = self.sigma_min + (self.sigma_max - self.sigma_min) * denoising_strength
        if self.extra_one_step:
            sigmas = np.linspace(sigma_start, self.sigma_min, num_inference_steps + 1,
                                 dtype=np.float64)[:-1]
        else:
            sigmas = np.linspace(sigma_start, self.sigma_min, num_inference_steps,
                                 dtype=np.float64)
        if self.inverse_timesteps:
            sigmas = sigmas[::-1].copy()
        if self.exponential_shift:
            if exponential_shift_mu is not None:
                mu = exponential_shift_mu
            elif dynamic_shift_len is not None:
                mu = self.calculate_shift(dynamic_shift_len)
            else:
                mu = self.exponential_shift_mu
            sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
        else:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        if self.shift_terminal is not None:
            one_minus_z = 1 - sigmas
            sigmas = 1 - one_minus_z / (one_minus_z[-1] / (1 - self.shift_terminal))
        if self.reverse_sigmas:
            sigmas = 1 - sigmas
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
            return sigma, 1.0 if (self.inverse_timesteps or self.reverse_sigmas) else 0.0
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

    @staticmethod
    def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                        max_seq_len: int = 8192, base_shift: float = 0.5,
                        max_shift: float = 0.9) -> float:
        """mu of the exponential shift, linear in the image's token count."""
        m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
        b = base_shift - m * base_seq_len
        return image_seq_len * m + b
