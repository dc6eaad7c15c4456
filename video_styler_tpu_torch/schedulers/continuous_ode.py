"""The EDM-style continuous ODE scheduler (Stable Video Diffusion's).

Counterpart of `video_styler_tpu/schedulers/continuous_ode.py`: Karras
sigmas between 700 and 0.002 at rho 7 (float32 from float64 math),
timesteps log(sigma) / 4, and the Euler step of the ODE on the
c_in-scaled sample. The arithmetic takes Python floats, so it runs on
numpy arrays and on tensors of any device alike.
"""
from __future__ import annotations

import math

import numpy as np


class ContinuousODEScheduler:

    def __init__(self, num_inference_steps: int = 100, sigma_max: float = 700.0,
                 sigma_min: float = 0.002, rho: float = 7.0):
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.rho = rho
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 100, denoising_strength: float = 1.0,
                      **kwargs):
        ramp = np.linspace(1 - denoising_strength, 1, num_inference_steps, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        self.sigmas = ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho))
                       ** self.rho).astype(np.float32)
        self.timesteps = (np.log(self.sigmas) * 0.25).astype(np.float32)

    def _timestep_id(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def step(self, model_output, timestep, sample, to_final: bool = False):
        timestep_id = self._timestep_id(timestep)
        sigma = float(self.sigmas[timestep_id])
        sample = sample * math.sqrt(sigma * sigma + 1)
        estimated = (-sigma / math.sqrt(sigma * sigma + 1) * model_output
                     + 1 / (sigma * sigma + 1) * sample)
        if to_final or timestep_id + 1 >= len(self.timesteps):
            return estimated
        sigma_ = float(self.sigmas[timestep_id + 1])
        derivative = 1 / sigma * (sample - estimated)
        return (sample + derivative * (sigma_ - sigma)) / math.sqrt(sigma_ * sigma_ + 1)

    def return_to_timestep(self, timestep, sample, sample_stablized):
        raise NotImplementedError("ContinuousODEScheduler doesn't support return_to_timestep")

    def add_noise(self, original_samples, noise, timestep):
        sigma = float(self.sigmas[self._timestep_id(timestep)])
        return (original_samples + noise * sigma) / math.sqrt(sigma * sigma + 1)

    def training_target(self, sample, noise, timestep):
        sigma = float(self.sigmas[self._timestep_id(timestep)])
        c = math.sqrt(sigma * sigma + 1)
        return (-c / sigma + 1 / c / sigma) * sample + 1 / c * noise

    def training_weight(self, timestep):
        sigma = float(self.sigmas[self._timestep_id(timestep)])
        return math.sqrt(1 + sigma * sigma) / sigma
