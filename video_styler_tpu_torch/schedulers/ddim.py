"""DDIM with the zero-terminal-SNR rescale and epsilon / v prediction.

Counterpart of `video_styler_tpu/schedulers/ddim.py` (`EnhancedDDIMScheduler`):
the beta tables (scaled_linear or linear) and their cumulative products are
host numpy, every coefficient a Python float; `step`, `return_to_timestep`
and `add_noise` are linear combinations of their tensor arguments, so they
run on whatever device the tensors are on. A timestep may be a Python or
numpy number or a tensor of one element.
"""
from __future__ import annotations

import math

import numpy as np


def _scalar(timestep) -> float:
    if hasattr(timestep, "detach"):
        return float(timestep.detach().reshape(-1)[0].cpu())
    return float(np.asarray(timestep).flatten()[0])


class EnhancedDDIMScheduler:

    def __init__(self, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                 prediction_type: str = "epsilon", rescale_zero_terminal_snr: bool = False):
        self.num_train_timesteps = num_train_timesteps
        if beta_schedule == "scaled_linear":
            betas = np.square(np.linspace(math.sqrt(beta_start), math.sqrt(beta_end),
                                          num_train_timesteps, dtype=np.float32))
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
        else:
            raise NotImplementedError(f"{beta_schedule} is not implemented")
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if rescale_zero_terminal_snr:
            alphas_cumprod = self.rescale_zero_terminal_snr(alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod.tolist()
        self.set_timesteps(10)
        self.prediction_type = prediction_type

    @staticmethod
    def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
        alphas_bar_sqrt = np.sqrt(alphas_cumprod)
        a0, aT = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
        alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
        return np.square(alphas_bar_sqrt)

    def set_timesteps(self, num_inference_steps: int, denoising_strength: float = 1.0, **kwargs):
        max_timestep = max(round(self.num_train_timesteps * denoising_strength) - 1, 0)
        num_inference_steps = min(num_inference_steps, max_timestep + 1)
        if num_inference_steps == 1:
            self.timesteps = np.array([max_timestep], dtype=np.float32)
        else:
            step_length = max_timestep / (num_inference_steps - 1)
            self.timesteps = np.array(
                [round(max_timestep - i * step_length) for i in range(num_inference_steps)],
                dtype=np.float32)

    def _timestep_id(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - _scalar(timestep))))

    def coefficients(self, alpha_prod_t: float, alpha_prod_t_prev: float):
        """(weight of the sample, weight of the model output)."""
        if self.prediction_type == "epsilon":
            weight_e = math.sqrt(1 - alpha_prod_t_prev) - math.sqrt(
                alpha_prod_t_prev * (1 - alpha_prod_t) / alpha_prod_t)
            weight_x = math.sqrt(alpha_prod_t_prev / alpha_prod_t)
        elif self.prediction_type == "v_prediction":
            weight_e = -math.sqrt(alpha_prod_t_prev * (1 - alpha_prod_t)) + math.sqrt(
                alpha_prod_t * (1 - alpha_prod_t_prev))
            weight_x = math.sqrt(alpha_prod_t * alpha_prod_t_prev) + math.sqrt(
                (1 - alpha_prod_t) * (1 - alpha_prod_t_prev))
        else:
            raise NotImplementedError(f"{self.prediction_type} is not implemented")
        return weight_x, weight_e

    def denoise(self, model_output, sample, alpha_prod_t, alpha_prod_t_prev):
        weight_x, weight_e = self.coefficients(alpha_prod_t, alpha_prod_t_prev)
        return sample * weight_x + model_output * weight_e

    def step(self, model_output, timestep, sample, to_final: bool = False):
        alpha_prod_t = self.alphas_cumprod[int(_scalar(timestep))]
        timestep_id = self._timestep_id(timestep)
        if to_final or timestep_id + 1 >= len(self.timesteps):
            alpha_prod_t_prev = 1.0
        else:
            alpha_prod_t_prev = self.alphas_cumprod[int(self.timesteps[timestep_id + 1])]
        return self.denoise(model_output, sample, alpha_prod_t, alpha_prod_t_prev)

    def return_to_timestep(self, timestep, sample, sample_stablized):
        alpha_prod_t = self.alphas_cumprod[int(_scalar(timestep))]
        return (sample - math.sqrt(alpha_prod_t) * sample_stablized) / math.sqrt(1 - alpha_prod_t)

    def add_noise(self, original_samples, noise, timestep):
        a = self.alphas_cumprod[int(_scalar(timestep))]
        return math.sqrt(a) * original_samples + math.sqrt(1 - a) * noise

    def training_target(self, sample, noise, timestep):
        if self.prediction_type == "epsilon":
            return noise
        a = self.alphas_cumprod[int(_scalar(timestep))]
        return math.sqrt(a) * noise - math.sqrt(1 - a) * sample

    def training_weight(self, timestep):
        return 1.0
