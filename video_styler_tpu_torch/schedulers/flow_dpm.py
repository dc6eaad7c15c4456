"""Multistep DPM-Solver++ scheduler for rectified flow.

Counterpart of `video_styler_tpu/schedulers/flow_dpm.py`: prediction_type
'flow_prediction', algorithm dpmsolver++ or sde-dpmsolver++, solver_type
midpoint/heun, solver_order <= 3, final_sigmas_type 'zero' or 'sigma_min',
optional dynamic shift.

The state machine and the coefficients are host numpy and Python floats;
the model outputs, the history and the sample stay where the caller put
them (on the card, in fp32). The SDE variant's noise is the caller's
`noise`, or drawn from the caller's `generator` on the sample's device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class FlowDPMSolverMultistepScheduler:

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        prediction_type: str = "flow_prediction",
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        algorithm_type: str = "dpmsolver++",
        solver_type: str = "midpoint",
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        final_sigmas_type: str = "zero",
    ):
        if prediction_type != "flow_prediction":
            raise NotImplementedError(prediction_type)
        if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++"):
            raise NotImplementedError(algorithm_type)
        if solver_type not in ("midpoint", "heun"):
            solver_type = "midpoint"
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.euler_at_final = euler_at_final
        self.final_sigmas_type = final_sigmas_type

        alphas = np.linspace(1, 1 / num_train_timesteps, num_train_timesteps)[::-1].copy()
        sigmas = 1.0 - alphas
        if not use_dynamic_shifting:
            sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.sigmas = sigmas.astype(np.float32)
        self.timesteps = (sigmas * num_train_timesteps).astype(np.float32)
        self.sigma_min = float(self.sigmas[-1])
        self.sigma_max = float(self.sigmas[0])
        self._reset_state(solver_order)

    def _reset_state(self, order):
        self.model_outputs = [None] * order
        self.lower_order_nums = 0
        self._step_index = None

    @property
    def step_index(self):
        return self._step_index

    def time_shift(self, mu: float, sigma: float, t: np.ndarray):
        return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)

    def set_timesteps(self, num_inference_steps: Optional[int] = None,
                      sigmas: Optional[np.ndarray] = None,
                      mu: Optional[float] = None,
                      shift: Optional[float] = None, **kwargs):
        if self.use_dynamic_shifting and mu is None:
            raise ValueError("pass `mu` when use_dynamic_shifting=True")
        if sigmas is None:
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1).copy()[:-1]
        if self.use_dynamic_shifting:
            sigmas = self.time_shift(mu, 1.0, sigmas)
        else:
            s = self.shift if shift is None else shift
            sigmas = s * sigmas / (1 + (s - 1) * sigmas)
        if self.final_sigmas_type == "zero":
            sigma_last = 0.0
        elif self.final_sigmas_type == "sigma_min":
            sigma_last = float(self.sigmas[-1])
        else:
            raise NotImplementedError(self.final_sigmas_type)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.int64)
        self.sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        self.num_inference_steps = len(self.timesteps)
        self._reset_state(self.solver_order)

    # -- conversions ---------------------------------------------------------

    @staticmethod
    def _alpha_sigma(sigma):
        return 1 - sigma, sigma

    def _lambda(self, sigma: float) -> float:
        alpha, sig = self._alpha_sigma(sigma)
        return math.log(max(alpha, 1e-20)) - math.log(max(sig, 1e-20))

    def convert_model_output(self, model_output, sample):
        """flow velocity -> x0 prediction."""
        sigma_t = float(self.sigmas[self._step_index])
        return sample - sigma_t * model_output

    # -- updates -------------------------------------------------------------

    def dpm_solver_first_order_update(self, model_output, sample, noise=None):
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s = float(self.sigmas[self._step_index])
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        h = self._lambda(sigma_t) - self._lambda(sigma_s)
        if self.algorithm_type == "dpmsolver++":
            return ((sigma_t_ / sigma_s) * sample
                    - alpha_t * math.expm1(-h) * model_output)
        return ((sigma_t_ / sigma_s) * math.exp(-h) * sample
                + alpha_t * (1 - math.exp(-2.0 * h)) * model_output
                + sigma_t_ * math.sqrt(1.0 - math.exp(-2 * h)) * noise)

    def multistep_dpm_solver_second_order_update(self, sample, noise=None):
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s0 = float(self.sigmas[self._step_index])
        sigma_s1 = float(self.sigmas[self._step_index - 1])
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        lam_t, lam_s0, lam_s1 = (self._lambda(sigma_t),
                                 self._lambda(sigma_s0),
                                 self._lambda(sigma_s1))
        m0, m1 = self.model_outputs[-1], self.model_outputs[-2]
        h, h_0 = lam_t - lam_s0, lam_s0 - lam_s1
        r0 = h_0 / h
        D0, D1 = m0, (1.0 / r0) * (m0 - m1)
        if self.algorithm_type == "dpmsolver++":
            if self.solver_type == "midpoint":
                return ((sigma_t_ / sigma_s0) * sample
                        - alpha_t * math.expm1(-h) * D0
                        - 0.5 * alpha_t * math.expm1(-h) * D1)
            return ((sigma_t_ / sigma_s0) * sample
                    - alpha_t * math.expm1(-h) * D0
                    + alpha_t * (math.expm1(-h) / h + 1.0) * D1)
        if self.solver_type == "midpoint":
            return ((sigma_t_ / sigma_s0) * math.exp(-h) * sample
                    + alpha_t * (1 - math.exp(-2.0 * h)) * D0
                    + 0.5 * alpha_t * (1 - math.exp(-2.0 * h)) * D1
                    + sigma_t_ * math.sqrt(1.0 - math.exp(-2 * h)) * noise)
        return ((sigma_t_ / sigma_s0) * math.exp(-h) * sample
                + alpha_t * (1 - math.exp(-2.0 * h)) * D0
                + alpha_t * ((1.0 - math.exp(-2.0 * h)) / (-2.0 * h) + 1.0) * D1
                + sigma_t_ * math.sqrt(1.0 - math.exp(-2 * h)) * noise)

    def multistep_dpm_solver_third_order_update(self, sample):
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s0 = float(self.sigmas[self._step_index])
        sigma_s1 = float(self.sigmas[self._step_index - 1])
        sigma_s2 = float(self.sigmas[self._step_index - 2])
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        lam_t = self._lambda(sigma_t)
        lam_s0, lam_s1, lam_s2 = (self._lambda(sigma_s0),
                                  self._lambda(sigma_s1),
                                  self._lambda(sigma_s2))
        m0, m1, m2 = (self.model_outputs[-1], self.model_outputs[-2],
                      self.model_outputs[-3])
        h, h_0, h_1 = lam_t - lam_s0, lam_s0 - lam_s1, lam_s1 - lam_s2
        r0, r1 = h_0 / h, h_1 / h
        D0 = m0
        D1_0, D1_1 = (1.0 / r0) * (m0 - m1), (1.0 / r1) * (m1 - m2)
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
        # dpmsolver++ only, as in the JAX package (no SDE third order)
        return ((sigma_t_ / sigma_s0) * sample
                - alpha_t * math.expm1(-h) * D0
                + alpha_t * (math.expm1(-h) / h + 1.0) * D1
                - alpha_t * ((math.expm1(-h) + h) / h ** 2 - 0.5) * D2)

    # -- stepping -------------------------------------------------------------

    def index_for_timestep(self, timestep) -> int:
        indices = np.nonzero(self.timesteps == int(timestep))[0]
        pos = 1 if len(indices) > 1 else 0
        return int(indices[pos])

    def step(self, model_output, timestep, sample, noise=None,
             generator: Optional[torch.Generator] = None, **kwargs):
        """One solver step. sde-dpmsolver++ takes `noise`, or draws it from
        `generator` (on the sample's device) when no noise is given."""
        if self._step_index is None:
            self._step_index = self.index_for_timestep(timestep)

        lower_order_final = (
            self._step_index == len(self.timesteps) - 1 and
            (self.euler_at_final or
             (self.lower_order_final and len(self.timesteps) < 15) or
             self.final_sigmas_type == "zero"))
        lower_order_second = (
            self._step_index == len(self.timesteps) - 2 and
            self.lower_order_final and len(self.timesteps) < 15)

        model_output = self.convert_model_output(model_output, sample)
        self.model_outputs = self.model_outputs[1:] + [model_output]

        if self.algorithm_type == "sde-dpmsolver++" and noise is None:
            if generator is None:
                raise ValueError("sde-dpmsolver++ needs `noise` or a `generator`")
            noise = torch.randn(sample.shape, generator=generator,
                                dtype=sample.dtype, device=sample.device)

        if (self.solver_order == 1 or self.lower_order_nums < 1
                or lower_order_final):
            prev = self.dpm_solver_first_order_update(model_output, sample,
                                                      noise=noise)
        elif (self.solver_order == 2 or self.lower_order_nums < 2
              or lower_order_second):
            prev = self.multistep_dpm_solver_second_order_update(sample,
                                                                 noise=noise)
        else:
            prev = self.multistep_dpm_solver_third_order_update(sample)

        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev

    def add_noise(self, original_samples, noise, timestep):
        sigma = float(self.sigmas[self.index_for_timestep(timestep)])
        alpha, sig = self._alpha_sigma(sigma)
        return alpha * original_samples + sig * noise
