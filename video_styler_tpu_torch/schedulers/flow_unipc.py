"""UniPC predictor-corrector multistep scheduler for rectified flow.

Counterpart of `video_styler_tpu/schedulers/flow_unipc.py` (the solver of
the Wan2.2 temporal enhancer): prediction_type 'flow_prediction',
predict_x0, solver_type bh1/bh2, solver_order <= 3, final_sigmas_type
'zero', optional dynamic shift.

The state machine and the coefficients (`_bh_coeffs`, the solve for the
rhos) are host numpy and Python floats. The model outputs, the multistep
history and the sample are tensors that stay where the caller put them (on
the card, in fp32): every update is elementwise tensor arithmetic with
Python-float coefficients, so no step copies a tensor to the host.
`set_timesteps` clears the history, so one scheduler serves many runs.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


class FlowUniPCMultistepScheduler:

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        prediction_type: str = "flow_prediction",
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        predict_x0: bool = True,
        solver_type: str = "bh2",
        lower_order_final: bool = True,
        disable_corrector: Optional[List[int]] = None,
        final_sigmas_type: str = "zero",
    ):
        if prediction_type != "flow_prediction":
            raise NotImplementedError(prediction_type)
        if solver_type not in ("bh1", "bh2"):
            solver_type = "bh2"
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.predict_x0 = predict_x0
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.disable_corrector = disable_corrector or []
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
        self.timestep_list = [None] * order
        self.lower_order_nums = 0
        self.last_sample = None
        self.this_order = None
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
        if self.final_sigmas_type != "zero":
            raise NotImplementedError(self.final_sigmas_type)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.int64)
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        self.num_inference_steps = len(self.timesteps)
        self._reset_state(self.solver_order)

    # -- conversions --------------------------------------------------------

    @staticmethod
    def _alpha_sigma(sigma):
        return 1 - sigma, sigma

    def convert_model_output(self, model_output, sample):
        """flow velocity -> x0 prediction: x0 = x - sigma * v."""
        sigma_t = float(self.sigmas[self._step_index])
        if self.predict_x0:
            return sample - sigma_t * model_output
        return sample - (1 - sigma_t) * model_output

    def _bh_coeffs(self, order: int, h: float, rks: np.ndarray):
        hh = -h if self.predict_x0 else h
        h_phi_1 = math.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        B_h = hh if self.solver_type == "bh1" else math.expm1(hh)
        R, b = [], []
        factorial_i = 1
        for i in range(1, order + 1):
            R.append(np.power(rks, i - 1))
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return np.stack(R), np.asarray(b), h_phi_1, B_h

    def _lambda(self, sigma: float) -> float:
        alpha, sig = self._alpha_sigma(sigma)
        return math.log(max(alpha, 1e-20)) - math.log(max(sig, 1e-20))

    def multistep_uni_p_bh_update(self, sample, order: int):
        m0 = self.model_outputs[-1]
        sigma_t = float(self.sigmas[self._step_index + 1])
        sigma_s0 = float(self.sigmas[self._step_index])
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        h = self._lambda(sigma_t) - self._lambda(sigma_s0)

        rks, D1s = [], []
        for i in range(1, order):
            si = self._step_index - i
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lambda(float(self.sigmas[si])) - self._lambda(sigma_s0)) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        R, b, h_phi_1, B_h = self._bh_coeffs(order, h, np.asarray(rks))

        if D1s:
            if order == 2:
                rhos_p = np.asarray([0.5])
            else:
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            pred_res = sum(float(r) * d for r, d in zip(rhos_p, D1s))
        else:
            pred_res = 0.0
        alpha_s0, sigma_s0_ = self._alpha_sigma(sigma_s0)
        if self.predict_x0:
            x_t = (sigma_t_ / sigma_s0_) * sample - alpha_t * h_phi_1 * m0
            return x_t - alpha_t * B_h * pred_res
        x_t = (alpha_t / alpha_s0) * sample - sigma_t_ * h_phi_1 * m0
        return x_t - sigma_t_ * B_h * pred_res

    def multistep_uni_c_bh_update(self, this_model_output, last_sample,
                                  this_sample, order: int):
        m0 = self.model_outputs[-1]
        sigma_t = float(self.sigmas[self._step_index])
        sigma_s0 = float(self.sigmas[self._step_index - 1])
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        alpha_s0, sigma_s0_ = self._alpha_sigma(sigma_s0)
        h = self._lambda(sigma_t) - self._lambda(sigma_s0)

        rks, D1s = [], []
        for i in range(1, order):
            si = self._step_index - (i + 1)
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lambda(float(self.sigmas[si])) - self._lambda(sigma_s0)) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        R, b, h_phi_1, B_h = self._bh_coeffs(order, h, np.asarray(rks))

        if order == 1:
            rhos_c = np.asarray([0.5])
        else:
            rhos_c = np.linalg.solve(R, b)
        corr_res = sum(float(r) * d for r, d in zip(rhos_c[:-1], D1s)) if D1s else 0.0
        D1_t = this_model_output - m0
        if self.predict_x0:
            x_t = (sigma_t_ / sigma_s0_) * last_sample - alpha_t * h_phi_1 * m0
            return x_t - alpha_t * B_h * (corr_res + float(rhos_c[-1]) * D1_t)
        x_t = (alpha_t / alpha_s0) * last_sample - sigma_t_ * h_phi_1 * m0
        return x_t - sigma_t_ * B_h * (corr_res + float(rhos_c[-1]) * D1_t)

    def index_for_timestep(self, timestep) -> int:
        indices = np.nonzero(self.timesteps == int(timestep))[0]
        pos = 1 if len(indices) > 1 else 0
        return int(indices[pos])

    def step(self, model_output, timestep, sample, **kwargs):
        if self._step_index is None:
            self._step_index = self.index_for_timestep(timestep)

        use_corrector = (self._step_index > 0
                         and self._step_index - 1 not in self.disable_corrector
                         and self.last_sample is not None)
        model_output_convert = self.convert_model_output(model_output, sample)
        if use_corrector:
            sample = self.multistep_uni_c_bh_update(
                this_model_output=model_output_convert,
                last_sample=self.last_sample, this_sample=sample,
                order=self.this_order)

        self.model_outputs = self.model_outputs[1:] + [model_output_convert]
        self.timestep_list = self.timestep_list[1:] + [timestep]

        if self.lower_order_final:
            this_order = min(self.solver_order,
                             len(self.timesteps) - self._step_index)
        else:
            this_order = self.solver_order
        self.this_order = min(this_order, self.lower_order_nums + 1)

        self.last_sample = sample
        prev_sample = self.multistep_uni_p_bh_update(sample, self.this_order)
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev_sample

    def add_noise(self, original_samples, noise, timestep):
        sigma = float(self.sigmas[self.index_for_timestep(timestep)])
        alpha, sig = self._alpha_sigma(sigma)
        return alpha * original_samples + sig * noise
