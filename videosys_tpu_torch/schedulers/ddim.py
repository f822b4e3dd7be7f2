"""DDIM scheduler with host-computed coefficients.

Port of `videosys_tpu/schedulers/ddim.py` (diffusers' `DDIMScheduler` and
the CogVideoX variant with zero-SNR rescaling, the SNR shift and
v-prediction). The beta and alpha tables are float64 numpy, computed once;
`set_timesteps` gives the integer ladder and `step` is tensor math with
Python-float coefficients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = [min(1 - alpha_bar((i + 1) / num_train_timesteps) /
                     alpha_bar(i / num_train_timesteps), 0.999)
                 for i in range(num_train_timesteps)]
        return np.array(betas, dtype=np.float64)
    raise ValueError(beta_schedule)


def add_noise_at(alphas_cumprod: np.ndarray, x0: torch.Tensor,
                 noise: torch.Tensor, t) -> torch.Tensor:
    """sqrt(a_t) x0 + sqrt(1 - a_t) noise with a_t = alphas_cumprod[t] in
    fp32, for a scalar or a batch of integer timesteps `t` (broadcast over
    x0's trailing dims)."""
    table = torch.as_tensor(alphas_cumprod, dtype=torch.float32,
                            device=x0.device)
    a = table[torch.as_tensor(t, dtype=torch.long, device=x0.device)]
    a = a.reshape(a.shape + (1,) * (x0.ndim - a.ndim))
    return a ** 0.5 * x0 + (1 - a) ** 0.5 * noise


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alphas_cumprod) so that the last step has zero
    SNR and the first keeps its value (arXiv:2305.08891)."""
    sqrt_ac = np.sqrt(alphas_cumprod)
    t0, tT = sqrt_ac[0].copy(), sqrt_ac[-1].copy()
    sqrt_ac -= tT
    sqrt_ac *= t0 / (t0 - tT)
    return sqrt_ac**2


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    clip_sample: bool = False
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    timestep_spacing: str = "leading"  # leading | linspace | trailing
    rescale_betas_zero_snr: bool = False
    snr_shift_scale: float = 1.0  # CogVideoX: 3.0


class DDIMScheduler:
    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        betas = make_betas(config.num_train_timesteps, config.beta_start,
                           config.beta_end, config.beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)
        if config.snr_shift_scale != 1.0:
            # SNR shift (CogVideoX): a' = a / (s + (1 - s) a)
            s = config.snr_shift_scale
            alphas_cumprod = alphas_cumprod / (s + (1 - s) * alphas_cumprod)
        if config.rescale_betas_zero_snr:
            alphas_cumprod = rescale_zero_terminal_snr(alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod.astype(np.float64)
        self.final_alpha_cumprod = (
            1.0 if config.set_alpha_to_one else float(alphas_cumprod[0]))

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The integer timestep ladder, descending."""
        c = self.config
        T = c.num_train_timesteps
        if c.timestep_spacing == "linspace":
            ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1]
        elif c.timestep_spacing == "leading":
            step_ratio = T // num_inference_steps
            ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
            ts = ts + c.steps_offset
        elif c.timestep_spacing == "trailing":
            step_ratio = T / num_inference_steps
            ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
        else:
            raise ValueError(c.timestep_spacing)
        self.num_inference_steps = num_inference_steps
        return ts.astype(np.int64).copy()

    def alphas_for_step(self, t: int) -> Tuple[float, float]:
        """(alpha_prod_t, alpha_prod_prev) of a ladder timestep."""
        prev_t = t - self.config.num_train_timesteps // self.num_inference_steps
        a_t = float(self.alphas_cumprod[t])
        a_prev = (float(self.alphas_cumprod[prev_t]) if prev_t >= 0
                  else self.final_alpha_cumprod)
        return a_t, a_prev

    def predict_x0(self, sample: torch.Tensor, model_output: torch.Tensor,
                   alpha_prod_t: float):
        """(pred_x0, pred_eps) for the configured prediction type."""
        c = self.config
        sa, sb = alpha_prod_t**0.5, (1.0 - alpha_prod_t) ** 0.5
        if c.prediction_type == "epsilon":
            x0 = (sample - sb * model_output) / sa
            eps = model_output
        elif c.prediction_type == "v_prediction":
            x0 = sa * sample - sb * model_output
            eps = sa * model_output + sb * sample
        elif c.prediction_type == "sample":
            x0 = model_output
            eps = (sample - sa * x0) / sb
        else:
            raise ValueError(c.prediction_type)
        if c.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
            eps = (sample - sa * x0) / sb
        return x0, eps

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM update x_t -> x_{t-1} (deterministic at eta = 0)."""
        a_t, a_prev = self.alphas_for_step(int(t))
        x0, eps = self.predict_x0(sample, model_output, a_t)
        var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
        std = eta * var**0.5
        prev = a_prev**0.5 * x0 + (1 - a_prev - std**2) ** 0.5 * eps
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 needs the step's noise")
            prev = prev + std * noise
        return prev

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        """x0 noised to the training timestep(s) `t`."""
        return add_noise_at(self.alphas_cumprod, x0, noise, t)
