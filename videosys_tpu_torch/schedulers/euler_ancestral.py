"""Euler-Ancestral discrete scheduler with host-computed sigmas.

Port of `videosys_tpu/schedulers/euler_ancestral.py` (diffusers'
`EulerAncestralDiscreteScheduler`, as the Open-Sora-Plan v1.2 pipeline
builds it). `set_timesteps` builds the (timestep, sigma) ladder in float64
numpy; `scale_model_input` and `step` are tensor math indexed by the step.
The ancestral noise comes from the caller's `draw(name, shape)`, asked for
"ancestral" on every step whose sigma_up is above zero.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from videosys_tpu_torch.schedulers.ddim import make_betas

Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EulerAncestralConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    timestep_spacing: str = "linspace"  # linspace | leading | trailing
    steps_offset: int = 0


class EulerAncestralScheduler:
    def __init__(self, config: EulerAncestralConfig = EulerAncestralConfig()):
        self.config = config
        betas = make_betas(config.num_train_timesteps, config.beta_start,
                           config.beta_end, config.beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.sigmas_all = np.sqrt((1 - self.alphas_cumprod)
                                  / self.alphas_cumprod)

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The float timesteps, descending; sigmas end with 0."""
        c = self.config
        T = c.num_train_timesteps
        if c.timestep_spacing == "linspace":
            ts = np.linspace(0, T - 1, num_inference_steps,
                             dtype=np.float64)[::-1]
        elif c.timestep_spacing == "leading":
            step_ratio = T // num_inference_steps
            ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
            ts = ts.astype(np.float64) + c.steps_offset
        elif c.timestep_spacing == "trailing":
            step_ratio = T / num_inference_steps
            ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.float64) - 1
        else:
            raise ValueError(c.timestep_spacing)
        sig = np.interp(ts, np.arange(T), self.sigmas_all)
        self.sigmas = np.concatenate([sig, [0.0]])
        self.timesteps = ts.copy()
        self.num_inference_steps = num_inference_steps
        return self.timesteps

    @property
    def init_noise_sigma(self) -> float:
        if self.config.timestep_spacing in ("linspace", "trailing"):
            return float(self.sigmas.max())
        return float((self.sigmas.max() ** 2 + 1) ** 0.5)

    def scale_model_input(self, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        sigma = float(self.sigmas[step_index])
        return sample / ((sigma ** 2 + 1) ** 0.5)

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, draw: Draw) -> torch.Tensor:
        """One ancestral Euler update."""
        c = self.config
        sigma = float(self.sigmas[step_index])
        if c.prediction_type == "epsilon":
            x0 = sample - sigma * model_output
        elif c.prediction_type == "v_prediction":
            x0 = model_output * (-sigma / (sigma ** 2 + 1) ** 0.5) + (
                sample / (sigma ** 2 + 1))
        else:
            raise ValueError(c.prediction_type)
        s_to = float(self.sigmas[step_index + 1])
        sigma_up = (s_to ** 2 * (sigma ** 2 - s_to ** 2) / sigma ** 2) ** 0.5
        sigma_down = (s_to ** 2 - sigma_up ** 2) ** 0.5
        prev = sample + (sample - x0) / sigma * (sigma_down - sigma)
        if sigma_up > 0:
            prev = prev + draw("ancestral", tuple(sample.shape)) * sigma_up
        return prev

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  step_indices) -> torch.Tensor:
        """x0 + sigma * noise with the ladder's fp32 sigma at each of
        `step_indices` (a scalar or one a sample, broadcast over x0's
        trailing dims); needs `set_timesteps`."""
        table = torch.as_tensor(self.sigmas, dtype=torch.float32,
                                device=x0.device)
        sig = table[torch.as_tensor(step_indices, dtype=torch.long,
                                    device=x0.device)]
        sig = sig.reshape(sig.shape + (1,) * (x0.ndim - sig.ndim))
        return x0 + sig * noise
