"""Flow-Match Euler discrete scheduler (SD3-style rectified flow).

Port of `videosys_tpu/schedulers/flow_match_euler.py` (diffusers'
`FlowMatchEulerDiscreteScheduler` with its defaults, as the Vchitect
pipeline builds it). The sigma ladder sigma_i = t_i / 1000, with the
optional shift, is built in float64 numpy; the Euler update
x += (sigma_next - sigma) * v is tensor math indexed by the step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 1.0  # diffusers' default, which Vchitect uses


class FlowMatchEulerScheduler:
    def __init__(self, config: FlowMatchEulerConfig = FlowMatchEulerConfig()):
        self.config = config
        T = config.num_train_timesteps
        ts = np.linspace(1, T, T, dtype=np.float64)[::-1]
        sigmas = ts / T
        sigmas = config.shift * sigmas / (1 + (config.shift - 1) * sigmas)
        self.train_sigmas = sigmas
        self.train_timesteps = sigmas * T

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """diffusers' ladder: a linspace over t(sigma_max)..t(sigma_min)
        with t(s) = s * T, then the shift map applied (again) to ts / T.
        Returns the float64 timesteps; `sigmas` ends with 0."""
        c = self.config
        T = c.num_train_timesteps
        ts = np.linspace(self.sigma_max * T, self.sigma_min * T,
                         num_inference_steps, dtype=np.float64)
        sigmas = ts / T
        sigmas = c.shift * sigmas / (1 + (c.shift - 1) * sigmas)
        self.sigmas = np.concatenate([sigmas, [0.0]])
        self.timesteps = sigmas * T
        self.num_inference_steps = num_inference_steps
        return self.timesteps

    @property
    def sigma_min(self) -> float:
        return float(self.train_sigmas[-1])

    @property
    def sigma_max(self) -> float:
        return float(self.train_sigmas[0])

    def scale_model_input(self, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        return sample  # flow matching feeds the sample unscaled

    def scale_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                    step_index: int) -> torch.Tensor:
        """The forward process: x_sigma = (1 - sigma) x0 + sigma noise."""
        sigma = float(self.sigmas[step_index])
        return (1.0 - sigma) * x0 + sigma * noise

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> torch.Tensor:
        sigma = float(self.sigmas[step_index])
        sigma_next = float(self.sigmas[step_index + 1])
        return sample + (sigma_next - sigma) * model_output
