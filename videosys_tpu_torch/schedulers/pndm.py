"""PNDM scheduler: Runge-Kutta warm-up (PRK), then linear multistep (PLMS).

Port of `videosys_tpu/schedulers/pndm.py` (diffusers' `PNDMScheduler` with
its defaults, as the Open-Sora-Plan v1.1 pipeline builds it). The scheduler
holds state between steps (the epsilon history `ets`, the Runge-Kutta
half-steps); `set_timesteps` resets it, so each `generate` starts afresh.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from videosys_tpu_torch.schedulers.ddim import add_noise_at, make_betas


@dataclasses.dataclass(frozen=True)
class PNDMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    skip_prk_steps: bool = False
    set_alpha_to_one: bool = False
    steps_offset: int = 0
    prediction_type: str = "epsilon"  # epsilon | v_prediction


class PNDMScheduler:
    pndm_order = 4

    def __init__(self, config: PNDMConfig = PNDMConfig()):
        self.config = config
        betas = make_betas(config.num_train_timesteps, config.beta_start,
                           config.beta_end, config.beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = (
            1.0 if config.set_alpha_to_one else float(self.alphas_cumprod[0]))
        self._reset_state()

    def _reset_state(self):
        self.counter = 0
        self.cur_sample = None
        self.cur_model_output = 0
        self.ets: List[torch.Tensor] = []

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The model-call ladder: PRK's paired half-steps over the last
        four points, then PLMS; resets the step state."""
        c = self.config
        T = c.num_train_timesteps
        if num_inference_steps < self.pndm_order:
            raise ValueError(f"PNDM needs at least {self.pndm_order} "
                             f"inference steps, got {num_inference_steps}")
        self.num_inference_steps = num_inference_steps
        step_ratio = T // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step_ratio).round() \
            + c.steps_offset
        if c.skip_prk_steps:
            self.prk_timesteps = np.array([], dtype=np.int64)
            plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
            self.plms_timesteps = plms.astype(np.int64).copy()
        else:
            prk = np.array(base[-self.pndm_order:]).repeat(2) + np.tile(
                np.array([0, T // num_inference_steps // 2]), self.pndm_order)
            self.prk_timesteps = (prk[:-1].repeat(2)[1:-1])[::-1].astype(
                np.int64).copy()
            self.plms_timesteps = base[:-3][::-1].astype(np.int64).copy()
        self.timesteps = np.concatenate([self.prk_timesteps,
                                         self.plms_timesteps])
        self._reset_state()
        return self.timesteps

    def _to_epsilon(self, model_output, sample, timestep: int):
        if self.config.prediction_type == "epsilon":
            return model_output
        a = float(self.alphas_cumprod[timestep])
        return a ** 0.5 * model_output + (1 - a) ** 0.5 * sample

    def _get_prev_sample(self, sample, timestep: int, prev_timestep: int,
                         model_output):
        a_t = float(self.alphas_cumprod[timestep])
        a_prev = (float(self.alphas_cumprod[prev_timestep])
                  if prev_timestep >= 0 else self.final_alpha_cumprod)
        b_t, b_prev = 1 - a_t, 1 - a_prev
        sample_coeff = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
        return sample_coeff * sample - (a_prev - a_t) * model_output / denom

    def step(self, model_output: torch.Tensor, timestep: int,
             sample: torch.Tensor) -> torch.Tensor:
        if self.counter < len(self.prk_timesteps) and not self.config.skip_prk_steps:
            return self._step_prk(model_output, int(timestep), sample)
        return self._step_plms(model_output, int(timestep), sample)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        """x0 noised to the training timestep(s) `t` (DDIM's formula)."""
        return add_noise_at(self.alphas_cumprod, x0, noise, t)

    def _step_prk(self, model_output, timestep: int, sample):
        """Runge-Kutta warm-up: four model calls per full step."""
        model_output = self._to_epsilon(model_output, sample, timestep)
        diff_to_prev = (0 if self.counter % 2 else
                        self.config.num_train_timesteps
                        // self.num_inference_steps // 2)
        prev_timestep = timestep - diff_to_prev
        timestep = int(self.prk_timesteps[self.counter // 4 * 4])
        phase = self.counter % 4
        if phase == 0:
            self.cur_model_output = self.cur_model_output + model_output / 6
            self.ets.append(model_output)
            self.cur_sample = sample
        elif phase in (1, 2):
            self.cur_model_output = self.cur_model_output + model_output / 3
        else:
            model_output = self.cur_model_output + model_output / 6
            self.cur_model_output = 0
        cur_sample = self.cur_sample if self.cur_sample is not None else sample
        prev = self._get_prev_sample(cur_sample, timestep, prev_timestep,
                                     model_output)
        self.counter += 1
        return prev

    def _step_plms(self, model_output, timestep: int, sample):
        """Linear multistep over the last (up to) four epsilons."""
        model_output = self._to_epsilon(model_output, sample, timestep)
        step_gap = self.config.num_train_timesteps // self.num_inference_steps
        prev_timestep = timestep - step_gap
        if self.counter != 1:
            self.ets = self.ets[-3:]
            self.ets.append(model_output)
        else:
            prev_timestep = timestep
            timestep = timestep + step_gap
        ets = self.ets
        if len(ets) == 1 and self.counter == 0:
            self.cur_sample = sample
        elif len(ets) == 1 and self.counter == 1:
            model_output = (model_output + ets[-1]) / 2
            sample = self.cur_sample
            self.cur_sample = None
        elif len(ets) == 2:
            model_output = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            model_output = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            model_output = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3]
                            - 9 * ets[-4]) / 24
        prev = self._get_prev_sample(sample, timestep, prev_timestep,
                                     model_output)
        self.counter += 1
        return prev
