"""CogVideoX's DPM-solver (SDE multistep) scheduler.

Port of `videosys_tpu/schedulers/dpm_cogvideox.py`: second order in lambda
space with stochastic noise; the previous x0 prediction is threaded through
the sampling loop by the caller. The noise comes from the caller's
`draw(name, shape)`: "first" on every step, "second" only on the
second-order branch, in that order, so that a seeded run draws the same
sequence each time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from videosys_tpu_torch.schedulers.ddim import DDIMConfig, DDIMScheduler

Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CogVideoXDPMConfig(DDIMConfig):
    prediction_type: str = "v_prediction"
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"


class CogVideoXDPMScheduler(DDIMScheduler):
    """The beta and alpha tables of DDIMScheduler with its own `step`."""

    def __init__(self, config: CogVideoXDPMConfig = CogVideoXDPMConfig()):
        super().__init__(config)

    @staticmethod
    def _variables(a_t: float, a_prev: float, a_back: Optional[float]):
        # IEEE semantics: alpha 0 (the zero-SNR last step) gives lambda =
        # -inf, h = +inf and exp(-h) = 0, and the step degrades gracefully
        a_t, a_prev = np.float64(a_t), np.float64(a_prev)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            lamb = float(np.log(np.sqrt(a_t / (1 - a_t))))
            lamb_next = float(np.log(np.sqrt(a_prev / (1 - a_prev))))
            h = lamb_next - lamb
            if a_back is None:
                return h, None
            a_back = np.float64(a_back)
            lamb_prev = float(np.log(np.sqrt(a_back / (1 - a_back))))
            return h, (lamb - lamb_prev) / h

    def step(self, model_output: torch.Tensor,
             old_pred_x0: Optional[torch.Tensor], timestep: int,
             timestep_back: Optional[int], sample: torch.Tensor,
             draw: Draw) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prev_sample, pred_x0); `old_pred_x0` is None on the first step,
        which returns the first-order sample."""
        prev_t = timestep - (self.config.num_train_timesteps
                             // self.num_inference_steps)
        a_t = float(self.alphas_cumprod[timestep])
        a_prev = (float(self.alphas_cumprod[prev_t]) if prev_t >= 0
                  else self.final_alpha_cumprod)
        a_back = (float(self.alphas_cumprod[timestep_back])
                  if timestep_back is not None else None)

        x0, _ = self.predict_x0(sample, model_output, a_t)
        h, r = self._variables(a_t, a_prev, a_back)
        mult1 = ((1 - a_prev) / (1 - a_t)) ** 0.5 * float(np.exp(-h))
        mult2 = float(np.expm1(-2 * h)) * a_prev**0.5
        mult_noise = (1 - a_prev) ** 0.5 * (1 - float(np.exp(-2 * h))) ** 0.5

        noise = draw("first", tuple(sample.shape))
        prev_sample = mult1 * sample - mult2 * x0 + mult_noise * noise
        if old_pred_x0 is None or prev_t < 0:
            return prev_sample, x0

        denoised_d = (1 + 1 / (2 * r)) * x0 - 1 / (2 * r) * old_pred_x0
        noise2 = draw("second", tuple(sample.shape))
        prev_sample = mult1 * sample - mult2 * denoised_d + mult_noise * noise2
        return prev_sample, x0
