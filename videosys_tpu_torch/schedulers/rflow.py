"""Rectified-flow (RFLOW) sampling scheduler.

Port of the sampling side of `videosys_tpu/schedulers/rflow.py`: the
timestep ladder and dt ladder are computed on the host in numpy, `step` and
`apply_cfg` are tensor functions. The training losses are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def timestep_transform(t, height: float, width: float, num_frames: int,
                       base_resolution: float = 512 * 512,
                       base_num_frames: float = 1.0, scale: float = 1.0,
                       num_timesteps: float = 1.0):
    """Resolution- and duration-aware timestep warp. `num_frames` is the
    pixel frame count (17 frames -> 5 latent frames, 1 = image)."""
    t = np.asarray(t, dtype=np.float64) / num_timesteps
    ratio_space = np.sqrt(height * width / base_resolution)
    lat_frames = 1.0 if num_frames == 1 else (num_frames // 17) * 5
    ratio_time = np.sqrt(lat_frames / base_num_frames)
    ratio = ratio_space * ratio_time * scale
    new_t = ratio * t / (1 + (ratio - 1) * t)
    return (new_t * num_timesteps).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RFlowConfig:
    num_sampling_steps: int = 30
    num_timesteps: int = 1000
    cfg_scale: float = 7.0
    use_discrete_timesteps: bool = False
    use_timestep_transform: bool = True
    transform_scale: float = 1.0


class RFlowScheduler:
    def __init__(self, config: RFlowConfig = RFlowConfig()):
        self.config = config

    def prepare_timesteps(self, height: float, width: float,
                          num_frames: int) -> np.ndarray:
        """Timestep ladder t_0 > t_1 > ... (fp32)."""
        c = self.config
        n, t_max = c.num_sampling_steps, c.num_timesteps
        ts = np.array([(1.0 - i / n) * t_max for i in range(n)], dtype=np.float64)
        if c.use_discrete_timesteps:
            ts = np.round(ts)
        if c.use_timestep_transform:
            ts = timestep_transform(ts, height, width, num_frames,
                                    scale=c.transform_scale,
                                    num_timesteps=t_max)
        return ts.astype(np.float32)

    def prepare_dts(self, timesteps: np.ndarray) -> np.ndarray:
        """dt_i = (t_i - t_{i+1}) / T; the last step integrates to 0."""
        t = np.asarray(timesteps, dtype=np.float64)
        dts = np.empty_like(t)
        dts[:-1] = t[:-1] - t[1:]
        dts[-1] = t[-1]
        return (dts / self.config.num_timesteps).astype(np.float32)

    @staticmethod
    def apply_cfg(pred_cond, pred_uncond, guidance_scale):
        """Classifier-free guidance combine."""
        return pred_uncond + guidance_scale * (pred_cond - pred_uncond)

    @staticmethod
    def step(z, v_pred, dt):
        """Euler update z <- z + v * dt, dt in z's dtype."""
        return z + v_pred * torch.as_tensor(dt, dtype=z.dtype, device=z.device)
