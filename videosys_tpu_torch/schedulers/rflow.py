"""Rectified-flow (RFLOW) scheduler: sampling and training losses.

Port of `videosys_tpu/schedulers/rflow.py`: the timestep ladder and dt
ladder are computed on the host in numpy, `step` and `apply_cfg` are tensor
functions. The training side draws its timesteps and noise from an explicit
`torch.Generator`, or takes them from the caller (`t=`, `noise=`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def latent_frames(num_frames: int) -> float:
    """The latent frame count the timestep warp scales by: 1 for an image,
    else 5 for every whole 17 pixel frames. 2 to 16 frames would give 0 and
    a NaN ladder (0 / 0 in the first step), so they raise; the JAX package
    has that fault (`videosys_tpu/schedulers/rflow.py:42`)."""
    if num_frames == 1:
        return 1.0
    if 2 <= num_frames <= 16:
        raise ValueError(
            f"num_frames={num_frames}: the timestep transform needs 1 or at "
            f"least 17 frames ((num_frames // 17) * 5 latent frames is 0 "
            f"for 2 to 16, a NaN ladder)")
    return float((num_frames // 17) * 5)


def timestep_transform(t, height: float, width: float, num_frames: int,
                       base_resolution: float = 512 * 512,
                       base_num_frames: float = 1.0, scale: float = 1.0,
                       num_timesteps: float = 1.0):
    """Resolution- and duration-aware timestep warp. `num_frames` is the
    pixel frame count (17 frames -> 5 latent frames, 1 = image)."""
    t = np.asarray(t, dtype=np.float64) / num_timesteps
    ratio_space = np.sqrt(height * width / base_resolution)
    ratio_time = np.sqrt(latent_frames(num_frames) / base_num_frames)
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
    sample_method: str = "uniform"  # or "logit-normal" (training)
    loc: float = 0.0
    scale: float = 1.0


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

    # ---- training ------------------------------------------------------- #

    def add_noise(self, x0, noise, t):
        """x_t = tp * x0 + (1 - tp) * noise with tp = 1 - t / T."""
        tp = 1.0 - t.float() / self.config.num_timesteps
        tp = tp.reshape(tp.shape + (1,) * (x0.ndim - tp.ndim))
        return tp * x0 + (1.0 - tp) * noise

    def sample_t(self, batch: int, generator: Optional[torch.Generator] = None,
                 device=None):
        """Training timesteps in [0, T): uniform, discrete, or logit-normal
        (the sigmoid of a normal draw)."""
        c = self.config
        kw = dict(generator=generator, device=device)
        if c.use_discrete_timesteps:
            return torch.randint(0, c.num_timesteps, (batch,), **kw).float()
        if c.sample_method == "uniform":
            return torch.rand(batch, **kw) * c.num_timesteps
        if c.sample_method == "logit-normal":
            z = torch.randn(batch, **kw) * c.scale + c.loc
            return torch.sigmoid(z) * c.num_timesteps
        raise ValueError(c.sample_method)

    def transform_training_t(self, t, height: float, width: float,
                             num_frames: int):
        """`timestep_transform` on sampled training timesteps (a tensor);
        the bucket's pixel dims make the warp ratio a host constant."""
        c = self.config
        ratio_space = float(np.sqrt(height * width / (512.0 * 512.0)))
        ratio = (ratio_space * float(np.sqrt(latent_frames(num_frames)))
                 * c.transform_scale)
        tn = t / c.num_timesteps
        return ratio * tn / (1.0 + (ratio - 1.0) * tn) * c.num_timesteps

    def training_losses(self, model_fn: Callable, x0,
                        model_kwargs: Optional[dict] = None, mask=None,
                        t=None, noise=None, weights=None,
                        height: Optional[float] = None,
                        width: Optional[float] = None,
                        num_frames: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        share: Tuple[int, int] = (0, 1)):
        """MSE(v_pred, x0 - noise) per sample, with an optional frame mask
        [B, T] (True = a noised frame that counts in the loss; False = a
        clean condition frame). x0: [B, C, T, H, W]. `t` [B] and `noise`
        (x0's shape) are drawn from `generator` unless given; a sampled t is
        warped by (height, width, num_frames) when the config asks for it.
        `share` (i, n): x0 is share i of a batch of n * B rows (a dp rank's);
        the draws are made for the whole batch and share i of them kept."""
        model_kwargs = dict(model_kwargs or {})
        if self.config.use_timestep_transform and num_frames is not None:
            latent_frames(num_frames)  # 2 to 16 frames raise
        # draws are made on the generator's device (a CPU generator gives
        # the same draws whatever device trains) and moved to x0's
        draw_dev = generator.device if generator is not None else x0.device
        i, n = share
        B = x0.shape[0]
        if t is None:
            t = self.sample_t(n * B, generator, draw_dev)[i * B:(i + 1) * B]
            t = t.to(x0.device)
            if self.config.use_timestep_transform:
                if height is None or width is None or num_frames is None:
                    raise ValueError(
                        "use_timestep_transform requires height/width/"
                        "num_frames (pixel dims) in training_losses")
                t = self.transform_training_t(t, height, width, num_frames)
        if noise is None:
            noise = torch.randn((n * B,) + tuple(x0.shape[1:]),
                                dtype=x0.dtype, device=draw_dev,
                                generator=generator)[i * B:(i + 1) * B]
            noise = noise.to(x0.device)
        x_t = self.add_noise(x0, noise, t)
        if mask is not None:
            x_t0 = self.add_noise(x0, noise, torch.zeros_like(t))
            x_t = torch.where(mask[:, None, :, None, None], x_t, x_t0)
        model_out = model_fn(x_t, t, **model_kwargs)
        v_pred = model_out.chunk(2, dim=1)[0]  # drop the predicted sigma
        err = (v_pred - (x0 - noise)) ** 2
        if weights is not None:
            w = weights[t.long()].to(err.dtype)
            err = err * w.reshape(w.shape + (1,) * (err.ndim - 1))
        if mask is None:
            return err.mean(dim=tuple(range(1, err.ndim)))
        # masked mean over frames: err [B, C, T, H, W], mask [B, T]
        err_bt = err.movedim(2, 1).reshape(err.shape[0], err.shape[2], -1)
        denom = mask.sum(dim=1) * err_bt.shape[-1]
        return (err_bt * mask[:, :, None]).sum(dim=(1, 2)) / denom
