"""The port's rflow timestep warp raises for 2 to 16 pixel frames, where
`(num_frames // 17) * 5` latent frames is 0 and the JAX package's ladder is
NaN (0 / 0 at the first step; `videosys_tpu/schedulers/rflow.py:42`, left
as it is): in sampling (`prepare_timesteps`, so `generate`) and in
training (`training_losses`). 1 frame (an image) and 17 or more stay as
JAX computes them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.schedulers import rflow as JR
from videosys_tpu_torch.schedulers import rflow as PR


@pytest.mark.parametrize("frames", [2, 5, 16])
def test_sampling_ladder_raises(frames):
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True))
    with pytest.raises(ValueError, match=f"num_frames={frames}"):
        sched.prepare_timesteps(144.0, 256.0, frames)
    with pytest.raises(ValueError, match=f"num_frames={frames}"):
        PR.timestep_transform(np.array([1000.0]), 144.0, 256.0, frames,
                              num_timesteps=1000.0)
    # the JAX ladder at that count: NaN, which the port refuses to return
    jsched = JR.RFlowScheduler(JR.RFlowConfig(use_timestep_transform=True))
    assert np.isnan(np.asarray(jsched.prepare_timesteps(144.0, 256.0,
                                                        frames))).any()


@pytest.mark.parametrize("frames", [2, 16])
def test_training_losses_raise(frames):
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True,
                                             sample_method="logit-normal"))
    x0 = torch.zeros(1, 4, 1, 4, 4)

    def model_fn(x, t):
        raise AssertionError("the model must not run")

    with pytest.raises(ValueError, match=f"num_frames={frames}"):
        sched.training_losses(model_fn, x0, height=64.0, width=64.0,
                              num_frames=frames,
                              generator=torch.Generator().manual_seed(0))
    # given timesteps too: the frame count is checked before any draw
    with pytest.raises(ValueError, match=f"num_frames={frames}"):
        sched.training_losses(model_fn, x0, t=torch.zeros(1),
                              noise=torch.zeros_like(x0), height=64.0,
                              width=64.0, num_frames=frames)


@pytest.mark.parametrize("frames", [1, 17, 34, 51])
def test_other_counts_match_jax(frames):
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=True))
    jsched = JR.RFlowScheduler(JR.RFlowConfig(use_timestep_transform=True))
    got = sched.prepare_timesteps(240.0, 426.0, frames)
    want = np.asarray(jsched.prepare_timesteps(240.0, 426.0, frames))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t = torch.tensor([100.0, 500.0, 900.0])
    np.testing.assert_allclose(
        sched.transform_training_t(t, 240.0, 426.0, frames).numpy(),
        np.asarray(jsched.transform_training_t(jnp.asarray(t.numpy()), 240.0,
                                               426.0, frames)), rtol=1e-5)


def test_transform_off_takes_any_count():
    sched = PR.RFlowScheduler(PR.RFlowConfig(use_timestep_transform=False))
    assert np.isfinite(sched.prepare_timesteps(144.0, 256.0, 8)).all()
