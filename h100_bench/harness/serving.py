"""What the text-to-video adapters share: which steps and which request
the check keeps (drawn from the seed), and the numbers it compares."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def steps_kept(seed: int, steps: int) -> List[int]:
    """The first, the last and one step between, drawn from the seed."""
    k = int(np.random.default_rng([int(seed), 2]).integers(1, steps - 1))
    return sorted({0, k, steps - 1})


def sample(seed: int, captures: Dict[int, dict]) -> int:
    """One completed request, drawn from the seed."""
    keys = sorted(captures)
    return keys[int(np.random.default_rng([int(seed), 3]).integers(
        0, len(keys)))]


def step_error(got, want, z_in) -> float:
    """How far a step's output lies from the reference's, as a share of
    the reference's own move from the step's input."""
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm((want - z_in).double()))


def video_mae(got, want) -> float:
    """Mean absolute difference of two uint8 videos, in levels."""
    return float((got.float() - want.float()).abs().mean())


def as_tensor(video, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(video)).to(device)
