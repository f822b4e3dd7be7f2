"""VideoSysEngine, the public entry point: builds the configured pipeline
and delegates to it; `initialize`, the reference's process setup. One
process drives one card."""

from __future__ import annotations

import random
from typing import Any, Optional

import numpy as np
import torch

from videosys_tpu_torch.utils.video import save_video as _save_video


def initialize(rank: int = 0, world_size: int = 1,
               coordinator_address: Optional[str] = None,
               seed: Optional[int] = None) -> None:
    """`videosys.initialize`: one process on one card needs no process
    group; `seed` seeds the host RNGs (random, numpy, torch's default
    generator). The pipelines draw from their own seeded generators."""
    if world_size > 1:
        raise NotImplementedError(
            "world_size > 1 is not ported yet (ROADMAP Queue 1 item 6, "
            "parallelism)")
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


class VideoSysEngine:
    """`VideoSysEngine(config).generate(prompt)`; the pipeline is
    `driver_worker` (also `pipeline`)."""

    def __init__(self, config: Any, **pipeline_kwargs):
        self.config = config
        self.driver_worker = config.pipeline_cls(config, **pipeline_kwargs)

    @property
    def pipeline(self):
        return self.driver_worker

    def generate(self, *args, **kwargs):
        return self.driver_worker.generate(*args, **kwargs)

    def save_video(self, video, output_path: str, fps: int = 24):
        return _save_video(video, output_path, fps=fps)

    def shutdown(self):
        """No worker processes to reap; kept for the reference's API."""
