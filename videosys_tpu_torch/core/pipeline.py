"""Pipeline base classes."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class VideoSysPipelineOutput:
    """`.video`: uint8 array [B, T, H, W, C]."""

    video: Any


class VideoSysPipeline:
    """Subclasses implement generate(...) -> VideoSysPipelineOutput."""

    def generate(self, *args, **kwargs) -> VideoSysPipelineOutput:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> VideoSysPipelineOutput:
        return self.generate(*args, **kwargs)
