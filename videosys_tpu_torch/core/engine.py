"""VideoSysEngine, the public entry point: builds the configured pipeline
and delegates to it. One process drives one card."""

from __future__ import annotations

from typing import Any

from videosys_tpu_torch.utils.video import save_video as _save_video


class VideoSysEngine:
    """`VideoSysEngine(config).generate(prompt)`."""

    def __init__(self, config: Any, **pipeline_kwargs):
        self.config = config
        self.pipeline = config.pipeline_cls(config, **pipeline_kwargs)

    def generate(self, *args, **kwargs):
        return self.pipeline.generate(*args, **kwargs)

    def save_video(self, video, output_path: str, fps: int = 24):
        return _save_video(video, output_path, fps=fps)
