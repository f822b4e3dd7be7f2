"""Video/image saving (reference: `videosys/utils/utils.py` save_video via
imageio, `pipelines/open_sora/data_process.py:502-525` save_sample)."""

from __future__ import annotations

import os

import numpy as np


def save_video(video, output_path: str, fps: int = 24) -> str:
    """video: uint8 array [T, H, W, C]. Writes mp4 (or png if T == 1)."""
    import imageio

    video = np.asarray(video)
    if video.ndim == 5 and video.shape[0] == 1:
        video = video[0]  # tolerate a batch-1 [B, T, H, W, C] pipeline output
    elif video.ndim == 5:
        # batched multi-prompt output: one file per sample, indexed suffix
        base, ext = os.path.splitext(output_path)
        return [save_video(video[i], f"{base}_{i}{ext}", fps=fps)
                for i in range(video.shape[0])]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    if video.ndim == 4 and video.shape[0] == 1:
        output_path = output_path if output_path.endswith(".png") else output_path + ".png"
        imageio.imwrite(output_path, video[0])
        return output_path
    if not output_path.endswith(".mp4"):
        output_path += ".mp4"
    try:
        imageio.mimwrite(output_path, list(video), fps=fps)
        return output_path
    except (ValueError, ImportError):
        # no ffmpeg backend available (air-gapped image): fall back to GIF
        gif_path = output_path[: -len(".mp4")] + ".gif"
        imageio.mimwrite(gif_path, list(video), duration=1000.0 / fps)
        return gif_path
