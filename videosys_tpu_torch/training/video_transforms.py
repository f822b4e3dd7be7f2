"""Video transform suite (host-side, numpy clips; resize on torch).

Port of `videosys_tpu/training/video_transforms.py`, with the same names and
compositions. Behavioral reference:
`videosys/training/datasets/open_sora/video_transforms.py` (ResizeCrop
:195-208, RandomCropVideo :210-245, CenterCropResizeVideo :247-284,
UCFCenterCropVideo :285-320, RandomHorizontalFlipVideo :423-450,
ToTensorVideo :401-421, TemporalRandomCrop :451-...) and
`utils.py get_transforms_video :96-119`. Clips are numpy [T, H, W, C]
uint8 in, [T, H, W, C] float32 in [-1, 1] out.

The JAX package resizes with OpenCV's INTER_LINEAR; OpenCV is not a
dependency of the port, so `resize` computes the same fixed-point rule on
torch (see its docstring) and gives the same bytes.
"""

from __future__ import annotations

import numbers
from typing import Sequence, Tuple

import numpy as np
import torch


def _size2(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source rows (s0, s1) and fixed-point weights (w0, w1) of each output
    row of an INTER_LINEAR resize, as OpenCV's `resize` computes them: the
    position (d + 0.5) * src / dst - 0.5 rounded to float32, its fraction
    f, and weights round((1 - f) * 2048), round(f * 2048) (2^-11 units,
    round half to even). Along the width an edge position takes the edge
    pixel with weight 1; along the height only the rows are clamped and
    the weights stay."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(pos).astype(np.int64)
    f = pos - s.astype(np.float32)
    if clamp_weights:
        f[(s < 0) | (s >= src - 1)] = 0.0
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    return (torch.from_numpy(np.clip(s, 0, src - 1)),
            torch.from_numpy(np.clip(s + 1, 0, src - 1)),
            torch.from_numpy(w0), torch.from_numpy(w1))


def resize(clip: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of uint8 frames to exactly (H, W) (reference resize
    :45-50): half-pixel centres, no antialias, OpenCV's INTER_LINEAR in
    fixed point. Each row is the width pass, sum of pixel * weight (2^11
    scale, exact in int32); each output pixel is the height pass as
    OpenCV's vector code rounds it: ((r0 >> 4) * w0 >> 16) + ((r1 >> 4) *
    w1 >> 16), then + 2 >> 2. Equal, byte for byte, to cv2.resize on the
    OpenCV build the tests hold it against."""
    if clip.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 frames, got {clip.dtype}")
    th, tw = target_size
    h, w = clip.shape[1:3]
    x0, x1, a0, a1 = _linear_taps(w, tw, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h, th, clamp_weights=False)
    px = torch.from_numpy(np.ascontiguousarray(clip)).to(torch.int32)
    px = px.reshape(*px.shape[:3], -1)  # [T, H, W, C]; grey frames get C = 1
    rows = px[:, :, x0] * a0[:, None] + px[:, :, x1] * a1[:, None]
    out = ((((rows[:, y0] >> 4) * b0[:, None, None]) >> 16)
           + (((rows[:, y1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8).reshape(
        clip.shape[0], th, tw, *clip.shape[3:]).numpy()


def crop(clip: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    return clip[:, i:i + h, j:j + w]


def center_crop(clip: np.ndarray, crop_size: Tuple[int, int]) -> np.ndarray:
    """(:79-91)."""
    th, tw = _size2(crop_size)
    h, w = clip.shape[1:3]
    if h < th or w < tw:
        raise ValueError(f"crop {th, tw} larger than input {h, w}")
    return crop(clip, (h - th) // 2, (w - tw) // 2, th, tw)


def center_crop_using_short_edge(clip: np.ndarray) -> np.ndarray:
    """Square center crop on the short edge (:92-106)."""
    h, w = clip.shape[1:3]
    s = min(h, w)
    return center_crop(clip, (s, s))


def resize_crop_to_fill(clip: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Scale so the target is fully covered, then center crop (:107-126) —
    the open-sora training transform ("resize_crop")."""
    th, tw = _size2(target_size)
    h, w = clip.shape[1:3]
    scale = max(th / h, tw / w)
    clip = resize(clip, (int(round(h * scale)), int(round(w * scale))))
    return center_crop(clip, (th, tw))


def hflip(clip: np.ndarray) -> np.ndarray:
    return clip[:, :, ::-1]


class ResizeCrop:
    """(:195-208)."""

    def __init__(self, size):
        self.size = _size2(size)

    def __call__(self, clip):
        return resize_crop_to_fill(clip, self.size)


class RandomCropVideo:
    """(:210-245)."""

    def __init__(self, size, rng: np.random.Generator | None = None):
        self.size = _size2(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        th, tw = self.size
        h, w = clip.shape[1:3]
        if h < th or w < tw:
            raise ValueError(f"crop {th, tw} larger than input {h, w}")
        i = int(self.rng.integers(0, h - th + 1))
        j = int(self.rng.integers(0, w - tw + 1))
        return crop(clip, i, j, th, tw)


class CenterCropResizeVideo:
    """Short-edge center crop then resize (:247-284)."""

    def __init__(self, size):
        self.size = _size2(size)

    def __call__(self, clip):
        return resize(center_crop_using_short_edge(clip), self.size)


class UCFCenterCropVideo:
    """Scale the short edge to size then square center crop (:285-320)."""

    def __init__(self, size):
        self.size = _size2(size)
        if self.size[0] != self.size[1]:
            raise ValueError("UCFCenterCropVideo expects a square size")

    def __call__(self, clip):
        h, w = clip.shape[1:3]
        scale = self.size[0] / min(h, w)
        clip = resize(clip, (int(round(h * scale)), int(round(w * scale))))
        return center_crop(clip, self.size)


class RandomHorizontalFlipVideo:
    """(:423-450)."""

    def __init__(self, p: float = 0.5, rng: np.random.Generator | None = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        return hflip(clip) if self.rng.random() < self.p else clip


class ToTensorNormalize:
    """uint8 [T, H, W, C] -> float32 in [-1, 1]: the reference's
    ToTensorVideo (:401-421, /255) + Normalize(mean 0.5, std 0.5)."""

    def __call__(self, clip):
        return clip.astype(np.float32) / 127.5 - 1.0


class TemporalRandomCrop:
    """Random temporal window of total_frames (:451-...)."""

    def __init__(self, size: int, rng: np.random.Generator | None = None):
        self.size = int(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, total_frames: int) -> Tuple[int, int]:
        begin = int(self.rng.integers(
            0, max(total_frames - self.size, 0) + 1))
        return begin, min(begin + self.size, total_frames)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip


def get_transforms_video(name: str = "center",
                         image_size: Tuple[int, int] = (256, 256)) -> Compose:
    """Named compositions (reference utils.py:96-119)."""
    if name == "center":
        assert image_size[0] == image_size[1], "center crop needs square size"
        return Compose([UCFCenterCropVideo(image_size[0]), ToTensorNormalize()])
    if name == "resize_crop":
        return Compose([ResizeCrop(image_size), ToTensorNormalize()])
    raise NotImplementedError(f"transform {name}")
