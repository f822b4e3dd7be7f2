"""Video quality metrics: PSNR / SSIM / LPIPS (PAB eval protocol).

Behavioral reference: `eval/pab/common_metrics/calculate_psnr.py` (img_psnr
:7-16, per-frame averaging :23-60), `calculate_ssim.py` (11x11 sigma-1.5
gaussian window, C1=0.01^2 C2=0.03^2, valid crop [5:-5], per-channel mean
:6-42) and `calculate_lpips.py` (AlexNet LPIPS). The reference leans on
cv2/lpips wheels; here PSNR/SSIM are exact numpy/scipy-free re-derivations
and LPIPS degrades gracefully when the `lpips` wheel is absent (zero-egress
images don't carry its pretrained net).

Inputs follow the pipelines' output convention: uint8 [T, H, W, C] or float
in [0, 1]; `calculate_*` batch wrappers take [B, T, H, W, C].
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


def _to_float01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float64) / 255.0
    return x.astype(np.float64)


def img_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """(calculate_psnr.py:7-16): range [0,1]; mse<1e-10 -> 100."""
    mse = float(np.mean((_to_float01(img1) - _to_float01(img2)) ** 2))
    if mse < 1e-10:
        return 100.0
    return 20 * math.log10(1 / math.sqrt(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel equivalent
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(ax**2) / (2 * sigma**2))
    return k / k.sum()


def _gauss_filter_same(img: np.ndarray, size: int = 11,
                       sigma: float = 1.5) -> np.ndarray:
    """cv2.filter2D(gaussian window) with BORDER_REFLECT_101, separable."""
    k = _gaussian_kernel(size, sigma)
    pad = size // 2
    padded = np.pad(img, pad, mode="reflect")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, padded)
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), 0, tmp)


def img_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM (calculate_ssim.py:6-23): gaussian 11x11 sigma 1.5,
    valid-crop [5:-5], C1=0.01^2, C2=0.03^2 on [0,1] inputs."""
    img1 = _to_float01(img1)
    img2 = _to_float01(img2)
    C1, C2 = 0.01**2, 0.03**2

    def f(x):
        return _gauss_filter_same(x)[5:-5, 5:-5]

    mu1, mu2 = f(img1), f(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = f(img1**2) - mu1_sq
    s2 = f(img2**2) - mu2_sq
    s12 = f(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(ssim_map.mean())


def frame_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Multi-channel frame [H, W, C]: per-channel mean (:26-42)."""
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if img1.ndim == 2:
        return img_ssim(img1, img2)
    return float(np.mean([img_ssim(img1[..., c], img2[..., c])
                          for c in range(img1.shape[-1])]))


def _per_frame(videos1, videos2, frame_fn) -> Dict[str, float]:
    videos1, videos2 = np.asarray(videos1), np.asarray(videos2)
    assert videos1.shape == videos2.shape, (videos1.shape, videos2.shape)
    per_video = []
    for v1, v2 in zip(videos1, videos2):
        per_video.append([frame_fn(f1, f2) for f1, f2 in zip(v1, v2)])
    arr = np.asarray(per_video)  # [B, T]
    return {
        "value": float(arr.mean()),
        "value_std": float(arr.mean(axis=1).std()),
        "per_frame_mean": arr.mean(axis=0).tolist(),
    }


def calculate_psnr(videos1, videos2) -> Dict[str, float]:
    """Batch PSNR over [B, T, H, W, C] (calculate_psnr.py:23-60)."""
    return _per_frame(videos1, videos2, img_psnr)


def calculate_ssim(videos1, videos2) -> Dict[str, float]:
    """Batch SSIM over [B, T, H, W, C] (calculate_ssim.py:48-88)."""
    return _per_frame(videos1, videos2, frame_ssim)


def calculate_lpips(videos1, videos2) -> Optional[Dict[str, float]]:
    """Batch LPIPS (calculate_lpips.py, AlexNet). Returns None when the
    `lpips` wheel (with its pretrained net) is unavailable."""
    try:
        import lpips  # noqa: F401
        import torch
    except ImportError:
        return None
    loss_fn = lpips.LPIPS(net="alex", spatial=False)

    def frame_lpips(f1, f2):
        def prep(f):
            t = torch.from_numpy(_to_float01(f).astype(np.float32))
            return (t.permute(2, 0, 1)[None] * 2 - 1)
        with torch.no_grad():
            return float(loss_fn(prep(f1), prep(f2)))

    return _per_frame(videos1, videos2, frame_lpips)


def evaluate_pair(videos1, videos2) -> Dict[str, dict]:
    """The PAB quality protocol (eval/pab/README.md): accelerated output vs
    the same model's dense output."""
    out = {
        "psnr": calculate_psnr(videos1, videos2),
        "ssim": calculate_ssim(videos1, videos2),
    }
    lp = calculate_lpips(videos1, videos2)
    if lp is not None:
        out["lpips"] = lp
    return out
