"""Directory-pair video evaluation (the on-disk PAB protocol).

Port of `videosys_tpu/eval/batch_eval.py` (numpy; imageio and PIL are
imported inside the functions that read and resize).

Behavioral reference: `eval/pab/common_metrics/eval.py` (load_video via
imageio :25-42, keep-aspect resize + center-crop of the ground-truth clip to
the generated clip's geometry :55-74, id pairing by filename :76-88) and
`batch_eval.py` (batched aggregation). The reference stacks frames on CUDA
torch tensors; here videos are numpy [T, H, W, C] uint8 and the metric math
is `videosys_tpu_torch.eval.metrics` (exact re-derivations of the reference's
cv2 formulas). LPIPS joins the report only when the `lpips` wheel and its
pretrained net are importable (zero-egress images don't carry them).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from videosys_tpu_torch.eval.metrics import calculate_lpips, calculate_psnr, calculate_ssim


def load_video(video_path: str) -> np.ndarray:
    """Read a video file into uint8 [T, H, W, C] (eval.py:25-42)."""
    import imageio

    reader = imageio.get_reader(video_path)
    frames = [np.asarray(frame) for frame in reader]
    reader.close()
    if not frames:
        raise ValueError(f"No frames decoded from {video_path}")
    return np.stack(frames)


def resize_video(video: np.ndarray, target_height: int,
                 target_width: int) -> np.ndarray:
    """Bilinear per-frame resize (eval.py resize_video :45-50). The reference
    uses torchvision F.resize with antialias — PIL's BILINEAR resize is the
    filter torchvision's antialiased path replicates."""
    from PIL import Image

    out = [np.asarray(Image.fromarray(frame).resize(
        (target_width, target_height), Image.BILINEAR)) for frame in video]
    return np.stack(out)


def preprocess_gt_video(gt_video: np.ndarray,
                        generated_shape: Sequence[int]) -> np.ndarray:
    """Fit the ground-truth clip to the generated clip's [T, H, W] geometry:
    keep-aspect upscale when smaller, then center crop and T-trim
    (eval.py preprocess_eval_video :55-74)."""
    T_gen, H_gen, W_gen = generated_shape[0], generated_shape[1], generated_shape[2]
    T_eval, H_eval, W_eval = gt_video.shape[:3]
    if T_eval < T_gen:
        raise ValueError(
            f"Eval video time steps ({T_eval}) are less than generated video "
            f"time steps ({T_gen}).")
    if H_eval < H_gen or W_eval < W_gen:
        resize_height = max(H_gen, int(H_gen * (H_eval / W_eval)))
        resize_width = max(W_gen, int(W_gen * (W_eval / H_eval)))
        gt_video = resize_video(gt_video, resize_height, resize_width)
        _, H_eval, W_eval = gt_video.shape[:3]
    start_h = (H_eval - H_gen) // 2
    start_w = (W_eval - W_gen) // 2
    return gt_video[:T_gen, start_h:start_h + H_gen, start_w:start_w + W_gen]


def list_video_ids(directory: str, file_extension: str = "mp4") -> List[str]:
    """Filename stems of every `.{ext}` clip in `directory` (eval.py:76-88)."""
    suffix = f".{file_extension}"
    return sorted(f[: -len(suffix)] for f in os.listdir(directory)
                  if f.endswith(suffix))


def eval_dirs(
    generated_video_dir: str,
    gt_video_dir: str,
    file_extension: str = "mp4",
    batch_size: int = 16,
    with_lpips: bool = True,
) -> Dict[str, float]:
    """Pair clips by filename stem across two directories and report mean
    PSNR/SSIM (+LPIPS when available) of generated-vs-ground-truth
    (eval.py main :76-140 / batch_eval.py). Returns the aggregate the
    reference prints, plus the clip count."""
    video_ids = list_video_ids(generated_video_dir, file_extension)
    if not video_ids:
        raise ValueError(
            "No videos found in the generated video dataset. Exiting.")

    psnr_vals: List[float] = []
    ssim_vals: List[float] = []
    lpips_vals: List[float] = []
    lpips_available = with_lpips
    for start in range(0, len(video_ids), batch_size):
        gen_batch, gt_batch = [], []
        for video_id in video_ids[start:start + batch_size]:
            gen = load_video(os.path.join(
                generated_video_dir, f"{video_id}.{file_extension}"))
            gt = load_video(os.path.join(
                gt_video_dir, f"{video_id}.{file_extension}"))
            gen_batch.append(gen)
            gt_batch.append(preprocess_gt_video(gt, gen.shape))
        gen_arr = np.stack(gen_batch)
        gt_arr = np.stack(gt_batch)
        psnr_vals.append(calculate_psnr(gen_arr, gt_arr)["value"])
        ssim_vals.append(calculate_ssim(gen_arr, gt_arr)["value"])
        if lpips_available:
            lp = calculate_lpips(gen_arr, gt_arr)
            if lp is None:
                lpips_available = False
            else:
                lpips_vals.append(lp["value"])

    out = {
        "psnr": float(np.mean(psnr_vals)),
        "ssim": float(np.mean(ssim_vals)),
        "n": len(video_ids),
    }
    if lpips_vals:
        out["lpips"] = float(np.mean(lpips_vals))
    return out
