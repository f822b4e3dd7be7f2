"""Open-Sora condition-frame masking and looped generation helpers.

Port of `videosys_tpu/pipelines/open_sora/mask_strategy.py` on torch
tensors (the reference: `videosys/pipelines/open_sora/pipeline_open_sora.py`
:797-878).

A mask strategy string is `;`-separated groups of up to six `,`-separated
fields `loop_id, ref_id, ref_start, target_start, length, edit_ratio`
(defaults "0,0,0,0,1,0"): write `length` latent frames of reference `ref_id`
into the target starting at `target_start`, and denoise them only for the
first `edit_ratio` fraction of the schedule (0 = keep frozen).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from videosys_tpu_torch.models.autoencoders.autoencoder_open_sora import Noise

MASK_DEFAULT = ["0", "0", "0", "0", "1", "0"]


def parse_mask_strategy(mask_strategy: Optional[str]) -> List[list]:
    """(:800-816)."""
    out: List[list] = []
    if not mask_strategy:
        return out
    for mask in mask_strategy.split(";"):
        group = mask.split(",")
        if not 1 <= len(group) <= 6:
            raise ValueError(f"Invalid mask strategy: {mask}")
        group = group + MASK_DEFAULT[len(group):]
        out.append([int(g) for g in group[:5]] + [float(group[5])])
    return out


def find_nearest_point(value: int, point: int, max_value: int) -> int:
    """(:819-823): snap to the nearest multiple of `point`."""
    t = value // point
    if value % point > point / 2 and t < max_value // point - 1:
        t += 1
    return t * point


def apply_mask_strategy(
    z: torch.Tensor,
    refs: Sequence[Optional[Sequence[torch.Tensor]]],
    mask_strategies: Sequence[Optional[str]],
    loop_i: int,
    align: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Write reference latents into a copy of z and build the per-frame edit
    mask (:826-855). z: [B, C, T, h, w]; each ref: [C, T_ref, h, w].
    Returns (z, mask [B, T] float32 on z's device), mask None when no
    strategy applies to this loop."""
    z = z.clone()
    T = z.shape[2]
    masks = []
    any_mask = False
    for i, strategy in enumerate(mask_strategies):
        mask = torch.ones(T, dtype=torch.float32)
        for mst in parse_mask_strategy(strategy):
            loop_id, m_id, m_ref_start, m_target_start, m_length, edit_ratio = mst
            if loop_id != loop_i:
                continue
            any_mask = True
            ref = refs[i][m_id]
            if m_ref_start < 0:
                m_ref_start += ref.shape[1]
            if m_target_start < 0:
                m_target_start += T
            if align is not None:
                m_ref_start = find_nearest_point(m_ref_start, align, ref.shape[1])
                m_target_start = find_nearest_point(m_target_start, align, T)
            m_length = min(m_length, T - m_target_start,
                           ref.shape[1] - m_ref_start)
            z[i, :, m_target_start:m_target_start + m_length] = \
                ref[:, m_ref_start:m_ref_start + m_length].to(z)
            mask[m_target_start:m_target_start + m_length] = edit_ratio
        masks.append(mask)
    if not any_mask:
        return z, None
    return z, torch.stack(masks).to(z.device)


def append_generated(
    vae, generated_video: torch.Tensor, refs, mask_strategies,
    loop_i: int, condition_frame_length: int, condition_frame_edit: float,
    noise: Noise,
) -> Tuple[list, list]:
    """Loop mode: encode the previous clip [B, 3, T, H, W] (the encode's
    draws from `noise`) and condition the next loop on its last
    `condition_frame_length` latent frames (:858-873)."""
    ref_x = vae.encode(generated_video, noise)
    refs = list(refs)
    mask_strategies = list(mask_strategies)
    for j in range(len(refs)):
        refs[j] = [ref_x[j]] if refs[j] is None else list(refs[j]) + [ref_x[j]]
        prefix = "" if not mask_strategies[j] else mask_strategies[j] + ";"
        mask_strategies[j] = (
            f"{prefix}{loop_i},{len(refs[j]) - 1},"
            f"-{condition_frame_length},0,{condition_frame_length},"
            f"{condition_frame_edit}")
    return refs, mask_strategies


def dframe_to_frame(num: int) -> int:
    """latent frames -> pixel frames under the 17->5 temporal VAE (:876-878)."""
    if num % 5 != 0:
        raise ValueError(f"Invalid num: {num}")
    return num // 5 * 17


def load_reference(pixels, vae, device, noise: Noise) -> torch.Tensor:
    """VAE-encode a reference given as pixels [C, T, H, W] in [-1, 1] (a
    numpy array or a tensor; the encode's draws from `noise`) -> latents
    [C, T_lat, h, w].

    Reading an image or video file is not supported: the JAX package's
    file path (`videosys_tpu/pipelines/open_sora/mask_strategy.py:124`)
    imports `_resize_crop` from `videosys_tpu/training/datasets.py`, which
    defines no such function, so the reference cannot read files either."""
    if not isinstance(pixels, (np.ndarray, torch.Tensor)):
        raise NotImplementedError(
            f"reference {pixels!r}: only pixel arrays [C, T, H, W] are "
            f"supported; the JAX reference's file path imports a "
            f"`_resize_crop` that videosys_tpu/training/datasets.py does not "
            f"define (videosys_tpu/pipelines/open_sora/mask_strategy.py:124)")
    x = torch.as_tensor(pixels, dtype=torch.float32, device=device)
    return vae.encode(x[None], noise)[0]
