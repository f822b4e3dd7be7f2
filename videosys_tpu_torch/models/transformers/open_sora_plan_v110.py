"""Open-Sora-Plan v1.1 transformer: the reference's `LatteT2V` variant.

Port of `videosys_tpu/models/transformers/open_sora_plan_v110.py`. The
architecture is Latte (`latte.py`) with optional RoPE2D on spatial and
RoPE1D on temporal attention (`use_rope`) and 65- or 221-frame checkpoints
(17 or 56 latent frames after the 4x8x8 causal VAE); this module only
specializes its config.
"""

from __future__ import annotations

import torch

from videosys_tpu_torch.models.transformers.latte import LatteConfig, LatteT2V

OpenSoraPlanV110Transformer = LatteT2V


def OpenSoraPlanV110Config(transformer_type: str = "65x512x512",
                           use_rope: bool = False,
                           dtype: torch.dtype = torch.float32,
                           **overrides) -> LatteConfig:
    """Config of the released v1.1.0 checkpoints
    (LanguageBind/Open-Sora-Plan-v1.1.0 subfolders 65x512x512 /
    221x512x512): 28 pairs, 16 heads x 72, patch 2, T5-XXL captions,
    learned sigma, sample_size 64; latent video_length = (frames - 1) // 4
    + 1."""
    frames = int(transformer_type.split("x")[0])
    defaults = dict(num_layers=28, num_heads=16, head_dim=72, in_channels=4,
                    patch_size=2, caption_channels=4096,
                    video_length=(frames - 1) // 4 + 1, sample_size=64,
                    learned_sigma=True, use_rope=use_rope, dtype=dtype)
    defaults.update(overrides)
    return LatteConfig(**defaults)
