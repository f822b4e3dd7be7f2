"""Shared pipeline helpers.

`bucket_text_kv` trims the padded caption tokens before cross-attention to
the smallest 64-token bucket that holds every real token of the batch. It
is exact: the trimmed tokens are masked and weigh nothing in the softmax.
"""

from __future__ import annotations

from typing import Tuple

import torch

_GRANULARITY = 64


def bucket_text_kv(y: torch.Tensor, kv_mask: torch.Tensor, max_length: int,
                   granularity: int = _GRANULARITY,
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """y: [B, L, C] padded embeddings; kv_mask: [B, L] bool (True = real).
    Returns (y[:, :Lb], kv_mask[:, :Lb], Lb), Lb a multiple of
    `granularity` capped at `max_length`."""
    n_real = int(kv_mask.sum(dim=1).max())
    lb = -(-max(n_real, 1) // granularity) * granularity
    lb = min(int(max_length), lb)
    if lb >= y.shape[1]:
        return y, kv_mask, y.shape[1]
    return y[:, :lb], kv_mask[:, :lb], lb
