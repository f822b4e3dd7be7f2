"""Shared pipeline helpers.

`bucket_text_kv` trims the padded caption tokens before cross-attention to
the smallest 64-token bucket that holds every real token of the batch. It
is exact: the trimmed tokens are masked and weigh nothing in the softmax.
`snapshot_text_encoder` loads the T5 of a local diffusers snapshot.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from videosys_tpu_torch.models.text_encoders.t5 import T5EncoderModel, T5TextEncoder

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


def snapshot_text_encoder(path: str, max_length: int, dtype: torch.dtype,
                          offload: bool, device,
                          option: str = "text_encoder") -> T5TextEncoder:
    """The T5 of a local snapshot: the encoder from `text_encoder/` and the
    tokenizer from `tokenizer/` (a diffusers snapshot), else both from
    `path` itself. A failure raises, naming the path and the config
    `option` that set it: a configured encoder is never replaced by the
    stub."""
    try:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no local directory {path!r}")
        from transformers import AutoTokenizer

        tok_dir = os.path.join(path, "tokenizer")
        enc_dir = os.path.join(path, "text_encoder")
        tokenizer = AutoTokenizer.from_pretrained(
            tok_dir if os.path.isdir(tok_dir) else path, local_files_only=True)
        model = T5EncoderModel.from_pretrained(
            enc_dir if os.path.isdir(enc_dir) else path, dtype)
        return T5TextEncoder(max_length=max_length, dtype=dtype,
                             offload=offload, device=device,
                             tokenizer=tokenizer, model=model)
    except Exception as e:
        raise RuntimeError(
            f"text encoder {path!r} could not be loaded ({e}); pass "
            f"{option}=None for the offline stub, or a local snapshot "
            f"path") from e
