"""Shared pipeline helpers.

`bucket_text_kv` trims the padded caption tokens before cross-attention to
the smallest 64-token bucket that holds every real token of the batch. It
is exact: the trimmed tokens are masked and weigh nothing in the softmax.
`snapshot_text_encoder` loads the T5 of a local diffusers snapshot.
`rank_groups` and `request_seed` are the multi-rank plumbing every
pipeline shares (`core/parallel.py`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from videosys_tpu_torch.core import parallel as par
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


def rank_groups(config, groups: Optional[par.Groups], device
                ) -> Optional[par.Groups]:
    """This rank's process groups: `groups` as given (the counterpart of
    the JAX pipelines' `mesh=`), else, with `config.num_gpus > 1`, the
    groups of `ParallelConfig.from_world_size(num_gpus, enable_cp)` built
    over the default process group (which must exist: `VideoSysEngine`
    spawns the ranks, a `torchrun` caller calls `initialize`); None on one
    rank. Raises when the groups' size is not `num_gpus`."""
    n = config.num_gpus
    if groups is None and n > 1:
        groups = par.build_groups(par.ParallelConfig.from_world_size(
            n, enable_cp=getattr(config, "enable_cp", False)), device)
    if groups is not None and groups.world_size != n:
        raise ValueError(f"groups of {groups.world_size} ranks for "
                         f"num_gpus={n}")
    return groups


def request_seed(seed: int, groups: Optional[par.Groups]) -> int:
    """`seed`, or for a negative one a draw of rank 0's, sent to every
    rank, so that every rank starts from the same noise."""
    if seed >= 0:
        return int(seed)
    return par.broadcast_from_rank0(int(np.random.randint(0, 2**31 - 1)),
                                    groups)
