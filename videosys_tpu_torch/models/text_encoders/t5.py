"""Offline deterministic text encoder.

Port of `StubTextEncoder` from `videosys_tpu/models/text_encoders/t5.py`:
words hash to fixed gaussian vectors, with the (embeddings [B, L, D], mask
[B, L]) contract of the T5 encoder, so the pipeline runs without weights.
The T5-XXL encoder itself is not ported yet.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch


class StubTextEncoder:
    def __init__(self, output_dim: int = 4096, max_length: int = 300,
                 device=None):
        """`device`: where `encode` puts its outputs; None is the card, and
        a CUDA device without a card raises (pass "cpu" to run there)."""
        self.output_dim = output_dim
        self.max_length = max_length
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")

    def _word_vec(self, word: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
        return np.random.default_rng(seed).standard_normal(self.output_dim).astype(np.float32)

    def encode(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L = len(texts), self.max_length
        embs = np.zeros((B, L, self.output_dim), np.float32)
        mask = np.zeros((B, L), bool)
        for i, text in enumerate(texts):
            words = text.split()[: L - 1] if text else []
            for j, w in enumerate(words):
                embs[i, j] = self._word_vec(w)
            embs[i, len(words)] = self._word_vec("</s>")
            mask[i, : len(words) + 1] = True
        return (torch.from_numpy(embs).to(self.device),
                torch.from_numpy(mask).to(self.device))
