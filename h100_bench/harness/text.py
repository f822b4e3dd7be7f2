"""The text encoder both configurations serve: T5-v1.1-XXL's encoder at
its published widths, its weights made from the seed, and the benchmark's
own tokenizer.

`WordTokenizer` stands in for T5's sentencepiece model, which the card's
machine does not have: each word of the traffic's vocabulary gets a token
id drawn from the seed (2 .. vocab_size - 1; 0 pads, 1 ends the text), a
word outside it an id from its CRC-32. It is called as a Hugging Face
tokenizer is. The program's `T5TextEncoder` takes it and the program's
`T5EncoderModel`, loaded with the weights `harness.weights` makes; the
reference (`reference/t5.py`) takes the same token ids and remakes the
weights.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from harness import traffic
from harness import weights as hw
from reference.common import Ops, rel_l2
from reference.t5 import T5Encoder

# the tied copy of the embedding in the program's state_dict
TIED = "encoder.embed_tokens.weight"


class WordTokenizer:
    def __init__(self, words: Sequence[str], vocab_size: int, seed: int):
        ids = np.random.default_rng([int(seed), 5]).integers(
            2, vocab_size, len(words))
        self.ids = dict(zip(words, ids.tolist()))
        self.vocab_size = vocab_size

    def encode(self, texts: Sequence[str], max_length: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, max_length], mask [B, max_length]): the words' ids,
        truncated to max_length - 1, then 1, then 0."""
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [self.ids.get(w, 2 + zlib.crc32(w.encode())
                                 % (self.vocab_size - 2))
                    for w in text.split()[:max_length - 1]] + [1]
            ids[i, :len(toks)] = toks
        return ids, ids > 0

    def __call__(self, texts, max_length, **_):
        ids, mask = self.encode(texts, max_length)
        return {"input_ids": ids, "attention_mask": mask.astype(np.int64)}


def tokenizer(cfg: dict, mix: dict, seed: int) -> WordTokenizer:
    return WordTokenizer(traffic.vocabulary(mix["vocabulary"]),
                         cfg["text_encoder"]["vocab_size"], seed)


def t5_fields(cfg: dict) -> dict:
    return {k: v for k, v in cfg["text_encoder"].items() if k != "source"}


def _model(cfg: dict):
    from videosys_tpu_torch.models.text_encoders.t5 import (
        T5Config, T5EncoderModel)

    return T5EncoderModel(T5Config(**t5_fields(cfg)))


def layout(cfg: dict) -> Tuple[str, hw.Layout]:
    """("text_encoder", its (name, shape) list), the tied embedding once."""
    with torch.device("meta"):
        model = _model(cfg)
    return "text_encoder", [(k, s) for k, s in hw.layout(model) if k != TIED]


def encoder(cfg: dict, weights: Dict[str, torch.Tensor], tok: WordTokenizer,
            max_length: int, device, dtype):
    """The program's T5TextEncoder on `weights`, in `dtype` on `device`."""
    from videosys_tpu_torch.models.text_encoders.t5 import T5TextEncoder

    with torch.device("meta"):
        model = _model(cfg)
    model.load_state_dict({**weights, TIED: weights["shared.weight"]},
                          assign=True)
    return T5TextEncoder(max_length=max_length, dtype=dtype, device=device,
                         tokenizer=tok, model=model)


def features(cfg: dict, weights: Dict[str, torch.Tensor], precision: str,
             tok: WordTokenizer, texts: List[str], max_length: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's (features [B, L, d_model] float32, mask [B, L])."""
    ids, mask = tok.encode(texts, max_length)
    ids = torch.from_numpy(ids).to(device)
    mask = torch.from_numpy(mask).to(device)
    model = T5Encoder(Ops(weights, precision, device), cfg["text_encoder"])
    return model.forward(ids, mask), mask


def text_rel(cfg: dict, weights: Dict[str, torch.Tensor], precision: str,
             tok: WordTokenizer, encodes: List[Tuple[List[str], torch.Tensor]],
             max_length: int, live_only: bool, device) -> float:
    """How far the program's caption features lie from the float32
    reference's, relative L2 over every encode of a request: `encodes`
    holds (texts, the program's features) a call. `live_only`: only the
    tokens' rows count (the transformer masks the rest). With `precision`
    below float32 the reference at that precision stands in for the
    program (the control)."""
    got, want = [], []
    for texts, hidden in encodes:
        ref, mask = features(cfg, weights, "fp32", tok, texts, max_length,
                             device)
        if precision != "fp32":
            hidden = features(cfg, weights, precision, tok, texts,
                              max_length, device)[0]
        rows = mask if live_only else torch.ones_like(mask)
        got.append(hidden.float()[rows])
        want.append(ref[rows])
    return rel_l2(torch.cat(got), torch.cat(want))
