"""Peaks of the card and the work of one attention op.

Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity), at its 700 W limit. An attention op's work is counted from its
shapes and live keys, whatever kernel ran it (the FlashAttention
convention): the forward 2 products of 2 flops a multiply-add over
(query, live key, channel); the backward 5. Bytes: q, the live keys' k
and v, and the output read or written once each (the backward adds dO
read and dq, dk, dv written), plus the key mask.
"""

from __future__ import annotations

from typing import Optional, Sequence

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12,
              "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_S = 3.35e12


def attention_work(B: int, H: int, Nq: int, Nk: int, D: int, itemsize: int,
                   live: Optional[Sequence[int]] = None,
                   backward: bool = False, masked: bool = False):
    """(flops, bytes) of one attention op. `live`: the live keys of each
    batch row (all Nk when None)."""
    keys = sum(live) if live is not None else B * Nk
    if live is not None and len(live) != B:
        raise ValueError(f"{len(live)} live counts for batch {B}")
    products = 5 if backward else 2
    flops = 2.0 * products * H * Nq * keys * D
    q_o = 2 * B * H * Nq * D  # q read, o written
    kv = 2 * H * keys * D  # k, v read
    # the backward also reads dO and writes dq, dk, dv
    elems = 2 * (q_o + kv) if backward else q_o + kv
    mask = B * Nk if masked else 0
    return flops, float(elems * itemsize + mask)


def bound_seconds(flops: float, nbytes: float, dtype: str = "bf16") -> float:
    """The least time the card could take: the larger of its compute and
    its memory bound."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)
