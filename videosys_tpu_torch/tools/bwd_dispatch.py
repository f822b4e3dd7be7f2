#!/usr/bin/env python3
"""Times the two backward routes of `FlashAttentionFunction` against each
other at the training path's row shapes, to place `backward_variant`'s
threshold on the card's numbers.

    python3 videosys_tpu_torch/tools/bwd_dispatch.py

For each shape [B, H, Nq, Nk, 72] in bf16 (a ragged key mask where Nk is a
caption's length, none where it is a spatial row) it prints one JSON line:
the fused backward's ms (`flash_bwd_fused`: statistics + cluster kernels, or
the short-row kernel), the blocked route's ms split into `flash_bwd_dq`
(which computes di = rowsum(dO * O) first and writes it) and `flash_bwd_dkv`
(which reads it), as `FlashAttentionFunction` runs them, which route is
faster, and which one `backward_variant` picks. Times are CUDA events over 10 calls after one
warm-up. Shapes: the spatial rows of a 144p (144 tokens) and a 240p (405)
latent frame and a 480p one (1590, past the fused kernel's 512 keys), and
cross attention from 405 and 144 tokens to 8 to 512 caption keys. Needs a
CUDA card and `nvcc`; prints the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SHAPES = ([(60, 16, 144, 144), (30, 16, 405, 405), (4, 16, 1590, 1590)]
          + [(30, 16, 405, nk) for nk in (8, 64, 128, 192, 256, 300, 384, 512)]
          + [(60, 16, 144, nk) for nk in (64, 128, 300)])


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from videosys_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("bwd_dispatch: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator("cuda").manual_seed(0)
    D = 72
    for B, H, Nq, Nk in SHAPES:
        q, do = (torch.randn(B, H, Nq, D, device="cuda", generator=gen)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, H, Nk, D, device="cuda", generator=gen)
                .bfloat16() for _ in range(2))
        mask = None
        if Nk != Nq:  # a caption: ragged lengths, the first row full
            lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
            lens[0] = Nk
            mask = torch.arange(Nk, device="cuda")[None] < lens[:, None]
        out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
        di = fa.flash_bwd_dq(q, k, v, mask, do, lse, out)[1]
        row = {"shape": [B, H, Nq, Nk, D], "masked": mask is not None,
               "chosen": fa.backward_variant(B, H, Nq, Nk, D, q.dtype)}
        if fa.fused_kind(Nq, Nk, q.dtype) is not None:
            row["fused_ms"] = time_ms(
                lambda: fa.flash_bwd_fused(q, k, v, mask, do))
        blocked = {
            "dq": time_ms(lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, out)),
            "dkv": time_ms(lambda: fa.flash_bwd_dkv(q, k, v, mask, do, lse, di))}
        row["blocked_ms"] = blocked
        row["blocked_total_ms"] = sum(blocked.values())
        row["faster"] = "blocked" if row["blocked_total_ms"] < row.get(
            "fused_ms", float("inf")) else "fused"
        print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, di
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
