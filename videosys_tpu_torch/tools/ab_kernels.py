#!/usr/bin/env python3
"""Times the wide-head forward and the fused backward of several source trees
in one call on one card, each against its own plain version.

    python3 videosys_tpu_torch/tools/ab_kernels.py TREE [TREE ...]

A TREE is a directory that holds a `videosys_tpu_torch/` package (the
repository root, or a copy with an edited `csrc/`: `git archive HEAD
videosys_tpu_torch | tar -x -C build/exp`). Each tree runs in a process of its
own, builds its kernels into its own `build/kernels/`, and prints one JSON
line: bf16, the VAE mid forward [8, 1, 6360, 6360, 512] and the fused backward
at the training shapes, three timings each (CUDA events), the relative L2
error against plain and whether two runs gave the same bits. Card times drift
between calls, so compare versions only within one call, and name a tree
twice (A B B A) to see the spread. Needs a CUDA card and `nvcc`; prints the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from videosys_tpu_torch.ops import flash_attention as fa
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
torch.backends.cuda.matmul.allow_tf32 = False


def time_ms(fn, iters):
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


def rel_l2(got, want):
    d = got.float() - want.float()
    return d.norm().item() / want.float().norm().item()


gen = torch.Generator("cuda").manual_seed(0)
out = {}
B, H, N, D = 8, 1, 6360, 512
q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen).bfloat16()
           for _ in range(3))
got, lse = fa._launch(q, k, v, None, None, save_lse=True)
want, want_lse = fa.flash_attention_plain(q, k, v, None, None, return_lse=True)
out["fwd_wide"] = {
    "rel_l2": rel_l2(got, want),
    "lse_err": (lse - want_lse).abs().max().item(),
    "ms": [time_ms(lambda: fa._launch(q, k, v, None, None), 10)
           for _ in range(3)]}
del q, k, v, got, want
for name, B, H, Nq, Nk, masked in (
        ("spatial", 30, 16, 405, 405, False),
        ("cross300", 30, 16, 405, 300, True),
        ("cross8", 30, 16, 405, 8, True),
        ("temporal", 810, 16, 15, 15, False)):
    q, k, v, do = (torch.randn(B, H, n, 72, device="cuda", generator=gen)
                   .bfloat16() for n in (Nq, Nk, Nk, Nq))
    mask = None
    if masked:
        lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
        lens[0] = Nk
        mask = torch.arange(Nk, device="cuda")[None] < lens[:, None]
    got = fa.flash_bwd_fused(q, k, v, mask, do)
    again = fa.flash_bwd_fused(q, k, v, mask, do)
    want = fa.flash_attention_bwd_plain(q, k, v, mask, do)
    out["bwd_fused_" + name] = {
        "rel_l2": max(rel_l2(g, w) for g, w in zip(got, want)),
        "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
        "ms": [time_ms(lambda: fa.flash_bwd_fused(q, k, v, mask, do), 20)
               for _ in range(3)]}
print(json.dumps(out))
'''


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    failed = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, tree],
                              capture_output=True, text=True)
        print(f"{tree}: {proc.stdout.strip()[-4000:]}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
