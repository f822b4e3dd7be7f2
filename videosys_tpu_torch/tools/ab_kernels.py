#!/usr/bin/env python3
"""Times the flash-attention kernels of several source trees in one call on
one card, each against its own plain version.

    python3 videosys_tpu_torch/tools/ab_kernels.py [--groups G,G] TREE [TREE ...]

A TREE is a directory that holds a `videosys_tpu_torch/` package (the
repository root, or a copy with an edited `csrc/`: `git archive HEAD
videosys_tpu_torch | tar -x -C build/exp`). Each tree runs in a process of its
own, builds its kernels into its own `build/kernels/`, and prints one JSON
line: bf16, three timings each (CUDA events), the relative L2 error against
plain and, for the backward kernels, whether two runs gave the same bits.
Groups (all by default): `fwd` the serving forward at the STDiT3 shapes
(spatial [30, 16, 1590, 1590, 72], cross to 64 masked keys, temporal [3180,
16, 15, 15, 72]), `wide` the VAE mid forward [8, 1, 6360, 6360, 512], `fused`
the fused backward at the training shapes, `dkv` `flash_bwd_dkv` at the 1080p
row [1, 16, 8160, 8160, 72] and the spatial training shape, `dq` `flash_bwd_dq`
at the same two shapes and at cross attention from 405 tokens to 300 masked
keys (a tree whose `flash_bwd_dq` still takes di, from before the dq kernel
computed it, is timed without the di and reports the di's own time in plain
PyTorch as `di_ms`), `long` the forward at the rows of more than 4096 keys
at heads up to 128 (Open-Sora-Plan v1.2 [2, 24 | 12, 9600, 9600, 96] and
[2, 24, 28800, 28800, 96], CogVideoX [2, 30 | 48 | 15, 17776, 17776, 64],
the 1080p training row [1, 16, 8160, 8160, 72]): whatever kernel the tree's
dispatch gives them (`narrow` before `flash_fwd_long`), its error over the
first 1024 rows of the first and the last (batch, head) against the plain
version, and torch's SDPA beside it. Card times drift
between calls, so compare versions only within one call, and name a tree
twice (A B B A) to see the spread. Needs a CUDA card and `nvcc`; prints the
card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
groups = sys.argv[2].split(",")
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


def ragged(B, Nk):
    lens = torch.randint(1, Nk + 1, (B,), device="cuda", generator=gen)
    lens[0] = Nk
    return torch.arange(Nk, device="cuda")[None] < lens[:, None]


def inputs(B, H, Nq, Nk, D, n=3):
    return [torch.randn(B, H, m, D, device="cuda", generator=gen).bfloat16()
            for m in (Nq, Nk, Nk, Nq)[:n]]


gen = torch.Generator("cuda").manual_seed(0)
out = {}
if "fwd" in groups:
    for name, B, H, Nq, Nk, masked in (("spatial", 30, 16, 1590, 1590, False),
                                       ("cross", 30, 16, 1590, 64, True),
                                       ("temporal", 3180, 16, 15, 15, False)):
        q, k, v = inputs(B, H, Nq, Nk, 72)
        mask = ragged(B, Nk) if masked else None
        got = fa._launch(q, k, v, None, mask)[0]
        want = fa.flash_attention_plain(q, k, v, None, mask)
        out["fwd_" + name] = {
            "rel_l2": rel_l2(got, want),
            "ms": [time_ms(lambda: fa._launch(q, k, v, None, mask), 20)
                   for _ in range(3)]}
        del q, k, v, got, want
if "wide" in groups:
    q, k, v = inputs(8, 1, 6360, 6360, 512)
    got, lse = fa._launch(q, k, v, None, None, save_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, None, None,
                                              return_lse=True)
    out["fwd_wide"] = {
        "rel_l2": rel_l2(got, want),
        "lse_err": (lse - want_lse).abs().max().item(),
        "ms": [time_ms(lambda: fa._launch(q, k, v, None, None), 10)
               for _ in range(3)]}
    del q, k, v, got, want
if "fused" in groups:
    for name, B, H, Nq, Nk, masked in (
            ("spatial", 30, 16, 405, 405, False),
            ("cross300", 30, 16, 405, 300, True),
            ("cross8", 30, 16, 405, 8, True),
            ("temporal", 810, 16, 15, 15, False)):
        q, k, v, do = inputs(B, H, Nq, Nk, 72, 4)
        mask = ragged(B, Nk) if masked else None
        got = fa.flash_bwd_fused(q, k, v, mask, do)
        again = fa.flash_bwd_fused(q, k, v, mask, do)
        want = fa.flash_attention_bwd_plain(q, k, v, mask, do)
        out["bwd_fused_" + name] = {
            "rel_l2": max(rel_l2(g, w) for g, w in zip(got, want)),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
            "ms": [time_ms(lambda: fa.flash_bwd_fused(q, k, v, mask, do), 20)
                   for _ in range(3)]}
if "long" in groups:
    import torch.nn.functional as F
    for B, H, N, D in ((2, 24, 9600, 96), (2, 12, 9600, 96),
                       (2, 24, 28800, 96), (2, 30, 17776, 64),
                       (2, 48, 17776, 64), (2, 15, 17776, 64),
                       (1, 16, 8160, 72)):
        q, k, v = inputs(B, H, N, N, D)
        got = fa._launch(q, k, v, None, None)[0]
        errs = []
        for b, h in ((0, 0), (B - 1, H - 1)):
            want = fa.flash_attention_plain(q[b:b + 1, h:h + 1, :1024],
                                            k[b:b + 1, h:h + 1],
                                            v[b:b + 1, h:h + 1])
            errs.append(rel_l2(got[b:b + 1, h:h + 1, :1024], want))
        iters = 2 if N > 20000 else 5
        row = {"variant": fa.kernel_variant(q.dtype, N, N, D),
               "rel_l2": max(errs),
               "ms": [time_ms(lambda: fa._launch(q, k, v, None, None), iters)
                      for _ in range(3)],
               "sdpa_ms": time_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v), iters)}
        out[f"long_{B}x{H}x{N}x{D}"] = row
        del q, k, v, got
if "dkv" in groups:
    for name, B, H, N in (("long_row", 1, 16, 8160), ("spatial", 30, 16, 405)):
        q, k, v, do = inputs(B, H, N, N, 72, 4)
        o, lse = fa._launch(q, k, v, None, None, save_lse=True)
        di = (do.float() * o.float()).sum(-1)
        got = fa.flash_bwd_dkv(q, k, v, None, do, lse, di)
        again = fa.flash_bwd_dkv(q, k, v, None, do, lse, di)
        want = fa.flash_attention_bwd_lse_plain(q, k, v, None, do, o, lse)[1:]
        out["bwd_dkv_" + name] = {
            "rel_l2": max(rel_l2(g, w) for g, w in zip(got, want)),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
            "ms": [time_ms(lambda: fa.flash_bwd_dkv(q, k, v, None, do, lse, di),
                           5 if N > 4096 else 20) for _ in range(3)]}
        del q, k, v, do, o, got, again, want
if "dq" in groups:
    import inspect
    computes_di = "out" in inspect.signature(fa.flash_bwd_dq).parameters
    for name, B, H, Nq, Nk, masked in (("long_row", 1, 16, 8160, 8160, False),
                                       ("spatial", 30, 16, 405, 405, False),
                                       ("cross300", 30, 16, 405, 300, True)):
        q, k, v, do = inputs(B, H, Nq, Nk, 72, 4)
        mask = ragged(B, Nk) if masked else None
        o, lse = fa._launch(q, k, v, None, mask, save_lse=True)
        want_di = (do.float() * o.float()).sum(-1)
        if computes_di:
            run = lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, o)
            got, di = run()
            again = run()
            row = {"di_rel": ((di - want_di).abs().max()
                              / want_di.abs().max()).item()}
            same = torch.equal(got, again[0]) and torch.equal(di, again[1])
        else:
            run = lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, want_di)
            got, again = run(), run()
            row = {"di_ms": [time_ms(lambda: (do.float() * o.float()).sum(-1),
                                     20) for _ in range(3)]}
            same = torch.equal(got, again)
        want = fa.flash_attention_bwd_lse_plain(q, k, v, mask, do, o, lse)[0]
        row.update(rel_l2=rel_l2(got, want), bit_equal=same,
                   ms=[time_ms(run, 5 if Nq > 4096 else 20) for _ in range(3)])
        out["bwd_dq_" + name] = row
        del q, k, v, do, o, got, again, want
print(json.dumps(out))
'''

GROUPS = ("fwd", "wide", "fused", "dkv", "dq", "long")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    groups = ",".join(GROUPS)
    if args[:1] == ["--groups"]:
        groups, args = args[1], args[2:]
    if not args or not set(groups.split(",")) <= set(GROUPS):
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
    for tree in args:
        tree = os.path.abspath(tree)  # the child checks where it imported from
        proc = subprocess.run([sys.executable, "-c", CHILD, tree, groups],
                              capture_output=True, text=True)
        print(f"{tree}: {proc.stdout.strip()[-4000:]}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
