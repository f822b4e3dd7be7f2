#!/usr/bin/env python3
"""Where the time of the first-design kernels went: the shares that were read
before `flash_bwd_fused` and the wide-head forward were redesigned.

    python3 videosys_tpu_torch/tools/kernel_shares.py --csrc DIR

DIR holds the sources of the first design (`flash_fwd.cu`, `flash_bwd.cu`,
`flash_common.cuh` as they were before the redesign: `git archive <commit>
videosys_tpu_torch/csrc | tar -x -C build/parent`). The script builds throw-away
variants of them by text substitution, one `nvcc` each, started together, and
times them with CUDA events on the card:

  * `flash_bwd_fused` at the spatial training shape [30, 16, 405, 405, 72]
    in bf16: all three passes, each pass alone (statistics, dk/dv, dq), and
    all three with the streamed tiles loaded only once (no loads in the loop);
  * the wide-head forward at the VAE mid shape [8, 1, 6360, 6360, 512]: all
    four column splits against one split alone (grid z = 1).

The variants' results are wrong by construction; only their times are read.
Needs a CUDA card and `nvcc`; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

PASS_LOOPS = {
    1: ("  for (int q0 = 0; q0 < Nq; q0 += 64)\n"
        "    bwd_tile_loop<T, NT, MODE_STATS>"),
    2: ("  for (int k0 = 0; k0 < Nk; k0 += 64)\n"
        "    bwd_tile_loop<T, NT, MODE_DKV>"),
    4: ("  for (int q0 = 0; q0 < Nq; q0 += 64)\n"
        "    bwd_tile_loop<T, NT, MODE_DQ>"),
}
STREAM_LOADS = ("    load_tile(sY1, ld, y1, t0, n_stream, 0, DP, D, vec);\n"
                "    load_tile(sY2, ld, y2, t0, n_stream, 0, DP, D, vec);\n")
SPLITS = "  const int splits = (DP + DC - 1) / DC;\n"


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"expected exactly one match of {old!r}")
    return text.replace(old, new)


def variants(csrc: Path) -> dict:
    """{name: (source text, nvcc defines)}."""
    bwd = (csrc / "flash_bwd.cu").read_text()
    for bit, loop in PASS_LOOPS.items():
        bwd = substitute(bwd, loop, f"  if (VS_PASSES & {bit})\n" + loop)
    bwd = substitute(bwd, STREAM_LOADS,
                     "    if (!VS_NOLOAD || t0 == 0) {\n" + STREAM_LOADS + "    }\n")
    fwd = substitute((csrc / "flash_fwd.cu").read_text(), SPLITS,
                     "  const int splits = VS_ONE_SPLIT ? 1 : (DP + DC - 1) / DC;\n")
    out = {f"bwd_passes_{p}": (bwd, [f"-DVS_PASSES={p}", "-DVS_NOLOAD=0"])
           for p in (7, 1, 2, 4)}
    out["bwd_noload"] = (bwd, ["-DVS_PASSES=7", "-DVS_NOLOAD=1"])
    out["fwd_all_splits"] = (fwd, ["-DVS_ONE_SPLIT=0"])
    out["fwd_one_split"] = (fwd, ["-DVS_ONE_SPLIT=1"])
    return out


def build(csrc: Path, work: Path) -> dict:
    procs = {}
    for name, (text, defines) in variants(csrc).items():
        src = work / f"{name}.cu"
        src.write_text(text)
        lib = work / f"lib{name}.so"
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", f"-I{csrc}", *defines, "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_ms(fn, iters: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="directory with the first design's sources")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_shares: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with tempfile.TemporaryDirectory() as work:
        libs = build(args.csrc, Path(work))
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator("cuda").manual_seed(0)
        res = {"card": card}

        B, H, N, D = 30, 16, 405, 72
        q, k, v, do = (torch.randn(B, H, N, D, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        for name in ("bwd_passes_7", "bwd_passes_1", "bwd_passes_2",
                     "bwd_passes_4", "bwd_noload", "bwd_passes_7"):
            fn = libs[name].flash_bwd_fused
            fn.argtypes = [ptr] * 8 + [i32] * 6 + [f32, i32, ptr]

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                         do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), 1, B * H, H, N, N, D, D ** -0.5, 1,
                         stream)
                assert err == 0, err

            res.setdefault(name, []).append(time_ms(run, 10))

        B, H, N, D = 8, 1, 6360, 512
        q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen)
                   .bfloat16() for _ in range(3))
        o = torch.empty_like(q)
        for name in ("fwd_all_splits", "fwd_one_split", "fwd_one_split",
                     "fwd_all_splits"):
            fn = libs[name].flash_fwd
            fn.argtypes = [ptr] * 6 + [i32] * 6 + [f32, i32, ptr]

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                         o.data_ptr(), None, 1, B * H, H, N, N, D, D ** -0.5,
                         1, stream)
                assert err == 0, err

            res.setdefault(name, []).append(time_ms(run, 3))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
