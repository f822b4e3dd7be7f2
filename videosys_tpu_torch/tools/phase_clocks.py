#!/usr/bin/env python3
"""Where a block's time goes inside the two redesigned kernels: cycle counts
of each phase of the cluster kernel of `flash_bwd_fused` and of the wide-head
forward, and the device time of the fused backward's two kernels.

    python3 videosys_tpu_torch/tools/phase_clocks.py [--what-if]

The script builds throw-away copies of `csrc/flash_bwd_fused.cu` and
`csrc/flash_fwd.cu` in which thread 0 of one block reads `clock64()` at the
phase boundaries of its tile loop and adds the differences into a device
array (text substitution on the sources: it stops if a boundary is no longer
found), runs them at the spatial training shape [30, 16, 405, 405, 72] and at
the VAE mid shape [8, 1, 6360, 6360, 512] in bf16, and prints the shares. The
copies compute the same results; the clocks cost a few percent. One thread's
view of one block: the other warps of the block and the other block on the SM
run beside it. Needs a CUDA card and `nvcc`; prints the card's name and power
limit.

With `--what-if` it instead times (CUDA events) throw-away variants that
leave a part of the work out, to bound what a better version of that part
could win; their results are wrong by construction, only their times are
read: the wide-head forward with every K and V tile copied from the first
64 keys (the same bytes again and again: the copy path with nothing to miss
in L2) and with no copies after the first tile (products, softmax and
barriers alone); the fused backward with the dq shares neither pushed, nor
waited for at the cluster barrier, nor summed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "videosys_tpu_torch" / "csrc"

CLOCKS = '''
__device__ long long g_t[32];
#define TT(n) do { if (timed_block && threadIdx.x == 0) { long long t_ = clock64(); g_t[n] += t_ - t_last; t_last = t_; } } while (0)
'''
READER = '''
extern "C" void read_times(long long* out) {
  cudaMemcpyFromSymbol(out, g_t, sizeof(long long) * 32);
  long long z[32] = {0};
  cudaMemcpyToSymbol(g_t, z, sizeof(z));
}
'''


def mark(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"expected exactly one match of {old!r}")
    return text.replace(old, new)


def timed_cluster_source() -> tuple:
    s = (CSRC / "flash_bwd_fused.cu").read_text()
    s = mark(s, "namespace {\n\n// Statistics of the fused backward",
             "namespace {\n" + CLOCKS + "\n// Statistics of the fused backward")
    s = mark(s, "  const int n_tiles = (Nq + 63) / 64;\n  for (int i = 0; i < n_tiles; ++i) {\n"
             "    const int buf = i & 1;\n    const int q0 = i * 64;\n    cp_async_wait_all();\n"
             "    fence_async_shared();\n    __syncthreads();  // q tile i (and K, V) are in; tile i - 1 is done with\n"
             "    if (i + 1 < n_tiles) issue_tile(q0 + 64, buf ^ 1);",
             "  const bool timed_block = blockIdx.x == gridDim.x / 2;\n  long long t_last = clock64();\n"
             "  const int n_tiles = (Nq + 63) / 64;\n  for (int i = 0; i < n_tiles; ++i) {\n"
             "    const int buf = i & 1;\n    const int q0 = i * 64;\n    TT(0);\n    cp_async_wait_all();\n"
             "    fence_async_shared();\n    __syncthreads();  // q tile i (and K, V) are in; tile i - 1 is done with\n"
             "    TT(1);\n    if (i + 1 < n_tiles) issue_tile(q0 + 64, buf ^ 1);\n    TT(2);")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n    // P^T and dS^T = P^T * (dP^T - delta), packed as A operands",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(3);\n    // P^T and dS^T = P^T * (dP^T - delta), packed as A operands")
    s = mark(s, "    fence_async_shared();\n    // dv += P^T dO, dk += dS^T Q: depth",
             "    TT(4);\n    fence_async_shared();\n    // dv += P^T dO, dk += dS^T Q: depth")
    s = mark(s, "    wgmma_commit();\n    __syncthreads();  // dS^T of every warp is in shared memory\n",
             "    wgmma_commit();\n    __syncthreads();  // dS^T of every warp is in shared memory\n    TT(5);\n")
    s = mark(s, "    if (i > 0) {\n      cluster.barrier_wait();\n      reduce_tile(i - 1);\n    }\n    wgmma_wait();",
             "    TT(6);\n    if (i > 0) {\n      cluster.barrier_wait();\n      TT(7);\n      reduce_tile(i - 1);\n"
             "      TT(8);\n    }\n    wgmma_wait();\n    TT(9);")
    s = mark(s, "    cluster.barrier_arrive();  // this block's share of q tile i is pushed\n  }",
             "    TT(10);\n    cluster.barrier_arrive();  // this block's share of q tile i is pushed\n    TT(11);\n  }")
    s = mark(s, "  reduce_tile(n_tiles - 1);\n\n  if (warp < my_groups) {",
             "  reduce_tile(n_tiles - 1);\n  TT(12);\n\n  if (warp < my_groups) {")
    names = ["loop top", "wait for copies, fence, barrier", "issue the next tile's copies",
             "S^T, dP^T products and wait", "elementwise, dS^T to shared memory",
             "issue dk/dv products, barrier", "issue dq product", "cluster barrier wait",
             "sum the shares of the last tile", "wait for dk/dv/dq products",
             "push the dq share", "cluster barrier arrive", "last tile's wait and sum"]
    return s + READER, names


def timed_forward_source() -> tuple:
    s = (CSRC / "flash_fwd.cu").read_text()
    s = mark(s, "namespace {\n\n// Tensor-core kernel for heads padded",
             "namespace {\n" + CLOCKS + "\n// Tensor-core kernel for heads padded")
    s = mark(s, "  for (int kv0 = 0, j = 0; kv0 < Nk; kv0 += 64, ++j) {\n"
             "    cp_async_wait_all();  // K(j) (and Q) of this thread have landed\n"
             "    fence_async_shared();\n    __syncthreads();  // K(j) is in; every warp is done with V(j - 1)\n"
             "    issue_v(kv0);",
             "  const bool timed_block = blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y / 2;\n"
             "  long long t_last = clock64();\n"
             "  for (int kv0 = 0, j = 0; kv0 < Nk; kv0 += 64, ++j) {\n    TT(0);\n"
             "    cp_async_wait_all();  // K(j) (and Q) of this thread have landed\n    TT(1);\n"
             "    fence_async_shared();\n    __syncthreads();  // K(j) is in; every warp is done with V(j - 1)\n"
             "    TT(2);\n    issue_v(kv0);\n    TT(3);")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n    float* mine = sX + wg * 32 * 128;",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(4);\n    float* mine = sX + wg * 32 * 128;")
    s = mark(s, "    __syncthreads();  // both halves are out; every warp is done with K(j)\n",
             "    __syncthreads();  // both halves are out; every warp is done with K(j)\n    TT(5);\n")
    s = mark(s, "    else cp_async_commit();  // keeps the count of groups in flight the same\n",
             "    else cp_async_commit();  // keeps the count of groups in flight the same\n    TT(6);\n")
    s = mark(s, "    cp_async_wait_group<1>();  // V(j) has landed; K(j + 1) may be in flight\n"
             "    fence_async_shared();\n    __syncthreads();  // V(j) is in\n",
             "    TT(7);\n    cp_async_wait_group<1>();  // V(j) has landed; K(j + 1) may be in flight\n"
             "    TT(8);\n    fence_async_shared();\n    __syncthreads();  // V(j) is in\n    TT(9);\n")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n  }\n\n  float l[2];\n#pragma unroll\n"
             "  for (int r = 0; r < 2; ++r) {\n    l[r] = l_r[r];\n"
             "    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);\n"
             "    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);\n    if (l[r] == 0.f) l[r] = 1.f;\n  }\n"
             "  const int row = q0 + (tw / 32) * 16 + lane / 4;",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(10);\n  }\n\n  float l[2];\n#pragma unroll\n"
             "  for (int r = 0; r < 2; ++r) {\n    l[r] = l_r[r];\n"
             "    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);\n"
             "    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);\n    if (l[r] == 0.f) l[r] = 1.f;\n  }\n"
             "  const int row = q0 + (tw / 32) * 16 + lane / 4;")
    names = ["loop top", "wait for K", "fence, barrier", "issue V copies",
             "S product (half depth) and wait", "write the half, barrier",
             "issue K copies", "sum halves, softmax, rescale", "wait for V",
             "fence, barrier", "P V product and wait"]
    return s + READER, names


def what_if_sources() -> dict:
    """{name: source text} of the variants `--what-if` times."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    hot = mark(fwd, "smem_addr(sK), kb, kv0, Nk, D);", "smem_addr(sK), kb, 0, Nk, D);")
    hot = mark(hot, "smem_addr(sV), vb, kv0, Nk, D);", "smem_addr(sV), vb, 0, Nk, D);")
    none = mark(fwd, "    issue_v(kv0);\n",
                "    if (kv0 == 0) issue_v(kv0);\n    else cp_async_commit();\n")
    none = mark(none, "    if (kv0 + 64 < Nk) issue_k(kv0 + 64, j + 1);\n    else cp_async_commit();",
                "    cp_async_commit();")
    bwd = (CSRC / "flash_bwd_fused.cu").read_text()
    alone = mark(bwd, "    if (i > 0) {\n      cluster.barrier_wait();\n      reduce_tile(i - 1);\n    }\n", "")
    a = alone.index("    // push this thread's two rows of the share")
    b = alone.index("  // nobody pushes to a block after the last barrier")
    alone = alone[:a] + "  }\n" + alone[b:]
    alone = mark(alone, "  cluster.barrier_wait();\n  reduce_tile(n_tiles - 1);\n", "")
    return {"fwd": fwd, "fwd_same_tile": hot, "fwd_no_copies": none,
            "bwd": bwd, "bwd_no_dq_exchange": alone}


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


def what_if() -> int:
    import json

    import torch

    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    B, H, N, D = 8, 1, 6360, 512
    fq, fk, fv = (torch.randn(B, H, N, D, device="cuda", generator=gen)
                  .bfloat16() for _ in range(3))
    fo = torch.empty_like(fq)
    Bb, Hb, Nb, Db = 30, 16, 405, 72
    q, k, v, do = (torch.randn(Bb, Hb, Nb, Db, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(2, Bb * Hb, Nb, device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for name, text in what_if_sources().items():
            lib = build(Path(work), name, text)
            if name.startswith("fwd"):
                lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, i32, ptr]

                def run():
                    err = lib.flash_fwd(
                        fq.data_ptr(), fk.data_ptr(), fv.data_ptr(), None,
                        fo.data_ptr(), None, 1, B * H, H, N, N, D, D ** -0.5,
                        1, stream)
                    assert err == 0, err
            else:
                lib.flash_bwd_fused_mma.argtypes = \
                    [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]

                def run():
                    err = lib.flash_bwd_fused_mma(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        do.data_ptr(), stats.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), 1, Bb * Hb, Hb, Nb, Nb,
                        Db, Db ** -0.5, 1, stream)
                    assert err == 0, err
            out[name] = [time_ms(run, 10) for _ in range(2)]
    print(json.dumps(out))
    return 0


def build(work: Path, name: str, text: str):
    src = work / f"{name}.cu"
    src.write_text(text)
    lib = work / f"lib{name}.so"
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}",
         "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))


def report(title: str, lib, names, tiles: int):
    out = (ctypes.c_longlong * 32)()
    lib.read_times(out)
    total = sum(out[:len(names)])
    print(f"{title}: {total} cycles, {total / tiles:.0f} a tile")
    for n, name in enumerate(names):
        print(f"   {name:36s} {out[n]:9d} {100.0 * out[n] / total:5.1f}%")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if "--what-if" in sys.argv[1:]:
        return what_if()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as work:
        text, names = timed_cluster_source()
        lib = build(Path(work), "bwd_timed", text)
        B, H, N, D = 30, 16, 405, 72
        q, k, v, do = (torch.randn(B, H, N, D, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        stats = torch.empty(2, B * H, N, device="cuda")
        fn = lib.flash_bwd_fused_mma
        fn.argtypes = [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]

        def run_bwd():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                     do.data_ptr(), stats.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), 1, B * H, H, N, N, D,
                     D ** -0.5, 1, stream)
            assert err == 0, err

        run_bwd()
        torch.cuda.synchronize()
        lib.read_times((ctypes.c_longlong * 32)())  # drop the warm-up's
        run_bwd()
        torch.cuda.synchronize()
        report(f"cluster kernel, spatial {[B, H, N, N, D]}, one block", lib,
               names, -(-N // 64))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run_bwd()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "flash_bwd" in e.key:
                print(f"   device time {e.key.split('(')[1][21:55]:36s} "
                      f"{e.self_device_time_total / e.count / 1e3:.4f} ms "
                      f"(with the clocks in)")

        text, names = timed_forward_source()
        lib = build(Path(work), "fwd_timed", text)
        B, H, N, D = 8, 1, 6360, 512
        q, k, v = (torch.randn(B, H, N, D, device="cuda", generator=gen)
                   .bfloat16() for _ in range(3))
        o = torch.empty_like(q)
        fwd = lib.flash_fwd
        fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, i32, ptr]

        def run_fwd():
            err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                      o.data_ptr(), None, 1, B * H, H, N, N, D, D ** -0.5, 1,
                      stream)
            assert err == 0, err

        run_fwd()
        torch.cuda.synchronize()
        lib.read_times((ctypes.c_longlong * 32)())
        run_fwd()
        torch.cuda.synchronize()
        report(f"wide forward, VAE mid {[B, H, N, N, D]}, one block", lib,
               names, -(-N // 64))
    return 0


if __name__ == "__main__":
    sys.exit(main())
