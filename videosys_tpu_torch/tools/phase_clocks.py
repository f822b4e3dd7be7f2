#!/usr/bin/env python3
"""Where a block's time goes inside the redesigned tile kernels: cycle counts
of each phase of the cluster kernel of `flash_bwd_fused`, of the wide-head
forward, of the narrow forward, of the long-row forward (its consumer
warpgroup 0 and its producer warp apart), of the dk/dv kernel and of the dq
kernel, and the device time of the fused backward's two kernels.

    python3 videosys_tpu_torch/tools/phase_clocks.py [--what-if]
        [--kernels fused,wide,narrow,long96,long64,dkv,dq]

The script builds throw-away copies of `csrc/flash_bwd_fused.cu`,
`csrc/flash_fwd.cu`, `csrc/flash_fwd_long.cu`, `csrc/flash_bwd_dkv.cu` and
`csrc/flash_bwd_dq.cu` in which thread 0 of one block
reads `clock64()` at the phase boundaries of its tile loop and adds the
differences into a device array (text substitution on the sources: it stops
if a boundary is no longer found), runs them at the spatial training shape
[30, 16, 405, 405, 72], at the VAE mid shape [8, 1, 6360, 6360, 512], at the
spatial serving shape [30, 16, 1590, 1590, 72], at the 1080p row [1, 16,
8160, 8160, 72] (dk/dv and dq) and, for the long-row forward, at Open-Sora-
Plan v1.2's [2, 24, 9600, 9600, 96] and CogVideoX-2b's [2, 30, 17776,
17776, 64] in bf16, and prints the shares. In the long-row forward the
producer warp's first lane reads its own clock beside thread 0:
its phases (waits for a free stage, the copies it issues) are reported
apart, as shares of its own time. The copies compute the same
results; the clocks cost a few percent. One thread's view of one block (in
the two-warpgroup kernels, warpgroup 0's): the other warps of the block and
the other blocks on the SM run beside it. Needs a CUDA card and `nvcc`;
prints the card's name and power limit.

With `--what-if` it instead times (CUDA events) throw-away variants that
leave a part of the work out, to bound what a better version of that part
could win; their results are wrong by construction, only their times are
read: the wide-head forward with every K and V tile copied from the first
64 keys (the same bytes again and again: the copy path with nothing to miss
in L2) and with no copies after the first tile (products, softmax and
barriers alone); the fused backward with the dq shares neither pushed, nor
waited for at the cluster barrier, nor summed; the narrow forward, the dk/dv
kernel and the dq kernel with no copies after the first ring of tiles.
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
# the long-row forward's: per-thread sums in registers, flushed once at the
# end of the thread's branch (a device-memory add a phase would be most of a
# 128-key tile)
CLOCKS_LONG = '''
#define TL(n) do { if (timed) { long long t_ = clock64(); t_acc[n] += t_ - t_last; t_last = t_; } } while (0)
#define TL_INIT(thread) const bool timed = blockIdx.x == gridDim.x / 2 && threadIdx.x == (thread); long long t_acc[16] = {0}; long long t_last = clock64()
#define TL_FLUSH(first, count) do { if (timed) for (int i_ = 0; i_ < (count); ++i_) g_t[(first) + i_] += t_acc[i_]; } while (0)
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
    s = mark(s, "namespace {\n\n// ---- heads up to 128 wide",
             "namespace {\n" + CLOCKS + "\n// ---- heads up to 128 wide")
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
    s = mark(s, "    if (kv0 + 64 < Nk) issue_k(kv0 + 64, j + 1);\n"
             "    else cp_async_commit();  // keeps the count of groups in flight the same\n",
             "    if (kv0 + 64 < Nk) issue_k(kv0 + 64, j + 1);\n"
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


def timed_narrow_source() -> tuple:
    s = (CSRC / "flash_fwd.cu").read_text()
    s = mark(s, "namespace {\n\n// ---- heads up to 128 wide",
             "namespace {\n" + CLOCKS + "\n// ---- heads up to 128 wide")
    s = mark(s, "  for (int j = 0; j < n_kv; ++j) {\n    const int st = j % S;\n"
             "    const int kv0 = j * 64;\n"
             "    if (!vec) fence_async_shared();  // this thread's stores of tile j\n"
             "    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed\n"
             "    __syncthreads();  // tile j is in; both warpgroups are done with tile j - 1\n",
             "  const bool timed_block = blockIdx.x == gridDim.x / 2;\n  long long t_last = clock64();\n"
             "  for (int j = 0; j < n_kv; ++j) {\n    const int st = j % S;\n"
             "    const int kv0 = j * 64;\n    TT(0);\n"
             "    if (!vec) fence_async_shared();  // this thread's stores of tile j\n"
             "    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed\n    TT(1);\n"
             "    __syncthreads();  // tile j is in; both warpgroups are done with tile j - 1\n    TT(2);\n")
    s = mark(s, "    if (!live) continue;\n    const uint32_t k_addr = smem_addr(sK0 + st * TILE);",
             "    TT(3);\n    if (!live) continue;\n    const uint32_t k_addr = smem_addr(sK0 + st * TILE);")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n\n"
             "    // scale to log2 units, mask (only tiles that need it), running max\n"
             "    const bool plain_tile = mrow == nullptr && kv0 + 64 <= Nk;\n"
             "    const int8_t* sM = sF0 + st * 64;",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(4);\n\n"
             "    // scale to log2 units, mask (only tiles that need it), running max\n"
             "    const bool plain_tile = mrow == nullptr && kv0 + 64 <= Nk;\n"
             "    const int8_t* sM = sF0 + st * 64;")
    s = mark(s, "    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i / 2) % 2];\n\n    wgmma_fence();",
             "    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i / 2) % 2];\n    TT(5);\n\n    wgmma_fence();")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n  }\n  if (!live) return;\n",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(6);\n  }\n  if (!live) return;\n")
    s = mark(s, "                                1 + wg);\n}\n\n// ---- short rows",
             "                                1 + wg);\n  TT(7);\n}\n\n// ---- short rows")
    names = ["loop top", "wait for copies", "fence, barrier", "issue the copies of tile j + 2",
             "S product and wait", "softmax, rescale", "P V product and wait",
             "epilogue: lse, output through shared memory"]
    return s + READER, names


def timed_long_source() -> tuple:
    """The long-row forward with clocks: thread 0's at g_t[0..9] (one key
    tile of the loop), the producer's first lane (thread 128 * its consumer
    warpgroups) at g_t[10..14]."""
    s = (CSRC / "flash_fwd_long.cu").read_text()
    s = mark(s, "namespace {\n\nconstexpr int LONG_KEYS",
             "namespace {\n" + CLOCKS + CLOCKS_LONG + "\nconstexpr int LONG_KEYS")
    s = mark(s, "    const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;\n",
             "    const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;\n"
             "    TL_INIT(128 * NWG);\n")
    s = mark(s, "      if (j >= S) mbar_wait(empty_k + st, (j / S - 1) & 1);\n",
             "      TL(0);\n      if (j >= S) mbar_wait(empty_k + st, (j / S - 1) & 1);\n"
             "      TL(1);\n")
    s = mark(s, "      if (j >= S) mbar_wait(empty_v + st, (j / S - 1) & 1);\n",
             "      TL(2);\n      if (j >= S) mbar_wait(empty_v + st, (j / S - 1) & 1);\n"
             "      TL(3);\n")
    s = mark(s, "        KL::load(smem_addr(sV0 + st * KL::BYTES), tm_v, kv0, bh, full_v + st);\n"
             "      }\n    }\n  } else {\n",
             "        KL::load(smem_addr(sV0 + st * KL::BYTES), tm_v, kv0, bh, full_v + st);\n"
             "      }\n      TL(4);\n    }\n    TL_FLUSH(10, 5);\n  } else {\n")
    s = mark(s, "      const int row0 = q0 + wg * 64;\n",
             "      const int row0 = q0 + wg * 64;\n      TL_INIT(0);\n")
    s = mark(s, "        mbar_wait(full_k + stk, (j / S) & 1);\n"
             "        named_sync(SCHED_BAR + wg, 256);\n",
             "        TL(0);\n        mbar_wait(full_k + stk, (j / S) & 1);\n        TL(1);\n"
             "        named_sync(SCHED_BAR + wg, 256);\n        TL(2);\n")
    s = mark(s, "        score(stk);\n        wgmma_commit();\n",
             "        score(stk);\n        wgmma_commit();\n        TL(3);\n")
    s = mark(s, "        mbar_wait(full_v + stv, ((j - 1) / S) & 1);\n        value(stv);",
             "        mbar_wait(full_v + stv, ((j - 1) / S) & 1);\n        TL(4);\n        value(stv);")
    s = mark(s, "        named_arrive(SCHED_BAR + (wg + 1) % NWG, 256);\n"
             "        wait_wgmma<1>();  // S_j is out; the value product may still run\n"
             "        pin<64>(s);\n",
             "        named_arrive(SCHED_BAR + (wg + 1) % NWG, 256);\n        TL(5);\n"
             "        wait_wgmma<1>();  // S_j is out; the value product may still run\n"
             "        pin<64>(s);\n        TL(6);\n")
    s = mark(s, "        warp_arrive(empty_k + stk, lane);\n        wait_wgmma<0>();\n"
             "        pin<NACC>(acc);\n        pin<64>(s);\n",
             "        TL(7);\n        warp_arrive(empty_k + stk, lane);\n        wait_wgmma<0>();\n"
             "        pin<NACC>(acc);\n        pin<64>(s);\n        TL(8);\n")
    s = mark(s, "        pack();\n      }\n      // the last value product\n",
             "        pack();\n        TL(9);\n      }\n      // the last value product\n")
    s = mark(s, "STORE_BAR + wg);\n    }\n  }\n}\n",
             "STORE_BAR + wg);\n      TL_FLUSH(0, 10);\n    }\n  }\n}\n")
    names = ["tile end to loop top", "wait for K", "wait for the tensor cores",
             "issue S", "wait for V", "issue P V, hand over", "wait for S",
             "softmax (P V running)", "wait for P V", "rescale, pack P"]
    producer = ["loop top (Q before the first)", "wait for a free K stage",
                "key flags, K copies", "wait for a free V stage", "V copies"]
    return s + READER, names, producer


def timed_dkv_source() -> tuple:
    s = (CSRC / "flash_bwd_dkv.cu").read_text()
    s = mark(s, "namespace {\n\nconstexpr int DKV_THREADS",
             "namespace {\n" + CLOCKS + "\nconstexpr int DKV_THREADS")
    s = mark(s, "  for (int i = 0; i < n_q; ++i) {\n    const int st = i % S;\n"
             "    cp_async_wait_group<S - 2>();  // lse and di of tile i (this thread's)\n"
             "    if (!vec) fence_async_shared();  // this thread's stores of tile i\n"
             "    else if (live) mbar_wait(bar + st, (i / S) & 1);  // Q, dO of tile i\n"
             "    __syncthreads();  // tile i is in; both warpgroups are done with tile i - 1\n",
             "  const bool timed_block = blockIdx.x == gridDim.x / 2;\n  long long t_last = clock64();\n"
             "  for (int i = 0; i < n_q; ++i) {\n    const int st = i % S;\n    TT(0);\n"
             "    cp_async_wait_group<S - 2>();  // lse and di of tile i (this thread's)\n"
             "    if (!vec) fence_async_shared();  // this thread's stores of tile i\n"
             "    else if (live) mbar_wait(bar + st, (i / S) & 1);  // Q, dO of tile i\n    TT(1);\n"
             "    __syncthreads();  // tile i is in; both warpgroups are done with tile i - 1\n    TT(2);\n")
    s = mark(s, "    if (!live) continue;\n    const uint32_t q_addr",
             "    TT(3);\n    if (!live) continue;\n    const uint32_t q_addr")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n    // P^T and dS^T = P^T * (dP^T - di), packed as A operands",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(4);\n    // P^T and dS^T = P^T * (dP^T - di), packed as A operands")
    s = mark(s, "    // dv += P^T dO, dk += dS^T Q: depth = the 64 q rows, four 16-row steps",
             "    TT(5);\n    // dv += P^T dO, dk += dS^T Q: depth = the 64 q rows, four 16-row steps")
    s = mark(s, "    wgmma_commit();\n    wgmma_wait();\n  }\n  if (!live) return;\n",
             "    wgmma_commit();\n    wgmma_wait();\n    TT(6);\n  }\n  if (!live) return;\n")
    s = mark(s, "                                1 + wg);\n}\n\ntemplate <typename T, int DP>\ncudaError_t launch_dkv(",
             "                                1 + wg);\n  TT(7);\n}\n\ntemplate <typename T, int DP>\ncudaError_t launch_dkv(")
    names = ["loop top", "wait for copies", "fence, barrier", "issue the copies of tile i + 2",
             "S^T, dP^T products and wait", "elementwise P^T, dS^T",
             "dv, dk products and wait", "epilogue: dk, dv through shared memory"]
    return s + READER, names


def timed_dq_source() -> tuple:
    s = (CSRC / "flash_bwd_dq.cu").read_text()
    s = mark(s, "namespace {\n\nconstexpr int DQ_THREADS",
             "namespace {\n" + CLOCKS + "\nconstexpr int DQ_THREADS")
    s = mark(s, "  if (!vec) __syncthreads();  // every thread's stores of Q and dO\n",
             "  const bool timed_block = blockIdx.x == gridDim.x / 2;\n  long long t_last = clock64();\n"
             "  if (!vec) __syncthreads();  // every thread's stores of Q and dO\n")
    s = mark(s, "  float acc[NACC];\n#pragma unroll\n  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;\n"
             "  const uint32_t q_addr",
             "  TT(0);\n  float acc[NACC];\n#pragma unroll\n  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;\n"
             "  const uint32_t q_addr")
    s = mark(s, "    if (!vec) fence_async_shared();  // this thread's stores of tile j\n"
             "    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed\n"
             "    __syncthreads();  // tile j is in; both warpgroups are done with tile j - 1\n",
             "    TT(1);\n    if (!vec) fence_async_shared();  // this thread's stores of tile j\n"
             "    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed\n    TT(2);\n"
             "    __syncthreads();  // tile j is in; both warpgroups are done with tile j - 1\n    TT(3);\n")
    s = mark(s, "    if (!live) continue;\n    const uint32_t k_addr",
             "    TT(4);\n    if (!live) continue;\n    const uint32_t k_addr")
    s = mark(s, "    wgmma_wait_n<1>();  // S is out; dP of the first half may still run\n",
             "    wgmma_wait_n<1>();  // S is out; dP of the first half may still run\n    TT(5);\n")
    s = mark(s, "    // per half: dS = P (dP - di), packed as the A operand of dq += dS K;\n",
             "    TT(6);\n    // per half: dS = P (dP - di), packed as the A operand of dq += dS K;\n")
    s = mark(s, "      wgmma_wait_n<0>();\n      fence_regs<16>(dp);\n",
             "      TT(7);\n      wgmma_wait_n<0>();\n      fence_regs<16>(dp);\n      TT(8);\n")
    s = mark(s, "    wgmma_wait_n<0>();\n  }\n  if (!live) return;\n",
             "    TT(7);\n    wgmma_wait_n<0>();\n    TT(9);\n  }\n  if (!live) return;\n")
    s = mark(s, "                                1 + wg);\n}\n\ntemplate <typename T, int DP>\ncudaError_t launch_dq(",
             "                                1 + wg);\n  TT(10);\n}\n\ntemplate <typename T, int DP>\ncudaError_t launch_dq(")
    names = ["prologue: Q, dO wait, di, lse", "loop top", "wait for copies", "barrier",
             "issue the copies of tile j + 2", "S product and wait (dP issued)",
             "P while dP runs", "dS of a half, issue dq (and dP) products",
             "wait for dP or dq products", "wait for the last dq product",
             "epilogue: dq through shared memory"]
    return s + READER, names


def what_if_sources() -> dict:
    """{name: source text} of the variants `--what-if` times."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    wide = "load_core_tile_wide<T, WIDE_THREADS, DP>("
    hot = mark(fwd, wide + "smem_addr(sK), kb, kv0, Nk, D);",
               wide + "smem_addr(sK), kb, 0, Nk, D);")
    hot = mark(hot, wide + "smem_addr(sV), vb, kv0, Nk, D);",
               wide + "smem_addr(sV), vb, 0, Nk, D);")
    none = mark(fwd, "    issue_v(kv0);\n",
                "    if (kv0 == 0) issue_v(kv0);\n    else cp_async_commit();\n")
    none = mark(none, "    if (kv0 + 64 < Nk) issue_k(kv0 + 64, j + 1);\n    else cp_async_commit();",
                "    cp_async_commit();")
    # no copies after the first ring, and no waits for them
    narrow = mark(fwd, "    if (j + S - 1 < n_kv) issue_tile(kv0 + (S - 1) * 64, (j + S - 1) % S);\n", "")
    narrow = mark(narrow, "    else if (live) mbar_wait(bar + st, (j / S) & 1);",
                  "    else if (live && j < S - 1) mbar_wait(bar + st, (j / S) & 1);")
    dkv = (CSRC / "flash_bwd_dkv.cu").read_text()
    dkv_none = mark(dkv, "    if (i + S - 1 < n_q) issue_tile((i + S - 1) * 64, (i + S - 1) % S);\n"
                    "    else cp_async_commit();", "    cp_async_commit();")
    dkv_none = mark(dkv_none, "    else if (live) mbar_wait(bar + st, (i / S) & 1);",
                    "    else if (live && i < S - 1) mbar_wait(bar + st, (i / S) & 1);")
    dq = (CSRC / "flash_bwd_dq.cu").read_text()
    dq_none = mark(dq, "    if (j + S - 1 < n_kv) issue_tile(kv0 + (S - 1) * 64, (j + S - 1) % S);\n", "")
    dq_none = mark(dq_none, "    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed",
                   "    else if (live && j < S - 1) mbar_wait(bar + st, (j / S) & 1);")
    bwd = (CSRC / "flash_bwd_fused.cu").read_text()
    alone = mark(bwd, "    if (i > 0) {\n      cluster.barrier_wait();\n      reduce_tile(i - 1);\n    }\n", "")
    a = alone.index("    // push this thread's two rows of the share")
    b = alone.index("  // nobody pushes to a block after the last barrier")
    alone = alone[:a] + "  }\n" + alone[b:]
    alone = mark(alone, "  cluster.barrier_wait();\n  reduce_tile(n_tiles - 1);\n", "")
    return {"fwd": fwd, "fwd_same_tile": hot, "fwd_no_copies": none,
            "narrow_no_copies": narrow, "dkv": dkv, "dkv_no_copies": dkv_none,
            "dq": dq, "dq_no_copies": dq_none,
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


def runners(torch) -> dict:
    """{kernel: (run(lib), rows, keys)}: one launch of the clocked or altered
    kernel at its shape, bf16, with its block's tile counts."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    def forward(B, H, N, D, entry="flash_fwd"):
        q, k, v = (rand(B, H, N, D) for _ in range(3))
        o = torch.empty_like(q)

        def run(lib):
            # flash_fwd takes one more int, `vec`, before the stream
            vec = [1] if entry == "flash_fwd" else []
            fn = getattr(lib, entry)
            fn.argtypes = [ptr] * 6 + [i32] * 6 + [f32] + [i32] * len(vec) \
                + [ptr]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                     o.data_ptr(), None, 1, B * H, H, N, N, D, D ** -0.5,
                     *vec, stream)
            assert err == 0, err
        return run

    def fused(B, H, N, D):
        q, k, v, do = (rand(B, H, N, D) for _ in range(4))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        stats = torch.empty(2, B * H, N, device="cuda")

        def run(lib):
            lib.flash_bwd_fused_mma.argtypes = [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]
            err = lib.flash_bwd_fused_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
                stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                1, B * H, H, N, N, D, D ** -0.5, 1, stream)
            assert err == 0, err
        return run

    def dkv(B, H, N, D):
        q, k, v, do = (rand(B, H, N, D) for _ in range(4))
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        # statistics of a softmax that stays finite: lse = log(N), di = 0
        lse = torch.full((B * H, N), float(N), device="cuda").log()
        di = torch.zeros(B * H, N, device="cuda")

        def run(lib):
            lib.flash_bwd_dkv_wgmma.argtypes = [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]
            err = lib.flash_bwd_dkv_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                1, B * H, H, N, N, D, D ** -0.5, 1, stream)
            assert err == 0, err
        return run

    def dq(B, H, N, D):
        q, k, v, do, o = (rand(B, H, N, D) for _ in range(5))
        dq, di = torch.empty_like(q), torch.empty(B * H, N, device="cuda")
        lse = torch.full((B * H, N), float(N), device="cuda").log()

        def run(lib):
            lib.flash_bwd_dq_wgmma.argtypes = [ptr] * 9 + [i32] * 6 + [f32, i32, ptr]
            err = lib.flash_bwd_dq_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
                o.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                1, B * H, H, N, N, D, D ** -0.5, 1, stream)
            assert err == 0, err
        return run

    return {"wide": (forward(8, 1, 6360, 512), 6360, 6360),
            "narrow": (forward(30, 16, 1590, 72), 1590, 1590),
            "long96": (forward(2, 24, 9600, 96, "flash_fwd_long"), 9600, 9600),
            "long64": (forward(2, 30, 17776, 64, "flash_fwd_long"), 17776,
                       17776),
            "fused": (fused(30, 16, 405, 72), 405, 405),
            "dkv": (dkv(1, 16, 8160, 72), 8160, 8160),
            "dq": (dq(1, 16, 8160, 72), 8160, 8160)}


def what_if() -> int:
    import json

    import torch

    run = runners(torch)
    sources = what_if_sources()
    # (variant, source, kernel it is timed as)
    plan = [("wide", "fwd", "wide"), ("wide_same_tile", "fwd_same_tile", "wide"),
            ("wide_no_copies", "fwd_no_copies", "wide"),
            ("narrow", "fwd", "narrow"), ("narrow_no_copies", "narrow_no_copies", "narrow"),
            ("dkv", "dkv", "dkv"), ("dkv_no_copies", "dkv_no_copies", "dkv"),
            ("dq", "dq", "dq"), ("dq_no_copies", "dq_no_copies", "dq"),
            ("fused", "bwd", "fused"), ("fused_no_dq_exchange", "bwd_no_dq_exchange", "fused")]
    out, libs = {}, {}
    with tempfile.TemporaryDirectory() as work:
        for variant, source, kernel in plan:
            if source not in libs:
                libs[source] = build(Path(work), source, sources[source])
            lib = libs[source]
            out[variant] = [time_ms(lambda: run[kernel][0](lib), 10)
                            for _ in range(2)]
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


def report(title: str, lib, names, tiles: int, first: int = 0, out=None):
    """The phases g_t[first:first + len(names)] as shares of their sum."""
    if out is None:
        out = (ctypes.c_longlong * 32)()
        lib.read_times(out)
    total = sum(out[first:first + len(names)]) or 1
    print(f"{title}: {total} cycles, {total / tiles:.0f} a tile")
    for n, name in enumerate(names):
        c = out[first + n]
        print(f"   {name:36s} {c:9d} {100.0 * c / total:5.1f}%")


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
    run = runners(torch)
    clocked = [("fused", "cluster kernel of the fused backward, spatial "
                "[30, 16, 405, 405, 72]", timed_cluster_source, 64),
               ("wide", "wide forward, VAE mid [8, 1, 6360, 6360, 512]",
                timed_forward_source, 64),
               ("narrow", "narrow forward, spatial [30, 16, 1590, 1590, 72]",
                timed_narrow_source, 64),
               ("long96", "long forward, OSP v1.2 [2, 24, 9600, 9600, 96]",
                timed_long_source, 128),
               ("long64", "long forward, CogVideoX-2b [2, 30, 17776, 17776, "
                "64]", timed_long_source, 128),
               ("dkv", "dk/dv kernel, 1080p row [1, 16, 8160, 8160, 72]",
                timed_dkv_source, 64),
               ("dq", "dq kernel, 1080p row [1, 16, 8160, 8160, 72]",
                timed_dq_source, 64)]
    if "--kernels" in sys.argv[1:]:
        chosen = sys.argv[sys.argv.index("--kernels") + 1].split(",")
        clocked = [c for c in clocked if c[0] in chosen]
    with tempfile.TemporaryDirectory() as work:
        for kernel, title, source, tile in clocked:
            text, names, *producer = source()
            lib = build(Path(work), kernel + "_timed", text)
            fn, rows, keys = run[kernel]
            fn(lib)
            torch.cuda.synchronize()
            lib.read_times((ctypes.c_longlong * 32)())  # drop the warm-up's
            fn(lib)
            torch.cuda.synchronize()
            # the loop walks the keys (forwards) or the q rows (backwards)
            walked = keys if kernel in ("wide", "narrow", "dq", "long96",
                                        "long64") else rows
            out = (ctypes.c_longlong * 32)()
            lib.read_times(out)
            report(f"{title}, one block", lib, names, -(-walked // tile),
                   out=out)
            if producer:
                report(f"{title}, its producer warp", lib, producer[0],
                       -(-walked // tile), first=10, out=out)
            if kernel == "fused":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn(lib)
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    if "flash_bwd" in e.key:
                        print(f"   device time {e.key.split('(')[1][21:55]:36s} "
                              f"{e.self_device_time_total / e.count / 1e3:.4f} ms "
                              f"(with the clocks in)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
