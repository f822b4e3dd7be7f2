// The fused flash-attention backward for bf16 and fp16 inputs on Hopper
// (sm_90a): dq, dk, dv from (q, k, v, key mask, dO) alone, nothing of the
// forward kept, non-causal, with a [B, Nk] key mask.
//
// Replaces _flash_bwd_kernel (videosys_tpu/ops/flash_attention.py:326) of the
// JAX package, which holds a whole score row in VMEM and needs 5 products.
//
//   S = scale * q k^T      P = softmax(S)       dP = dO v^T
//   dS = P * (dP - delta)  delta = rowsum(P * dP)
//   dq = scale * dS k      dk = scale * dS^T q  dv = P^T dO
//
// What bounds it on an H100: at STDiT3's training shapes (spatial N = 405,
// D = 72) the five products are 10*B*H*Nq*Nk*D flop against 8*B*H*N*D bytes,
// far above the card's 295 flop per byte; what the first design lost was not
// tensor-core rate but work done twice and waiting: 9 products for 5, every
// streamed tile copied and waited for on the spot, K and V read from device
// memory 21 times, and one 4-warp block per (batch, head). Temporal attention
// (15 x 15) is bound by bytes and filled 15 rows of 64.
//
// What this design does about it:
//   * 7 products. A row's softmax needs its log-sum-exp before any dS, and
//     with no residual that costs S and dP once (`flash_bwd_stats_wgmma`,
//     grid over q tiles, statistics to 8 bytes per row of scratch in device
//     memory); then S^T and dP^T are computed once more and feed dv, dk and
//     dq from the same tile (`flash_bwd_cluster_wgmma`).
//   * dk and dv of 405 keys x 80 columns do not fit one block's registers, so
//     a thread-block cluster takes each (batch, head): every block owns up to
//     64 keys with K and V resident in shared memory (read once) and dk, dv
//     in registers, and the blocks' shares of dq are summed through
//     distributed shared memory in rank order: no atomics, the same bits
//     every run, and C = ceil(Nk / 64) times more blocks on the card than
//     B*H, two to an SM.
//   * Every product is a wgmma (m64n64k16 for S^T and dP^T from shared
//     memory, the S^T orientation included; P^T and dS^T as register A
//     operands; dS^T read back transposed for dq), on tiles in the
//     core-matrix layout of wgmma.cuh.
//   * Every streamed tile has two buffers: cp.async copies tile j + 1 while
//     tile j is on the tensor cores; the cluster barrier of a q tile is
//     waited for one tile later, behind that tile's products.
//   * Rows of at most 16 queries and 16 keys take `flash_bwd_short_mma`: one
//     warp per (batch, head) on a 16 x 16 tile (mma.sync m16n8k16), eight per
//     block, 5 products, one pass over the bytes.
// What is left: a q tile's steps (copies issued, two barriers, three batches
// of products, the push of the dq share, the cluster barrier, the sum) each
// wait for the one before; the products themselves are a small part of a
// tile's time.
//
// Rows of more than 8 x 64 keys do not fit a portable cluster; the Python
// wrapper sends them to the blocked pair (flash_bwd.cu). fp32 inputs take the
// SIMT kernel there.
//
// Masking as in the forward: keys at or past Nk score -inf, masked keys
// -0.7*FLT_MAX, so their P and dS are exactly 0 and so are their dk, dv rows;
// a fully masked row has P = 1/Nk on its Nk keys (dv follows, dq and dk get
// nothing from it: a masked score is a constant). q rows past Nq are zero
// filled (dO = 0), contribute nothing and are not written. head_dim is zero
// padded in shared memory to 32, 64, 80 or 128 columns.

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace {

// Statistics of the fused backward: a block of one warpgroup owns 64 q rows,
// keeps Q and dO of them in shared memory and streams K and V in 64-key tiles
// through two buffers (cp.async copies tile j + 1 while tile j is on the
// tensor cores). S = Q K^T and dP = dO V^T are wgmma m64n64k16 from shared
// memory (all tiles in the core-matrix layout of wgmma.cuh). Per row it keeps
// a running (max, sum of e, sum of e * dP) and writes the log-sum-exp in log2
// units (MASK_VALUE for a fully masked row) and delta to stats[0][bh][row] and
// stats[1][bh][row]. Grid (B*H * q tiles), the q tiles of one (batch, head)
// next to each other so that they find its K and V in L2; 128 threads.
template <int NT>
__host__ __device__ constexpr size_t stats_smem_bytes() {
  return (size_t)6 * 64 * NT * 8 * 2 + 2 * 64;
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_stats_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ dout,
                          float* __restrict__ stats, int BH, int H, int Nq,
                          int Nk, int D, float scale, int vec) {
  constexpr int DP = NT * 8;
  constexpr int GROUP = DP * 16;     // bytes of one 8-row group of a tile
  constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;
  unsigned char* sDO = sQ + TILE;
  unsigned char* sK0 = sDO + TILE;      // [2][TILE]
  unsigned char* sV0 = sK0 + 2 * TILE;  // [2][TILE]
  int8_t* sF0 = reinterpret_cast<int8_t*>(sV0 + 2 * TILE);  // [2][64]

  const int n_tiles = (Nq + 63) / 64;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float scale_log2 = scale * LOG2E;

  CorePlan<THREADS, 64, DP> plan;
  if (vec) {
    plan.init(D);
    // the planned copies skip the pad columns: zero them once
    if (D < DP)
      for (int i = threadIdx.x; i < 4 * TILE / 16; i += THREADS)
        reinterpret_cast<uint4*>(sK0)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  auto issue_tile = [&](int kv0, int buf) {
    if (vec) {
      plan.issue(smem_addr(sK0 + buf * TILE), kb, kv0, Nk, D);
      plan.issue(smem_addr(sV0 + buf * TILE), vb, kv0, Nk, D);
    } else {
      load_core_rows<T, THREADS>(sK0 + buf * TILE, DP, kb, kv0, 64, Nk, D, vec);
      load_core_rows<T, THREADS>(sV0 + buf * TILE, DP, vb, kv0, 64, Nk, D, vec);
    }
    if (threadIdx.x < 64)
      sF0[buf * 64 + threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
    cp_async_commit();
  };
  load_core_rows<T, THREADS>(sQ, DP, q + (size_t)bh * Nq * D, q0, 64, Nq, D, vec);
  load_core_rows<T, THREADS>(sDO, DP, dout + (size_t)bh * Nq * D, q0, 64, Nq, D, vec);
  issue_tile(0, 0);

  float m_r[2] = {-INFINITY, -INFINITY};  // running max,
  float l_r[2] = {0.f, 0.f};              // sum of e (this lane's share),
  float d_r[2] = {0.f, 0.f};              // sum of e * dP (this lane's share)
  for (int kv0 = 0, j = 0; kv0 < Nk; kv0 += 64, ++j) {
    const int buf = j & 1;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (kv0 + 64 < Nk) issue_tile(kv0 + 64, buf ^ 1);
    const int8_t* sF = sF0 + buf * 64;

    // element 4 n + e: q row warp * 16 + lane / 4 + (e / 2) * 8, key
    // n * 8 + (lane % 4) * 2 + (e & 1)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    const uint32_t k_addr = smem_addr(sK0 + buf * TILE);
    const uint32_t v_addr = smem_addr(sV0 + buf * TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64<T>(s, wgmma_desc(smem_addr(sQ) + kk * 256, 128, GROUP),
                      wgmma_desc(k_addr + kk * 256, 128, GROUP), 1);
      wgmma_ss_n64<T>(dp, wgmma_desc(smem_addr(sDO) + kk * 256, 128, GROUP),
                      wgmma_desc(v_addr + kk * 256, 128, GROUP), 1);
    }
    wgmma_commit();
    wgmma_wait();

    // a tile with no masked key and none past Nk needs no flags
    const bool plain = mrow == nullptr && kv0 + 64 <= Nk;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (!plain) x = masked_score(x, sF[n * 8 + (lane % 4) * 2 + (e & 1)]);
        s[4 * n + e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      // the tile's first key is real, so the new max is finite
      const float m_new = fmaxf(m_r[r], mt[r]);
      const float alpha = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha;
      d_r[r] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[4 * n + e] - m_r[e / 2]);
        l_r[e / 2] += p;
        d_r[e / 2] += p * dp[4 * n + e];
      }
  }

  float* lse_out = stats + (size_t)bh * Nq;
  float* delta_out = stats + (size_t)BH * Nq + (size_t)bh * Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r], d = d_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const int row = q0 + warp * 16 + lane / 4 + r * 8;
    if (lane % 4 == 0 && row < Nq) {
      lse_out[row] = m_r[r] <= MASK_HALF ? MASK_VALUE : m_r[r] + log2f(l);
      delta_out[row] = d / l;
    }
  }
}

// The cluster kernel of the fused backward. Grid (C * B*H) in clusters of C =
// ceil(Nk / 64) blocks (at most 8): the 16-key groups of one (batch, head)
// are dealt out evenly, block `rank` of a cluster owns up to 4 of them (64
// keys). A block is one warpgroup; it keeps K and V of its keys in shared
// memory for its whole life and their dk, dv in registers (warp w: 16 keys),
// and walks the q rows in 64-row tiles (Q, dO and the row statistics through
// two buffers, cp.async). Two blocks share an SM, so that one's waiting is
// the other's work. All tiles are in the core-matrix layout of wgmma.cuh, and
// every product is a wgmma. Per q tile S^T and dP^T are computed once and feed
// all three gradients:
//   * S^T = K Q^T and dP^T = V dO^T: m64n64k16, both operands from shared
//     memory, 64 keys x 64 q rows;
//   * dv += P^T dO and dk += dS^T Q: P^T and dS^T leave the accumulators as
//     register A operands; dO and Q are read with their columns contiguous
//     (m64n{DP}k16, transposed B);
//   * dS^T also goes to shared memory as [key][q], which is dS with its 64
//     rows contiguous: the transposed A operand of this block's share of dq =
//     dS K, 64 x DP in fp32. The q rows of a tile are dealt out to the blocks
//     of the cluster (ceil(64 / C) each): every block pushes the rows of its
//     share into their owner's shared memory (remote stores through
//     distributed shared memory, which nobody waits for), arrives at the
//     cluster barrier and goes on with the next q tile; while that tile's
//     last products run it waits for the barrier and sums the C shares of
//     its own rows of the previous tile, always in rank order 0 .. C - 1, so
//     the result does not change from run to run, scales the sum and writes
//     it out. The shares sit in two buffers, so one cluster barrier per q
//     tile is enough.
constexpr int CL_THREADS = 128;
constexpr int CL_KEYS = 64;  // keys per block: 4 warps x 16
constexpr int CL_MAX = 8;    // portable cluster size
constexpr int DS_TILE = 64 * 64 * 2;  // bytes of the dS^T tile
// rows of the shares one block receives: C * ceil(64 / C) is at most 70
constexpr int RECV_ROWS = 70;

template <int NT>
__host__ __device__ constexpr size_t cluster_smem_bytes() {
  return (size_t)(2 * CL_KEYS + 4 * 64) * NT * 8 * 2 + DS_TILE +
         (size_t)2 * RECV_ROWS * NT * 8 * sizeof(float) +
         4 * 64 * sizeof(float);
}

// the address, in the cluster's shared memory window, of this block's
// shared-memory address `addr` in the block of rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_cluster_f2(uint32_t addr, float x,
                                                 float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

template <typename T, int NT>
__global__ void __launch_bounds__(CL_THREADS, 2)
    flash_bwd_cluster_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const T* __restrict__ dout,
                            const float* __restrict__ stats,
                            T* __restrict__ dq, T* __restrict__ dk,
                            T* __restrict__ dv, int BH, int H, int Nq, int Nk,
                            int D, float scale, int vec) {
  constexpr int DP = NT * 8;
  constexpr int GROUP = DP * 16;     // bytes of one 8-row group of a tile
  constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;
  unsigned char* sV = sK + TILE;
  unsigned char* sQ0 = sV + TILE;        // [2][TILE]
  unsigned char* sDO0 = sQ0 + 2 * TILE;  // [2][TILE]
  unsigned char* sDS = sDO0 + 2 * TILE;  // [DS_TILE]: dS^T
  // dq shares received: [2][C senders][RPO rows][DP]
  float* sR0 = reinterpret_cast<float*>(sDS + DS_TILE);
  float* sL0 = sR0 + 2 * RECV_ROWS * DP;  // [2][64] log-sum-exp, log2 units
  float* sD0 = sL0 + 2 * 64;        // [2][64] delta

  const int bh = blockIdx.x / C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // 16-key groups: the first `extra` blocks own one more than the others
  const int groups = (Nk + 15) / 16;
  const int my_groups = groups / C + (rank < groups % C ? 1 : 0);
  const int k0 = (rank * (groups / C) + min(rank, groups % C)) * 16;
  const int k_end = min(Nk, k0 + my_groups * 16);  // this block's keys end
  const T* qb = q + (size_t)bh * Nq * D;
  const T* dob = dout + (size_t)bh * Nq * D;
  T* dqb = dq + (size_t)bh * Nq * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float* lse_in = stats + (size_t)bh * Nq;
  const float* delta_in = stats + (size_t)BH * Nq + (size_t)bh * Nq;
  const float scale_log2 = scale * LOG2E;
  const float inv_nk = 1.f / (float)Nk;

  CorePlan<CL_THREADS, 64, DP> plan;
  if (vec) {
    plan.init(D);
    // the planned copies skip the pad columns: zero them once
    if (D < DP)
      for (int i = threadIdx.x; i < 4 * TILE / 16; i += CL_THREADS)
        reinterpret_cast<uint4*>(sQ0)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  auto issue_tile = [&](int q0, int buf) {
    if (vec) {
      plan.issue(smem_addr(sQ0 + buf * TILE), qb, q0, Nq, D);
      plan.issue(smem_addr(sDO0 + buf * TILE), dob, q0, Nq, D);
    } else {
      load_core_rows<T, CL_THREADS>(sQ0 + buf * TILE, DP, qb, q0, 64, Nq, D, vec);
      load_core_rows<T, CL_THREADS>(sDO0 + buf * TILE, DP, dob, q0, 64, Nq, D, vec);
    }
    {
      // rows past Nq get 0: p = exp2(0 - 0) stays finite, dS = p * (0 - 0) = 0
      const int r = threadIdx.x % 64;
      const bool in = q0 + r < Nq;
      const float* src = threadIdx.x < 64 ? lse_in : delta_in;
      float* dst = threadIdx.x < 64 ? sL0 : sD0;
      cp_async4(dst + buf * 64 + r, in ? src + q0 + r : src, in ? 4 : 0);
    }
    cp_async_commit();
  };
  // keys past this block's end are zero filled and flagged as past the end
  load_core_rows<T, CL_THREADS>(sK, DP, k + (size_t)bh * Nk * D, k0, 64, k_end,
                                D, vec);
  load_core_rows<T, CL_THREADS>(sV, DP, v + (size_t)bh * Nk * D, k0, 64, k_end,
                                D, vec);
  issue_tile(0, 0);

  // this thread's keys: k0 + warp * 16 + lane / 4, and that + 8
  const int own_key = k0 + warp * 16 + lane / 4;
  const int8_t own_flag[2] = {key_flag(mrow, own_key, k_end),
                              key_flag(mrow, own_key + 8, k_end)};
  // no key of this warp is masked or past the end, and no row can be fully
  // masked: scores need no flags
  const bool plain = mrow == nullptr && k0 + warp * 16 + 16 <= k_end;
  const int ksteps = my_groups;  // 16-key steps of the dq product
  const int RPO = (64 + C - 1) / C;  // q rows of a tile per owning block

  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  const uint32_t k_addr = smem_addr(sK);
  const uint32_t v_addr = smem_addr(sV);
  const uint32_t ds_addr = smem_addr(sDS);

  // sums the C shares of this block's rows of q tile `tile`, in rank order,
  // scales the sum and writes those dq rows
  auto reduce_tile = [&](int tile) {
    const float* sR = sR0 + (tile & 1) * RECV_ROWS * DP;
    const int row0 = rank * RPO;  // first of this block's rows in the tile
    const int total4 = max(0, min(RPO, 64 - row0)) * (DP / 4);
    for (int idx = threadIdx.x; idx < total4; idx += CL_THREADS) {
      const int r = idx / (DP / 4);
      const int col = (idx % (DP / 4)) * 4;
      const float* mine = sR + r * DP + col;
      float4 sum = *reinterpret_cast<const float4*>(mine);
#pragma unroll
      for (int c = 1; c < CL_MAX; ++c)
        if (c < C) {
          const float4 x =
              *reinterpret_cast<const float4*>(mine + c * RPO * DP);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
      const int row = tile * 64 + row0 + r;
      if (row < Nq) {
        T* out = dqb + (size_t)row * D + col;
        if (vec && col < D) {  // D % 8 == 0: all four columns are real
          uint2 packed;
          packed.x = Ops<T>::pack(sum.x * scale, sum.y * scale);
          packed.y = Ops<T>::pack(sum.z * scale, sum.w * scale);
          *reinterpret_cast<uint2*>(out) = packed;
        } else {
          const float x[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < D) out[e] = Ops<T>::from_float(x[e] * scale);
        }
      }
    }
  };

  const int n_tiles = (Nq + 63) / 64;
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    const int q0 = i * 64;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // q tile i (and K, V) are in; tile i - 1 is done with
    if (i + 1 < n_tiles) issue_tile(q0 + 64, buf ^ 1);
    const uint32_t q_addr = smem_addr(sQ0 + buf * TILE);
    const uint32_t do_addr = smem_addr(sDO0 + buf * TILE);
    const float* sL = sL0 + buf * 64;
    const float* sD = sD0 + buf * 64;

    // s = K Q^T and dp = V dO^T: 64 keys x 64 q rows; element 4 n + e: key
    // warp * 16 + lane / 4 + (e / 2) * 8 of them, q row n * 8 +
    // (lane % 4) * 2 + (e & 1)
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64<T>(s, wgmma_desc(k_addr + kk * 256, 128, GROUP),
                      wgmma_desc(q_addr + kk * 256, 128, GROUP), 1);
      wgmma_ss_n64<T>(dp, wgmma_desc(v_addr + kk * 256, 128, GROUP),
                      wgmma_desc(do_addr + kk * 256, 128, GROUP), 1);
    }
    wgmma_commit();
    wgmma_wait();
    // P^T and dS^T = P^T * (dP^T - delta), packed as A operands
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], ds[4];
      float c_lse[2], c_delta[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n * 8 + (lane % 4) * 2 + jj;
        c_lse[jj] = sL[col];
        c_delta[jj] = sD[col];
      }
      if (plain) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(s[4 * n + e], scale_log2, -c_lse[e & 1]));
          ds[e] = p[e] * (dp[4 * n + e] - c_delta[e & 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              masked_score(s[4 * n + e] * scale_log2, own_flag[e / 2]);
          // a fully masked row: lse = MASK_VALUE, P = 1 / Nk
          const float pmul = c_lse[e & 1] <= MASK_HALF ? inv_nk : 1.f;
          p[e] = fast_exp2(x - c_lse[e & 1]) * pmul;
          // a masked score is a constant: no gradient reaches q and k through
          // it (only a fully masked row has p != 0 there)
          ds[e] = x == MASK_VALUE ? 0.f
                                  : p[e] * (dp[4 * n + e] - c_delta[e & 1]);
        }
      }
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p[2], p[3]);
      dsa[n / 2][(n % 2) * 2] = Ops<T>::pack(ds[0], ds[1]);
      dsa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(ds[2], ds[3]);
      // dS^T to shared memory: 8 keys x 8 q rows per core matrix, q rows
      // contiguous; 8-key groups 1024 bytes apart, 8-row groups 128
      unsigned char* lo = sDS + (2 * warp) * 1024 + n * 128 +
                          (lane / 4) * 16 + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(lo) = dsa[n / 2][(n % 2) * 2];
      *reinterpret_cast<uint32_t*>(lo + 1024) = dsa[n / 2][(n % 2) * 2 + 1];
    }
    fence_async_shared();
    // dv += P^T dO, dk += dS^T Q: depth = the 64 q rows, four 16-row steps
    // of two 8-row groups each
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_rs<T, DP>(acc_dv, pa[ks],
                      wgmma_desc(do_addr + ks * 2 * GROUP, GROUP, 128), 1);
      wgmma_rs<T, DP>(acc_dk, dsa[ks],
                      wgmma_desc(q_addr + ks * 2 * GROUP, GROUP, 128), 1);
    }
    wgmma_commit();
    __syncthreads();  // dS^T of every warp is in shared memory

    // this block's share of dq = dS K: depth = the block's keys, 16 a step
    float acc_dq[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc_dq[j] = 0.f;
    wgmma_fence();
    for (int ks = 0; ks < ksteps; ++ks)
      wgmma_tt<T, DP>(acc_dq, wgmma_desc(ds_addr + ks * 2048, 1024, 128),
                      wgmma_desc(k_addr + ks * 2 * GROUP, GROUP, 128), 1);
    wgmma_commit();
    // while the tensor cores run: the previous q tile's shares are complete
    // once every block of the cluster has arrived
    if (i > 0) {
      cluster.barrier_wait();
      reduce_tile(i - 1);
    }
    wgmma_wait();
    // push this thread's two rows of the share to the blocks that own them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + lane / 4 + h * 8;
      const int owner = row / RPO;
      const float* slot = sR0 + buf * RECV_ROWS * DP +
                          (rank * RPO + row - owner * RPO) * DP +
                          (lane % 4) * 2;
      const uint32_t remote = cluster_addr(smem_addr(slot), owner);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        store_cluster_f2(remote + j * 32, acc_dq[4 * j + 2 * h],
                         acc_dq[4 * j + 2 * h + 1]);
    }
    cluster.barrier_arrive();  // this block's share of q tile i is pushed
  }
  // nobody pushes to a block after the last barrier: it may leave once it
  // has summed its rows
  cluster.barrier_wait();
  reduce_tile(n_tiles - 1);

  if (warp < my_groups) {
    T* dkb = dk + (size_t)bh * Nk * D;
    T* dvb = dv + (size_t)bh * Nk * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = own_key + (e / 2) * 8;
        const int c = col + (e & 1);
        if (r < Nk && c < D) {
          dkb[(size_t)r * D + c] = Ops<T>::from_float(acc_dk[4 * n + e] * scale);
          dvb[(size_t)r * D + c] = Ops<T>::from_float(acc_dv[4 * n + e]);
        }
      }
    }
  }
}

// Short rows (Nq <= 16 and Nk <= 16: temporal attention over 15 frames): one
// warp per (batch, head), eight of them packed into a block, each on its own
// 16 x 16 score tile, so no row of a 64-row tile idles. The whole score row
// is in one tile: no statistics pass, and S and dP are computed once. P and
// dS go through a small shared-memory tile to be read back transposed for
// dk = dS^T Q and dv = P^T dO. Bound by bytes: every input is read once.
constexpr int SH_WARPS = 8;
constexpr int SH_LDT = 16 + PAD;  // row stride of the P and dS tiles

template <typename T, int NT>
__host__ __device__ constexpr size_t short_smem_bytes() {
  return (size_t)SH_WARPS * (4 * 16 * (NT * 8 + PAD) + 2 * 16 * SH_LDT) * sizeof(T);
}

// rows [0, N) of a row-major [N, D] matrix into a [16][ld] tile by one warp,
// zero filled past N and past D
template <typename T>
__device__ __forceinline__ void load_rows_warp(T* dst, int ld, const T* src,
                                               int N, int DP, int D, bool vec,
                                               int lane) {
  const int chunks = DP / 8;
  const T zero = Ops<T>::from_float(0.f);
  for (int c = lane; c < 16 * chunks; c += 32) {
    const int r = c / chunks;
    const int cc = (c % chunks) * 8;
    T* d = dst + r * ld + cc;
    if (vec) {  // D % 8 == 0: a chunk lies wholly inside or outside D
      const bool in = r < N && cc < D;
      cp_async16(d, in ? src + (size_t)r * D + cc : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (r < N && cc + e < D) ? src[(size_t)r * D + cc + e] : zero;
    }
  }
}

// out[r][c] = acc * mul for the 16 x DP accumulator of one warp
template <typename T, int NT>
__device__ __forceinline__ void store_rows_warp(T* out, const float (*acc)[4],
                                                int N, int D, float mul,
                                                int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = lane / 4 + (e / 2) * 8;
      const int c = n * 8 + (lane % 4) * 2 + (e & 1);
      if (r < N && c < D) out[(size_t)r * D + c] = Ops<T>::from_float(acc[n][e] * mul);
    }
}

template <typename T, int NT>
__global__ void __launch_bounds__(SH_WARPS * 32)
    flash_bwd_short_mma(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, int BH, int H,
                        int Nq, int Nk, int D, float scale, int vec) {
  constexpr int DP = NT * 8;
  constexpr int ld = DP + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x * SH_WARPS + warp;
  if (bh >= BH) return;  // warps are independent: no block barrier below
  T* sQ = reinterpret_cast<T*>(smem_raw) + warp * (4 * 16 * ld + 2 * 16 * SH_LDT);
  T* sK = sQ + 16 * ld;
  T* sV = sK + 16 * ld;
  T* sDO = sV + 16 * ld;
  T* sP = sDO + 16 * ld;      // [16 q][SH_LDT]
  T* sDS = sP + 16 * SH_LDT;  // [16 q][SH_LDT]
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float scale_log2 = scale * LOG2E;

  load_rows_warp(sQ, ld, q + (size_t)bh * Nq * D, Nq, DP, D, vec, lane);
  load_rows_warp(sK, ld, k + (size_t)bh * Nk * D, Nk, DP, D, vec, lane);
  load_rows_warp(sV, ld, v + (size_t)bh * Nk * D, Nk, DP, D, vec, lane);
  load_rows_warp(sDO, ld, dout + (size_t)bh * Nq * D, Nq, DP, D, vec, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();

  // s = Q K^T, dp = dO V^T: 16 q rows x 16 keys; element (n, e) is q row
  // lane / 4 + (e / 2) * 8 and key n * 8 + (lane % 4) * 2 + (e & 1)
  float s[2][4], dp[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = 0.f;
      dp[n][e] = 0.f;
    }
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4], b[4];
    const int a_off = ((lane % 8) + ((lane / 8) % 2) * 8) * ld + kk + (lane / 16) * 8;
    const int b_off = ((lane % 8) + (lane / 16) * 8) * ld + kk + ((lane / 8) % 2) * 8;
    ldmatrix_x4(a, sQ + a_off);
    ldmatrix_x4(b, sK + b_off);
    Ops<T>::mma(s[0], a, b);
    Ops<T>::mma(s[1], a, b + 2);
    ldmatrix_x4(a, sDO + a_off);
    ldmatrix_x4(b, sV + b_off);
    Ops<T>::mma(dp[0], a, b);
    Ops<T>::mma(dp[1], a, b + 2);
  }
  // softmax over the whole row, delta = rowsum(P * dP)
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n * 8 + (lane % 4) * 2 + (e & 1);
      s[n][e] = masked_score(s[n][e] * scale_log2, key_flag(mrow, key, Nk));
      m[e / 2] = fmaxf(m[e / 2], s[n][e]);
    }
  float l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  float p[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] = exp2f(s[n][e] - m[e / 2]);  // key 0 is real: m is finite
      l[e / 2] += p[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] /= l[e / 2];
      delta[e / 2] += p[n][e] * dp[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
  }
  uint32_t pa[4], dsa[4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      // a masked score is a constant: no gradient reaches q and k through it
      ds[e] = s[n][e] == MASK_VALUE ? 0.f : p[n][e] * (dp[n][e] - delta[e / 2]);
    pa[n * 2] = Ops<T>::pack(p[n][0], p[n][1]);
    pa[n * 2 + 1] = Ops<T>::pack(p[n][2], p[n][3]);
    dsa[n * 2] = Ops<T>::pack(ds[0], ds[1]);
    dsa[n * 2 + 1] = Ops<T>::pack(ds[2], ds[3]);
    const int off = (lane / 4) * SH_LDT + n * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(sP + off) = pa[n * 2];
    *reinterpret_cast<uint32_t*>(sP + off + 8 * SH_LDT) = pa[n * 2 + 1];
    *reinterpret_cast<uint32_t*>(sDS + off) = dsa[n * 2];
    *reinterpret_cast<uint32_t*>(sDS + off + 8 * SH_LDT) = dsa[n * 2 + 1];
  }
  __syncwarp();

  float acc[NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  };
  // acc (+)= A Y for a [16][ld] tile Y whose rows are the depth
  auto times_rows = [&](const uint32_t* a, const T* sY) {
#pragma unroll
    for (int dpi = 0; dpi < NT / 2; ++dpi) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sY + ((lane % 8) + ((lane / 8) % 2) * 8) * ld +
                               dpi * 16 + (lane / 16) * 8);
      Ops<T>::mma(acc[2 * dpi], a, b);
      Ops<T>::mma(acc[2 * dpi + 1], a, b + 2);
    }
  };
  // dq = scale * dS K, from the accumulator registers
  zero_acc();
  times_rows(dsa, sK);
  store_rows_warp<T, NT>(dq + (size_t)bh * Nq * D, acc, Nq, D, scale, lane);
  // dk = scale * dS^T Q, dv = P^T dO: the transposed tiles (16 keys x 16 q
  // rows) come back from shared memory; matrix lane / 8 covers keys
  // ((lane / 8) % 2) * 8 .., q rows (lane / 16) * 8 ..
  const int t_off = ((lane / 16) * 8 + (lane % 8)) * SH_LDT + ((lane / 8) % 2) * 8;
  uint32_t at[4];
  ldmatrix_x4_trans(at, sDS + t_off);
  zero_acc();
  times_rows(at, sQ);
  store_rows_warp<T, NT>(dk + (size_t)bh * Nk * D, acc, Nk, D, scale, lane);
  ldmatrix_x4_trans(at, sP + t_off);
  zero_acc();
  times_rows(at, sDO);
  store_rows_warp<T, NT>(dv + (size_t)bh * Nk * D, acc, Nk, D, 1.f, lane);
}

// ---- launches -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const uint8_t* mask;
  float* stats;
  void *dq, *dk, *dv;
  int BH, H, Nq, Nk, D;
  float scale;
  int vec;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > SMEM_PER_BLOCK) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// kind of kernel a shape takes: 1 statistics + cluster, 2 short rows, -1 none
int fused_kind(int Nq, int Nk, int D) {
  if (Nq <= 0 || Nk <= 0 || D <= 0 || D > 128) return -1;
  if (Nq <= 16 && Nk <= 16) return 2;
  if (Nk <= CL_MAX * CL_KEYS) return 1;  // 512 keys
  return -1;
}

template <typename T, int NT>
cudaError_t launch_fused(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  cudaError_t err;
  const int kind = fused_kind(a.Nq, a.Nk, a.D);
  if (kind == 2) {
    auto kernel = flash_bwd_short_mma<T, NT>;
    constexpr size_t smem = short_smem_bytes<T, NT>();
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(a.BH + SH_WARPS - 1) / SH_WARPS, SH_WARPS * 32, smem, a.stream>>>(
        q, k, v, a.mask, dout, dq, dk, dv, a.BH, a.H, a.Nq, a.Nk, a.D, a.scale,
        a.vec);
    return cudaGetLastError();
  }
  if (kind != 1 || a.stats == nullptr ||
      (long long)a.BH * ((a.Nq + 63) / 64) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  {
    auto kernel = flash_bwd_stats_wgmma<T, NT>;
    constexpr size_t smem = stats_smem_bytes<NT>();
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    const unsigned grid = (unsigned)a.BH * ((a.Nq + 63) / 64);
    kernel<<<grid, THREADS, smem, a.stream>>>(q, k, v, a.mask, dout, a.stats,
                                              a.BH, a.H, a.Nq, a.Nk, a.D,
                                              a.scale, a.vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_cluster_wgmma<T, NT>;
  constexpr size_t smem = cluster_smem_bytes<NT>();
  if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
  const int C = (a.Nk + CL_KEYS - 1) / CL_KEYS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * a.BH);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* stats = a.stats;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, a.mask, dout, stats, dq, dk,
                           dv, a.BH, a.H, a.Nq, a.Nk, a.D, a.scale, a.vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fused(const Args& a) {
  // head_dim padded to the next of 32, 64, 80, 128 columns
  if (a.D <= 32) return launch_fused<T, 4>(a);
  if (a.D <= 64) return launch_fused<T, 8>(a);
  if (a.D <= 80) return launch_fused<T, 10>(a);
  if (a.D <= 128) return launch_fused<T, 16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q, dout, dq: [BH, Nq, D]; k, v, dk, dv:
// [BH, Nk, D], all contiguous and of one type (dtype 1 = bf16, 2 = fp16);
// mask: [BH / H, Nk] bytes (nonzero = attend) or null; stats: 2 * BH * Nq
// floats of scratch (may be null for short rows). Launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for a shape or type
// it does not take: see flash_bwd_fused_mma_kind).
extern "C" int flash_bwd_fused_mma(const void* q, const void* k, const void* v,
                                   const void* mask, const void* dout,
                                   void* stats, void* dq, void* dk, void* dv,
                                   int dtype, int BH, int H, int Nq, int Nk,
                                   int D, float scale, int vec, void* stream) {
  if (BH <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask),
               static_cast<float*>(stats), dq, dk, dv, BH, H, Nq, Nk, D,
               scale, vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)dispatch_fused<__nv_bfloat16>(a);
  if (dtype == 2) return (int)dispatch_fused<__half>(a);
  return (int)cudaErrorInvalidValue;
}

// Which kernels a shape takes: 1 the statistics kernel and the cluster
// kernel, 2 the short-row kernel, -1 none (more than 512 keys, head_dim
// above 128); the wrapper's dispatch mirrors it.
extern "C" int flash_bwd_fused_mma_kind(int Nq, int Nk, int D) {
  return fused_kind(Nq, Nk, D);
}

// Bytes of shared memory a block of kernel `which` (0 statistics, 1 cluster,
// 2 short rows) asks for at head_dim D with 2-byte elements, or -1; the
// wrapper mirrors the formulas.
extern "C" long flash_bwd_fused_mma_smem(int which, int D) {
  if (D <= 0 || D > 128 || which < 0 || which > 2) return -1;
  typedef __nv_bfloat16 T;
  const size_t table[4][3] = {
      {stats_smem_bytes<4>(), cluster_smem_bytes<4>(), short_smem_bytes<T, 4>()},
      {stats_smem_bytes<8>(), cluster_smem_bytes<8>(), short_smem_bytes<T, 8>()},
      {stats_smem_bytes<10>(), cluster_smem_bytes<10>(), short_smem_bytes<T, 10>()},
      {stats_smem_bytes<16>(), cluster_smem_bytes<16>(), short_smem_bytes<T, 16>()}};
  return (long)table[D <= 32 ? 0 : D <= 64 ? 1 : D <= 80 ? 2 : 3][which];
}

extern "C" const char* flash_bwd_fused_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
