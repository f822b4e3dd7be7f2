// dq of flash attention for bf16 and fp16 inputs on Hopper (sm_90a), from
// the forward's log-sum-exp and output, non-causal, with a [B, Nk] key mask.
// The kernel also computes di = rowsum(dO * O), which the dk/dv kernel
// (flash_bwd_dkv.cu) reads after it.
//
// Replaces _flash_bwd_dq_kernel (videosys_tpu/ops/flash_attention.py:594) of
// the JAX package, the dq leg of its KV-blocked backward, and the di its glue
// computes outside the kernels (:684-689):
//
//   S = scale * q k^T   P = exp(S - lse)   dP = dO v^T   di = rowsum(dO * O)
//   dS = P * (dP - di)  dq = scale * dS k
//
// What bounds it on an H100: at the 1080p row (B*H = 16, N = 8160, D = 72)
// its three products are 6*B*H*N^2*D flop against 12*B*H*N*D bytes, far
// above the card's 295 flop per byte: operations, if the products are fed.
// The first design (mma.sync, four warps owning 64 q rows, the K and V tiles
// loaded and waited for one at a time) reached 18% of that.
//
// What this design does about it (the narrow forward's skeleton, flash_fwd.cu,
// with a second score product and dS in place of P):
//   * A block of two warpgroups (256 threads) owns 128 q rows of one (batch,
//     head): warpgroup w owns rows [64 w, 64 w + 64); Q and dO of them stay
//     in shared memory for the block's life, dq in registers (DP / 2 fp32 a
//     thread: 40 at D = 72). Every K and V tile crosses L2 once per 128 rows.
//   * Before the first key tile each warpgroup computes di of its rows from
//     its dO tile and 16-byte loads of O, in the layout of the score tiles
//     (the four threads that share a row each sum a quarter of its chunks),
//     keeps it in registers and writes it out for the dk/dv kernel.
//   * It walks the keys in 64-row tiles; K, V and the tile's key flags come
//     through a ring of DQ_STAGES stages: one thread asks the copy engine
//     (TMA, the tile layout of tma.cuh) for tile j + 2 right after the barrier
//     that frees its stage and before the products of tile j; the warpgroups
//     wait on the stage's mbarrier.
//   * Every product is a wgmma: S = Q K^T (m64n64k16) and dP = dO V^T in two
//     halves of 32 keys (m64n32k16), both operands from shared memory; dS =
//     P * (dP - di) leaves the accumulators as the register A operand of dq
//     += dS K (K read with its columns contiguous, as V in the forward's P
//     V). P is computed while the first half of dP runs, and the first
//     half's dq product runs beside the second half of dP. With dP in halves
//     at most 40 + 32 + 16 accumulator registers are live (dq, S, half of
//     dP), so two blocks fit an SM at D <= 80 without spilling (128
//     registers at D = 72). The whole dP at once spilled there; on an H100
//     at the 1080p row (tools/ab_kernels.py) that took 1.23 ms with two
//     blocks an SM and 1.40 with one, the halves 1.12-1.14. No online
//     softmax: the forward's lse fixes P, so nothing is rescaled.
//   * No sum crosses blocks: no atomics, the same bits every run. The grid
//     runs the q blocks of one (batch, head) next to each other, so that they
//     find its K and V in L2; dq leaves through shared memory (the
//     warpgroup's own Q tile) as 16-byte stores.
//
// Masking as in the forward: keys at or past Nk and masked keys weigh
// nothing in dq (a masked score is a constant, so P there is set to 0); a
// fully masked row (lse = MASK_VALUE) attends to no key and gets dq = 0. q
// rows past Nq are zero filled (dO = 0, di = 0, lse = 0) and not written.
// head_dim is zero padded in shared memory to 32, 64, 80 or 128 columns.
// (A head whose rows cannot be copied in 16-byte chunks is loaded element by
// element by every thread instead.) fp32 inputs take the SIMT kernel of
// flash_bwd.cu. Left out on purpose: a producer warp and ping-pong between
// the warpgroups.

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int DQ_THREADS = 256;
constexpr int DQ_STAGES = 3;  // K / V / key flag ring

template <int DP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // Q and dO of 128 rows, the K and V ring, 64 key flags a stage, an
  // mbarrier a stage and one for Q and dO
  return (size_t)(4 + 2 * DQ_STAGES) * 64 * DP * 2 + DQ_STAGES * 64 +
         (DQ_STAGES + 1) * 8;
}

// waits until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers written by an asynchronous wgmma after the wait for it, so
// that no read of them is scheduled before the wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// sum of the products of two 16-byte chunks of eight 16-bit values
template <typename T>
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float s) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int e = 0; e < 8; ++e) s = fmaf(to_float(x[e]), to_float(y[e]), s);
  return s;
}

// descriptor of the 16-column step kk of a K-major operand whose rows start
// at row `row0` (a multiple of 8) of a tile of layout L at `base`
template <typename L>
__device__ __forceinline__ uint64_t k_major_rows(uint32_t base, int kk,
                                                 int row0) {
  return L::k_major(base + row0 * (kk < 4 * L::NSW ? 128 : 16), kk);
}

template <typename T, int DP>
__global__ void __launch_bounds__(DQ_THREADS, DP <= 80 ? 2 : 1)
    flash_bwd_dq_wgmma(const __grid_constant__ TileMaps tm_q,
                       const __grid_constant__ TileMaps tm_k,
                       const __grid_constant__ TileMaps tm_v,
                       const __grid_constant__ TileMaps tm_do,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const T* __restrict__ dout, const T* __restrict__ o,
                       const float* __restrict__ lse, float* __restrict__ di,
                       T* __restrict__ dq, int H, int Nq, int Nk, int D,
                       float scale, int vec) {
  // the swizzled tiles (measured against chunk-major on an H100: 1.12-1.14
  // against 1.14-1.16 ms at the 1080p row, tools/ab_kernels.py)
  using L = TileLayout<DP, true>;
  constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  constexpr int NACC = DP / 2;       // accumulator registers per thread
  constexpr int S = DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;         // [2][TILE]: the block's 128 q rows
  unsigned char* sDO = sQ + 2 * TILE;   // [2][TILE]: their dO
  unsigned char* sK0 = sDO + 2 * TILE;  // [S][TILE]
  unsigned char* sV0 = sK0 + S * TILE;  // [S][TILE]
  int8_t* sF0 = reinterpret_cast<int8_t*>(sV0 + S * TILE);  // [S][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sF0 + S * 64);  // [S] K/V, Q/dO

  const int n_tiles = (Nq + 127) / 128;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * 128;
  const int wg = threadIdx.x / 128;  // warpgroup: rows [64 wg, 64 wg + 64)
  const int tw = threadIdx.x % 128;  // thread within the warpgroup
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64;
  const bool live = row0 < Nq;
  const int q_tiles = q0 + 64 < Nq ? 2 : 1;  // the block's live Q, dO tiles
  const T* qb = q + (size_t)bh * Nq * D;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const T* dob = dout + (size_t)bh * Nq * D;
  const T* ob = o + (size_t)bh * Nq * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float scale_log2 = scale * LOG2E;

  if (vec) {
    // the copies never write the pad chunks: zero them in every tile once
    L::template zero_pad<DQ_THREADS>(smem_raw, 4 + 2 * S, D);
    if (threadIdx.x == 0) {
      if (L::NSW > 0 && smem_addr(smem_raw) % 1024 != 0) __trap();
      for (int i = 0; i <= S; ++i) mbar_init(bar + i, 1);
      mbar_init_fence();
      for (const TileMaps* m : {&tm_q, &tm_k, &tm_v, &tm_do}) {
        if (L::NSW > 0) tma_prefetch(&m->sw);
        if (L::REM > 0) tma_prefetch(&m->rem);
      }
    }
    fence_async_shared();
    __syncthreads();
  }
  // key tile starting at kv0 -> stage `st` (K, V, and per key: 1 attend,
  // 0 masked, -1 past Nk)
  auto issue_tile = [&](int kv0, int st) {
    unsigned char* sK = sK0 + st * TILE;
    unsigned char* sV = sV0 + st * TILE;
    if (vec) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar + st, 2 * L::tx_bytes(D));
        tma_tile<L>(smem_addr(sK), tm_k, kv0, bh, bar + st);
        tma_tile<L>(smem_addr(sV), tm_v, kv0, bh, bar + st);
      }
    } else {
      load_tile_rows<T, DQ_THREADS, L>(sK, kb, kv0, Nk, D);
      load_tile_rows<T, DQ_THREADS, L>(sV, vb, kv0, Nk, D);
    }
    if (threadIdx.x < 64)
      sF0[st * 64 + threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
  };
  // Q and dO of the block's rows; rows past Nq are zero filled
  if (vec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar + S, 2 * q_tiles * L::tx_bytes(D));
      for (int t = 0; t < q_tiles; ++t) {
        tma_tile<L>(smem_addr(sQ + t * TILE), tm_q, q0 + t * 64, bh, bar + S);
        tma_tile<L>(smem_addr(sDO + t * TILE), tm_do, q0 + t * 64, bh, bar + S);
      }
    }
  } else {
    for (int t = 0; t < 2; ++t) {
      load_tile_rows<T, DQ_THREADS, L>(sQ + t * TILE, qb, q0 + t * 64, Nq, D);
      load_tile_rows<T, DQ_THREADS, L>(sDO + t * TILE, dob, q0 + t * 64, Nq,
                                       D);
    }
  }
  const int n_kv = (Nk + 63) / 64;
  for (int st = 0; st < S - 1 && st < n_kv; ++st) issue_tile(st * 64, st);

  // di and lse of this thread's two rows, r_in and r_in + 8 of the
  // warpgroup's 64, in the score tiles' layout: the four threads of a row
  // (lane % 4) each sum every fourth 16-byte chunk of dO * O
  if (!vec) __syncthreads();  // every thread's stores of Q and dO
  else if (live) mbar_wait(bar + S, 0);
  const int r_in = (tw / 32) * 16 + lane / 4;
  const unsigned char* sDOw = sDO + wg * TILE;
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_in + h * 8;
    const int row = row0 + r;
    float sum = 0.f;
    if (row < Nq) {
      if (vec) {
        for (int c = lane % 4; c < D / 8; c += 4)
          sum = dot8<T>(*reinterpret_cast<const uint4*>(sDOw + L::offset(r, c)),
                        *reinterpret_cast<const uint4*>(ob + (size_t)row * D + c * 8),
                        sum);
      } else {
        for (int c = lane % 4; c < D; c += 4)
          sum = fmaf(to_float(reinterpret_cast<const T*>(
                                  sDOw + L::offset(r, c / 8))[c % 8]),
                     to_float(ob[(size_t)row * D + c]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    di_r[h] = sum;
    float l = 0.f;  // rows past Nq: q = 0, so p = 2^0 and dS = p (0 - 0)
    if (row < Nq) {
      l = lse[(size_t)bh * Nq + row];
      if (lane % 4 == 0) di[(size_t)bh * Nq + row] = sum;
    }
    // a fully masked row attends to no key: its P is set to 0 below
    lse2[h] = l <= MASK_HALF ? MASK_VALUE : l * LOG2E;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_addr(sQ) + wg * TILE;
  const uint32_t do_addr = smem_addr(sDO) + wg * TILE;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % S;
    const int kv0 = j * 64;
    if (!vec) fence_async_shared();  // this thread's stores of tile j
    else if (live) mbar_wait(bar + st, (j / S) & 1);  // tile j has landed
    __syncthreads();  // tile j is in; both warpgroups are done with tile j - 1
    if (j + S - 1 < n_kv) issue_tile(kv0 + (S - 1) * 64, (j + S - 1) % S);
    if (!live) continue;
    const uint32_t k_addr = smem_addr(sK0 + st * TILE);
    const uint32_t v_addr = smem_addr(sV0 + st * TILE);

    // S = Q K^T: 64 q rows x 64 keys; element 4 n + e is row e / 2 of this
    // thread's two, key n * 8 + (lane % 4) * 2 + (e & 1). dP = dO V^T in two
    // halves of 32 keys (element 4 n + e of half h: key 32 h + n * 8 + ...),
    // so that only one half of it is held at a time
    float s[32], dp[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64<T>(s, L::k_major(q_addr, kk), L::k_major(k_addr, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n32<T>(dp, L::k_major(do_addr, kk), k_major_rows<L>(v_addr, kk, 0), 1);
    wgmma_commit();
    wgmma_wait_n<1>();  // S is out; dP of the first half may still run
    fence_regs<32>(s);

    // P = 2^(S scale log2(e) - lse2) in place, while dP runs; a masked
    // score is a constant, so no gradient reaches q through it: P = 0 there
    if (mrow == nullptr && kv0 + 64 <= Nk) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -lse2[(i / 2) % 2]));
    } else {
      const int8_t* sM = sF0 + st * 64;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int8_t flag = sM[n * 8 + (lane % 4) * 2 + (e & 1)];
          s[4 * n + e] =
              flag > 0 ? fast_exp2(fmaf(s[4 * n + e], scale_log2, -lse2[e / 2]))
                       : 0.f;
        }
    }

    // per half: dS = P (dP - di), packed as the A operand of dq += dS K;
    // the first half's dq product runs beside the second half's dP
    uint32_t dsa[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_wait_n<0>();
      fence_regs<16>(dp);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* p = s + 4 * (4 * h + n);
        const float d0 = p[0] * (dp[4 * n] - di_r[0]);
        const float d1 = p[1] * (dp[4 * n + 1] - di_r[0]);
        const float d2 = p[2] * (dp[4 * n + 2] - di_r[1]);
        const float d3 = p[3] * (dp[4 * n + 3] - di_r[1]);
        dsa[2 * h + n / 2][(n % 2) * 2] = Ops<T>::pack(d0, d1);
        dsa[2 * h + n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(d2, d3);
      }
      if (h == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) dp[i] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 2 * h; ks < 2 * h + 2; ++ks)  // 16 keys a step
        L::template mn_product<T>(acc, dsa[ks], k_addr, ks);
      wgmma_commit();
      if (h == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n32<T>(dp, L::k_major(do_addr, kk),
                          k_major_rows<L>(v_addr, kk, 32), 1);
        wgmma_commit();
      }
    }
    wgmma_wait_n<0>();
  }
  if (!live) return;
  fence_regs<NACC>(acc);

  // the warpgroup's Q tile is free: its last product has been waited for,
  // and the other warpgroup reads only its own
  const float mul[2] = {scale, scale};
  store_tile_warpgroup<T, NACC>(dq + (size_t)bh * Nq * D, acc, mul, row0, Nq,
                                D, vec, reinterpret_cast<T*>(sQ + wg * TILE),
                                1 + wg);
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const uint8_t* mask, const void* dout, const void* o,
                      const float* lse, float* di, void* dq, int BH, int H,
                      int Nq, int Nk, int D, float scale, int vec,
                      cudaStream_t stream) {
  const long long blocks = (long long)BH * ((Nq + 127) / 128);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<DP>();
  static_assert(smem <= SMEM_PER_BLOCK, "one block fits an SM");
  auto kernel = flash_bwd_dq_wgmma<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  TileMaps maps[4] = {};  // q, k, v, dout; unused without `vec`
  if (vec) {
    const void* bases[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i) {
      err = tile_maps<TileLayout<DP, true>>(&maps[i], bases[i], BH,
                                            i % 3 == 0 ? Nq : Nk, D);
      if (err != cudaSuccess) return err;
    }
  }
  // the q blocks of one (batch, head) are neighbours: they share its K and V
  kernel<<<(unsigned)blocks, DQ_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), static_cast<const T*>(o), lse, di,
      static_cast<T*>(dq), H, Nq, Nk, D, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const uint8_t* mask, const void* dout, const void* o,
                        const float* lse, float* di, void* dq, int BH, int H,
                        int Nq, int Nk, int D, float scale, int vec,
                        cudaStream_t stream) {
#define VIDEOSYS_ARGS q, k, v, mask, dout, o, lse, di, dq, BH, H, Nq, Nk, D, scale, vec, stream
  // head_dim padded to the next of 32, 64, 80, 128 columns
  if (D <= 32) return launch_dq<T, 32>(VIDEOSYS_ARGS);
  if (D <= 64) return launch_dq<T, 64>(VIDEOSYS_ARGS);
  if (D <= 80) return launch_dq<T, 80>(VIDEOSYS_ARGS);
  if (D <= 128) return launch_dq<T, 128>(VIDEOSYS_ARGS);
#undef VIDEOSYS_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q, dout, out (the forward's output), dq:
// [BH, Nq, D]; k, v: [BH, Nk, D], all contiguous and of one type (dtype 1 =
// bf16, 2 = fp16); mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse:
// [BH, Nq] fp32, the natural log-sum-exp of the scaled scores; di: [BH, Nq]
// fp32, written (rowsum(dO * O)). Launches on `stream` and returns the
// launch's cudaError_t (cudaErrorInvalidValue for a shape or type it does not
// take: head_dim above 128, fp32).
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* out, const void* lse, void* di,
                                  void* dq, int dtype, int BH, int H, int Nq,
                                  int Nk, int D, float scale, int vec,
                                  void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_dq<__nv_bfloat16>(q, k, v, m, dout, out, l, d, dq, BH,
                                           H, Nq, Nk, D, scale, vec, s);
  if (dtype == 2)
    return (int)dispatch_dq<__half>(q, k, v, m, dout, out, l, d, dq, BH, H, Nq,
                                    Nk, D, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory a block asks for at head_dim D with 2-byte
// elements, or -1; the wrapper mirrors the formula.
extern "C" long flash_bwd_dq_wgmma_smem(int D) {
  if (D <= 0 || D > 128) return -1;
  return (long)(D <= 32   ? dq_smem_bytes<32>()
                : D <= 64 ? dq_smem_bytes<64>()
                : D <= 80 ? dq_smem_bytes<80>()
                          : dq_smem_bytes<128>());
}

extern "C" const char* flash_bwd_dq_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
