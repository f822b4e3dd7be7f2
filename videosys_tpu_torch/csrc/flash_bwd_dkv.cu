// dk and dv of flash attention for bf16 and fp16 inputs on Hopper (sm_90a),
// from the forward's log-sum-exp and di = rowsum(dO * O), non-causal, with a
// [B, Nk] key mask.
//
// Replaces _flash_bwd_dkv_kernel (videosys_tpu/ops/flash_attention.py:522) of
// the JAX package, the dk/dv leg of its KV-blocked backward for long rows
// (the 8160-token row of a 1080p image):
//
//   S = scale * q k^T   P = exp(S - lse)   dP = dO v^T   dS = P * (dP - di)
//   dk = scale * dS^T q                    dv = P^T dO
//
// What bounds it on an H100: at the 1080p row (B*H = 16, N = 8160, D = 72)
// its four products are 8*B*H*N^2*D flop against 12*B*H*N*D bytes, far above
// the card's 295 flop per byte: operations, if the products are fed. The
// first design (mma.sync, four warps owning 64 keys, the streamed tiles
// loaded and waited for one by one, the row statistics read from device
// memory per element) reached a fifth of that.
//
// What this design does about it:
//   * A block of two warpgroups (256 threads) owns 128 keys of one (batch,
//     head): warpgroup w owns keys [64 w, 64 w + 64), K and V of them stay in
//     shared memory for the block's life and dk, dv of them in registers
//     (DP / 2 + DP / 2 a thread: 80 at D = 72). Every Q and dO tile crosses
//     L2 once per 128 keys.
//   * It walks the q rows in 64-row tiles; Q, dO and the tile's lse and di
//     come through a ring of DKV_STAGES stages: one thread asks the copy
//     engine (TMA, the tile layout of tma.cuh) for the Q and dO tiles
//     of tile i + 2 and 128 threads copy its lse and di by cp.async, before
//     the products of tile i; the warpgroups wait on the stage's mbarrier.
//     The row statistics sit in shared memory beside their tile. (A head
//     whose rows cannot be copied in 16-byte chunks is loaded element by
//     element by every thread instead.)
//   * Every product is a wgmma: S^T = K Q^T and dP^T = V dO^T (m64n64k16,
//     both operands from shared memory, 64 keys x 64 q rows); P^T and dS^T
//     leave the accumulators as register A operands of dv += P^T dO and dk
//     += dS^T Q (m64n{DP}k16, dO and Q read with their columns contiguous).
//   * No sum crosses blocks: no atomics, the same bits every run.
//   * The grid runs the key blocks of one (batch, head) next to each other,
//     so that they find its Q and dO in L2; dk and dv leave through shared
//     memory (the warpgroup's own K and V tiles) as 16-byte stores.
//
// Masking as in the forward: keys at or past Nk score -inf, masked keys
// -0.7*FLT_MAX, so their P and dS are exactly 0 and so are their dk, dv rows;
// a fully masked row (lse = MASK_VALUE) has P = 1/Nk on its Nk keys (dv
// follows, dk gets nothing from it: a masked score is a constant). q rows past
// Nq are zero filled (dO = 0, lse = di = 0), contribute nothing. head_dim is
// zero padded in shared memory to 32, 64, 80 or 128 columns. fp32 inputs take
// the SIMT kernel of flash_bwd.cu.

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int DKV_THREADS = 256;
constexpr int DKV_STAGES = 3;  // Q / dO / lse / di ring

template <int DP>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  // K and V of 128 keys, then per stage a Q and a dO tile of 64 rows and
  // the tile's lse and di, an mbarrier a stage and one for K and V
  return (size_t)(4 + 2 * DKV_STAGES) * 64 * DP * 2 +
         (size_t)DKV_STAGES * 2 * 64 * sizeof(float) + (DKV_STAGES + 1) * 8;
}

template <typename T, int DP>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ TileMaps tm_q,
                        const __grid_constant__ TileMaps tm_k,
                        const __grid_constant__ TileMaps tm_v,
                        const __grid_constant__ TileMaps tm_do,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Nq, int Nk, int D,
                        float scale, int vec) {
  using L = TileLayout<DP, false>;
  constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  constexpr int NACC = DP / 2;       // accumulator registers per thread
  constexpr int S = DKV_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;           // [2][TILE]: the block's 128 keys
  unsigned char* sV = sK + 2 * TILE;      // [2][TILE]
  unsigned char* sQ0 = sV + 2 * TILE;     // [S][TILE]
  unsigned char* sDO0 = sQ0 + S * TILE;   // [S][TILE]
  float* sL0 = reinterpret_cast<float*>(sDO0 + S * TILE);  // [S][64] lse
  float* sD0 = sL0 + S * 64;                               // [S][64] di
  uint64_t* bar = reinterpret_cast<uint64_t*>(sD0 + S * 64);  // [S], K/V

  const int n_kb = (Nk + 127) / 128;
  const int bh = blockIdx.x / n_kb;
  const int k0 = (blockIdx.x % n_kb) * 128;
  const int wg = threadIdx.x / 128;  // warpgroup: keys [64 wg, 64 wg + 64)
  const int tw = threadIdx.x % 128;  // thread within the warpgroup
  const int warp = tw / 32;          // warp within the warpgroup
  const int lane = threadIdx.x % 32;
  const int kw0 = k0 + wg * 64;      // this warpgroup's first key
  const bool live = kw0 < Nk;
  const int kv_tiles = k0 + 64 < Nk ? 2 : 1;  // the block's live key tiles
  const T* qb = q + (size_t)bh * Nq * D;
  const T* dob = dout + (size_t)bh * Nq * D;
  const float* lse_in = lse + (size_t)bh * Nq;
  const float* di_in = di + (size_t)bh * Nq;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const float scale_log2 = scale * LOG2E;
  const float inv_nk = 1.f / (float)Nk;

  if (vec) {
    // the copies never write the pad chunks: zero them in every tile once
    L::template zero_pad<DKV_THREADS>(smem_raw, 4 + 2 * S, D);
    if (threadIdx.x == 0) {
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
  // q tile starting at q0 -> stage `st`
  auto issue_tile = [&](int q0, int st) {
    if (vec) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar + st, 2 * L::tx_bytes(D));
        tma_tile<L>(smem_addr(sQ0 + st * TILE), tm_q, q0, bh, bar + st);
        tma_tile<L>(smem_addr(sDO0 + st * TILE), tm_do, q0, bh, bar + st);
      }
    } else {
      load_tile_rows<T, DKV_THREADS, L>(sQ0 + st * TILE, qb, q0, Nq, D);
      load_tile_rows<T, DKV_THREADS, L>(sDO0 + st * TILE, dob, q0, Nq, D);
    }
    if (threadIdx.x < 128) {
      // rows past Nq get 0: p = exp2(0 - 0) stays finite, dS = p * (0 - 0) = 0
      const int r = threadIdx.x % 64;
      const bool in = q0 + r < Nq;
      const float* src = threadIdx.x < 64 ? lse_in : di_in;
      float* dst = (threadIdx.x < 64 ? sL0 : sD0) + st * 64 + r;
      cp_async4(dst, in ? src + q0 + r : src, in ? 4 : 0);
    }
    cp_async_commit();
  };
  // keys past Nk are zero filled
  if (vec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar + S, 2 * kv_tiles * L::tx_bytes(D));
      for (int t = 0; t < kv_tiles; ++t) {
        tma_tile<L>(smem_addr(sK + t * TILE), tm_k, k0 + t * 64, bh, bar + S);
        tma_tile<L>(smem_addr(sV + t * TILE), tm_v, k0 + t * 64, bh, bar + S);
      }
    }
  } else {
    const T* kb = k + (size_t)bh * Nk * D;
    const T* vb = v + (size_t)bh * Nk * D;
    for (int t = 0; t < 2; ++t) {
      load_tile_rows<T, DKV_THREADS, L>(sK + t * TILE, kb, k0 + t * 64, Nk, D);
      load_tile_rows<T, DKV_THREADS, L>(sV + t * TILE, vb, k0 + t * 64, Nk, D);
    }
  }
  const int n_q = (Nq + 63) / 64;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_q) issue_tile(st * 64, st);
    else cp_async_commit();
  }

  // this thread's keys: kw0 + warp * 16 + lane / 4, and that + 8
  const int own_key = kw0 + warp * 16 + lane / 4;
  const int8_t own_flag[2] = {key_flag(mrow, own_key, Nk),
                              key_flag(mrow, own_key + 8, Nk)};
  // no key of this warp is masked or past Nk, and no row can be fully
  // masked: scores need no flags
  const bool plain = mrow == nullptr && kw0 + warp * 16 + 16 <= Nk;

  float acc_dk[NACC], acc_dv[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  const uint32_t k_addr = smem_addr(sK) + wg * TILE;
  const uint32_t v_addr = smem_addr(sV) + wg * TILE;
  if (vec && live) mbar_wait(bar + S, 0);

  for (int i = 0; i < n_q; ++i) {
    const int st = i % S;
    cp_async_wait_group<S - 2>();  // lse and di of tile i (this thread's)
    if (!vec) fence_async_shared();  // this thread's stores of tile i
    else if (live) mbar_wait(bar + st, (i / S) & 1);  // Q, dO of tile i
    __syncthreads();  // tile i is in; both warpgroups are done with tile i - 1
    if (i + S - 1 < n_q) issue_tile((i + S - 1) * 64, (i + S - 1) % S);
    else cp_async_commit();  // keeps the count of groups in flight the same
    if (!live) continue;
    const uint32_t q_addr = smem_addr(sQ0 + st * TILE);
    const uint32_t do_addr = smem_addr(sDO0 + st * TILE);
    const float* sL = sL0 + st * 64;
    const float* sD = sD0 + st * 64;

    // s = K Q^T and dp = V dO^T: 64 keys x 64 q rows; element 4 n + e: key
    // warp * 16 + lane / 4 + (e / 2) * 8 of the warpgroup's, q row n * 8 +
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
      wgmma_ss_n64<T>(s, L::k_major(k_addr, kk), L::k_major(q_addr, kk), 1);
      wgmma_ss_n64<T>(dp, L::k_major(v_addr, kk), L::k_major(do_addr, kk), 1);
    }
    wgmma_commit();
    wgmma_wait();
    // P^T and dS^T = P^T * (dP^T - di), packed as A operands
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], ds[4];
      float c_lse[2], c_di[2], c_pmul[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n * 8 + (lane % 4) * 2 + jj;
        const float l = sL[col];
        // a fully masked row: lse = MASK_VALUE, P = 1 / Nk
        const bool dead = l <= MASK_HALF;
        c_lse[jj] = dead ? MASK_VALUE : l * LOG2E;
        c_pmul[jj] = dead ? inv_nk : 1.f;
        c_di[jj] = sD[col];
      }
      if (plain) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(s[4 * n + e], scale_log2, -c_lse[e & 1]));
          ds[e] = p[e] * (dp[4 * n + e] - c_di[e & 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              masked_score(s[4 * n + e] * scale_log2, own_flag[e / 2]);
          p[e] = fast_exp2(x - c_lse[e & 1]) * c_pmul[e & 1];
          // a masked score is a constant: no gradient reaches k through it
          // (only a fully masked row has p != 0 there)
          ds[e] = x == MASK_VALUE ? 0.f : p[e] * (dp[4 * n + e] - c_di[e & 1]);
        }
      }
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p[2], p[3]);
      dsa[n / 2][(n % 2) * 2] = Ops<T>::pack(ds[0], ds[1]);
      dsa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(ds[2], ds[3]);
    }
    // dv += P^T dO, dk += dS^T Q: depth = the 64 q rows, four 16-row steps
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      L::template mn_product<T>(acc_dv, pa[ks], do_addr, ks);
      L::template mn_product<T>(acc_dk, dsa[ks], q_addr, ks);
    }
    wgmma_commit();
    wgmma_wait();
  }
  if (!live) return;

  // the warpgroup's K and V tiles are free: its last products have been
  // waited for, and the other warpgroup reads only its own
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_tile_warpgroup<T, NACC>(dk + (size_t)bh * Nk * D, acc_dk, dk_mul, kw0,
                                Nk, D, vec, reinterpret_cast<T*>(sK + wg * TILE),
                                1 + wg);
  store_tile_warpgroup<T, NACC>(dv + (size_t)bh * Nk * D, acc_dv, dv_mul, kw0,
                                Nk, D, vec, reinterpret_cast<T*>(sV + wg * TILE),
                                1 + wg);
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const uint8_t* mask, const void* dout, const float* lse,
                       const float* di, void* dk, void* dv, int BH, int H,
                       int Nq, int Nk, int D, float scale, int vec,
                       cudaStream_t stream) {
  const long long blocks = (long long)BH * ((Nk + 127) / 128);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  static_assert(smem <= SMEM_PER_BLOCK, "one block fits an SM");
  auto kernel = flash_bwd_dkv_wgmma<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  TileMaps maps[4] = {};  // q, k, v, dout; unused without `vec`
  if (vec) {
    const void* bases[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i) {
      err = tile_maps<TileLayout<DP, false>>(&maps[i], bases[i], BH, i % 3 == 0 ? Nq : Nk, D);
      if (err != cudaSuccess) return err;
    }
  }
  // the key blocks of one (batch, head) are neighbours: they share its Q, dO
  kernel<<<(unsigned)blocks, DKV_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Nq, Nk, D, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const uint8_t* mask, const void* dout,
                         const float* lse, const float* di, void* dk, void* dv,
                         int BH, int H, int Nq, int Nk, int D, float scale,
                         int vec, cudaStream_t stream) {
#define VIDEOSYS_ARGS q, k, v, mask, dout, lse, di, dk, dv, BH, H, Nq, Nk, D, scale, vec, stream
  // head_dim padded to the next of 32, 64, 80, 128 columns
  if (D <= 32) return launch_dkv<T, 32>(VIDEOSYS_ARGS);
  if (D <= 64) return launch_dkv<T, 64>(VIDEOSYS_ARGS);
  if (D <= 80) return launch_dkv<T, 80>(VIDEOSYS_ARGS);
  if (D <= 128) return launch_dkv<T, 128>(VIDEOSYS_ARGS);
#undef VIDEOSYS_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q, dout: [BH, Nq, D]; k, v, dk, dv:
// [BH, Nk, D], all contiguous and of one type (dtype 1 = bf16, 2 = fp16);
// mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse, di: [BH, Nq]
// fp32 (lse the natural log-sum-exp of the scaled scores). Launches on
// `stream` and returns the launch's cudaError_t (cudaErrorInvalidValue for
// a shape or type it does not take: head_dim above 128, fp32).
extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* dout, const void* lse,
                                   const void* di, void* dk, void* dv,
                                   int dtype, int BH, int H, int Nq, int Nk,
                                   int D, float scale, int vec, void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_dkv<__nv_bfloat16>(q, k, v, m, dout, l, d, dk, dv,
                                            BH, H, Nq, Nk, D, scale, vec, s);
  if (dtype == 2)
    return (int)dispatch_dkv<__half>(q, k, v, m, dout, l, d, dk, dv, BH, H,
                                     Nq, Nk, D, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory a block asks for at head_dim D with 2-byte
// elements, or -1; the wrapper mirrors the formula.
extern "C" long flash_bwd_dkv_wgmma_smem(int D) {
  if (D <= 0 || D > 128) return -1;
  return (long)(D <= 32   ? dkv_smem_bytes<32>()
                : D <= 64 ? dkv_smem_bytes<64>()
                : D <= 80 ? dkv_smem_bytes<80>()
                          : dkv_smem_bytes<128>());
}

extern "C" const char* flash_bwd_dkv_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
