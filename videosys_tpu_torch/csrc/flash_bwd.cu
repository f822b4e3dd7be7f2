// Flash-attention backward for Hopper (sm_90a), non-causal, with a [B, Nk]
// key mask: the blocked pair, and the fused backward for fp32 inputs.
//
// With flash_bwd_fused.cu this replaces the three backward Pallas kernels of
// the JAX package, videosys_tpu/ops/flash_attention.py:
//   * _flash_bwd_kernel (:326)      -> flash_bwd_fused: dq, dk, dv from
//     (q, k, v, mask, dO) alone, no residual of the forward. Here only its
//     fp32 form (a SIMT loop); bf16 and fp16 inputs, the main path's, take
//     the tensor-core kernels of flash_bwd_fused.cu;
//   * _flash_bwd_dkv_kernel (:522)  -> flash_bwd_dkv: dk, dv from the
//     forward's log-sum-exp and di = rowsum(dO * O);
//   * _flash_bwd_dq_kernel (:594)   -> flash_bwd_dq: dq from the same.
//
//   S = scale * q k^T      P = softmax(S)       dP = dO v^T
//   dS = P * (dP - delta)  delta = rowsum(P * dP) = rowsum(dO * O)
//   dq = scale * dS k      dk = scale * dS^T q  dv = P^T dO
//
// The blocked pair is built from one tile loop (`bwd_tile_loop`), which a
// block runs over a 64-row tile it owns while it streams 64-row tiles of the
// other side through shared memory:
//   * DQ:    owns 64 q rows, streams the keys; S and dP tiles come out of
//            mma.sync in the accumulator layout, which is the A-operand
//            layout of the next product, so dS feeds dq += dS k from
//            registers;
//   * DKV:   owns 64 keys, streams the q rows; it computes the transposed
//            tiles S^T = k q^T and dP^T = v dO^T, so that P^T and dS^T feed
//            dv += P^T dO and dk += dS^T q from registers as well.
// The fp32 loop (`bwd_tile_loop_f32`) has a third role, STATS: it owns 64 q
// rows, streams the keys and keeps a running (max, sum, sum of e * dP) per
// row, the row's log-sum-exp and delta; the fp32 fused kernel runs STATS,
// then DKV, then DQ in one block per (batch, head).
// No [Nq, Nk] tensor reaches device memory, and no sum crosses blocks, so
// there are no atomics and results do not change from run to run.
//
// What bounds them on an H100: at the 1080p image row (N = 8160, D = 72) the
// pair's seven products are 14*B*H*N^2*D flop against 16*B*H*N*D bytes, far
// above the card's 295 flop per byte, so the products run on the tensor
// cores (mma.sync m16n8k16, bf16 or fp16 in, fp32 accumulate) and the grids
// spread over the tiles: (B*H, key tiles) and (B*H, q tiles).
//
// Masking as in the forward: keys at or past Nk score -inf, masked keys
// -0.7*FLT_MAX, so their P and dS are exactly 0 and so are their dk, dv rows;
// a fully masked row has P = 1/Nk on its Nk keys (dv follows, dq and dk get
// nothing from it: a masked score is a constant). q rows past Nq are zero
// filled (dO = 0), contribute nothing and are not written. head_dim is zero
// padded in shared memory to 32, 64, 80 or 128 columns.
//
// What the pair's simple design gives up: wgmma and TMA, double buffering of
// the streamed tiles, and the two recomputed products (S and dP in both
// orientations).

#include "flash_common.cuh"

namespace {

constexpr int MODE_DQ = 0;
constexpr int MODE_DKV = 1;
constexpr int MODE_STATS = 2;

// Row statistics as the loops read them: log-sum-exp in log2 units (a fully
// masked row: MASK_VALUE, with P = 1/Nk), and delta.
struct RowStats {
  const float* lse;    // [Nq]; natural log unless `log2_units`
  const float* delta;  // [Nq]
  bool log2_units;
};

__device__ __forceinline__ void load_stats(const RowStats& st, int row, int Nq,
                                           int Nk, float& lse2, float& delta,
                                           float& pmul) {
  // rows past Nq: p = exp2(0 - 0) stays finite and dS = p * (0 - 0) = 0
  float l = 0.f;
  delta = 0.f;
  pmul = 1.f;
  if (row < Nq) {
    l = st.lse[row];
    delta = st.delta[row];
    if (l <= MASK_HALF) {
      l = MASK_VALUE;
      pmul = 1.f / (float)Nk;
    } else if (!st.log2_units) {
      l *= LOG2E;
    }
  }
  lse2 = l;
}

// Shared memory of the tensor-core loop: four [64][DP + PAD] tiles and 64
// key flags.
template <typename T, int NT>
__host__ __device__ constexpr size_t mma_tiles_bytes() {
  return (size_t)4 * 64 * (NT * 8 + PAD) * sizeof(T) + 64;
}

// One owned 64-row tile against every streamed tile; 128 threads, warp w owns
// rows [16 w, 16 w + 16) of the owned tile. `own0` is the first owned row (a
// q row, or a key in MODE_DKV). MODE_DQ writes out1 = dq rows; MODE_DKV writes
// out1 = dk, out2 = dv rows.
template <typename T, int NT, int MODE>
__device__ __forceinline__ void bwd_tile_loop(
    unsigned char* smem, const T* qb, const T* kb, const T* vb, const T* dob,
    const uint8_t* mrow, RowStats st, T* out1, T* out2, int own0, int Nq,
    int Nk, int D, float scale, int vec) {
  static_assert(MODE == MODE_DQ || MODE == MODE_DKV, "the blocked pair");
  constexpr int DP = NT * 8;
  constexpr int ld = DP + PAD;
  constexpr int NT2 = MODE == MODE_DKV ? NT : 1;
  T* sX1 = reinterpret_cast<T*>(smem);
  T* sX2 = sX1 + 64 * ld;
  T* sY1 = sX2 + 64 * ld;
  T* sY2 = sY1 + 64 * ld;
  int8_t* sF = reinterpret_cast<int8_t*>(sY2 + 64 * ld);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* x1 = MODE == MODE_DKV ? kb : qb;
  const T* x2 = MODE == MODE_DKV ? vb : dob;
  const T* y1 = MODE == MODE_DKV ? qb : kb;
  const T* y2 = MODE == MODE_DKV ? dob : vb;
  const int n_own = MODE == MODE_DKV ? Nk : Nq;
  const int n_stream = MODE == MODE_DKV ? Nq : Nk;
  const float scale_log2 = scale * LOG2E;

  __syncthreads();  // whoever used this shared memory before is done
  load_tile(sX1, ld, x1, own0, n_own, 0, DP, D, vec);
  load_tile(sX2, ld, x2, own0, n_own, 0, DP, D, vec);

  // this thread's two owned rows: own0 + warp*16 + lane/4, and that + 8
  const int own_row = own0 + warp * 16 + lane / 4;
  float own_lse[2] = {0.f, 0.f}, own_delta[2] = {0.f, 0.f},
        own_pmul[2] = {1.f, 1.f};
  int8_t own_flag[2] = {1, 1};
  if (MODE == MODE_DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      load_stats(st, own_row + r * 8, Nq, Nk, own_lse[r], own_delta[r],
                 own_pmul[r]);
  }
  if (MODE == MODE_DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      own_flag[r] = key_flag(mrow, own_row + r * 8, Nk);
  }
  float acc1[NT][4];
  float acc2[NT2][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;

  for (int t0 = 0; t0 < n_stream; t0 += 64) {
    if (t0 > 0) __syncthreads();  // every warp is done with the last tile
    load_tile(sY1, ld, y1, t0, n_stream, 0, DP, D, vec);
    load_tile(sY2, ld, y2, t0, n_stream, 0, DP, D, vec);
    if (MODE != MODE_DKV && threadIdx.x < 64)
      sF[threadIdx.x] = key_flag(mrow, t0 + threadIdx.x, Nk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // s = X1 Y1^T and dp = X2 Y2^T: this warp's 16 rows x 64 streamed rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a1[4], a2[4];
      const int a_off =
          (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld + kk +
          (lane / 16) * 8;
      ldmatrix_x4(a1, sX1 + a_off);
      ldmatrix_x4(a2, sX2 + a_off);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        const int b_off = (p * 16 + (lane % 8) + (lane / 16) * 8) * ld + kk +
                          ((lane / 8) % 2) * 8;
        ldmatrix_x4(b, sY1 + b_off);
        Ops<T>::mma(s[2 * p], a1, b);
        Ops<T>::mma(s[2 * p + 1], a1, b + 2);
        ldmatrix_x4(b, sY2 + b_off);
        Ops<T>::mma(dp[2 * p], a2, b);
        Ops<T>::mma(dp[2 * p + 1], a2, b + 2);
      }
    }

    // scores in log2 units, masked; element (n, e) is owned row e / 2 and
    // streamed row n*8 + (lane%4)*2 + (e&1)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int8_t flag = MODE == MODE_DKV
                                ? own_flag[e / 2]
                                : sF[n * 8 + (lane % 4) * 2 + (e & 1)];
        s[n][e] = masked_score(s[n][e] * scale_log2, flag);
      }

    // P and dS = P * (dP - delta), packed as A operands
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], ds[4];
      float c_lse[2] = {0.f, 0.f}, c_delta[2] = {0.f, 0.f},
            c_pmul[2] = {1.f, 1.f};
      if (MODE == MODE_DKV) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          load_stats(st, t0 + n * 8 + (lane % 4) * 2 + j, Nq, Nk, c_lse[j],
                     c_delta[j], c_pmul[j]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = MODE == MODE_DKV ? c_lse[e & 1] : own_lse[e / 2];
        const float delta =
            MODE == MODE_DKV ? c_delta[e & 1] : own_delta[e / 2];
        const float pmul = MODE == MODE_DKV ? c_pmul[e & 1] : own_pmul[e / 2];
        p[e] = exp2f(s[n][e] - lse2) * pmul;
        // a masked score is a constant: no gradient reaches q and k through
        // it (only a fully masked row has p != 0 there)
        ds[e] = s[n][e] == MASK_VALUE ? 0.f : p[e] * (dp[n][e] - delta);
      }
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p[2], p[3]);
      dsa[n / 2][(n % 2) * 2] = Ops<T>::pack(ds[0], ds[1]);
      dsa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(ds[2], ds[3]);
    }

    // acc1 += dS Y1 (dq += dS k, or dk += dS^T q); MODE_DKV: acc2 += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dpi = 0; dpi < NT / 2; ++dpi) {
        uint32_t b[4];
        const int b_off = (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld +
                          dpi * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(b, sY1 + b_off);
        Ops<T>::mma(acc1[2 * dpi], dsa[kk], b);
        Ops<T>::mma(acc1[2 * dpi + 1], dsa[kk], b + 2);
        if (MODE == MODE_DKV) {
          ldmatrix_x4_trans(b, sY2 + b_off);
          Ops<T>::mma(acc2[(2 * dpi) % NT2], pa[kk], b);
          Ops<T>::mma(acc2[(2 * dpi + 1) % NT2], pa[kk], b + 2);
        }
      }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + (lane % 4) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = own_row + (e / 2) * 8;
      const int c = col + (e & 1);
      if (r < n_own && c < D) {
        out1[(size_t)r * D + c] = Ops<T>::from_float(acc1[n][e] * scale);
        if (MODE == MODE_DKV)
          out2[(size_t)r * D + c] = Ops<T>::from_float(acc2[n % NT2][e]);
      }
    }
  }
}

// Grid (B*H, key tiles) for MODE_DKV, (B*H, q tiles) for MODE_DQ; lse and
// di are [B*H, Nq] fp32 in device memory.
template <typename T, int NT, int MODE>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_blocked_mma(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ out1,
                          T* __restrict__ out2, int H, int Nq, int Nk, int D,
                          float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int n_own = MODE == MODE_DKV ? Nk : Nq;
  const RowStats st{lse + (size_t)bh * Nq, di + (size_t)bh * Nq, false};
  bwd_tile_loop<T, NT, MODE>(
      smem_raw, q + (size_t)bh * Nq * D, k + (size_t)bh * Nk * D,
      v + (size_t)bh * Nk * D, dout + (size_t)bh * Nq * D,
      mask ? mask + (size_t)(bh / H) * Nk : nullptr, st,
      out1 + (size_t)bh * n_own * D,
      MODE == MODE_DKV ? out2 + (size_t)bh * n_own * D : nullptr,
      blockIdx.y * 64, Nq, Nk, D, scale, vec);
}

// ---- fp32: SIMT loop with the same structure ------------------------------
//
// 256 threads as 16 x 16; thread (ty, tx) holds the score elements of owned
// rows ty + 16 i and streamed rows tx + 16 j (i, j < 4), and the output
// elements of owned rows ty + 16 i and columns tx + 16 jj (jj < 8: head_dim
// <= 128). P and dS go through shared memory between the two products.

constexpr int F32_THREADS = 256;
constexpr int F32_LDP = 65;  // row stride of the P and dS tiles

__host__ __device__ inline int f32_ld(int D) { return ((D + 15) / 16 * 16) | 1; }

__host__ __device__ inline size_t f32_tiles_bytes(int D) {
  return (size_t)(4 * 64 * f32_ld(D) + 2 * 64 * F32_LDP) * sizeof(float) + 64;
}

// rows [row0, row0 + 64) of a row-major [N, D] matrix into a [64][ld] tile,
// zero filled past N and past D
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src, int row0,
                                              int N, int D) {
  for (int i = threadIdx.x; i < 64 * ld; i += F32_THREADS) {
    const int r = i / ld, c = i % ld;
    const int grow = row0 + r;
    dst[i] = (grow < N && c < D) ? src[(size_t)grow * D + c] : 0.f;
  }
}

template <int MODE>
__device__ __forceinline__ void bwd_tile_loop_f32(
    unsigned char* smem, const float* qb, const float* kb, const float* vb,
    const float* dob, const uint8_t* mrow, RowStats st, float* stats_lse,
    float* stats_delta, float* out1, float* out2, int own0, int Nq, int Nk,
    int D, float scale) {
  const int ld = f32_ld(D);
  const int ND = (D + 15) / 16;
  float* sX1 = reinterpret_cast<float*>(smem);
  float* sX2 = sX1 + 64 * ld;
  float* sY1 = sX2 + 64 * ld;
  float* sY2 = sY1 + 64 * ld;
  float* sP = sY2 + 64 * ld;
  float* sDS = sP + 64 * F32_LDP;
  int8_t* sF = reinterpret_cast<int8_t*>(sDS + 64 * F32_LDP);

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* x1 = MODE == MODE_DKV ? kb : qb;
  const float* x2 = MODE == MODE_DKV ? vb : dob;
  const float* y1 = MODE == MODE_DKV ? qb : kb;
  const float* y2 = MODE == MODE_DKV ? dob : vb;
  const int n_own = MODE == MODE_DKV ? Nk : Nq;
  const int n_stream = MODE == MODE_DKV ? Nq : Nk;
  const float scale_log2 = scale * LOG2E;

  __syncthreads();
  load_tile_f32(sX1, ld, x1, own0, n_own, D);
  load_tile_f32(sX2, ld, x2, own0, n_own, D);

  float own_lse[4], own_delta[4], own_pmul[4];
  int8_t own_flag[4];
  float m_r[4], l_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = own0 + ty + 16 * i;
    own_lse[i] = 0.f;
    own_delta[i] = 0.f;
    own_pmul[i] = 1.f;
    own_flag[i] = 1;
    if (MODE == MODE_DQ)
      load_stats(st, row, Nq, Nk, own_lse[i], own_delta[i], own_pmul[i]);
    if (MODE == MODE_DKV) own_flag[i] = key_flag(mrow, row, Nk);
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
    d_r[i] = 0.f;
  }
  float acc1[4][8], acc2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      acc1[i][jj] = 0.f;
      acc2[i][jj] = 0.f;
    }

  for (int t0 = 0; t0 < n_stream; t0 += 64) {
    __syncthreads();  // every thread is done with the last tile
    load_tile_f32(sY1, ld, y1, t0, n_stream, D);
    load_tile_f32(sY2, ld, y2, t0, n_stream, D);
    if (MODE != MODE_DKV && threadIdx.x < 64)
      sF[threadIdx.x] = key_flag(mrow, t0 + threadIdx.x, Nk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int d = 0; d < D; ++d) {
      float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = sX1[(ty + 16 * i) * ld + d];
        a2[i] = sX2[(ty + 16 * i) * ld + d];
        b1[i] = sY1[(tx + 16 * i) * ld + d];
        b2[i] = sY2[(tx + 16 * i) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a1[i], b1[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t flag = MODE == MODE_DKV ? own_flag[i] : sF[tx + 16 * j];
        s[i][j] = masked_score(s[i][j] * scale_log2, flag);
      }

    if (MODE == MODE_STATS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int off = 8; off > 0; off /= 2)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m_r[i], mt);
        const float alpha = exp2f(m_r[i] - m_new);
        m_r[i] = m_new;
        l_r[i] *= alpha;
        d_r[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(s[i][j] - m_new);
          l_r[i] += p;
          d_r[i] += p * dp[i][j];
        }
      }
      continue;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float c_lse = 0.f, c_delta = 0.f, c_pmul = 1.f;
      if (MODE == MODE_DKV)
        load_stats(st, t0 + tx + 16 * j, Nq, Nk, c_lse, c_delta, c_pmul);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lse2 = MODE == MODE_DKV ? c_lse : own_lse[i];
        const float delta = MODE == MODE_DKV ? c_delta : own_delta[i];
        const float pmul = MODE == MODE_DKV ? c_pmul : own_pmul[i];
        const float p = exp2f(s[i][j] - lse2) * pmul;
        sP[(ty + 16 * i) * F32_LDP + tx + 16 * j] = p;
        // a masked score is a constant: no gradient reaches q and k
        sDS[(ty + 16 * i) * F32_LDP + tx + 16 * j] =
            s[i][j] == MASK_VALUE ? 0.f : p * (dp[i][j] - delta);
      }
    }
    __syncthreads();

    for (int c = 0; c < 64; ++c) {
      float ds[4], p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[i] = sDS[(ty + 16 * i) * F32_LDP + c];
        p[i] = sP[(ty + 16 * i) * F32_LDP + c];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj < ND) {
          const float y1v = sY1[c * ld + tx + 16 * jj];
          const float y2v = MODE == MODE_DKV ? sY2[c * ld + tx + 16 * jj] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc1[i][jj] = fmaf(ds[i], y1v, acc1[i][jj]);
            if (MODE == MODE_DKV) acc2[i][jj] = fmaf(p[i], y2v, acc2[i][jj]);
          }
        }
      }
    }
  }

  if (MODE == MODE_STATS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l = l_r[i], d = d_r[i];
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
        d += __shfl_xor_sync(0xffffffffu, d, off);
      }
      if (tx == 0) {
        stats_lse[own0 + ty + 16 * i] =
            m_r[i] <= MASK_HALF ? MASK_VALUE : m_r[i] + log2f(l);
        stats_delta[own0 + ty + 16 * i] = d / l;
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = own0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = tx + 16 * jj;
      if (r < n_own && c < D) {
        out1[(size_t)r * D + c] = acc1[i][jj] * scale;
        if (MODE == MODE_DKV) out2[(size_t)r * D + c] = acc2[i][jj];
      }
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_fused_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ dout, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv, int H,
                        int Nq, int Nk, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq_pad = (Nq + 63) / 64 * 64;
  // the tiles' byte count ends in the 64 key flags: a multiple of 4
  float* s_lse = reinterpret_cast<float*>(smem_raw + f32_tiles_bytes(D));
  float* s_delta = s_lse + nq_pad;
  const int bh = blockIdx.x;
  const float* qb = q + (size_t)bh * Nq * D;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;
  const float* dob = dout + (size_t)bh * Nq * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
  const RowStats st{s_lse, s_delta, true};
  for (int q0 = 0; q0 < Nq; q0 += 64)
    bwd_tile_loop_f32<MODE_STATS>(smem_raw, qb, kb, vb, dob, mrow, st, s_lse,
                                  s_delta, nullptr, nullptr, q0, Nq, Nk, D,
                                  scale);
  for (int k0 = 0; k0 < Nk; k0 += 64)
    bwd_tile_loop_f32<MODE_DKV>(smem_raw, qb, kb, vb, dob, mrow, st, nullptr,
                                nullptr, dk + (size_t)bh * Nk * D,
                                dv + (size_t)bh * Nk * D, k0, Nq, Nk, D,
                                scale);
  for (int q0 = 0; q0 < Nq; q0 += 64)
    bwd_tile_loop_f32<MODE_DQ>(smem_raw, qb, kb, vb, dob, mrow, st, nullptr,
                               nullptr, dq + (size_t)bh * Nq * D, nullptr, q0,
                               Nq, Nk, D, scale);
}

template <int MODE>
__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_blocked_f32(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          float* __restrict__ out1, float* __restrict__ out2,
                          int H, int Nq, int Nk, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int n_own = MODE == MODE_DKV ? Nk : Nq;
  const RowStats st{lse + (size_t)bh * Nq, di + (size_t)bh * Nq, false};
  bwd_tile_loop_f32<MODE>(
      smem_raw, q + (size_t)bh * Nq * D, k + (size_t)bh * Nk * D,
      v + (size_t)bh * Nk * D, dout + (size_t)bh * Nq * D,
      mask ? mask + (size_t)(bh / H) * Nk : nullptr, st, nullptr, nullptr,
      out1 + (size_t)bh * n_own * D,
      MODE == MODE_DKV ? out2 + (size_t)bh * n_own * D : nullptr,
      blockIdx.y * 64, Nq, Nk, D, scale);
}

// ---- launches -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const uint8_t* mask;
  const float *lse, *di;
  void *out1, *out2, *out3;  // fused: dq, dk, dv; dkv: dk, dv; dq: dq
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

// kind: 1 dkv, 2 dq (0, the fused backward, takes 16-bit inputs in
// flash_bwd_fused.cu)
template <typename T, int NT>
cudaError_t launch_mma(int kind, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const size_t smem = mma_tiles_bytes<T, NT>();
  cudaError_t err;
  if (kind == 0) return cudaErrorInvalidValue;
  if (kind == 1) {
    auto kernel = flash_bwd_blocked_mma<T, NT, MODE_DKV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(a.BH, (a.Nk + 63) / 64);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, a.lse, a.di, static_cast<T*>(a.out1),
        static_cast<T*>(a.out2), a.H, a.Nq, a.Nk, a.D, a.scale, a.vec);
  } else {
    auto kernel = flash_bwd_blocked_mma<T, NT, MODE_DQ>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(a.BH, (a.Nq + 63) / 64);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, a.lse, a.di, static_cast<T*>(a.out1), nullptr,
        a.H, a.Nq, a.Nk, a.D, a.scale, a.vec);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(int kind, const Args& a) {
  // head_dim padded to the next of 32, 64, 80, 128 columns
  if (a.D <= 32) return launch_mma<T, 4>(kind, a);
  if (a.D <= 64) return launch_mma<T, 8>(kind, a);
  if (a.D <= 80) return launch_mma<T, 10>(kind, a);
  if (a.D <= 128) return launch_mma<T, 16>(kind, a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(int kind, const Args& a) {
  if (a.D > 128) return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  size_t smem = f32_tiles_bytes(a.D);
  cudaError_t err;
  if (kind == 0) {
    smem += (size_t)2 * ((a.Nq + 63) / 64 * 64) * sizeof(float);
    if ((err = set_smem(flash_bwd_fused_f32, smem)) != cudaSuccess) return err;
    flash_bwd_fused_f32<<<a.BH, F32_THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, static_cast<float*>(a.out1),
        static_cast<float*>(a.out2), static_cast<float*>(a.out3), a.H, a.Nq,
        a.Nk, a.D, a.scale);
  } else if (kind == 1) {
    auto kernel = flash_bwd_blocked_f32<MODE_DKV>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(a.BH, (a.Nk + 63) / 64);
    kernel<<<grid, F32_THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, a.lse, a.di, static_cast<float*>(a.out1),
        static_cast<float*>(a.out2), a.H, a.Nq, a.Nk, a.D, a.scale);
  } else {
    auto kernel = flash_bwd_blocked_f32<MODE_DQ>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid(a.BH, (a.Nq + 63) / 64);
    kernel<<<grid, F32_THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, a.lse, a.di, static_cast<float*>(a.out1),
        nullptr, a.H, a.Nq, a.Nk, a.D, a.scale);
  }
  return cudaGetLastError();
}

int launch(int kind, int dtype, const Args& a) {
  if (a.BH <= 0 || a.H <= 0 || a.Nq <= 0 || a.Nk <= 0 || a.D <= 0 ||
      (a.Nq + 63) / 64 > 65535 || (a.Nk + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_f32(kind, a);
  if (dtype == 1) return (int)dispatch_mma<__nv_bfloat16>(kind, a);
  if (dtype == 2) return (int)dispatch_mma<__half>(kind, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q, dout, dq: [BH, Nq, D]; k, v, dk, dv:
// [BH, Nk, D], all contiguous and of one type (dtype 0 = fp32, 1 = bf16,
// 2 = fp16); mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse, di:
// [BH, Nq] fp32. Each launches on `stream` and returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape it does not take: head_dim
// above 128, or row statistics that do not fit the block's shared memory).
// flash_bwd_fused here takes fp32 inputs only; bf16 and fp16 go to
// flash_bwd_fused_mma in flash_bwd_fused.cu.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* mask, const void* dout, void* dq,
                               void* dk, void* dv, int dtype, int BH, int H,
                               int Nq, int Nk, int D, float scale, int vec,
                               void* stream) {
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask), nullptr,
               nullptr, dq, dk, dv, BH, H, Nq, Nk, D, scale, vec,
               static_cast<cudaStream_t>(stream)};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch(0, dtype, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* mask, const void* dout,
                             const void* lse, const void* di, void* dk,
                             void* dv, int dtype, int BH, int H, int Nq,
                             int Nk, int D, float scale, int vec,
                             void* stream) {
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(di),
               dk, dv, nullptr, BH, H, Nq, Nk, D, scale, vec,
               static_cast<cudaStream_t>(stream)};
  return launch(1, dtype, a);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout,
                            const void* lse, const void* di, void* dq,
                            int dtype, int BH, int H, int Nq, int Nk, int D,
                            float scale, int vec, void* stream) {
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(di),
               dq, nullptr, nullptr, BH, H, Nq, Nk, D, scale, vec,
               static_cast<cudaStream_t>(stream)};
  return launch(2, dtype, a);
}

// Bytes of shared memory the fp32 flash_bwd_fused asks for, or -1 for a
// head_dim it does not take; the wrapper's dispatch reads the same formula.
extern "C" long flash_bwd_fused_smem(int Nq, int D) {
  if (D <= 0 || D > 128 || Nq <= 0) return -1;
  const size_t stats = (size_t)2 * ((Nq + 63) / 64 * 64) * sizeof(float);
  return (long)(f32_tiles_bytes(D) + stats);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
