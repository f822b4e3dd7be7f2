// Flash-attention backward for Hopper (sm_90a), non-causal, with a [B, Nk]
// key mask: the fp32 kernels.
//
// With flash_bwd_fused.cu, flash_bwd_dkv.cu and flash_bwd_dq.cu this replaces
// the three backward Pallas kernels of the JAX package,
// videosys_tpu/ops/flash_attention.py:
//   * _flash_bwd_kernel (:326)      -> flash_bwd_fused: dq, dk, dv from
//     (q, k, v, mask, dO) alone, no residual of the forward;
//   * _flash_bwd_dkv_kernel (:522)  -> flash_bwd_dkv: dk, dv from the
//     forward's log-sum-exp and di = rowsum(dO * O);
//   * _flash_bwd_dq_kernel (:594)   -> flash_bwd_dq: dq from the forward's
//     log-sum-exp and output, and di, which it computes first.
// Here only their fp32 forms (a SIMT loop); bf16 and fp16 inputs, the main
// path's, take the tensor-core kernels of the other three files.
//
//   S = scale * q k^T      P = softmax(S)       dP = dO v^T
//   dS = P * (dP - delta)  delta = rowsum(P * dP) = rowsum(dO * O)
//   dq = scale * dS k      dk = scale * dS^T q  dv = P^T dO
//
// The loop (`bwd_tile_loop_f32`) runs a block over a 64-row tile it owns
// while it streams 64-row tiles of the other side, in three roles: DQ (owns q
// rows, streams the keys; in the blocked pair it first computes di of its rows
// from dO and O and writes it out), DKV (owns keys, streams the q rows, and
// computes the transposed tiles S^T and dP^T) and STATS (owns q rows, streams
// the keys and keeps a running (max, sum, sum of e * dP) per row, the row's
// log-sum-exp and delta); the fused kernel runs STATS, then DKV, then DQ in
// one block per (batch, head). No [Nq, Nk] tensor reaches device memory, and
// no sum crosses blocks, so there are no atomics and results do not change
// from run to run. fp32 is off the main path (the model computes in bf16):
// these kernels serve the fp32 checks against the JAX package's tolerances.
//
// Masking as in the forward: keys at or past Nk score -inf, masked keys
// -0.7*FLT_MAX, so their P and dS are exactly 0 and so are their dk, dv rows;
// a fully masked row has P = 1/Nk on its Nk keys (dv follows, dq and dk get
// nothing from it: a masked score is a constant). q rows past Nq are zero
// filled (dO = 0), contribute nothing and are not written.

#include "flash_common.cuh"

namespace {

constexpr int MODE_DQ = 0;
constexpr int MODE_DKV = 1;
constexpr int MODE_STATS = 2;

// Row statistics as the loops read them: log-sum-exp in log2 units (a fully
// masked row: MASK_VALUE, with P = 1/Nk), and delta.
struct RowStats {
  const float* lse;    // [Nq]; natural log unless `log2_units`
  const float* delta;  // [Nq], or null where the loop computes it
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
    if (st.delta) delta = st.delta[row];
    if (l <= MASK_HALF) {
      l = MASK_VALUE;
      pmul = 1.f / (float)Nk;
    } else if (!st.log2_units) {
      l *= LOG2E;
    }
  }
  lse2 = l;
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
    int D, float scale, const float* ob = nullptr, float* di_out = nullptr) {
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
  if (MODE == MODE_DQ && ob != nullptr) {
    // di = rowsum(dO * O) of the owned rows, the 16 threads of a row (tx)
    // each over every 16th column, written out for the dk/dv kernel
    __syncthreads();  // the dO tile is in
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = own0 + ty + 16 * i;
      float sum = 0.f;
      if (row < Nq)
        for (int c = tx; c < D; c += 16)
          sum = fmaf(sX2[(ty + 16 * i) * ld + c], ob[(size_t)row * D + c], sum);
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      own_delta[i] = sum;
      if (tx == 0 && row < Nq) di_out[row] = sum;
    }
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
                          const float* __restrict__ o,
                          const float* __restrict__ lse,
                          const float* __restrict__ di_in,
                          float* __restrict__ di_out,
                          float* __restrict__ out1, float* __restrict__ out2,
                          int H, int Nq, int Nk, int D, float scale) {
  // DKV reads di (di_in); DQ computes it from dO and O and writes it (di_out)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int n_own = MODE == MODE_DKV ? Nk : Nq;
  const RowStats st{lse + (size_t)bh * Nq,
                    MODE == MODE_DKV ? di_in + (size_t)bh * Nq : nullptr, false};
  bwd_tile_loop_f32<MODE>(
      smem_raw, q + (size_t)bh * Nq * D, k + (size_t)bh * Nk * D,
      v + (size_t)bh * Nk * D, dout + (size_t)bh * Nq * D,
      mask ? mask + (size_t)(bh / H) * Nk : nullptr, st, nullptr, nullptr,
      out1 + (size_t)bh * n_own * D,
      MODE == MODE_DKV ? out2 + (size_t)bh * n_own * D : nullptr,
      blockIdx.y * 64, Nq, Nk, D, scale,
      MODE == MODE_DQ ? o + (size_t)bh * Nq * D : nullptr,
      MODE == MODE_DQ ? di_out + (size_t)bh * Nq : nullptr);
}

// ---- launches -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *o;
  const uint8_t* mask;
  const float *lse, *di;     // di: read by dkv
  float* di_out;             // di: written by dq
  void *out1, *out2, *out3;  // fused: dq, dk, dv; dkv: dk, dv; dq: dq
  int BH, H, Nq, Nk, D;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > SMEM_PER_BLOCK) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch(int kind, const Args& a) {
  if (a.BH <= 0 || a.H <= 0 || a.Nq <= 0 || a.Nk <= 0 || a.D <= 0 ||
      a.D > 128 || (a.Nq + 63) / 64 > 65535 || (a.Nk + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  size_t smem = f32_tiles_bytes(a.D);
  cudaError_t err;
  if (kind == 0) {
    smem += (size_t)2 * ((a.Nq + 63) / 64 * 64) * sizeof(float);
    if ((err = set_smem(flash_bwd_fused_f32, smem)) != cudaSuccess)
      return (int)err;
    flash_bwd_fused_f32<<<a.BH, F32_THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, static_cast<float*>(a.out1),
        static_cast<float*>(a.out2), static_cast<float*>(a.out3), a.H, a.Nq,
        a.Nk, a.D, a.scale);
  } else {
    auto kernel = kind == 1 ? flash_bwd_blocked_f32<MODE_DKV>
                            : flash_bwd_blocked_f32<MODE_DQ>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return (int)err;
    dim3 grid(a.BH, ((kind == 1 ? a.Nk : a.Nq) + 63) / 64);
    kernel<<<grid, F32_THREADS, smem, a.stream>>>(
        q, k, v, a.mask, dout, static_cast<const float*>(a.o), a.lse, a.di,
        a.di_out, static_cast<float*>(a.out1), static_cast<float*>(a.out2),
        a.H, a.Nq, a.Nk, a.D, a.scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes; fp32 inputs only (bf16 and fp16 go to
// flash_bwd_fused_mma in flash_bwd_fused.cu, flash_bwd_dkv_wgmma in
// flash_bwd_dkv.cu and flash_bwd_dq_wgmma in flash_bwd_dq.cu). q, dout, out
// (the forward's output), dq: [BH, Nq, D]; k, v, dk, dv: [BH, Nk, D], all
// contiguous fp32; mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse,
// di: [BH, Nq] fp32 (flash_bwd_dq writes di). Each launches on `stream` and
// returns the launch's cudaError_t (cudaErrorInvalidValue for a shape it does
// not take: head_dim above 128, or row statistics that do not fit the block's
// shared memory).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* mask, const void* dout, void* dq,
                               void* dk, void* dv, int BH, int H, int Nq,
                               int Nk, int D, float scale, void* stream) {
  const Args a{q, k, v, dout, nullptr, static_cast<const uint8_t*>(mask),
               nullptr, nullptr, nullptr, dq, dk, dv, BH, H, Nq, Nk, D, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(0, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* mask, const void* dout,
                             const void* lse, const void* di, void* dk,
                             void* dv, int BH, int H, int Nq, int Nk, int D,
                             float scale, void* stream) {
  const Args a{q, k, v, dout, nullptr, static_cast<const uint8_t*>(mask),
               static_cast<const float*>(lse), static_cast<const float*>(di),
               nullptr, dk, dv, nullptr, BH, H, Nq, Nk, D, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(1, a);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* mask, const void* dout,
                            const void* out, const void* lse, void* di,
                            void* dq, int BH, int H, int Nq, int Nk, int D,
                            float scale, void* stream) {
  const Args a{q, k, v, dout, out, static_cast<const uint8_t*>(mask),
               static_cast<const float*>(lse), nullptr,
               static_cast<float*>(di), dq, nullptr, nullptr, BH, H, Nq, Nk,
               D, scale, static_cast<cudaStream_t>(stream)};
  return launch(2, a);
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
