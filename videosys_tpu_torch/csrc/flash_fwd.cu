// Flash-attention forward for Hopper (sm_90a), non-causal, with a [B, Nk]
// key mask.
//
// Replaces the two forward Pallas kernels of the JAX package,
// videosys_tpu/ops/flash_attention.py:
//   * _single_pass_kernel (:125) -- whole KV row in VMEM, used for Nk <= 4096
//     (STDiT3 spatial, cross and temporal attention);
//   * _flash_kernel (:49)        -- KV-blocked online softmax, used above
//     4096 keys (the VAE mid-block attention, D = 512, N = 6360 at 480p).
// Both are one kernel here: each block owns a 64-row q tile of one
// (batch*head) and walks the keys in 64-row tiles in its own loop (the TPU's
// sequential grid axis), keeping a running (max, sum, acc) in fp32 and
// dividing by the sum once at the end. The softmax scale times log2(e) is
// applied to the fp32 scores, so the exponentials are exp2. The log-sum-exp
// output of _flash_kernel (natural log of the sum over the scaled scores,
// one fp32 per q row, [B*H, Nq]) is written only when the caller passes a
// buffer: the KV-blocked backward (flash_bwd.cu) reads it. A fully masked
// row stores MASK_VALUE itself.
//
// What bounds it on an H100: STDiT3 spatial attention (B*H = 480, N = 1590,
// D = 72) does 4*B*H*N^2*D = 3.5e11 flop per layer against 2.2e8 bytes of
// q/k/v/o, and the VAE mid attention (D = 512) is denser still: both are
// compute-bound, so the products run on the tensor cores (mma.sync
// m16n8k16, bf16 or fp16 in, fp32 accumulate). fp32 inputs take a plain
// SIMT kernel with the same arithmetic; the main path never sends them.
//
// Design choices:
//   * head_dim is zero-padded in shared memory to a multiple of 16 (the k
//     depth of one mma), 72 -> 80; device memory is never padded.
//   * The output accumulator lives in registers, at most 128 columns per
//     block. Wider heads (D = 512) split the output columns across
//     blockIdx.z and every split recomputes the scores: the VAE mid
//     attention pays 2.5x its minimal flops for keeping acc out of shared
//     memory.
//   * Ragged q and kv tails are zero-filled on load; keys at or past Nk get
//     a score of -inf and weigh nothing, keys masked off get
//     -0.7*FLT_MAX, so a fully masked row averages v over its Nk keys (the
//     plain PyTorch version does the same). Rows past Nq are not written.
//
// Key tiles up to D = 128 are double-buffered: cp.async copies tile j + 1
// into shared memory while tile j is on the tensor cores. D = 512 keeps one
// buffer, since two would not fit beside its q tile.
//
// What the simple design gives up: mma.sync instead of wgmma, cp.async
// instead of a TMA ring, one q tile per block instead of a persistent
// schedule, and 64-row q tiles that waste 49 of 64 rows on temporal
// attention (N = 15).

#include "flash_common.cuh"

namespace {

// Tensor-core kernel. Grid (B*H, ceil(Nq/64), column splits); NT = output
// columns per block / 8. With STAGES = 2 the next key tile is copied in
// (cp.async) while the current one is computed on.
template <typename T, int NT, int STAGES>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  T* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                  int Nk, int D, int DP, float scale_log2, int vec) {
  constexpr int DC = NT * 8;
  static_assert(NT % 2 == 0, "output columns come in 16-wide pairs");
  static_assert(STAGES == 1 || STAGES == 2, "one or two key-tile buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = DP + PAD;
  const int ldv = DC + PAD;
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK0 = sQ + BLOCK_M * ldq;                 // [STAGES][BLOCK_N][ldq]
  T* sV0 = sK0 + STAGES * BLOCK_N * ldq;       // [STAGES][BLOCK_N][ldv]
  int8_t* sM0 = reinterpret_cast<int8_t*>(sV0 + STAGES * BLOCK_N * ldv);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_M;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * Nq * D;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  // key tile starting at kv0 -> buffer `buf` (K, V columns of this split,
  // and per key: 1 attend, 0 masked, -1 past Nk)
  auto issue_tile = [&](int kv0, int buf) {
    load_tile(sK0 + buf * BLOCK_N * ldq, ldq, kb, kv0, Nk, 0, DP, D, vec);
    load_tile(sV0 + buf * BLOCK_N * ldv, ldv, vb, kv0, Nk, c0, DC, D, vec);
    if (threadIdx.x < BLOCK_N) {
      const int key = kv0 + threadIdx.x;
      sM0[buf * BLOCK_N + threadIdx.x] =
          key >= Nk ? -1 : ((mrow && !mrow[key]) ? 0 : 1);
    }
    cp_async_commit();
  };

  load_tile(sQ, ldq, qb, q0, Nq, 0, DP, D, vec);
  issue_tile(0, 0);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows: warp*16 + lane/4 and that + 8
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int kv0 = 0, j = 0; kv0 < Nk; kv0 += BLOCK_N, ++j) {
    const int buf = STAGES == 2 ? (j & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (STAGES == 2 && kv0 + BLOCK_N < Nk) issue_tile(kv0 + BLOCK_N, buf ^ 1);
    const T* sK = sK0 + buf * BLOCK_N * ldq;
    const T* sV = sV0 + buf * BLOCK_N * ldv;
    const int8_t* sM = sM0 + buf * BLOCK_N;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldq
                         + kk + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (p * 16 + (lane % 8) + (lane / 16) * 8) * ldq + kk
                           + ((lane / 8) % 2) * 8);
        Ops<T>::mma(s[2 * p], a, b);
        Ops<T>::mma(s[2 * p + 1], a, b + 2);
      }
    }

    // scale to log2 units, mask (only tiles that need it), running max
    const bool plain_tile = mrow == nullptr && kv0 + BLOCK_N <= Nk;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!plain_tile) {
          const int8_t mk = sM[n * 8 + (lane % 4) * 2 + (e & 1)];
          x = mk < 0 ? -INFINITY : (mk == 0 ? MASK_VALUE : x);
        }
        s[n][e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      // the tile's first key is real, so the new max is finite
      const float m_new = fmaxf(m_r[r], mt[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }

    // P = exp2(S - m) in fp32 for the sums, packed to T as the A operand of
    // the PV product (the S accumulator layout is the A fragment layout)
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_r[0]);
      const float p1 = exp2f(s[n][1] - m_r[0]);
      const float p2 = exp2f(s[n][2] - m_r[1]);
      const float p3 = exp2f(s[n][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldv
                                 + dp * 16 + (lane / 16) * 8);
        Ops<T>::mma(acc[2 * dp], pa[kk], b);
        Ops<T>::mma(acc[2 * dp + 1], pa[kk], b + 2);
      }
    if (STAGES == 1 && kv0 + BLOCK_N < Nk) {
      __syncthreads();  // every warp is done with the only buffer
      issue_tile(kv0 + BLOCK_N, 0);
    }
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_r[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
  const int row = q0 + warp * 16 + lane / 4;
  if (lse != nullptr && blockIdx.z == 0 && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + r * 8 < Nq)
        lse[(size_t)bh * Nq + row + r * 8] =
            m_r[r] <= 0.5f * MASK_VALUE ? MASK_VALUE
                                        : (m_r[r] + log2f(l[r])) * LN2;
  }
  T* ob = o + (size_t)bh * Nq * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = c0 + n * 8 + (lane % 4) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e / 2) * 8;
      const int c = col + (e & 1);
      if (r < Nq && c < D)
        ob[(size_t)r * D + c] = Ops<T>::from_float(acc[n][e] / l[e / 2]);
    }
  }
}

// fp32 kernel: one warp per q row, 32 keys per iteration, lane j scores key
// j. Same online softmax as the tensor-core kernel.
constexpr int F32_ROWS = 8;
constexpr int F32_KEYS = 32;
constexpr int F32_MAX_D = 512;

__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  float* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                  int Nk, int D, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = D | 1;  // odd stride: the 32 lanes read 32 distinct banks
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + F32_ROWS * D;
  float* sV = sK + F32_KEYS * ldk;
  int8_t* sM = reinterpret_cast<int8_t*>(sV + F32_KEYS * D);

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * F32_ROWS;
  const float* qb = q + (size_t)bh * Nq * D;
  const float* kb = k + (size_t)bh * Nk * D;
  const float* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  for (int i = threadIdx.x; i < F32_ROWS * D; i += blockDim.x) {
    const int r = row0 + i / D;
    sQ[i] = r < Nq ? qb[(size_t)r * D + i % D] : 0.f;
  }
  float acc[F32_MAX_D / 32];
#pragma unroll
  for (int i = 0; i < F32_MAX_D / 32; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < Nk; kv0 += F32_KEYS) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_KEYS * D; i += blockDim.x) {
      const int r = i / D, c = i % D, key = kv0 + r;
      sK[r * ldk + c] = key < Nk ? kb[(size_t)key * D + c] : 0.f;
      sV[i] = key < Nk ? vb[(size_t)key * D + c] : 0.f;
    }
    if (threadIdx.x < F32_KEYS) {
      const int key = kv0 + threadIdx.x;
      sM[threadIdx.x] = key >= Nk ? -1 : ((mrow && !mrow[key]) ? 0 : 1);
    }
    __syncthreads();

    const float* qr = sQ + warp * D;
    const float* kr = sK + lane * ldk;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s *= scale_log2;
    const int8_t mk = sM[lane];
    s = mk < 0 ? -INFINITY : (mk == 0 ? MASK_VALUE : s);
    float mt = s;
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m, mt);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    const float p = exp2f(s - m);
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * alpha + ps;
#pragma unroll
    for (int i = 0; i < F32_MAX_D / 32; ++i) acc[i] *= alpha;
    for (int j = 0; j < F32_KEYS; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vr = sV + j * D;
#pragma unroll
      for (int i = 0; i < F32_MAX_D / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
  }

  const int r = row0 + warp;
  if (r < Nq) {
    const float inv_l = l == 0.f ? 1.f : l;
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Nq + r] =
          m <= 0.5f * MASK_VALUE ? MASK_VALUE : (m + log2f(inv_l)) * LN2;
#pragma unroll
    for (int i = 0; i < F32_MAX_D / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[(size_t)bh * Nq * D + (size_t)r * D + d] = acc[i] / inv_l;
    }
  }
}

template <typename T, int NT, int STAGES>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* o, float* lse, int BH,
                       int H, int Nq, int Nk, int D, float scale_log2, int vec,
                       cudaStream_t stream) {
  constexpr int DC = NT * 8;
  const int DP = (D + 15) / 16 * 16;
  const int splits = (DP + DC - 1) / DC;
  const size_t smem =
      (size_t)(BLOCK_M * (DP + PAD) +
               STAGES * BLOCK_N * ((DP + PAD) + (DC + PAD))) * sizeof(T) +
      STAGES * BLOCK_N;
  auto kernel = flash_fwd_mma<T, NT, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Nq + BLOCK_M - 1) / BLOCK_M, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Nq, Nk, D,
      DP, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const uint8_t* mask, void* o, float* lse, int BH,
                         int H, int Nq, int Nk, int D, float scale_log2,
                         int vec, cudaStream_t stream) {
  const int DP = (D + 15) / 16 * 16;
  if (DP > 128)  // wide heads: column splits, one buffer (shared memory)
    return launch_mma<T, 16, 1>(q, k, v, mask, o, lse, BH, H, Nq, Nk, D,
                                scale_log2, vec, stream);
  switch (DP / 8) {
#define VIDEOSYS_CASE(NT)                                                 \
  case NT:                                                                \
    return launch_mma<T, NT, 2>(q, k, v, mask, o, lse, BH, H, Nq, Nk, D,  \
                                scale_log2, vec, stream);
    VIDEOSYS_CASE(2)
    VIDEOSYS_CASE(4)
    VIDEOSYS_CASE(6)
    VIDEOSYS_CASE(8)
    VIDEOSYS_CASE(10)
    VIDEOSYS_CASE(12)
    VIDEOSYS_CASE(14)
    VIDEOSYS_CASE(16)
#undef VIDEOSYS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. q: [BH, Nq, D], k/v: [BH, Nk, D], o:
// [BH, Nq, D], all contiguous and of one type (dtype 0 = fp32, 1 = bf16,
// 2 = fp16); mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse: fp32
// [BH, Nq] or null. Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* o, void* lse, int dtype,
                         int BH, int H, int Nq, int Nk, int D, float scale,
                         int vec, void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D > F32_MAX_D)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem =
        (size_t)(F32_ROWS * D + F32_KEYS * (D | 1) + F32_KEYS * D) *
            sizeof(float) + F32_KEYS;
    err = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(BH, (Nq + F32_ROWS - 1) / F32_ROWS);
    flash_fwd_f32<<<grid, F32_ROWS * 32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(o), l, H, Nq, Nk,
        D, scale_log2);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    err = dispatch_mma<__nv_bfloat16>(q, k, v, m, o, l, BH, H, Nq, Nk, D,
                                      scale_log2, vec, s);
  } else if (dtype == 2) {
    err = dispatch_mma<__half>(q, k, v, m, o, l, BH, H, Nq, Nk, D, scale_log2,
                               vec, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
