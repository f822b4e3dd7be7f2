// Flash-attention forward for Hopper (sm_90a), non-causal, with a [B, Nk]
// key mask.
//
// Replaces the two forward Pallas kernels of the JAX package,
// videosys_tpu/ops/flash_attention.py:
//   * _single_pass_kernel (:125) -- whole KV row in VMEM, used for Nk <= 4096
//     (STDiT3 spatial, cross and temporal attention);
//   * _flash_kernel (:49)        -- KV-blocked online softmax, used above
//     4096 keys (the VAE mid-block attention, D = 512, N = 6360 at 480p).
// Here the head width picks the kernel, not the key count: heads padded to at
// most 128 columns take `flash_fwd_mma` (mma.sync, four warps), wider ones
// (129 to 512) take `flash_fwd_wide` (wgmma, two warpgroups; its note is
// above it). In both, a block owns a 64-row q tile of one (batch*head) and
// walks the keys in 64-row tiles in its own loop (the TPU's sequential grid
// axis), keeping a running (max, sum, acc) in fp32 and dividing by the sum
// once at the end. The softmax scale times log2(e) is applied to the fp32
// scores, so the exponentials are exp2. The log-sum-exp output of
// _flash_kernel (natural log of the sum over the scaled scores, one fp32 per
// q row, [B*H, Nq]) is written only when the caller passes a buffer: the
// KV-blocked backward (flash_bwd.cu) reads it. A fully masked row stores
// MASK_VALUE itself.
//
// What bounds them on an H100: STDiT3 spatial attention (B*H = 480, N = 1590,
// D = 72) does 4*B*H*N^2*D = 3.5e11 flop per layer against 2.2e8 bytes of
// q/k/v/o, and the VAE mid attention (D = 512) is denser still: by the
// card's peaks both are bound by operations, so the products run on the
// tensor cores (bf16 or fp16 in, fp32 accumulate). What the wide kernel
// actually waits for is K and V coming out of L2 again for every 64-row q
// tile (see its note). fp32 inputs take a plain SIMT kernel with the same
// arithmetic; the main path never sends them.
//
// Design choices of both:
//   * head_dim is zero-padded in shared memory (to a multiple of 16 for
//     mma.sync, to 256 or 512 for wgmma); device memory is never padded.
//   * Ragged q and kv tails are zero-filled on load; keys at or past Nk get
//     a score of -inf and weigh nothing, keys masked off get
//     -0.7*FLT_MAX, so a fully masked row averages v over its Nk keys (the
//     plain PyTorch version does the same). Rows past Nq are not written.
//   * Copies run beside the products: the mma.sync kernel has two buffers for
//     the key tiles (cp.async copies tile j + 1 while tile j is computed on);
//     the wgmma kernel has one buffer each for K and V and asks for the next
//     K while P V runs and for the next V while Q K^T runs.
//
// What the mma.sync kernel's simple design gives up: wgmma, a TMA ring, a
// persistent schedule, and 64-row q tiles that waste 49 of 64 rows on
// temporal attention (N = 15).

#include "wgmma.cuh"

namespace {

// Tensor-core kernel for heads padded to at most 128 columns. Grid (B*H,
// ceil(Nq/64)); NT = padded head_dim / 8. The next key tile is copied in
// (cp.async) while the current one is computed on.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  T* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                  int Nk, int D, int DP, float scale_log2, int vec) {
  constexpr int DC = NT * 8;
  constexpr int STAGES = 2;  // key-tile buffers
  static_assert(NT % 2 == 0, "output columns come in 16-wide pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = DP + PAD;
  const int ldv = DC + PAD;
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK0 = sQ + BLOCK_M * ldq;                 // [STAGES][BLOCK_N][ldq]
  T* sV0 = sK0 + STAGES * BLOCK_N * ldq;       // [STAGES][BLOCK_N][ldv]
  int8_t* sM0 = reinterpret_cast<int8_t*>(sV0 + STAGES * BLOCK_N * ldv);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_M;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * Nq * D;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  // key tile starting at kv0 -> buffer `buf` (K, V, and per key: 1 attend,
  // 0 masked, -1 past Nk)
  auto issue_tile = [&](int kv0, int buf) {
    load_tile(sK0 + buf * BLOCK_N * ldq, ldq, kb, kv0, Nk, 0, DP, D, vec);
    load_tile(sV0 + buf * BLOCK_N * ldv, ldv, vb, kv0, Nk, 0, DC, D, vec);
    if (threadIdx.x < BLOCK_N)
      sM0[buf * BLOCK_N + threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
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
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (kv0 + BLOCK_N < Nk) issue_tile(kv0 + BLOCK_N, buf ^ 1);
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
        if (!plain_tile)
          x = masked_score(x, sM[n * 8 + (lane % 4) * 2 + (e & 1)]);
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
  if (lse != nullptr && lane % 4 == 0) {
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
    const int col = n * 8 + (lane % 4) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e / 2) * 8;
      const int c = col + (e & 1);
      if (r < Nq && c < D)
        ob[(size_t)r * D + c] = Ops<T>::from_float(acc[n][e] / l[e / 2]);
    }
  }
}

// ---- wide heads (128 < head_dim <= 512): wgmma, two warpgroups -------------
//
// One block of two warpgroups (256 threads) owns 64 q rows and the whole
// output width DP (256 or 512 padded columns): warpgroup w keeps the fp32
// accumulator of output columns [w DP/2, (w + 1) DP/2) in registers (DP/4 per
// thread: 128 at DP = 512), which is what wgmma with n = 256 is made for. The
// scores of a (q tile, key tile) pair are computed once: each warpgroup takes
// one half of the depth DP (m64n64k16 from shared memory), the two 64 x 64
// fp32 halves are summed through 32 KB of shared memory, and both warpgroups
// then run the same softmax on the same numbers, so each has P in the
// accumulator layout, which is the register A operand of its O += P V
// (m64n{DP/2}k16, V read from shared memory with its columns contiguous).
//
// Shared memory at DP = 512, 16-bit elements: Q 64 x 512 = 64 KB, one K tile
// and one V tile of 64 keys = 64 KB each, the two score halves 32 KB, key
// flags 128 B: 229,504 of the 232,448 bytes a block may use, one block per
// SM. There is one buffer each for K and V, and the copies still run beside
// the products: K(j + 1) is asked for (cp.async) as soon as both score halves
// of tile j are out of the tensor cores and lands during the softmax and the
// P V product of tile j; V(j + 1) is asked for once P V of tile j is done and
// lands during the score product and the softmax of tile j + 1.
//
// All tiles use the core-matrix layout of wgmma.cuh (no swizzle): 8-row
// groups at DP * 16 bytes, 16-byte chunks of a row 128 bytes apart.
//
// What is left: with 64-row q tiles every block reads all of K and V of its
// (batch, head) from L2, 128 KB per key tile at D = 512, and the cp.async
// copies of a tile take longer to issue than both products and the softmax
// take to run. A q tile of 128 rows does not fit the registers (the
// accumulator alone would be 256 a thread); the next step is a cluster of
// two blocks that share each K and V tile through one multicast TMA copy.
constexpr int WIDE_THREADS = 256;

template <int DP>
__host__ __device__ constexpr size_t wide_smem_bytes() {
  return (size_t)3 * 64 * DP * 2 + 2 * 32 * 128 * sizeof(float) + 2 * 64;
}

template <typename T, int DP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   T* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                   int Nk, int D, float scale_log2, int vec) {
  constexpr int GROUP_BYTES = DP * 16;  // one 8-row group of a tile
  constexpr int TILE_BYTES = 64 * DP * 2;
  constexpr int HALF = DP / 2;   // output columns, and depth, per warpgroup
  constexpr int NACC = HALF / 2;  // accumulator registers per thread
  extern __shared__ __align__(128) unsigned char wide_smem[];
  unsigned char* sQ = wide_smem;
  unsigned char* sK = sQ + TILE_BYTES;
  unsigned char* sV = sK + TILE_BYTES;
  float* sX = reinterpret_cast<float*>(sV + TILE_BYTES);  // [2][32][128]
  int8_t* sF = reinterpret_cast<int8_t*>(sX + 2 * 32 * 128);  // [2][64]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int wg = threadIdx.x / 128;    // warpgroup: depth half, column half
  const int tw = threadIdx.x % 128;    // thread within the warpgroup
  const int lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * Nq * D;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  auto issue_k = [&](int kv0, int j) {
    if (vec) load_core_tile_wide<T, WIDE_THREADS, DP>(smem_addr(sK), kb, kv0, Nk, D);
    else load_core_rows<T, WIDE_THREADS>(sK, DP, kb, kv0, 64, Nk, D, vec);
    if (threadIdx.x < 64)
      sF[(j & 1) * 64 + threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
    cp_async_commit();
  };
  auto issue_v = [&](int kv0) {
    if (vec) load_core_tile_wide<T, WIDE_THREADS, DP>(smem_addr(sV), vb, kv0, Nk, D);
    else load_core_rows<T, WIDE_THREADS>(sV, DP, vb, kv0, 64, Nk, D, vec);
    cp_async_commit();
  };

  load_core_rows<T, WIDE_THREADS>(sQ, DP, qb, q0, 64, Nq, D, vec);
  issue_k(0, 0);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // this thread's two rows: (tw / 32) * 16 + lane / 4 and that + 8
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  const uint32_t q_addr = smem_addr(sQ) + wg * (HALF / 8) * 128;
  const uint32_t k_addr = smem_addr(sK) + wg * (HALF / 8) * 128;
  const uint32_t v_addr = smem_addr(sV) + wg * (HALF / 8) * 128;

  for (int kv0 = 0, j = 0; kv0 < Nk; kv0 += 64, ++j) {
    cp_async_wait_all();  // K(j) (and Q) of this thread have landed
    fence_async_shared();
    __syncthreads();  // K(j) is in; every warp is done with V(j - 1)
    issue_v(kv0);

    // this warpgroup's half of S = Q K^T: depth [wg HALF, (wg + 1) HALF)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk)
      wgmma_ss_n64<T>(s, wgmma_desc(q_addr + kk * 256, 128, GROUP_BYTES),
                      wgmma_desc(k_addr + kk * 256, 128, GROUP_BYTES), 1);
    wgmma_commit();
    wgmma_wait();
    float* mine = sX + wg * 32 * 128;
    const float* other = sX + (wg ^ 1) * 32 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + tw] = s[i];
    __syncthreads();  // both halves are out; every warp is done with K(j)
    if (kv0 + 64 < Nk) issue_k(kv0 + 64, j + 1);
    else cp_async_commit();  // keeps the count of groups in flight the same
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += other[i * 128 + tw];

    // scale to log2 units, mask (only tiles that need it), running max;
    // element 4 n + e is row e / 2, key n * 8 + (lane % 4) * 2 + (e & 1)
    const bool plain_tile = mrow == nullptr && kv0 + 64 <= Nk;
    const int8_t* sM = sF + (j & 1) * 64;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (!plain_tile)
          x = masked_score(x, sM[n * 8 + (lane % 4) * 2 + (e & 1)]);
        s[4 * n + e] = x;
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
    // P = exp2(S - m): fp32 for the sums, packed as the A operand of P V
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[4 * n] - m_r[0]);
      const float p1 = exp2f(s[4 * n + 1] - m_r[0]);
      const float p2 = exp2f(s[4 * n + 2] - m_r[1]);
      const float p3 = exp2f(s[4 * n + 3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i / 2) % 2];

    cp_async_wait_group<1>();  // V(j) has landed; K(j + 1) may be in flight
    fence_async_shared();
    __syncthreads();  // V(j) is in
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // 16 keys = two 8-key groups GROUP_BYTES apart (the depth of this
      // product), 8-column core matrices 128 bytes apart
      const uint64_t desc =
          wgmma_desc(v_addr + ks * 2 * GROUP_BYTES, GROUP_BYTES, 128);
      if constexpr (HALF == 256) wgmma_rs_n256<T>(acc, pa[ks], desc, 1);
      else wgmma_rs_n128<T>(acc, pa[ks], desc, 1);
    }
    wgmma_commit();
    wgmma_wait();
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_r[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
  const int row = q0 + (tw / 32) * 16 + lane / 4;
  if (lse != nullptr && wg == 0 && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + r * 8 < Nq)
        lse[(size_t)bh * Nq + row + r * 8] =
            m_r[r] <= 0.5f * MASK_VALUE ? MASK_VALUE
                                        : (m_r[r] + log2f(l[r])) * LN2;
  }
  T* ob = o + (size_t)bh * Nq * D;
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n) {
    const int col = wg * HALF + n * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + h * 8;
      if (r >= Nq) continue;
      const float x0 = acc[4 * n + 2 * h] / l[h];
      const float x1 = acc[4 * n + 2 * h + 1] / l[h];
      if (vec && col + 1 < D) {  // D % 8 == 0, 16-byte aligned rows
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * D + col) =
            Ops<T>::pack(x0, x1);
      } else {
        if (col < D) ob[(size_t)r * D + col] = Ops<T>::from_float(x0);
        if (col + 1 < D) ob[(size_t)r * D + col + 1] = Ops<T>::from_float(x1);
      }
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
    if (threadIdx.x < F32_KEYS)
      sM[threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
    __syncthreads();

    const float* qr = sQ + warp * D;
    const float* kr = sK + lane * ldk;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s *= scale_log2;
    s = masked_score(s, sM[lane]);
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

template <typename T, int NT>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* o, float* lse, int BH,
                       int H, int Nq, int Nk, int D, float scale_log2, int vec,
                       cudaStream_t stream) {
  constexpr int DP = NT * 8;
  const size_t smem =
      (size_t)(BLOCK_M + 4 * BLOCK_N) * (DP + PAD) * sizeof(T) + 2 * BLOCK_N;
  auto kernel = flash_fwd_mma<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Nq + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Nq, Nk, D,
      DP, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* o, float* lse, int BH,
                        int H, int Nq, int Nk, int D, float scale_log2,
                        int vec, cudaStream_t stream) {
  if (BH > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = wide_smem_bytes<DP>();
  auto kernel = flash_fwd_wide<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + 63) / 64, BH);  // neighbours in x share one K and V (L2)
  kernel<<<grid, WIDE_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Nq, Nk, D,
      scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const uint8_t* mask, void* o, float* lse, int BH,
                         int H, int Nq, int Nk, int D, float scale_log2,
                         int vec, cudaStream_t stream) {
  const int DP = (D + 15) / 16 * 16;
  if (DP > 256)
    return launch_wide<T, 512>(q, k, v, mask, o, lse, BH, H, Nq, Nk, D,
                               scale_log2, vec, stream);
  if (DP > 128)
    return launch_wide<T, 256>(q, k, v, mask, o, lse, BH, H, Nq, Nk, D,
                               scale_log2, vec, stream);
  switch (DP / 8) {
#define VIDEOSYS_CASE(NT)                                                 \
  case NT:                                                                \
    return launch_mma<T, NT>(q, k, v, mask, o, lse, BH, H, Nq, Nk, D,     \
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
