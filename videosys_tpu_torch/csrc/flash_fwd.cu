// Flash-attention forward for Hopper (sm_90a), non-causal, with a [B, Nk]
// key mask.
//
// Replaces the two forward Pallas kernels of the JAX package,
// videosys_tpu/ops/flash_attention.py:
//   * _single_pass_kernel (:125) -- whole KV row in VMEM, used for Nk <= 4096
//     (STDiT3 spatial, cross and temporal attention);
//   * _flash_kernel (:49)        -- KV-blocked online softmax, used above
//     4096 keys (the VAE mid-block attention, D = 512, N = 6360 at 480p).
// Here the shape picks the kernel, not the key count alone (`fwd_variant`):
// rows of at most 16 queries and 16 keys (temporal attention over 15
// frames) take `flash_fwd_short` (one warp per (batch, head), mma.sync);
// rows of more than 4096 keys at heads of at most 128 columns with D % 8 ==
// 0 take `flash_fwd_long` (flash_fwd_long.cu, its own library); other
// heads of at most 128 columns take `flash_fwd_narrow` (two
// warpgroups of 64 q rows, wgmma); wider ones (129 to 512) take
// `flash_fwd_wide` (wgmma, two warpgroups that split the output columns);
// fp32 takes a SIMT kernel. Each kernel's note is above it. The tile kernels
// walk the keys in 64-row tiles in their own loop (the TPU's sequential grid
// axis), keeping a running (max, sum, acc) in fp32 and dividing by the sum
// once at the end. The softmax scale times log2(e) is applied to the fp32
// scores, so the exponentials are exp2. The log-sum-exp output of
// _flash_kernel (natural log of the sum over the scaled scores, one fp32 per
// q row, [B*H, Nq]) is written only when the caller passes a buffer: the
// KV-blocked backward reads it. A fully masked row stores MASK_VALUE itself.
//
// What bounds them on an H100: STDiT3 spatial attention (B*H = 480, N = 1590,
// D = 72) does 4*B*H*N^2*D = 3.5e11 flop per layer against 2.2e8 bytes of
// q/k/v/o, and the VAE mid attention (D = 512) is denser still: by the
// card's peaks both are bound by operations, so the products run on the
// tensor cores (bf16 or fp16 in, fp32 accumulate). What the tile kernels
// actually wait for is K and V coming out of L2 again for every q tile;
// cross attention (64 keys) and temporal attention (15 x 15) are bound by
// bytes. fp32 inputs take a plain SIMT kernel with the same arithmetic; the
// main path never sends them.
//
// Design choices shared by the kernels:
//   * head_dim is zero-padded in shared memory (to 32, 64, 80 or 128 for the
//     short and narrow kernels, to 256 or 512 for the wide one); device
//     memory is never padded.
//   * Ragged q and kv tails are zero-filled on load; keys at or past Nk get
//     a score of -inf and weigh nothing, keys masked off get
//     -0.7*FLT_MAX, so a fully masked row averages v over its Nk keys (the
//     plain PyTorch version does the same). Rows past Nq are not written.

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---- heads up to 128 wide: wgmma, two warpgroups of 64 q rows --------------
//
// A block of two warpgroups (256 threads) owns 128 q rows of one (batch,
// head); warpgroup w owns rows [64 w, 64 w + 64) and keeps their 64 x DP
// fp32 accumulator in registers (DP / 2 a thread: 40 at D = 72). Both
// warpgroups read the same K and V tile, so a key tile crosses L2 once per
// 128 q rows, half the traffic of a 64-row block. Per 64-key tile:
//   * S = Q K^T: wgmma m64n64k16 from shared memory (Q and K K-major);
//   * the online softmax in registers; P leaves the accumulator as the
//     register A operand of O += P V (wgmma m64n{DP}k16, V read with its
//     columns contiguous).
// K and V come through a ring of NARROW_STAGES tiles in the layout of
// tma.cuh (128-byte swizzled blocks of 64 columns, the rest chunk-major: the
// copies read whole L2 sectors, which the kernel is short of): one thread
// asks the copy engine (TMA) for tile j + 2, one box a block, right after
// the barrier that frees its stage and before the products of tile j, and
// the warpgroups wait on the stage's mbarrier. No other thread spends an
// instruction on a copy. (A head whose rows cannot be copied in 16-byte
// chunks is loaded element by element by every thread instead.) The grid
// runs the q tiles of one (batch, head) next to each other, so that they
// find its K and V in L2. A warpgroup whose rows
// all lie past Nq only takes part in the barriers. The output leaves through
// shared memory (the warpgroup's own Q tile) as 16-byte stores of its
// contiguous rows. Shared memory at D = 72 (DP = 80): Q 20 KB + three stages
// of K and V 60 KB + flags and barriers: 82,144 bytes, two blocks an SM.
constexpr int NARROW_THREADS = 256;
constexpr int NARROW_STAGES = 3;

template <int DP>
__host__ __device__ constexpr size_t narrow_smem_bytes() {
  // Q of 128 rows, the K and V ring, 64 key flags a stage, an mbarrier a
  // stage and one for Q
  return (size_t)(2 + 2 * NARROW_STAGES) * 64 * DP * 2 + NARROW_STAGES * 64 +
         (NARROW_STAGES + 1) * 8;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NARROW_THREADS, DP <= 80 ? 2 : 1)
    flash_fwd_narrow(const __grid_constant__ TileMaps tm_q,
                     const __grid_constant__ TileMaps tm_k,
                     const __grid_constant__ TileMaps tm_v,
                     const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Nq,
                     int Nk, int D, float scale_log2, int vec) {
  using L = TileLayout<DP, true>;
  constexpr int TILE = 64 * DP * 2;  // bytes of a 64-row tile
  constexpr int NACC = DP / 2;       // accumulator registers per thread
  constexpr int S = NARROW_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;          // [2][TILE]: the block's 128 q rows
  unsigned char* sK0 = sQ + 2 * TILE;    // [S][TILE]
  unsigned char* sV0 = sK0 + S * TILE;   // [S][TILE]
  int8_t* sF0 = reinterpret_cast<int8_t*>(sV0 + S * TILE);  // [S][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sF0 + S * 64);  // [S] K/V, Q

  const int n_tiles = (Nq + 127) / 128;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * 128;
  const int wg = threadIdx.x / 128;  // warpgroup: rows [64 wg, 64 wg + 64)
  const int tw = threadIdx.x % 128;  // thread within the warpgroup
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64;
  const bool live = row0 < Nq;
  const int q_tiles = q0 + 64 < Nq ? 2 : 1;  // the block's live Q tiles
  const T* qb = q + (size_t)bh * Nq * D;
  const T* kb = k + (size_t)bh * Nk * D;
  const T* vb = v + (size_t)bh * Nk * D;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  if (vec) {
    // the copies never write the pad chunks: zero them in every tile once
    L::template zero_pad<NARROW_THREADS>(smem_raw, 2 + 2 * S, D);
    if (threadIdx.x == 0) {
      if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle's atoms
      for (int i = 0; i <= S; ++i) mbar_init(bar + i, 1);
      mbar_init_fence();
      for (const TileMaps* m : {&tm_q, &tm_k, &tm_v}) {
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
      load_tile_rows<T, NARROW_THREADS, L>(sK, kb, kv0, Nk, D);
      load_tile_rows<T, NARROW_THREADS, L>(sV, vb, kv0, Nk, D);
    }
    if (threadIdx.x < 64)
      sF0[st * 64 + threadIdx.x] = key_flag(mrow, kv0 + threadIdx.x, Nk);
  };
  if (vec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar + S, q_tiles * L::tx_bytes(D));
      for (int t = 0; t < q_tiles; ++t)
        tma_tile<L>(smem_addr(sQ + t * TILE), tm_q, q0 + t * 64, bh, bar + S);
    }
  } else {
    for (int t = 0; t < 2; ++t)
      load_tile_rows<T, NARROW_THREADS, L>(sQ + t * TILE, qb, q0 + t * 64, Nq,
                                            D);
  }
  const int n_kv = (Nk + 63) / 64;
  for (int st = 0; st < S - 1 && st < n_kv; ++st) issue_tile(st * 64, st);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // this thread's two rows: row0 + (tw / 32) * 16 + lane / 4 and that + 8
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_addr(sQ) + wg * TILE;
  if (vec && live) mbar_wait(bar + S, 0);

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
    // thread's two, key n * 8 + (lane % 4) * 2 + (e & 1)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64<T>(s, L::k_major(q_addr, kk), L::k_major(k_addr, kk), 1);
    wgmma_commit();
    wgmma_wait();

    // scale to log2 units, mask (only tiles that need it), running max
    const bool plain_tile = mrow == nullptr && kv0 + 64 <= Nk;
    const int8_t* sM = sF0 + st * 64;
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
      alpha[r] = fast_exp2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P = exp2(S - m): fp32 for the sums, packed as the A operand of P V
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = fast_exp2(s[4 * n] - m_r[0]);
      const float p1 = fast_exp2(s[4 * n + 1] - m_r[0]);
      const float p2 = fast_exp2(s[4 * n + 2] - m_r[1]);
      const float p3 = fast_exp2(s[4 * n + 3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = Ops<T>::pack(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // 16 keys a step: the depth of P V
      L::template mn_product<T>(acc, pa[ks], v_addr, ks);
    wgmma_commit();
    wgmma_wait();
  }
  if (!live) return;

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (l == 0.f) l = 1.f;
    const int row = row0 + (tw / 32) * 16 + lane / 4 + r * 8;
    if (lse != nullptr && lane % 4 == 0 && row < Nq)
      lse[(size_t)bh * Nq + row] =
          m_r[r] <= MASK_HALF ? MASK_VALUE : (m_r[r] + log2f(l)) * LN2;
    inv_l[r] = 1.f / l;
  }
  // the warpgroup's Q tile is free: its last product has been waited for
  store_tile_warpgroup<T, NACC>(o + (size_t)bh * Nq * D, acc, inv_l, row0, Nq,
                                D, vec, reinterpret_cast<T*>(sQ + wg * TILE),
                                1 + wg);
}

// ---- short rows (Nq <= 16 and Nk <= 16): one warp per (batch, head) --------
//
// Temporal attention over 15 frames fills 15 rows of a 64-row tile; here
// eight warps share a block and each takes one (batch, head) on its own 16 x
// 16 score tile (mma.sync m16n8k16): Q, K and V read once by 16-byte
// cp.async, S and P V in registers (P leaves the S accumulator as the A
// operand of P V), the whole row's softmax at once, the output staged in the
// warp's Q tile and written as 16-byte stores of its contiguous rows. Bound
// by bytes: every input is read once and the output written once. The
// counterpart of `flash_bwd_short_mma` (flash_bwd_fused.cu).
constexpr int SHORT_WARPS = 8;
constexpr int SHORT_ROWS = 16;

template <int NT>
__host__ __device__ constexpr size_t short_smem_bytes() {
  return (size_t)SHORT_WARPS * 3 * 16 * (NT * 8 + PAD) * 2;
}

template <typename T, int NT>
__global__ void __launch_bounds__(SHORT_WARPS * 32)
    flash_fwd_short(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ o, float* __restrict__ lse, int BH, int H,
                    int Nq, int Nk, int D, float scale_log2, int vec) {
  constexpr int DP = NT * 8;
  constexpr int ld = DP + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x * SHORT_WARPS + warp;
  if (bh >= BH) return;  // warps are independent: no block barrier below
  T* sQ = reinterpret_cast<T*>(smem_raw) + warp * 3 * 16 * ld;
  T* sK = sQ + 16 * ld;
  T* sV = sK + 16 * ld;
  const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;

  load_rows_warp(sQ, ld, q + (size_t)bh * Nq * D, Nq, DP, D, vec, lane);
  load_rows_warp(sK, ld, k + (size_t)bh * Nk * D, Nk, DP, D, vec, lane);
  load_rows_warp(sV, ld, v + (size_t)bh * Nk * D, Nk, DP, D, vec, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();

  // S = Q K^T: 16 q rows x 16 keys; element (n, e) is q row lane / 4 +
  // (e / 2) * 8 and key n * 8 + (lane % 4) * 2 + (e & 1)
  float s[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, sQ + ((lane % 8) + ((lane / 8) % 2) * 8) * ld + kk +
                       (lane / 16) * 8);
    ldmatrix_x4(b, sK + ((lane % 8) + (lane / 16) * 8) * ld + kk +
                       ((lane / 8) % 2) * 8);
    Ops<T>::mma(s[0], a, b);
    Ops<T>::mma(s[1], a, b + 2);
  }
  // the whole row's softmax in log2 units
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n * 8 + (lane % 4) * 2 + (e & 1);
      s[n][e] = masked_score(s[n][e] * scale_log2, key_flag(mrow, key, Nk));
      m[e / 2] = fmaxf(m[e / 2], s[n][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  float l[2] = {0.f, 0.f};
  uint32_t pa[4];  // P as the A operand of P V (16 keys deep)
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = fast_exp2(s[n][e] - m[e / 2]);  // key 0 is real: m is finite
      l[e / 2] += p[e];
    }
    pa[n * 2] = Ops<T>::pack(p[0], p[1]);
    pa[n * 2 + 1] = Ops<T>::pack(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // O = P V, V's 16 rows the depth
  float acc[NT][4];
#pragma unroll
  for (int dpi = 0; dpi < NT / 2; ++dpi) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, sV + ((lane % 8) + ((lane / 8) % 2) * 8) * ld +
                             dpi * 16 + (lane / 16) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dpi][e] = 0.f;
      acc[2 * dpi + 1][e] = 0.f;
    }
    Ops<T>::mma(acc[2 * dpi], pa, b);
    Ops<T>::mma(acc[2 * dpi + 1], pa, b + 2);
  }
  const int row = lane / 4;
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + r * 8 < Nq)
        lse[(size_t)bh * Nq + row + r * 8] =
            m[r] <= MASK_HALF ? MASK_VALUE : (m[r] + log2f(l[r])) * LN2;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= l[e / 2];  // l >= 1
  store_rows_warp<T, NT>(o + (size_t)bh * Nq * D, acc, Nq, D, 1.f, lane,
                         vec ? sQ : nullptr);
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

// The JAX package's line between its forward kernels
// (videosys_tpu/ops/flash_attention.py:169): longer rows take _flash_kernel.
constexpr int SINGLE_PASS_MAX_KV = 4096;

// The forward kernel a shape takes: 0 the fp32 SIMT kernel, 1 short rows,
// 2 narrow (heads up to 128), 3 wide (129 to 512), 4 long (more than
// SINGLE_PASS_MAX_KV keys at heads up to 128 whose rows TMA can copy, D % 8
// == 0: flash_fwd_long, launched through flash_fwd_long.cu's entry), -1
// none.
int fwd_variant(int dtype, int Nq, int Nk, int D) {
  if (Nq <= 0 || Nk <= 0 || D <= 0 || D > F32_MAX_D) return -1;
  if (dtype == 0) return 0;
  if (dtype != 1 && dtype != 2) return -1;
  if (D > 128) return 3;
  if (Nq <= SHORT_ROWS && Nk <= SHORT_ROWS) return 1;
  return Nk > SINGLE_PASS_MAX_KV && D % 8 == 0 ? 4 : 2;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > SMEM_PER_BLOCK) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
cudaError_t launch_narrow(const void* q, const void* k, const void* v,
                          const uint8_t* mask, void* o, float* lse, int BH,
                          int H, int Nq, int Nk, int D, float scale_log2,
                          int vec, cudaStream_t stream) {
  const long long blocks = (long long)BH * ((Nq + 127) / 128);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_narrow<T, DP>;
  cudaError_t err = set_smem(kernel, narrow_smem_bytes<DP>());
  if (err != cudaSuccess) return err;
  TileMaps maps[3] = {};  // q, k, v; unused without `vec`
  if (vec) {
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      err = tile_maps<TileLayout<DP, true>>(&maps[i], bases[i], BH, i == 0 ? Nq : Nk, D);
      if (err != cudaSuccess) return err;
    }
  }
  // the q tiles of one (batch, head) are neighbours: they share its K and V
  kernel<<<(unsigned)blocks, NARROW_THREADS, narrow_smem_bytes<DP>(), stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), lse, H, Nq, Nk, D, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_short(const void* q, const void* k, const void* v,
                         const uint8_t* mask, void* o, float* lse, int BH,
                         int H, int Nq, int Nk, int D, float scale_log2,
                         int vec, cudaStream_t stream) {
  auto kernel = flash_fwd_short<T, NT>;
  cudaError_t err = set_smem(kernel, short_smem_bytes<NT>());
  if (err != cudaSuccess) return err;
  kernel<<<(BH + SHORT_WARPS - 1) / SHORT_WARPS, SHORT_WARPS * 32,
           short_smem_bytes<NT>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, BH, H, Nq, Nk,
      D, scale_log2, vec);
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
cudaError_t dispatch_half(const void* q, const void* k, const void* v,
                          const uint8_t* mask, void* o, float* lse, int BH,
                          int H, int Nq, int Nk, int D, float scale_log2,
                          int vec, cudaStream_t stream) {
  const int variant = fwd_variant(1, Nq, Nk, D);
#define VIDEOSYS_ARGS q, k, v, mask, o, lse, BH, H, Nq, Nk, D, scale_log2, vec, stream
  if (variant == 3)
    return (D + 15) / 16 * 16 > 256 ? launch_wide<T, 512>(VIDEOSYS_ARGS)
                                    : launch_wide<T, 256>(VIDEOSYS_ARGS);
  // head_dim padded to the next of 32, 64, 80, 128 columns
  if (variant == 1) {
    if (D <= 32) return launch_short<T, 4>(VIDEOSYS_ARGS);
    if (D <= 64) return launch_short<T, 8>(VIDEOSYS_ARGS);
    if (D <= 80) return launch_short<T, 10>(VIDEOSYS_ARGS);
    return launch_short<T, 16>(VIDEOSYS_ARGS);
  }
  if (variant == 2) {
    if (D <= 32) return launch_narrow<T, 32>(VIDEOSYS_ARGS);
    if (D <= 64) return launch_narrow<T, 64>(VIDEOSYS_ARGS);
    if (D <= 80) return launch_narrow<T, 80>(VIDEOSYS_ARGS);
    return launch_narrow<T, 128>(VIDEOSYS_ARGS);
  }
#undef VIDEOSYS_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. q: [BH, Nq, D], k/v: [BH, Nk, D], o:
// [BH, Nq, D], all contiguous and of one type (dtype 0 = fp32, 1 = bf16,
// 2 = fp16); mask: [BH / H, Nk] bytes (nonzero = attend) or null; lse: fp32
// [BH, Nq] or null. Launches on `stream` and returns the launch's
// cudaError_t; a shape of the long variant (4) is refused here
// (flash_fwd_long.cu launches it).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* o, void* lse, int dtype,
                         int BH, int H, int Nq, int Nk, int D, float scale,
                         int vec, void* stream) {
  const int variant = fwd_variant(dtype, Nq, Nk, D);
  if (BH <= 0 || H <= 0 || variant < 0 || variant == 4)
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
    err = dispatch_half<__nv_bfloat16>(q, k, v, m, o, l, BH, H, Nq, Nk, D,
                                       scale_log2, vec, s);
  } else {
    err = dispatch_half<__half>(q, k, v, m, o, l, BH, H, Nq, Nk, D,
                                scale_log2, vec, s);
  }
  return (int)err;
}

// Which kernel a shape takes (0 fp32, 1 short rows, 2 narrow, 3 wide, 4
// long, -1 none); the wrapper's `kernel_variant` mirrors it.
extern "C" int flash_fwd_variant(int dtype, int Nq, int Nk, int D) {
  return fwd_variant(dtype, Nq, Nk, D);
}

// Bytes of shared memory a block of kernel `which` (1 short rows, 2 narrow,
// 3 wide) asks for at head_dim D with 2-byte elements, or -1; the wrapper
// mirrors the formulas.
extern "C" long flash_fwd_smem(int which, int D) {
  if (D <= 0) return -1;
  if (which == 3 && D <= 512)
    return (long)((D + 15) / 16 * 16 > 256 ? wide_smem_bytes<512>()
                                           : wide_smem_bytes<256>());
  if (D > 128) return -1;
  const int i = D <= 32 ? 0 : D <= 64 ? 1 : D <= 80 ? 2 : 3;
  const size_t narrow[4] = {narrow_smem_bytes<32>(), narrow_smem_bytes<64>(),
                            narrow_smem_bytes<80>(), narrow_smem_bytes<128>()};
  const size_t shorts[4] = {short_smem_bytes<4>(), short_smem_bytes<8>(),
                            short_smem_bytes<10>(), short_smem_bytes<16>()};
  if (which == 1) return (long)shorts[i];
  if (which == 2) return (long)narrow[i];
  return -1;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
