// Flash-attention forward for long key rows on Hopper (sm_90a): bf16 and
// fp16, heads of at most 128 columns (D % 8 == 0), non-causal, with a
// [B, Nk] key mask and the optional fp32 log-sum-exp.
//
// Replaces _flash_kernel (videosys_tpu/ops/flash_attention.py:49), the
// KV-blocked online softmax the JAX package takes for rows of more than
// SINGLE_PASS_MAX_KV = 4096 keys (:169, :197) and for every forward that
// saves the log-sum-exp, at heads up to 128: CogVideoX's joint attention
// ([2, 30 | 48, 17776, 17776, 64]), Open-Sora-Plan v1.2's self-attention
// ([2, 24, 9600 | 28800, ..., 96]) and the 1080p training row ([1, 16,
// 8160, 8160, 72]). `fwd_variant` (flash_fwd.cu) sends those rows here; rows
// of at most 4096 keys keep flash_fwd_narrow and flash_fwd_short.
//
// It computes what flash_fwd_narrow computes: scores in log2 units (scale *
// log2(e) on the fp32 products), keys at or past Nk weigh nothing, masked
// keys score MASK_VALUE (a fully masked row averages v over its Nk keys), P
// rounded to the input type before P V, the running sum divided out once at
// the end, and lse = the natural log of the sum over the scaled scores
// (MASK_VALUE for a fully masked row), [B*H, Nq].
//
// What bounds it on an H100: 4*B*H*Nq*Nk*D flop against 2*B*H*(2 Nq + 2 Nk)*D
// bytes, thousands of flop a byte: operations, on the tensor cores. Beside
// the products stand the exponentials, one a score: the special-function
// unit does 16 a clock an SM (PERF.md §6 has a warp's clocks for them),
// so a 128 x 128 tile spends 1024 clocks on them, as long as its two
// products take at D = 64 (4096 flop a clock an SM). flash_fwd_narrow did
// each step of a tile in turn (copy wait, S = Q K^T, softmax, P V, a
// __syncthreads a tile) and reached 28-37% of the bound on these rows.
// Clocks of this kernel (tools/phase_clocks.py, PERF.md §6) put a consumer
// warpgroup's softmax at 62% of its tile at D = 64 with two consumer
// warpgroups: the chain softmax -> P V -> softmax of one warpgroup, not the
// tensor cores or the copies, sets the pace, so more warpgroups in flight is
// what pays.
//
// What this design does about it:
//   * One block an SM: consumer warpgroups of 64 q rows each (three at 64
//     padded columns, two above: `long_consumers`) and a producer warpgroup
//     whose first warp keeps the copy engine (TMA) busy: Q once a tile, then
//     K and V through a ring of stages of 128 keys, each with a "full"
//     mbarrier (the copies' bytes; for K also the key flags the producer
//     writes) and an "empty" one (one arrival from each consumer warp). No
//     consumer thread issues a copy and no __syncthreads runs in the key
//     loop. The producer gives up registers and the consumers take them
//     (setmaxnreg: 128 * 24 + 256 * 240, or 128 * 32 + 384 * 160 with three
//     consumers, of the SM's 65,536).
//   * Ping-pong: named barriers (bar.sync id, 256) hand the tensor cores
//     from one consumer warpgroup to the next in turn, so that one
//     warpgroup's softmax runs while another's products are issued and run.
//   * Overlap inside a warpgroup: at key tile j a warpgroup issues S_j = Q
//     K_j^T and then P_{j-1} V_{j-1} (P of the tile before), waits for S_j
//     alone (wgmma.wait_group 1) and runs the softmax of tile j while
//     P_{j-1} V_{j-1} is on the tensor cores; then it waits for that product,
//     rescales the accumulator and packs P_j. One S tile is live at a time:
//     S (64 fp32 a thread) + P (32) + the accumulator (DP / 2) fit in 160
//     registers at DP = 64 and 240 above. (Issuing S_{j+1} before the softmax
//     of tile j instead would hold two S tiles, 128 registers.)
//   * Each head at its own width: DP = 64, 80, 96 or 128 padded columns (D =
//     72 takes 80, D = 96 is not padded to 128): the Q K^T product takes DP /
//     16 steps of k = 16, and P V one wgmma of n = 96 at DP = 96 (three
//     blocks of 32 columns with the 64-byte swizzle), else one of n = 64 a
//     block of 64 columns (the 128-byte swizzle) and one of n = 16 for DP =
//     80's chunk-major rest (`LongLayout`). At DP = 80 and 96 the Q rows sit
//     in registers as the A operand of Q K^T, which spares shared memory
//     their reads.
//   * Key tiles of 128 rows (S as m64n128: 64 fp32 a thread), so every K and
//     V tile feeds twice the products of narrow's 64-key tiles per barrier
//     and per copy. The ring takes as many stages as fit beside Q, at most
//     LONG_MAX_STAGES (`long_smem_bytes`).
//   * One block a q tile, the grid in (b*h, q tile) order, so that the
//     blocks on the card at once share one (batch, head)'s K and V in L2.
//     One persistent block an SM walking the tiles in that order, its ring
//     running on from one tile into the next, measured no faster (PERF.md).
// The output leaves through shared memory (the warpgroup's own Q tile) as
// 16-byte stores of its contiguous rows. Rows past Nq are zero filled and
// not written; a warpgroup whose rows all lie past Nq computes on zeros and
// takes part in every barrier. Tried and measured slower on the card
// (PERF.md): a third consumer warpgroup at DP = 80 and 96 (spills), the
// softmax's maxima and sums in four chains, a quarter of the exponentials
// by a polynomial on the FMA pipe, the accumulator's rescale moved before
// P V's issue, the waits with the hardware's suspend hint.

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int LONG_KEYS = 128;     // keys a tile
constexpr int LONG_MAX_STAGES = 4;
// named barriers: 1 + w hands the tensor cores to consumer warpgroup w;
// STORE_BAR + w is warpgroup w's own (the output's staging)
constexpr int SCHED_BAR = 1;
constexpr int STORE_BAR = 4;

// The padded width a head of D (D % 8 == 0, D <= 128) takes.
__host__ __device__ constexpr int long_width(int D) {
  return D <= 64 ? 64 : D <= 80 ? 80 : D <= 96 ? 96 : 128;
}

// Consumer warpgroups of a block at padded width DP, 64 q rows each: three
// at DP = 64, where S, P and the accumulator fit 160 registers a thread
// (setmaxnreg: 128 * 32 + 384 * 160 = 65,536), two above (24 and 240).
__host__ __device__ constexpr int long_consumers(int DP) {
  return DP == 64 ? 3 : 2;
}

// K/V stages beside the Q tiles: as many as fit, at most LONG_MAX_STAGES.
// A stage: K and V of 128 keys, 128 key flags, four mbarriers; one more
// mbarrier for Q.
template <int DP>
__host__ __device__ constexpr int long_stages() {
  return (int)((SMEM_PER_BLOCK - 128 * DP * long_consumers(DP) - 8) /
               (512 * DP + LONG_KEYS + 32)) < LONG_MAX_STAGES
             ? (int)((SMEM_PER_BLOCK - 128 * DP * long_consumers(DP) - 8) /
                     (512 * DP + LONG_KEYS + 32))
             : LONG_MAX_STAGES;
}

template <int DP>
__host__ __device__ constexpr size_t long_smem_bytes() {
  return (size_t)128 * DP * long_consumers(DP) +
         (size_t)long_stages<DP>() * (512 * DP + LONG_KEYS + 32) + 8;
}

// A tile of ROWS rows and DP padded 16-bit columns as TMA fills it and wgmma
// reads it. Its columns lie in swizzled blocks of ROWS rows, one TMA box
// each: at DP = 96 three blocks of 32 columns with the 64-byte swizzle (rows
// of 64 bytes, the 16-byte chunks of row r permuted by chunk ^ (r / 2 % 4)),
// elsewhere blocks of 64 columns with the 128-byte swizzle (chunk ^ (r %
// 8)). At DP = 80 the 16 columns after the first block lie chunk-major
// without a swizzle: chunk c of row r at c * ROWS * 16 + r * 16, one box of
// 8 columns x ROWS rows x the chunks. wgmma reads a swizzled block with
// stride 8 * SW (the next 8 rows): a 16-deep step of a K-major operand
// starts 32 bytes further in its row, an MN-major operand's 16-row step 16 *
// SW further; an MN-major product spans the blocks with lead = BLOCK (the
// next block of columns). It reads the chunk-major part with, K-major,
// lead = ROWS * 16 (the next 8 columns) and stride = 128 (the next 8 rows);
// MN-major, lead = 128 and stride = ROWS * 16.
template <int DP, int ROWS>
struct LongLayout {
  static constexpr int SW = DP == 96 ? 64 : 128;  // bytes of a swizzled row
  static constexpr int BCOLS = SW / 2;             // columns of a block
  static constexpr int NSW = DP / BCOLS;           // swizzled blocks
  static constexpr int REM = DP - BCOLS * NSW;     // chunk-major columns
  static constexpr int BLOCK = ROWS * SW;          // one swizzled block
  static constexpr int CHUNK = ROWS * 16;          // one chunk-major chunk
  static constexpr int REM0 = NSW * BLOCK;         // where the chunks start
  static constexpr int BYTES = ROWS * DP * 2;      // the tile
  static constexpr int KPB = SW / 32;              // 16-deep steps a block
  static constexpr uint64_t DESC_SW = SW == 64 ? 2ull << 62 : DESC_SW128;
  static_assert(DP == 64 || DP == 80 || DP == 96 || DP == 128,
                "padded widths 64, 80, 96, 128");

  // descriptor of the 16-column step kk of a K-major operand at `base`
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    if (kk < KPB * NSW)
      return wgmma_desc(base + (kk / KPB) * BLOCK + (kk % KPB) * 32, 16,
                        8 * SW) | DESC_SW;
    return wgmma_desc(base + REM0 + (2 * kk - 2 * KPB * NSW) * CHUNK, CHUNK,
                      128);
  }

  // d[DP / 2] (+)= A B for the 16-row step ks of an MN-major operand B at
  // `base` (the depth along its rows, its DP columns the output's): one
  // n = 96 product over the three 64-byte blocks, else one n = 64 product
  // a 128-byte block and one for the chunk-major part
  template <typename T>
  static __device__ __forceinline__ void mn_product(float* d, const uint32_t* a,
                                                    uint32_t base, int ks) {
    if constexpr (SW == 64) {
      wgmma_rs<T, DP>(d, a, wgmma_desc(base + ks * 16 * SW, BLOCK, 8 * SW) |
                               DESC_SW, 1);
    } else {
#pragma unroll
      for (int b = 0; b < NSW; ++b)
        wgmma_rs<T, 64>(d + 32 * b, a,
                        wgmma_desc(base + b * BLOCK + ks * 16 * SW, BLOCK,
                                   8 * SW) | DESC_SW, 1);
      if constexpr (REM > 0)
        wgmma_rs<T, REM>(d + 32 * NSW, a,
                         wgmma_desc(base + REM0 + ks * 256, 128, CHUNK), 1);
    }
  }

  // bytes the copies of one tile put on its barrier at head_dim D: whole
  // swizzled boxes (columns past D land as zeros) and the chunks of D
  static __host__ __device__ __forceinline__ uint32_t tx_bytes(int D) {
    return NSW * BLOCK + (REM > 0 ? (D - BCOLS * NSW) * 2 * ROWS : 0);
  }

  // zeroes the chunk-major chunks from D to DP of `tiles` tiles BYTES apart
  // (the copies never write them), by `nthreads` threads from `t`
  static __device__ __forceinline__ void zero_pad(unsigned char* smem,
                                                  int tiles, int D, int t,
                                                  int nthreads) {
    if constexpr (REM > 0) {
      const int first = (D - BCOLS * NSW) / 8;  // first pad chunk of the part
      const int pad = (REM / 8 - first) * ROWS;  // 16-byte rows a tile
      for (int i = t; i < tiles * pad; i += nthreads)
        *reinterpret_cast<uint4*>(smem + (i / pad) * BYTES + REM0 +
                                  (first + (i % pad) / ROWS) * CHUNK +
                                  (i % ROWS) * 16) = make_uint4(0, 0, 0, 0);
    }
  }

  // rows [row0, row0 + ROWS) of matrix `bh` into the tile at `dst`
  // (1024-byte aligned), tx_bytes(D) on `bar`; rows past N land as zeros
  static __device__ __forceinline__ void load(uint32_t dst, const TileMaps& maps,
                                              int row0, int bh, uint64_t* bar) {
#pragma unroll
    for (int b = 0; b < NSW; ++b)
      tma_load_3d(dst + b * BLOCK, &maps.sw, BCOLS * b, row0, bh, bar);
    if constexpr (REM > 0)
      tma_load_4d(dst + REM0, &maps.rem, 0, row0, 0, bh, bar);
  }

  // the maps `load` reads, of a contiguous [BH, N, D] matrix of 16-bit
  // elements (D % 8 == 0, a 16-byte aligned base)
  static cudaError_t maps(TileMaps* m, const void* base, int BH, int N, int D) {
    const cuuint64_t row = (cuuint64_t)D * 2, mat = (cuuint64_t)N * D * 2;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {row, mat};
    const cuuint32_t box[3] = {BCOLS, ROWS, 1};
    cudaError_t err = encode_tiled(
        &m->sw, 3, base, dims, strides, box,
        SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess || REM == 0) return err;
    const int chunks = (D - BCOLS * NSW) / 8;
    const cuuint64_t rdims[4] = {8, (cuuint64_t)N, (cuuint64_t)chunks,
                                 (cuuint64_t)BH};
    const cuuint64_t rstrides[3] = {row, 16, mat};
    const cuuint32_t rbox[4] = {8, ROWS, (cuuint32_t)chunks, 1};
    return encode_tiled(&m->rem, 4, static_cast<const char*>(base) + SW * NSW,
                        rdims, rstrides, rbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void wait_wgmma() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers written by an asynchronous wgmma after the wait for it
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// one arrival of the calling warp on `bar` (its lanes are done)
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The online softmax of one 64 x 128 score tile of a warpgroup, in place:
// S (the m64n128 accumulator: element 4 n + e is row e / 2 of this thread's
// two, key n * 8 + (lane % 4) * 2 + (e & 1)) becomes P = 2^(S scale log2(e)
// - m) with the running max m of each row updated, the running sums l
// rescaled and summed into (this thread's share of the row), and alpha =
// 2^(m_old - m_new), the factor the accumulator takes. `flags` (the tile's
// key flags, or null without a mask) and Nk mark the keys: 1 attend, 0
// masked (MASK_VALUE), -1 past Nk (-inf). A tile whose keys all attend
// takes the maximum of the raw products and one fused multiply-add a score.
__device__ __forceinline__ void online_softmax(float* s, float* m_r, float* l_r,
                                               float* alpha, float scale_log2,
                                               const int8_t* flags, int kv0,
                                               int Nk, int lane) {
  const bool plain = flags == nullptr && kv0 + LONG_KEYS <= Nk &&
                     scale_log2 > 0.f;
  float mt[2] = {-INFINITY, -INFINITY};
  if (plain) {
#pragma unroll
    for (int i = 0; i < 64; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
  } else {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + (lane % 4) * 2 + (e & 1);
        const int8_t flag = flags ? flags[key] : (kv0 + key < Nk ? 1 : -1);
        const float x = masked_score(s[4 * n + e] * scale_log2, flag);
        s[4 * n + e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    if (plain) mt[r] *= scale_log2;
    // the row's first key is real, so the running max is finite
    const float m_new = fmaxf(m_r[r], mt[r]);
    alpha[r] = fast_exp2(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
  if (plain) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_r[(i >> 1) & 1]));
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = fast_exp2(s[i] - m_r[(i >> 1) & 1]);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) l_r[(i >> 1) & 1] += s[i];
}

template <typename T, int DP>
__global__ void __launch_bounds__(128 * (long_consumers(DP) + 1), 1)
    flash_fwd_long(const __grid_constant__ TileMaps tm_q,
                   const __grid_constant__ TileMaps tm_k,
                   const __grid_constant__ TileMaps tm_v,
                   const T* __restrict__ q,
                   const uint8_t* __restrict__ mask, T* __restrict__ o,
                   float* __restrict__ lse, int H, int Nq, int Nk, int D,
                   float scale_log2) {
  using QL = LongLayout<DP, 64>;         // a consumer warpgroup's Q rows
  using KL = LongLayout<DP, LONG_KEYS>;  // a K or a V tile
  constexpr int NWG = long_consumers(DP);  // consumer warpgroups
  constexpr int THREADS = 128 * (NWG + 1);  // the producer's last
  constexpr int QROWS = 64 * NWG;           // q rows a tile
  constexpr int S = long_stages<DP>();
  constexpr int NACC = DP / 2;  // accumulator registers a thread
  // at DP = 80 and 96 each warpgroup holds its Q rows in registers, the A
  // operand of S = Q K^T (DP / 8 a thread, read from device memory once a
  // tile), which spares shared memory those reads; at DP = 64 (three
  // warpgroups at 160 registers) and 128 (where they spill) it reads the Q
  // tile the producer copies
  constexpr bool QREG = DP == 80 || DP == 96;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw;               // [NWG][QL::BYTES]
  unsigned char* sK0 = sQ + NWG * QL::BYTES;  // [S][KL::BYTES]
  unsigned char* sV0 = sK0 + S * KL::BYTES;   // [S][KL::BYTES]
  int8_t* sF0 = reinterpret_cast<int8_t*>(sV0 + S * KL::BYTES);  // [S][128]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sF0 + S * LONG_KEYS);
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;
  uint64_t* full_q = empty_v + S;

  const int q_tiles = (Nq + QROWS - 1) / QROWS;
  const int n_kv = (Nk + LONG_KEYS - 1) / LONG_KEYS;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QROWS;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  // the copies never write the pad chunks: zero them in every K and V tile
  // once (only DP = 80 has them; its Q rows come to registers)
  KL::zero_pad(sK0, 2 * S, D, threadIdx.x, THREADS);
  if (threadIdx.x == 0) {
    if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle's atoms
    for (int i = 0; i < S; ++i) {
      mbar_init(full_k + i, 32);  // the producer warp's lanes (key flags)
      mbar_init(full_v + i, 1);
      mbar_init(empty_k + i, 4 * NWG);  // one arrival a consumer warp
      mbar_init(empty_v + i, 4 * NWG);
    }
    mbar_init(full_q, 1);
    mbar_init_fence();
  }
  fence_async_shared();
  __syncthreads();

  if (wg == NWG) {
    // ---- the producer: its first warp keeps the copies in flight ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NWG == 2 ? 24 : 32));
    if (threadIdx.x / 32 != 4 * NWG) return;
    if (lane == 0)
      for (const TileMaps* m : {&tm_q, &tm_k, &tm_v}) {
        tma_prefetch(&m->sw);
        if (KL::REM > 0) tma_prefetch(&m->rem);
      }
    const uint8_t* mrow = mask ? mask + (size_t)(bh / H) * Nk : nullptr;
    if (!QREG && lane == 0) {
      // the Q tiles with a row < Nq
      const int live = min(NWG, (Nq - q0 + 63) / 64);
      mbar_expect_tx(full_q, live * QL::tx_bytes(D));
      for (int t = 0; t < live; ++t)
        QL::load(smem_addr(sQ + t * QL::BYTES), tm_q, q0 + 64 * t, bh, full_q);
    }
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % S;
      const int kv0 = j * LONG_KEYS;
      if (j >= S) mbar_wait(empty_k + st, (j / S - 1) & 1);
      if (mrow) {
        int8_t* f = sF0 + st * LONG_KEYS + lane * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = key_flag(mrow, kv0 + lane * 4 + i, Nk);
      }
      if (lane == 0) {
        mbar_expect_tx(full_k + st, KL::tx_bytes(D));
        KL::load(smem_addr(sK0 + st * KL::BYTES), tm_k, kv0, bh, full_k + st);
      } else {
        mbar_arrive(full_k + st);  // after this lane's key flags
      }
      if (j >= S) mbar_wait(empty_v + st, (j / S - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full_v + st, KL::tx_bytes(D));
        KL::load(smem_addr(sV0 + st * KL::BYTES), tm_v, kv0, bh, full_v + st);
      }
    }
  } else {
    // ---- the consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NWG == 2 ? 240 : 160));
    const int tw = threadIdx.x % 128;
    const uint32_t q_addr = smem_addr(sQ + wg * QL::BYTES);
    T* stage = reinterpret_cast<T*>(sQ + wg * QL::BYTES);
    float s[64], acc[NACC];
    uint32_t pa[8][4];  // P as the A operand of P V: 16 keys a step
    uint32_t qa[QREG ? DP / 16 : 1][4];  // Q as the A operand of S
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    // the first turn at the tensor cores is warpgroup 0's
    if (wg == NWG - 1) named_arrive(SCHED_BAR, 256);

    // S = Q K^T of the key tile in stage st (DP / 16 steps of k = 16)
    auto score = [&](int st) {
      const uint32_t k_addr = smem_addr(sK0 + st * KL::BYTES);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if constexpr (QREG)
          wgmma_rs_n128_kmajor<T>(s, qa[kk], KL::k_major(k_addr, kk), kk > 0);
        else
          wgmma_ss_n128<T>(s, QL::k_major(q_addr, kk),
                           KL::k_major(k_addr, kk), kk > 0);
      }
    };
    // acc += P V of the value tile in stage st (8 steps of 16 keys)
    auto value = [&](int st) {
      const uint32_t v_addr = smem_addr(sV0 + st * KL::BYTES);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        KL::template mn_product<T>(acc, pa[ks], v_addr, ks);
    };
    auto pack = [&]() {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        pa[n / 2][(n % 2) * 2] = Ops<T>::pack(s[4 * n], s[4 * n + 1]);
        pa[n / 2][(n % 2) * 2 + 1] = Ops<T>::pack(s[4 * n + 2], s[4 * n + 3]);
      }
    };

    // One trip: the grid holds one block a q tile. ptxas gives the consumer
    // warpgroups the registers setmaxnreg.inc asks for only when their code
    // sits in a loop; written straight it held them to the launch's 168,
    // spilled in the key loop and serialized the wgmma (ptxas C7512): 1.5x
    // slower on the card (PERF.md §6).
    for (int tile = blockIdx.x; tile < (int)gridDim.x; tile += gridDim.x) {
      const int row0 = q0 + wg * 64;
      const bool masked = mask != nullptr;
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      float m_r[2] = {-INFINITY, -INFINITY};  // this thread's two rows
      float l_r[2] = {0.f, 0.f};
      float alpha[2];
      if constexpr (QREG) {
        // this thread's two rows and, per 16-column step, columns c, c + 1,
        // c + 8, c + 9 (c = (lane % 4) * 2): the accumulator layout
        const T* qb = q + (size_t)bh * Nq * D;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int row = row0 + (tw / 32) * 16 + lane / 4 + (h & 1) * 8;
            const int col = kk * 16 + (lane % 4) * 2 + (h >> 1) * 8;
            qa[kk][h] = row < Nq && col < D
                            ? *reinterpret_cast<const uint32_t*>(
                                  qb + (size_t)row * D + col)
                            : 0u;
          }
      } else {
        mbar_wait(full_q, 0);
      }

      // key tile 0: its scores and softmax; no P V yet
      {
        mbar_wait(full_k, 0);
        named_sync(SCHED_BAR + wg, 256);
        wgmma_fence();
        score(0);
        wgmma_commit();
        named_arrive(SCHED_BAR + (wg + 1) % NWG, 256);
        wait_wgmma<0>();
        pin<64>(s);
        online_softmax(s, m_r, l_r, alpha, scale_log2, masked ? sF0 : nullptr,
                       0, Nk, lane);
        warp_arrive(empty_k, lane);  // K and its flags are read
        pack();
      }
      // key tile j: S_j, then P_{j-1} V_{j-1}; the softmax of j runs while
      // the value product is on the tensor cores
      for (int j = 1; j < n_kv; ++j) {
        const int stk = j % S, stv = (j - 1) % S;
        mbar_wait(full_k + stk, (j / S) & 1);
        named_sync(SCHED_BAR + wg, 256);
        wgmma_fence();
        score(stk);
        wgmma_commit();
        mbar_wait(full_v + stv, ((j - 1) / S) & 1);
        value(stv);
        wgmma_commit();
        named_arrive(SCHED_BAR + (wg + 1) % NWG, 256);
        wait_wgmma<1>();  // S_j is out; the value product may still run
        pin<64>(s);
        online_softmax(s, m_r, l_r, alpha, scale_log2,
                       masked ? sF0 + stk * LONG_KEYS : nullptr, j * LONG_KEYS,
                       Nk, lane);
        warp_arrive(empty_k + stk, lane);
        wait_wgmma<0>();
        pin<NACC>(acc);
        pin<64>(s);
        warp_arrive(empty_v + stv, lane);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];
        pack();
      }
      // the last value product
      {
        const int stv = (n_kv - 1) % S;
        mbar_wait(full_v + stv, ((n_kv - 1) / S) & 1);
        named_sync(SCHED_BAR + wg, 256);
        wgmma_fence();
        value(stv);
        wgmma_commit();
        named_arrive(SCHED_BAR + (wg + 1) % NWG, 256);
        wait_wgmma<0>();
        pin<NACC>(acc);
        warp_arrive(empty_v + stv, lane);
      }

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
      // the warpgroup's Q tile is free: its last score product is done
      store_tile_warpgroup<T, NACC>(o + (size_t)bh * Nq * D, acc, inv_l,
                                    row0, Nq, D, true, stage, STORE_BAR + wg);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_long(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* o, float* lse, int BH,
                        int H, int Nq, int Nk, int D, float scale_log2,
                        cudaStream_t stream) {
  constexpr int QROWS = 64 * long_consumers(DP);
  const long long tiles = (long long)BH * ((Nq + QROWS - 1) / QROWS);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = long_smem_bytes<DP>();
  static_assert(smem <= SMEM_PER_BLOCK, "shared memory of a block");
  auto kernel = flash_fwd_long<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  TileMaps maps[3] = {};
  err = LongLayout<DP, 64>::maps(&maps[0], q, BH, Nq, D);
  if (err == cudaSuccess) err = LongLayout<DP, LONG_KEYS>::maps(&maps[1], k, BH, Nk, D);
  if (err == cudaSuccess) err = LongLayout<DP, LONG_KEYS>::maps(&maps[2], v, BH, Nk, D);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles, 128 * (long_consumers(DP) + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(q), mask,
      static_cast<T*>(o), lse, H, Nq, Nk, D, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_long(const void* q, const void* k, const void* v,
                          const uint8_t* mask, void* o, float* lse, int BH,
                          int H, int Nq, int Nk, int D, float scale_log2,
                          cudaStream_t stream) {
#define VIDEOSYS_ARGS q, k, v, mask, o, lse, BH, H, Nq, Nk, D, scale_log2, stream
  switch (long_width(D)) {
    case 64: return launch_long<T, 64>(VIDEOSYS_ARGS);
    case 80: return launch_long<T, 80>(VIDEOSYS_ARGS);
    case 96: return launch_long<T, 96>(VIDEOSYS_ARGS);
    default: return launch_long<T, 128>(VIDEOSYS_ARGS);
  }
#undef VIDEOSYS_ARGS
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C interface, loaded with ctypes. q: [BH, Nq, D], k/v: [BH, Nk, D], o:
// [BH, Nq, D], contiguous, 16-byte aligned, of one type (dtype 1 = bf16, 2 =
// fp16), D % 8 == 0 and D <= 128; mask: [BH / H, Nk] bytes (nonzero =
// attend) or null; lse: fp32 [BH, Nq] or null. Launches one block a q tile
// on `stream` and returns the launch's cudaError_t.
extern "C" int flash_fwd_long(const void* q, const void* k, const void* v,
                              const void* mask, void* o, void* lse, int dtype,
                              int BH, int H, int Nq, int Nk, int D, float scale,
                              void* stream) {
  if (BH <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || (dtype != 1 && dtype != 2) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? dispatch_long<__nv_bfloat16>(q, k, v, m, o, l, BH, H, Nq,
                                                Nk, D, scale_log2, s)
                 : dispatch_long<__half>(q, k, v, m, o, l, BH, H, Nq, Nk, D,
                                         scale_log2, s);
  return (int)err;
}

// Bytes of shared memory a block asks for at head_dim D, or -1; the
// wrapper's `long_smem_bytes` mirrors the formula.
extern "C" long flash_fwd_long_smem(int D) {
  if (D <= 0 || D > 128) return -1;
  switch (long_width(D)) {
    case 64: return (long)long_smem_bytes<64>();
    case 80: return (long)long_smem_bytes<80>();
    case 96: return (long)long_smem_bytes<96>();
    default: return (long)long_smem_bytes<128>();
  }
}

extern "C" const char* flash_fwd_long_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
