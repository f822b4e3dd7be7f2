// Tensor Memory Accelerator (TMA) copies, mbarriers and the tile layout they
// fill, for the wgmma kernels (sm_90a): one thread asks for a whole tile, the
// copy engine fills it and counts its bytes on a barrier in shared memory,
// and the consumers wait on that barrier. No thread spends registers or
// instructions on addresses.
//
// Layout of a 64-row tile of DP padded 16-bit columns (`TileLayout<DP,
// SWIZZLED>`):
//   * with SWIZZLED, the first 64 * (DP / 64) columns in blocks of 64
//     columns, each 64 rows x 128 bytes with the 16-byte chunks of row r
//     permuted by chunk ^ (r % 8): the 128-byte swizzle of TMA and wgmma.
//     One box a block; its rows are 128 contiguous bytes of device memory,
//     whole L2 sectors;
//   * the columns after them (16 at DP = 80, all 32 at DP = 32; all of them
//     without SWIZZLED) chunk-major, without a swizzle: chunk c of row r at
//     c * 1024 + r * 16, one box of 8 columns x 64 rows x the chunks.
// The swizzled blocks halve what a tile costs in L2 sectors (a chunk-major
// box reads 16 bytes of each 32-byte sector it touches), which pays where
// the copies are the limit (the narrow forward); the chunk-major form takes
// one product a step for the MN-major operand, which pays where the
// products are (the dk/dv kernel).
// wgmma reads the swizzled blocks with stride 1024 (the next 8 rows); a
// 16-deep step of a K-major operand starts 32 bytes further in its row, an
// MN-major operand's 16-row step 2048 bytes further. It reads the
// chunk-major part with, K-major, lead = 1024 (the next 8 columns) and
// stride = 128 (the next 8 rows); MN-major, lead = 128 and stride = 1024.
#pragma once

#include <cuda.h>

#include "wgmma.cuh"

namespace {

constexpr int TILE_ROWS = 64;
constexpr int CHUNK_BYTES = TILE_ROWS * 16;  // one chunk-major chunk
constexpr int SW_BYTES = TILE_ROWS * 128;    // one swizzled block
constexpr uint64_t DESC_SW128 = 1ull << 62;  // descriptor layout: 128B swizzle

template <int DP, bool SWIZZLED>
struct TileLayout {
  static constexpr int NSW = SWIZZLED ? DP / 64 : 0;  // swizzled blocks
  static constexpr int REM = DP - 64 * NSW;  // chunk-major columns
  static constexpr int REM0 = NSW * SW_BYTES;  // where they start
  static constexpr int COLS = DP;
  static_assert(DP == 32 || DP == 64 || DP == 80 || DP == 128,
                "padded widths 32, 64, 80, 128");

  // byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    if (c < 8 * NSW)
      return (c / 8) * SW_BYTES + r * 128 + (((c % 8) ^ (r % 8)) * 16);
    return REM0 + (c - 8 * NSW) * CHUNK_BYTES + r * 16;
  }

  // descriptor of the 16-column step kk of a K-major operand (rows M or N,
  // the depth along the columns) at `base`
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    if (kk < 4 * NSW)
      return wgmma_desc(base + (kk / 4) * SW_BYTES + (kk % 4) * 32, 16, 1024) |
             DESC_SW128;
    return wgmma_desc(base + REM0 + (2 * kk - 8 * NSW) * CHUNK_BYTES,
                      CHUNK_BYTES, 128);
  }

  // d[DP / 2] (+)= A B for the 16-row step ks of an MN-major operand B at
  // `base` (the depth along its rows, its DP columns the output's): one
  // product per swizzled block, one for the chunk-major part
  template <typename T>
  static __device__ __forceinline__ void mn_product(float* d, const uint32_t* a,
                                                    uint32_t base, int ks) {
#pragma unroll
    for (int b = 0; b < NSW; ++b)
      wgmma_rs<T, 64>(d + 32 * b, a,
                      wgmma_desc(base + b * SW_BYTES + ks * 2048, SW_BYTES,
                                 1024) | DESC_SW128, 1);
    if constexpr (REM > 0)
      wgmma_rs<T, REM>(d + 32 * NSW, a,
                       wgmma_desc(base + REM0 + ks * 256, 128, CHUNK_BYTES), 1);
  }

  // bytes the copies of one tile put on its barrier at head_dim D: whole
  // swizzled boxes (columns past D land as zeros) and the chunks of D after
  // them
  static __host__ __device__ __forceinline__ uint32_t tx_bytes(int D) {
    return NSW * SW_BYTES + (REM > 0 ? (D - 64 * NSW) * 128 : 0);
  }

  // zeroes the chunk-major chunks from D to DP of `tiles` tiles TILE bytes
  // apart (the copies never write them), by the block's threads
  template <int NTHREADS>
  static __device__ __forceinline__ void zero_pad(unsigned char* smem,
                                                  int tiles, int D) {
    if constexpr (REM > 0) {
      constexpr int TILE = TILE_ROWS * DP * 2;
      const int first = (D - 64 * NSW) / 8;  // first pad chunk of the part
      const int pad = (REM / 8 - first) * TILE_ROWS;  // 16-byte rows a tile
      for (int i = threadIdx.x; i < tiles * pad; i += NTHREADS)
        *reinterpret_cast<uint4*>(smem + (i / pad) * TILE + REM0 +
                                  (first + (i % pad) / TILE_ROWS) * CHUNK_BYTES +
                                  (i % TILE_ROWS) * 16) = make_uint4(0, 0, 0, 0);
    }
  }
};

// the tensor maps of one [BH, N, D] matrix: the swizzled blocks' and the
// chunk-major part's (either unused where the layout has none)
struct TileMaps {
  CUtensorMap sw, rem;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// makes initialised barriers visible to the copy engine; a __syncthreads()
// must follow before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the calling thread's arrival, and `bytes` more to come from copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the phase of the given parity to complete; a copy that never
// lands traps after ~2^34 cycles (about ten seconds) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// box {c0, c1, c2} of a three-dimensional tensor map into shared memory at
// `dst`, its bytes counted on `bar`; elements out of bounds land as zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// the same for a four-dimensional map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// brings a tensor map into the copy engine's cache before its first use
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Rows [row0, row0 + 64) of matrix `bh` of the maps made by `tile_maps<L>`
// (D % 8 == 0) into a tile of layout L at `dst` (1024-byte aligned): one box
// a swizzled block and one for the chunk-major part, L::tx_bytes(D) on
// `bar`. Rows past N land as zeros.
template <typename L>
__device__ __forceinline__ void tma_tile(uint32_t dst, const TileMaps& maps,
                                         int row0, int bh, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < L::NSW; ++b)
    tma_load_3d(dst + b * SW_BYTES, &maps.sw, 64 * b, row0, bh, bar);
  if constexpr (L::REM > 0) tma_load_4d(dst + L::REM0, &maps.rem, 0, row0, 0, bh, bar);
}

// The same tile by the block's threads, element by element (any D and any
// alignment): zeros past N and past D up to DP. The writes are generic:
// fence_async_shared() and a barrier before wgmma reads them.
template <typename T, int NTHREADS, typename L>
__device__ __forceinline__ void load_tile_rows(unsigned char* dst,
                                               const T* src, int row0, int N,
                                               int D) {
  const T zero = Ops<T>::from_float(0.f);
  for (int u = threadIdx.x; u < TILE_ROWS * (L::COLS / 8); u += NTHREADS) {
    const int r = u % TILE_ROWS;
    const int chunk = u / TILE_ROWS;
    const int grow = row0 + r;
    T* de = reinterpret_cast<T*>(dst + L::offset(r, chunk));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = chunk * 8 + e;
      de[e] = (grow < N && col < D) ? src[(size_t)grow * D + col] : zero;
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime so that the
// library needs no link to the driver
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(CUtensorMap* map, cuuint32_t rank,
                                const void* base, const cuuint64_t* dims,
                                const cuuint64_t* strides, const cuuint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT16, rank, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps `tma_tile<L>` reads, of a contiguous [BH, N, D] matrix of
// 16-bit elements (D % 8 == 0, a 16-byte aligned base): the swizzled blocks
// as boxes of 64 columns x 64 rows of one matrix; the chunk-major part as
// [BH][chunks][N rows][8 columns] (the chunk stride, 16 bytes, under the row
// stride), one box of 8 columns x 64 rows x its chunks of D.
template <typename L>
cudaError_t tile_maps(TileMaps* maps, const void* base, int BH, int N, int D) {
  const cuuint64_t row = (cuuint64_t)D * 2, mat = (cuuint64_t)N * D * 2;
  if (L::NSW > 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {row, mat};
    const cuuint32_t box[3] = {64, TILE_ROWS, 1};
    cudaError_t err = encode_tiled(&maps->sw, 3, base, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  if (L::REM > 0) {
    const int chunks = (D - 64 * L::NSW) / 8;
    const cuuint64_t dims[4] = {8, (cuuint64_t)N, (cuuint64_t)chunks,
                                (cuuint64_t)BH};
    const cuuint64_t strides[3] = {row, 16, mat};
    const cuuint32_t box[4] = {8, TILE_ROWS, (cuuint32_t)chunks, 1};
    return encode_tiled(&maps->rem, 4,
                        static_cast<const char*>(base) + 128 * L::NSW, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  return cudaSuccess;
}

}  // namespace
