// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_fused.cu): the bf16/fp16 mma.sync wrappers, ldmatrix and cp.async,
// the tile loader and the key flags.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // q rows per block: 4 warps x 16 rows
constexpr int BLOCK_N = 64;  // keys per loop iteration
constexpr int THREADS = 128;
constexpr int PAD = 8;       // shared-memory row padding against bank conflicts
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASK_HALF = 0.5f * MASK_VALUE;
constexpr size_t SMEM_PER_BLOCK = 232448;  // 227 KB, the most a block may ask

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  // copies src_bytes (16 or 0) and zero-fills the rest of the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  // copies src_bytes (4 or 0) and zero-fills the rest of the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// waits until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ int8_t key_flag(const uint8_t* mrow, int key,
                                           int Nk) {
  // 1 attend, 0 masked, -1 past Nk
  return key >= Nk ? -1 : ((mrow && !mrow[key]) ? 0 : 1);
}

__device__ __forceinline__ float masked_score(float x, int8_t flag) {
  return flag < 0 ? -INFINITY : (flag == 0 ? MASK_VALUE : x);
}

// Starts copying rows [row0, row0 + 64) and columns [col0, col0 + width) of
// a row-major [N, D] matrix into shared memory with row stride `ld`, zero
// filling whatever lies past N or D. `width` is a multiple of 8. With `vec`
// (D % 8 == 0 and 16-byte aligned rows) 8-element chunks go by cp.async and
// land after cp_async_wait_all(); otherwise elements are copied one by one.
// Either way a __syncthreads() must follow before the tile is read.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int N, int col0,
                                          int width, int D, bool vec) {
  const int chunks = width / 8;
  const T zero = Ops<T>::from_float(0.f);
  for (int c = threadIdx.x; c < 64 * chunks; c += THREADS) {
    const int r = c / chunks;
    const int cc = (c % chunks) * 8;
    const int grow = row0 + r;
    const int gcol = col0 + cc;
    T* d = dst + r * ld + cc;
    if (vec) {  // D % 8 == 0: a chunk lies wholly inside or outside D
      const bool in = grow < N && gcol < D;
      cp_async16(d, in ? src + (size_t)grow * D + gcol : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = gcol + e;
        d[e] = (grow < N && col < D) ? src[(size_t)grow * D + col] : zero;
      }
    }
  }
}

}  // namespace
