// Pieces shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu):
// dtype conversions, the fast exponential, the bf16 and fp16 tensor-core
// products and their fragment helpers, the 16-byte tile copy into shared
// memory, and the padded widths the simt and mma kernels are built at.
//
// ops/_build.py hashes every .cuh in csrc/ into each kernel's library name,
// so an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT_MMA = 128;   // threads per block of the tensor-core kernels (4 warps)
constexpr float NEG = -1e30f; // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// 2^x as one MUFU op (ex2.approx.ftz): exp2f adds a fix-up for subnormal
// results around it, which cost 3-4% of the forward's wgmma kernel at the
// main shape on an H100; here probabilities below 2^-126 become 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }
// x rounded to the storage type T, as the plain version rounds a product's
// operand to the input dtype
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_as(float x, __half) {
  return __half2float(__float2half_rn(x));
}

// The simt and mma kernels are built at a padded head dim DP of 32, 64, 128,
// 256 or (simt alone) 512, the smallest that holds the true d, which they
// take at run time (the mma kernels also have an exact build for d = DP):
// columns past d load as zeros and are not stored, so the zero columns add
// nothing to Q.K^T and the kept columns are exact. 0: d is past the widest.
inline int padded_dim(int d) {
  return d < 1 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256
       : d <= 512 ? 512 : 0;
}

// the simt kernels' tiles (q rows, keys): 64, 32 at DP = 256 and 16 at 512,
// where their fp32 tiles of more rows would not fit in shared memory (at 512
// the forward takes ~100 KB and the backward ~133 KB of the 227 KB)
__host__ __device__ constexpr int simt_tile(int DP) {
  return DP > 256 ? 16 : DP > 128 ? 32 : 64;
}

// Tensor-core helpers. mma.sync m16n8k16 fragments, with g = lane / 4 and
// t = lane % 4: A (16x16, row-major) reg0 = (row g, cols 2t, 2t+1), reg1 =
// row g+8, reg2 = row g cols +8, reg3 = row g+8 cols +8; B (16x8) reg0 =
// (rows 2t, 2t+1, col g), reg1 = rows +8; C (16x8 fp32) c0, c1 = (row g,
// cols 2t, 2t+1), c2, c3 = row g+8. The lower column sits in the low half.
// So the C tiles of n-tiles 2j and 2j+1 are, packed to the input type, the
// A fragment of k-step j of a following product. The same layout holds for
// fp16 (mma_t<__half>, the .f16 form).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the product of the input type T (bf16 or fp16) with fp32 sums
template <typename T>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(d, a, b0, b1);
  } else {
    mma_bf16(d, a, b0, b1);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lo and hi rounded to T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack_t(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack_raw(T lo, T hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// A fragment of rows [0, 16) x cols [16 kk, 16 kk + 16) of a 16-bit tile in
// shared memory with row stride DS
template <int DS, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int kk, int g,
                                       int t4) {
  a[0] = ld_pair(tile + g * DS + 16 * kk + 2 * t4);
  a[1] = ld_pair(tile + (g + 8) * DS + 16 * kk + 2 * t4);
  a[2] = ld_pair(tile + g * DS + 16 * kk + 8 + 2 * t4);
  a[3] = ld_pair(tile + (g + 8) * DS + 16 * kk + 8 + 2 * t4);
}

// rows [r0, r0 + 64) of a [S, d] matrix of 16-bit T (row stride `ss`, d a
// multiple of 8) into shared memory with row stride DP + 8, zero past row S
// and past column d up to DP; 16-byte copies
template <int DP, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ss, int r0, int S,
                                          int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT_MMA) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = {0u, 0u, 0u, 0u};
    if (r0 + r < S && c < d)
      x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = x;
  }
}

// the tensor-core kernels copy rows of 16-bit elements in pieces of `bytes`
// (16; 8 for the head-dim-100 wgmma kernels): the n base pointers, the ns
// row strides (in elements) and the head dim d must allow that
inline bool rows_aligned(const void* const* ptrs, int n, const int64_t* st, int ns, int d,
                         int bytes = 16) {
  const int elems = bytes / 2;
  if (d % elems) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % bytes) return false;
  for (int i = 0; i < ns; ++i)
    if (st[i] % elems) return false;
  return true;
}

}  // namespace
