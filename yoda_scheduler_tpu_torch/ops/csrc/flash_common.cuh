// Pieces shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu):
// dtype conversions, the fast exponential, the bf16 tensor-core product and
// its fragment helpers, and the 16-byte tile copy into shared memory.
//
// ops/_build.py hashes every .cuh in csrc/ into each kernel's library name,
// so an edit here rebuilds both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to the storage type T, as the plain version rounds a product's
// operand to the input dtype
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Tensor-core helpers. mma.sync m16n8k16 fragments, with g = lane / 4 and
// t = lane % 4: A (16x16, row-major) reg0 = (row g, cols 2t, 2t+1), reg1 =
// row g+8, reg2 = row g cols +8, reg3 = row g+8 cols +8; B (16x8) reg0 =
// (rows 2t, 2t+1, col g), reg1 = rows +8; C (16x8 fp32) c0, c1 = (row g,
// cols 2t, 2t+1), c2, c3 = row g+8. The lower column sits in the low half.
// So the C tiles of n-tiles 2j and 2j+1 are, packed to bf16, the A fragment
// of k-step j of a following product.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// A fragment of rows [0, 16) x cols [16 kk, 16 kk + 16) of a bf16 tile in
// shared memory with row stride DS
template <int DS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int kk, int g, int t4) {
  a[0] = ld_pair(tile + g * DS + 16 * kk + 2 * t4);
  a[1] = ld_pair(tile + (g + 8) * DS + 16 * kk + 2 * t4);
  a[2] = ld_pair(tile + g * DS + 16 * kk + 8 + 2 * t4);
  a[3] = ld_pair(tile + (g + 8) * DS + 16 * kk + 8 + 2 * t4);
}

// rows [r0, r0 + 64) of a [S, D] bf16 matrix (row stride `ss`) into shared
// memory with row stride D + 8, zero past row S; 16-byte copies
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t ss, int r0, int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT_MMA) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = {0u, 0u, 0u, 0u};
    if (r0 + r < S) x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
  }
}

// the tensor-core kernels copy rows in 16-byte pieces: the n base pointers
// and the ns row strides (in elements) must allow that
inline bool rows_aligned(const void* const* ptrs, int n, const int64_t* st, int ns) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < ns; ++i)
    if (st[i] % 8) return false;
  return true;
}

}  // namespace
