// Layout checks of hopper.cuh on the card, one tile each; no kernel of the
// model's path uses this library. tests/test_torch_cuda.py compares:
// - hopper_tma_tile: one TMA box (64 columns x `rows`, 128-byte swizzle) of
//   a strided 4-D bf16 tensor, copied out of shared memory byte for byte,
//   against the swizzled slice (zeros past the edges);
// - hopper_wgmma_ss: rows [a_row0, a_row0 + 64) of A [128, 128] times B^T,
//   B [128, 128], both K-major and TMA-loaded, as flash_fwd.cu's Q K^T;
// - hopper_wgmma_rs: P [64, 128] from registers times V [128, 128], V an
//   MN-major B operand, as flash_fwd.cu's P V;
// - hopper_wgmma_ss64: rows [a_row0, a_row0 + 64) of A [128, 128] times B^T,
//   B [64, 128] a 64-row box, with the m64n64k16 form, as flash_bwd.cu's
//   S^T = K Q^T (and S = Q K^T);
// - hopper_wgmma_rs64: P [64, 64] from registers times V [64, 128], V a
//   64-row MN-major B operand (halves 8 KB apart), as flash_bwd.cu's P^T dO,
//   dS^T Q and dS K.
// Each launches one block of one warpgroup; run them first after a change to
// hopper.cuh or to a kernel's descriptors.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int HALF = 128 * 128;  // bytes of one 64-column half of a 128-row tile
constexpr int HALF64 = 64 * 128; // ... of a 64-row tile

__global__ void __launch_bounds__(128) tma_tile_kernel(
    const __grid_constant__ CUtensorMap map, int c0, int c1, int c2, int c3,
    int rows, unsigned char* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* tile = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, rows * 128);
    tma_load_4d(tile, &map, &bar, c0, c1, c2, c3);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < rows * 128; i += blockDim.x) out[i] = tile[i];
}

// d (the m64n128 accumulator layout) into a row-major [64, 128] fp32 matrix
__device__ void store_acc(const float (&d)[64], float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * 128 + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

__global__ void __launch_bounds__(128) wgmma_ss_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    int a_row0, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + 2 * HALF;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 4 * HALF);
    tma_load_4d(sA, &map_a, &bar, 0, 0, 0, 0);
    tma_load_4d(sA + HALF, &map_a, &bar, 64, 0, 0, 0);
    tma_load_4d(sB, &map_b, &bar, 0, 0, 0, 0);
    tma_load_4d(sB + HALF, &map_b, &bar, 64, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  float d[64];
  const uint64_t da = desc_kmajor(sA + 128 * a_row0), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t off = ((kk / 4) * HALF + (kk % 4) * 32) >> 4;
    wgmma_m64n128k16_ss<0, 0>(d, da + off, db + off, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc(d, out);
}

__global__ void __launch_bounds__(128) wgmma_rs_kernel(
    const __nv_bfloat16* __restrict__ p, const __grid_constant__ CUtensorMap map_v,
    float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sV = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 2 * HALF);
    tma_load_4d(sV, &map_v, &bar, 0, 0, 0, 0);
    tma_load_4d(sV + HALF, &map_v, &bar, 64, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t pa[8][4];
  const __nv_bfloat16* prow = p + (16 * warp + g) * 128 + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    pa[jj][0] = ld_pair(prow + 16 * jj);
    pa[jj][1] = ld_pair(prow + 8 * 128 + 16 * jj);
    pa[jj][2] = ld_pair(prow + 16 * jj + 8);
    pa[jj][3] = ld_pair(prow + 8 * 128 + 16 * jj + 8);
  }
  mbar_wait(&bar, 0);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint64_t dv = desc_mnmajor(sV, HALF);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    wgmma_m64n128k16_rs<1>(d, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc(d, out);
}

// the m64n64 accumulator into a row-major [64, 64] fp32 matrix
__device__ void store_acc64(const float (&d)[32], float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

__global__ void __launch_bounds__(128) wgmma_ss64_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    int a_row0, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + 2 * HALF;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 2 * HALF + 2 * HALF64);
    tma_load_4d(sA, &map_a, &bar, 0, 0, 0, 0);
    tma_load_4d(sA + HALF, &map_a, &bar, 64, 0, 0, 0);
    tma_load_4d(sB, &map_b, &bar, 0, 0, 0, 0);
    tma_load_4d(sB + HALF64, &map_b, &bar, 64, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  float d[32];
  const uint64_t da = desc_kmajor(sA + 128 * a_row0), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<0, 0>(d, da + (((kk / 4) * HALF + (kk % 4) * 32) >> 4),
                             db + (((kk / 4) * HALF64 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc64(d, out);
}

__global__ void __launch_bounds__(128) wgmma_rs64_kernel(
    const __nv_bfloat16* __restrict__ p, const __grid_constant__ CUtensorMap map_v,
    float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sV = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 2 * HALF64);
    tma_load_4d(sV, &map_v, &bar, 0, 0, 0, 0);
    tma_load_4d(sV + HALF64, &map_v, &bar, 64, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t pa[4][4];
  const __nv_bfloat16* prow = p + (16 * warp + g) * 64 + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    pa[jj][0] = ld_pair(prow + 16 * jj);
    pa[jj][1] = ld_pair(prow + 8 * 64 + 16 * jj);
    pa[jj][2] = ld_pair(prow + 16 * jj + 8);
    pa[jj][3] = ld_pair(prow + 8 * 64 + 16 * jj + 8);
  }
  mbar_wait(&bar, 0);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint64_t dv = desc_mnmajor(sV, HALF64);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    wgmma_m64n128k16_rs<1>(d, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc(d, out);
}

// a rows x 128 contiguous bf16 matrix as a 4-D map of 64-column boxes
bool matrix_map(CUtensorMap* map, const void* base, int64_t rows, uint32_t box_rows) {
  const int64_t dims[4] = {128, rows, 1, 1};
  const int64_t strides[3] = {128, 128 * rows, 128 * rows};
  return make_map_bf16_4d(map, base, dims, strides, box_rows);
}

bool square_map(CUtensorMap* map, const void* base, uint32_t box_rows) {
  return matrix_map(map, base, 128, box_rows);
}

}  // namespace

// src: a bf16 tensor of dims d0..d3 (innermost first, d0 contiguous) with
// element strides s1..s3; out: rows * 128 bytes.
extern "C" int hopper_tma_tile(const void* src, int64_t d0, int64_t d1, int64_t d2,
                               int64_t d3, int64_t s1, int64_t s2, int64_t s3,
                               int c0, int c1, int c2, int c3, int rows, void* out,
                               void* stream) {
  const int64_t dims[4] = {d0, d1, d2, d3};
  const int64_t strides[3] = {s1, s2, s3};
  CUtensorMap map;
  if (rows < 1 || rows > 256 || !make_map_bf16_4d(&map, src, dims, strides, rows))
    return (int)cudaErrorInvalidValue;
  const int smem = rows * 128 + 1024;
  tma_tile_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      map, c0, c1, c2, c3, rows, (unsigned char*)out);
  return (int)cudaGetLastError();
}

// a: [128, 128], b: [128, 128] bf16 contiguous; out: [64, 128] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T
extern "C" int hopper_wgmma_ss(const void* a, const void* b, int a_row0, void* out,
                               void* stream) {
  CUtensorMap map_a, map_b;
  if ((a_row0 != 0 && a_row0 != 64) || !square_map(&map_a, a, 128) ||
      !square_map(&map_b, b, 128))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * HALF + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                         (float*)out);
  return (int)cudaGetLastError();
}

// p: [64, 128], v: [128, 128] bf16 contiguous; out: [64, 128] fp32 = p @ v
extern "C" int hopper_wgmma_rs(const void* p, const void* v, void* out, void* stream) {
  CUtensorMap map_v;
  if (!square_map(&map_v, v, 128)) return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 1024;
  wgmma_rs_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)p, map_v, (float*)out);
  return (int)cudaGetLastError();
}

// a: [128, 128], b: [64, 128] bf16 contiguous; out: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T
extern "C" int hopper_wgmma_ss64(const void* a, const void* b, int a_row0, void* out,
                                 void* stream) {
  CUtensorMap map_a, map_b;
  if ((a_row0 != 0 && a_row0 != 64) || !square_map(&map_a, a, 128) ||
      !matrix_map(&map_b, b, 64, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 2 * HALF64 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss64_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                           (float*)out);
  return (int)cudaGetLastError();
}

// p: [64, 64], v: [64, 128] bf16 contiguous; out: [64, 128] fp32 = p @ v
extern "C" int hopper_wgmma_rs64(const void* p, const void* v, void* out, void* stream) {
  CUtensorMap map_v;
  if (!matrix_map(&map_v, v, 64, 64)) return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF64 + 1024;
  wgmma_rs64_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)p, map_v, (float*)out);
  return (int)cudaGetLastError();
}
