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
//   dS^T Q and dS K;
// - hopper_wgmma_rs96: P [64, rows] from registers times V [rows, 96] (rows
//   64 or 128), V a tensor 96 wide read as two 64-column boxes (the second
//   zero-filled past column 96) and an MN-major B operand of the m64n96k16
//   form, as the D = 96 kernels' P V (128 rows), P^T dO and dS^T Q (64);
// - hopper_wgmma_rs80, hopper_wgmma_rs104: the same with V 80 and 104 wide
//   and the m64n80k16 and m64n104k16 forms, as the D = 80 and D = 100
//   forwards' P V; hopper_wgmma_rs80_f16, hopper_wgmma_rs96_f16,
//   hopper_wgmma_rs104_f16: the m64n80k16, m64n96k16 and m64n104k16 forms on
//   fp16 operands (the .f16 forms over FLOAT16 maps), as the fp16 D = 80, 96
//   and 100 forwards' P V;
// - hopper_cp_async_tile: two [S, 100] row sets, A and B, 8-byte aligned,
//   copied by cp_async_rows into the 128-wide swizzled layout (rows past S
//   zero, columns 100-127 zeroed) and read back through wgmma: A B^T with 7
//   SS k-steps and P B with m64n104k16, as flash_fwd_wgmma100_kernel's Q K^T
//   and P V;
// - hopper_cp_async_tile64: [S, 100] row sets A, B and C, 8-byte aligned: A
//   copied by cp_async_rows into a 128-row tile, rows [row0, row0 + 64) of B
//   and C into two 64-row tiles in one pass (cp_async_rows<100, 64>), read
//   back through the backward's products: A B^T with 7 SS m64n64k16 k-steps
//   and P C with m64n104k16, C a 64-row MN-major B, as the D = 100 backward
//   kernels' S^T = K Q^T and dV += P^T dO (and S = Q K^T, dQ += dS K);
// - hopper_wgmma_ss_f16, hopper_wgmma_rs_f16: hopper_wgmma_ss and
//   hopper_wgmma_rs on fp16 operands (the .f16 instructions over FLOAT16
//   maps), as flash_fwd.cu's fp16 Q K^T and P V;
// - hopper_wgmma_ss64_f16: hopper_wgmma_ss64 on fp16 operands, as
//   flash_bwd.cu's fp16 S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T;
// - hopper_wgmma_ss96_f16, hopper_wgmma_ss80_f16: the same over rows 96 or
//   80 wide (A [128, W], B [64, W]), each read as two 64-column boxes, the
//   second zero-filled by TMA past column W, with 6 or 5 k-steps (the 5th
//   over the second box's columns 64-79), as the fp16 D = 96 and D = 80
//   backward kernels' S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T;
// - hopper_wgmma_rs64_f16: P [64, 128] from registers times V [128, 64], V
//   one MN-major box, with the fp16 m64n64k16 RS form, as
//   flash_fwd_wgmma64_f16_kernel's P V;
// - hopper_wgmma_chain64_f16: S = A B^T (A, B [64, 64] fp16, one K-major box
//   each, 4 SS m64n64k16 k-steps), S rounded to fp16 in registers as the RS
//   form's A (`to_a_operand<__half>` of flash_bwd.cu), times C [64, 64], one
//   64-row MN-major box, with 4 RS m64n64k16 k-steps: the fp16 head-dim-64
//   backward kernels' S^T = K Q^T, P^T, dV += P^T dO (and dS^T Q, dS K);
// - hopper_wgmma_ss256: rows [a_row0, a_row0 + 64) of A [128, 256] times
//   B^T, B [64, 256], each row in four 64-column boxes (A's 16 KB apart, B's
//   8 KB), with 16 SS m64n64k16 k-steps, as flash_fwd_wgmma256_kernel's
//   Q K^T;
// - hopper_wgmma_ss256_a64: the same with A [64, 256] of four 64-row boxes
//   8 KB apart, as B's, as the head-dim-256 backward kernels' S^T = K Q^T,
//   dP^T = V dO^T, S = Q K^T and dP = dO V^T (`scores256`);
// - hopper_wgmma_rs256: P [64, 64] from registers times V [64, 256], V in
//   four MN-major 64-row boxes 8 KB apart, as two RS m64n128k16 products
//   over its column halves, as flash_fwd_wgmma256_kernel's P V;
// - hopper_wgmma_ss256_a64_f16, hopper_wgmma_rs256_f16: those two on fp16
//   operands (the .f16 forms over FLOAT16 maps), as the fp16 head-dim-256
//   backward kernels' `scores256` and `sum256` (and the fp16 forward's P V).
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

// an m64nN accumulator (the m64n128 layout's columns 0 to N - 1) into a
// row-major [64, N] fp32 matrix
template <int N>
__device__ void store_acc(const float (&d)[N / 2], float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * warp + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

template <typename T>
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
    wgmma_m64n128k16_ss<0, 0, T>(d, da + off, db + off, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<128>(d, out);
}

template <typename T>
__global__ void __launch_bounds__(128) wgmma_rs_kernel(
    const T* __restrict__ p, const __grid_constant__ CUtensorMap map_v,
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
  const T* prow = p + (16 * warp + g) * 128 + 2 * t;
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
    wgmma_m64n128k16_rs<1, T>(d, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<128>(d, out);
}

// rows of D (128, or 96 or 80 over the same boxes, zero past column D): D /
// 16 k-steps
template <typename T, int D = 128>
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
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss<0, 0, T>(d, da + (((kk / 4) * HALF + (kk % 4) * 32) >> 4),
                                db + (((kk / 4) * HALF64 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<64>(d, out);
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
  store_acc<128>(d, out);
}

template <typename T, int N, int ROWS>
__global__ void __launch_bounds__(128) wgmma_rs_n_kernel(
    const T* __restrict__ p, const __grid_constant__ CUtensorMap map_v, float* out) {
  constexpr int VHALF = ROWS * 128;  // bytes of one 64-column box of V
  extern __shared__ unsigned char raw[];
  unsigned char* sV = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 2 * VHALF);
    tma_load_4d(sV, &map_v, &bar, 0, 0, 0, 0);
    tma_load_4d(sV + VHALF, &map_v, &bar, 64, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t pa[ROWS / 16][4];
  const T* prow = p + (16 * warp + g) * ROWS + 2 * t;
#pragma unroll
  for (int jj = 0; jj < ROWS / 16; ++jj) {
    pa[jj][0] = ld_pair(prow + 16 * jj);
    pa[jj][1] = ld_pair(prow + 8 * ROWS + 16 * jj);
    pa[jj][2] = ld_pair(prow + 16 * jj + 8);
    pa[jj][3] = ld_pair(prow + 8 * ROWS + 16 * jj + 8);
  }
  mbar_wait(&bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint64_t dv = desc_mnmajor(sV, VHALF);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < ROWS / 16; ++jj)
    wgmma_rs<N, 1, T>(d, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<N>(d, out);
}

__global__ void __launch_bounds__(128) cp_async_tile_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b, int64_t ss,
    int S, int a_row0, const __nv_bfloat16* __restrict__ p, float* out_s, float* out_o) {
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + 2 * HALF;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 128);
    mbar_fence_init();
  }
  zero_cols_past<100>(sA, threadIdx.x, 128);
  zero_cols_past<100>(sB, threadIdx.x, 128);
  fence_proxy_async();
  __syncthreads();
  cp_async_rows<100>(sA, a, ss, 0, S, threadIdx.x);
  cp_async_rows<100>(sB, b, ss, 0, S, threadIdx.x);
  cp_async_arrive_noinc(&bar);
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
  fence_proxy_async();
  float d[64];
  const uint64_t da = desc_kmajor(sA + 128 * a_row0), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 7; ++kk) {
    const uint64_t off = ((kk / 4) * HALF + (kk % 4) * 32) >> 4;
    wgmma_m64n128k16_ss<0, 0>(d, da + off, db + off, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<128>(d, out_s);
  float o[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) o[i] = 0.f;
  const uint64_t dv = desc_mnmajor(sB, HALF);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    wgmma_rs<104, 1>(o, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  store_acc<104>(o, out_o);
}

__global__ void __launch_bounds__(128) cp_async_tile64_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ c, int64_t ss, int S, int row0, int a_row0,
    const __nv_bfloat16* __restrict__ p, float* out_s, float* out_o) {
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + 2 * HALF;
  unsigned char* sC = sB + 2 * HALF64;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 128);
    mbar_fence_init();
  }
  zero_cols_past<100>(sA, threadIdx.x, 128);
  zero_cols_past<100, 64>(sB, threadIdx.x, 128);
  zero_cols_past<100, 64>(sC, threadIdx.x, 128);
  fence_proxy_async();
  __syncthreads();
  cp_async_rows<100>(sA, a, ss, 0, S, threadIdx.x);
  cp_async_rows<100, 64>(sB, b, ss, row0, S, threadIdx.x, sC, c, ss);
  cp_async_arrive_noinc(&bar);
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
  fence_proxy_async();
  float d[32];
  const uint64_t da = desc_kmajor(sA + 128 * a_row0), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 7; ++kk)
    wgmma_m64n64k16_ss<0, 0>(d, da + (((kk / 4) * HALF + (kk % 4) * 32) >> 4),
                             db + (((kk / 4) * HALF64 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<64>(d, out_s);
  float o[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) o[i] = 0.f;
  const uint64_t dc = desc_mnmajor(sC, HALF64);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    wgmma_rs<104, 1>(o, pa[jj], dc + ((jj * 16 * 128) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  store_acc<104>(o, out_o);
}

// P [64, 128] (fp16) times V [128, 64] (fp16, one 128-row box): m64n64k16 RS
__global__ void __launch_bounds__(128) wgmma_rs64_f16_kernel(
    const __half* __restrict__ p, const __grid_constant__ CUtensorMap map_v, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sV = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, HALF);
    tma_load_4d(sV, &map_v, &bar, 0, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t pa[8][4];
  const __half* prow = p + (16 * warp + g) * 128 + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    pa[jj][0] = ld_pair(prow + 16 * jj);
    pa[jj][1] = ld_pair(prow + 8 * 128 + 16 * jj);
    pa[jj][2] = ld_pair(prow + 16 * jj + 8);
    pa[jj][3] = ld_pair(prow + 8 * 128 + 16 * jj + 8);
  }
  mbar_wait(&bar, 0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint64_t dv = desc_mnmajor(sV, HALF);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) wgmma_m64n64k16_rs<1, __half>(d, pa[jj], dv + jj * 128, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<64>(d, out);
}

// round(A B^T, fp16) C, A, B and C [64, 64] fp16 (one box each): the
// scores from SS m64n64k16, rounded in registers, then RS m64n64k16 over C
// as a 64-row MN-major B
__global__ void __launch_bounds__(128) wgmma_chain64_f16_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + HALF64;
  unsigned char* sC = sB + HALF64;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 3 * HALF64);
    tma_load_4d(sA, &map_a, &bar, 0, 0, 0, 0);
    tma_load_4d(sB, &map_b, &bar, 0, 0, 0, 0);
    tma_load_4d(sC, &map_c, &bar, 0, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  float sc[32], d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint64_t da = desc_kmajor(sA), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<0, 0, __half>(sc, da + 2 * kk, db + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  uint32_t pa[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[s][i] = pack_t<__half>(sc[8 * s + 2 * i], sc[8 * s + 2 * i + 1]);
  const uint64_t dc = desc_mnmajor(sC, HALF64);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) wgmma_m64n64k16_rs<1, __half>(d, pa[k4], dc + k4 * 128, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<64>(d, out);
}

// rows [a_row0, a_row0 + 64) of A [AROWS, 256] times B^T, B [64, 256]:
// each row four 64-column boxes, A's AROWS * 128 bytes apart (16 KB for 128
// rows, 8 KB for 64) and B's 8 KB; T bf16 or fp16
template <int AROWS, typename T>
__global__ void __launch_bounds__(128) wgmma_ss256_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    int a_row0, float* out) {
  constexpr int ABOX = AROWS * 128;
  extern __shared__ unsigned char raw[];
  unsigned char* sA = aligned_smem(raw);
  unsigned char* sB = sA + 4 * ABOX;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 4 * ABOX + 4 * HALF64);
    for (int c = 0; c < 4; ++c) {
      tma_load_4d(sA + ABOX * c, &map_a, &bar, 64 * c, 0, 0, 0);
      tma_load_4d(sB + HALF64 * c, &map_b, &bar, 64 * c, 0, 0, 0);
    }
  }
  mbar_wait(&bar, 0);
  float d[32];
  const uint64_t da = desc_kmajor(sA + 128 * a_row0), db = desc_kmajor(sB);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_m64n64k16_ss<0, 0, T>(d, da + (((kk / 4) * ABOX + (kk % 4) * 32) >> 4),
                                db + (((kk / 4) * HALF64 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  store_acc<64>(d, out);
}

// P [64, 64] times V [64, 256], V four 64-row MN-major boxes 8 KB apart:
// two RS m64n128k16 products over its column halves, 16 KB apart; T bf16 or
// fp16
template <typename T>
__global__ void __launch_bounds__(128) wgmma_rs256_kernel(
    const T* __restrict__ p, const __grid_constant__ CUtensorMap map_v, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sV = aligned_smem(raw);
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 4 * HALF64);
    for (int c = 0; c < 4; ++c) tma_load_4d(sV + HALF64 * c, &map_v, &bar, 64 * c, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint32_t pa[4][4];
  const T* prow = p + (16 * warp + g) * 64 + 2 * t;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    pa[jj][0] = ld_pair(prow + 16 * jj);
    pa[jj][1] = ld_pair(prow + 8 * 64 + 16 * jj);
    pa[jj][2] = ld_pair(prow + 16 * jj + 8);
    pa[jj][3] = ld_pair(prow + 8 * 64 + 16 * jj + 8);
  }
  mbar_wait(&bar, 0);
  float d[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[0][i] = d[1][i] = 0.f;
  const uint64_t dv = desc_mnmajor(sV, HALF64);
  fence_regs(d[0]);
  fence_regs(d[1]);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    wgmma_m64n128k16_rs<1, T>(d[0], pa[jj], dv + ((jj * 2048) >> 4), 1);
    wgmma_m64n128k16_rs<1, T>(d[1], pa[jj], dv + ((2 * HALF64 + jj * 2048) >> 4), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d[0]);
  fence_regs(d[1]);
  // the two halves as columns 0-127 and 128-255 of a row-major [64, 256]
  const int row = 16 * warp + g;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(row + 8 * (e >> 1)) * 256 + 128 * hf + 8 * j + 2 * t + (e & 1)] = d[hf][4 * j + e];
}

// the map type of T (bf16 or fp16)
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// P [64, rows] times V [rows, N] (rows 64 or 128; T bf16 or fp16) through
// wgmma_rs_n_kernel
template <typename T, int N>
int wgmma_rs_n(const void* p, const void* v, int rows, void* out, void* stream) {
  const int64_t dims[4] = {N, rows, 1, 1};
  const int64_t strides[3] = {N, N * (int64_t)rows, N * (int64_t)rows};
  CUtensorMap map_v;
  if ((rows != 64 && rows != 128) ||
      !make_map_4d(&map_v, map_type<T>(), v, dims, strides, rows))
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * rows * 128 + 1024;
  auto kernel = rows == 64 ? wgmma_rs_n_kernel<T, N, 64> : wgmma_rs_n_kernel<T, N, 128>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, (cudaStream_t)stream>>>((const T*)p, map_v, (float*)out);
  return (int)cudaGetLastError();
}

// a rows x 128 contiguous bf16 (or `type`) matrix as a 4-D map of 64-column
// boxes
bool matrix_map(CUtensorMap* map, const void* base, int64_t rows, uint32_t box_rows,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const int64_t dims[4] = {128, rows, 1, 1};
  const int64_t strides[3] = {128, 128 * rows, 128 * rows};
  return make_map_4d(map, type, base, dims, strides, box_rows);
}

bool square_map(CUtensorMap* map, const void* base, uint32_t box_rows,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  return matrix_map(map, base, 128, box_rows, type);
}

template <typename T>
int wgmma_ss(const void* a, const void* b, int a_row0, void* out, void* stream) {
  CUtensorMap map_a, map_b;
  if ((a_row0 != 0 && a_row0 != 64) || !square_map(&map_a, a, 128, map_type<T>()) ||
      !square_map(&map_b, b, 128, map_type<T>()))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * HALF + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss_kernel<T><<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                            (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int wgmma_ss64(const void* a, const void* b, int a_row0, void* out, void* stream) {
  CUtensorMap map_a, map_b;
  if ((a_row0 != 0 && a_row0 != 64) || !square_map(&map_a, a, 128, map_type<T>()) ||
      !matrix_map(&map_b, b, 64, 64, map_type<T>()))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 2 * HALF64 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss64_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss64_kernel<T><<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                              (float*)out);
  return (int)cudaGetLastError();
}

// A [128, W] and B [64, W] (T, contiguous, W 96 or 80) through maps W wide,
// two 64-column boxes a row, into wgmma_ss64_kernel<T, W>
template <typename T, int W>
int wgmma_ss64_wide(const void* a, const void* b, int a_row0, void* out, void* stream) {
  const int64_t dims_a[4] = {W, 128, 1, 1}, dims_b[4] = {W, 64, 1, 1};
  const int64_t strides_a[3] = {W, W * 128, W * 128}, strides_b[3] = {W, W * 64, W * 64};
  CUtensorMap map_a, map_b;
  if ((a_row0 != 0 && a_row0 != 64) ||
      !make_map_4d(&map_a, map_type<T>(), a, dims_a, strides_a, 128) ||
      !make_map_4d(&map_b, map_type<T>(), b, dims_b, strides_b, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 2 * HALF64 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss64_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss64_kernel<T, W><<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                                 (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int wgmma_rs(const void* p, const void* v, void* out, void* stream) {
  CUtensorMap map_v;
  if (!square_map(&map_v, v, 128, map_type<T>())) return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 1024;
  wgmma_rs_kernel<T><<<1, 128, smem, (cudaStream_t)stream>>>((const T*)p, map_v,
                                                            (float*)out);
  return (int)cudaGetLastError();
}

// A [AROWS, 256] and B [64, 256] (T, contiguous) through their maps into
// wgmma_ss256_kernel<AROWS, T>
template <int AROWS, typename T>
int wgmma_ss256(const void* a, const void* b, int a_row0, void* out, void* stream) {
  const int64_t dims_a[4] = {256, AROWS, 1, 1}, dims_b[4] = {256, 64, 1, 1};
  const int64_t strides_a[3] = {256, 256 * AROWS, 256 * AROWS};
  const int64_t strides_b[3] = {256, 256 * 64, 256 * 64};
  CUtensorMap map_a, map_b;
  if (!make_map_4d(&map_a, map_type<T>(), a, dims_a, strides_a, AROWS) ||
      !make_map_4d(&map_b, map_type<T>(), b, dims_b, strides_b, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * AROWS * 128 + 4 * HALF64 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_ss256_kernel<AROWS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_ss256_kernel<AROWS, T><<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, a_row0,
                                                                      (float*)out);
  return (int)cudaGetLastError();
}

// P [64, 64] and V [64, 256] (T, contiguous) into wgmma_rs256_kernel<T>
template <typename T>
int wgmma_rs256(const void* p, const void* v, void* out, void* stream) {
  const int64_t dims[4] = {256, 64, 1, 1};
  const int64_t strides[3] = {256, 256 * 64, 256 * 64};
  CUtensorMap map_v;
  if (!make_map_4d(&map_v, map_type<T>(), v, dims, strides, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * HALF64 + 1024;
  wgmma_rs256_kernel<T><<<1, 128, smem, (cudaStream_t)stream>>>((const T*)p, map_v,
                                                               (float*)out);
  return (int)cudaGetLastError();
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
  if (rows < 1 || rows > 256 ||
      !make_map_4d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, dims, strides, rows))
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
  return wgmma_ss<__nv_bfloat16>(a, b, a_row0, out, stream);
}

// the same in fp16: the f16 form of the instruction over FLOAT16 maps
extern "C" int hopper_wgmma_ss_f16(const void* a, const void* b, int a_row0, void* out,
                                   void* stream) {
  return wgmma_ss<__half>(a, b, a_row0, out, stream);
}

// p: [64, 128], v: [128, 128] bf16 contiguous; out: [64, 128] fp32 = p @ v
extern "C" int hopper_wgmma_rs(const void* p, const void* v, void* out, void* stream) {
  return wgmma_rs<__nv_bfloat16>(p, v, out, stream);
}

// the same in fp16
extern "C" int hopper_wgmma_rs_f16(const void* p, const void* v, void* out, void* stream) {
  return wgmma_rs<__half>(p, v, out, stream);
}

// a: [128, 128], b: [64, 128] bf16 contiguous; out: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T
extern "C" int hopper_wgmma_ss64(const void* a, const void* b, int a_row0, void* out,
                                 void* stream) {
  return wgmma_ss64<__nv_bfloat16>(a, b, a_row0, out, stream);
}

// the same in fp16: the f16 form of the m64n64k16 instruction over FLOAT16 maps
extern "C" int hopper_wgmma_ss64_f16(const void* a, const void* b, int a_row0, void* out,
                                     void* stream) {
  return wgmma_ss64<__half>(a, b, a_row0, out, stream);
}

// a: [128, 96], b: [64, 96] fp16 contiguous; out: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T: the f16 m64n64k16 SS form over 96-wide
// FLOAT16 maps, as the fp16 D = 96 backward kernels' score products
extern "C" int hopper_wgmma_ss96_f16(const void* a, const void* b, int a_row0, void* out,
                                     void* stream) {
  return wgmma_ss64_wide<__half, 96>(a, b, a_row0, out, stream);
}

// a: [128, 80], b: [64, 80] fp16 contiguous; out: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T: the f16 m64n64k16 SS form over 80-wide
// FLOAT16 maps (5 k-steps), as the fp16 D = 80 backward kernels' score
// products
extern "C" int hopper_wgmma_ss80_f16(const void* a, const void* b, int a_row0, void* out,
                                     void* stream) {
  return wgmma_ss64_wide<__half, 80>(a, b, a_row0, out, stream);
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

// p: [64, rows], v: [rows, 96] bf16 contiguous, rows 64 or 128; out: [64, 96]
// fp32 = p @ v
extern "C" int hopper_wgmma_rs96(const void* p, const void* v, int rows, void* out,
                                 void* stream) {
  return wgmma_rs_n<__nv_bfloat16, 96>(p, v, rows, out, stream);
}

// the same with v [rows, 80] and out [64, 80]: m64n80k16
extern "C" int hopper_wgmma_rs80(const void* p, const void* v, int rows, void* out,
                                 void* stream) {
  return wgmma_rs_n<__nv_bfloat16, 80>(p, v, rows, out, stream);
}

// the same with v [rows, 104] and out [64, 104]: m64n104k16
extern "C" int hopper_wgmma_rs104(const void* p, const void* v, int rows, void* out,
                                  void* stream) {
  return wgmma_rs_n<__nv_bfloat16, 104>(p, v, rows, out, stream);
}

// the same in fp16 with v [rows, 80] and out [64, 80]: m64n80k16's f16 form,
// the fp16 D = 80 forward's P V
extern "C" int hopper_wgmma_rs80_f16(const void* p, const void* v, int rows, void* out,
                                     void* stream) {
  return wgmma_rs_n<__half, 80>(p, v, rows, out, stream);
}

// the same in fp16 with v [rows, 96] and out [64, 96]: m64n96k16's f16 form,
// the fp16 D = 96 forward's P V
extern "C" int hopper_wgmma_rs96_f16(const void* p, const void* v, int rows, void* out,
                                     void* stream) {
  return wgmma_rs_n<__half, 96>(p, v, rows, out, stream);
}

// the same in fp16 with v [rows, 104] and out [64, 104]: m64n104k16's f16
// form, the fp16 D = 100 forward's P V
extern "C" int hopper_wgmma_rs104_f16(const void* p, const void* v, int rows, void* out,
                                      void* stream) {
  return wgmma_rs_n<__half, 104>(p, v, rows, out, stream);
}

// a, b: S rows of 100 bf16 (S <= 128) at row stride ss elements, base and
// ss 8-byte aligned; p: [64, 128] bf16 contiguous. out_s: [64, 128] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T, out_o: [64, 104] fp32 = p @ b (b's rows
// past S and its columns 100-103 read as zeros)
extern "C" int hopper_cp_async_tile(const void* a, const void* b, int64_t ss, int S,
                                    int a_row0, const void* p, void* out_s, void* out_o,
                                    void* stream) {
  if (S < 1 || S > 128 || (a_row0 != 0 && a_row0 != 64)) return (int)cudaErrorInvalidValue;
  const void* ptrs[2] = {a, b};
  if (!rows_aligned(ptrs, 2, &ss, 1, 100, 8)) return (int)cudaErrorInvalidValue;
  constexpr int smem = 4 * HALF + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      cp_async_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cp_async_tile_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, ss, S, a_row0,
      (const __nv_bfloat16*)p, (float*)out_s, (float*)out_o);
  return (int)cudaGetLastError();
}

// a, b, c: S rows of 100 bf16 (S <= 128) at row stride ss elements, bases
// and ss 8-byte aligned; p: [64, 64] bf16 contiguous. out_s: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b[row0 : row0 + 64]^T, out_o: [64, 104] fp32 = p
// @ c[row0 : row0 + 64] (rows past S and c's columns 100-103 read as zeros)
extern "C" int hopper_cp_async_tile64(const void* a, const void* b, const void* c, int64_t ss,
                                      int S, int row0, int a_row0, const void* p,
                                      void* out_s, void* out_o, void* stream) {
  if (S < 1 || S > 128 || (row0 != 0 && row0 != 64) || (a_row0 != 0 && a_row0 != 64))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {a, b, c};
  if (!rows_aligned(ptrs, 3, &ss, 1, 100, 8)) return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * HALF + 4 * HALF64 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      cp_async_tile64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cp_async_tile64_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const __nv_bfloat16*)c, ss, S, row0,
      a_row0, (const __nv_bfloat16*)p, (float*)out_s, (float*)out_o);
  return (int)cudaGetLastError();
}


// p: [64, 128], v: [128, 64] fp16 contiguous; out: [64, 64] fp32 = p @ v
extern "C" int hopper_wgmma_rs64_f16(const void* p, const void* v, void* out, void* stream) {
  const int64_t dims[4] = {64, 128, 1, 1};
  const int64_t strides[3] = {64, 64 * 128, 64 * 128};
  CUtensorMap map_v;
  if (!make_map_4d(&map_v, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, v, dims, strides, 128))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = HALF + 1024;
  wgmma_rs64_f16_kernel<<<1, 128, smem, (cudaStream_t)stream>>>((const __half*)p, map_v,
                                                               (float*)out);
  return (int)cudaGetLastError();
}

// a, b, c: [64, 64] fp16 contiguous; out: [64, 64] fp32 = fp16(a @ b^T) @ c
extern "C" int hopper_wgmma_chain64_f16(const void* a, const void* b, const void* c,
                                        void* out, void* stream) {
  const int64_t dims[4] = {64, 64, 1, 1};
  const int64_t strides[3] = {64, 64 * 64, 64 * 64};
  CUtensorMap map_a, map_b, map_c;
  if (!make_map_4d(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a, dims, strides, 64) ||
      !make_map_4d(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, b, dims, strides, 64) ||
      !make_map_4d(&map_c, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, c, dims, strides, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 3 * HALF64 + 1024;
  wgmma_chain64_f16_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(map_a, map_b, map_c,
                                                                  (float*)out);
  return (int)cudaGetLastError();
}

// a: [128, 256], b: [64, 256] bf16 contiguous; out: [64, 64] fp32 =
// a[a_row0 : a_row0 + 64] @ b^T
extern "C" int hopper_wgmma_ss256(const void* a, const void* b, int a_row0, void* out,
                                  void* stream) {
  if (a_row0 != 0 && a_row0 != 64) return (int)cudaErrorInvalidValue;
  return wgmma_ss256<128, __nv_bfloat16>(a, b, a_row0, out, stream);
}

// a: [64, 256], b: [64, 256] bf16 contiguous; out: [64, 64] fp32 = a @ b^T
extern "C" int hopper_wgmma_ss256_a64(const void* a, const void* b, void* out,
                                      void* stream) {
  return wgmma_ss256<64, __nv_bfloat16>(a, b, 0, out, stream);
}

// the same in fp16: the .f16 SS m64n64k16 form over FLOAT16 maps, as the
// fp16 head-dim-256 backward kernels' `scores256`
extern "C" int hopper_wgmma_ss256_a64_f16(const void* a, const void* b, void* out,
                                          void* stream) {
  return wgmma_ss256<64, __half>(a, b, 0, out, stream);
}

// p: [64, 64], v: [64, 256] bf16 contiguous; out: [64, 256] fp32 = p @ v
extern "C" int hopper_wgmma_rs256(const void* p, const void* v, void* out, void* stream) {
  return wgmma_rs256<__nv_bfloat16>(p, v, out, stream);
}

// the same in fp16: the .f16 RS m64n128k16 form over a FLOAT16 map, as the
// fp16 head-dim-256 backward kernels' `sum256`
extern "C" int hopper_wgmma_rs256_f16(const void* p, const void* v, void* out,
                                      void* stream) {
  return wgmma_rs256<__half>(p, v, out, stream);
}
