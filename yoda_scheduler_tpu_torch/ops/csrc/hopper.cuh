// Hopper (sm_90a) primitives shared by the flash attention kernels: mbarriers,
// TMA tiled loads and their tensor maps, wgmma shared-memory descriptors for
// the 128-byte swizzle, the wgmma fences and groups, setmaxnreg, and the bf16
// wgmma m64n128k16 in its SS (both operands in shared memory) and RS (A in
// registers) forms and m64n64k16 in its SS form.
//
// The layout they assume. A tile row of 64 bf16 (128 bytes) is one line of
// the 128-byte swizzle: TMA with CU_TENSOR_MAP_SWIZZLE_128B stores the 16-byte
// chunk c of row r at chunk c ^ (r % 8), in atoms of 8 rows (1024 bytes) that
// start on a 1024-byte boundary. A 128-wide row (head_dim 128) therefore
// arrives as two boxes of 64 columns, each a "half" of its own; the halves of
// one tile of R rows lie R * 128 bytes apart (16 KB for 128 rows, 8 KB for 64).
//
// tests/test_torch_cuda.py holds these pieces against torch on the card
// (csrc/hopper_check.cu: one TMA tile against a slice copy, SS and RS
// products of 128- and 64-row tiles against torch.matmul). ops/_build.py
// hashes every .cuh in csrc/ into each kernel's library name.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; only the header
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A barrier starts in
// phase 0, so waiting on parity 1 passes at once. There is no time limit: a
// trap on the wait's path makes ptxas ignore setmaxnreg and give the
// consumers no more registers than the launch gives every thread (168 at
// 384 threads), which spilled the dK/dV kernel's sums on an H100
// (PERF.md). Run a kernel under a new layout under `timeout`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  while (!mbar_try_wait(a, parity)) {
  }
}

// the block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atoms); launches add 1024 bytes of slack for it
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// --------------------------------------------------------------------- TMA
// One box of the 4-D map into shared memory at `dst` (1024-byte aligned for
// the 128-byte swizzle); completion counts its bytes on `bar`. Coordinates
// are in elements, innermost first; a box past the tensor's edge reads zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------- wgmma smem descriptors
// bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45 stride
// byte offset >> 4, 62-63 layout (1 = 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}

__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_field(smem_u32(tile)) | (desc_field(lbo) << 16) |
         (desc_field(sbo) << 32) | (1ull << 62);
}

// K-major operand (its contraction dim contiguous): rows of M or N are
// 128-byte lines of 64 k values, 8-row groups 1024 bytes apart (SBO); LBO is
// unused. A k-step of 16 within the line adds 32 bytes to the start address
// (desc + 2); k values 64-127 are in the next half.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return desc_sw128(tile, 16, 1024);
}

// MN-major operand (its M or N dim contiguous): each 128-byte line holds 64
// M/N values of one k; 8-line groups of k are 1024 bytes apart (SBO) and the
// next 64 M/N values lie `mn_half_bytes` further on (LBO: the half stride of
// the tile, 16 KB for 128 k rows, 8 KB for 64). A k-step of 16 adds 2048
// bytes (desc + 128).
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile,
                                                 uint32_t mn_half_bytes) {
  return desc_sw128(tile, mn_half_bytes, 1024);
}

// ------------------------------------------------------ wgmma and friends
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma's issue or its wait: put it on both sides of each group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

#define HOPPER_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_D64_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 operands, fp32 sums, both
// from shared memory. The fp32 accumulator of thread i of the warpgroup
// (warp w = i / 32, g = lane / 4, t = lane % 4): d[4 j + e] is row 16 w + g +
// 8 (e / 2), column 8 j + 2 t + (e % 2). TA/TB = 1 marks an MN-major operand.
// scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_D64_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with A from registers: a[0..3] hold, as bf16 pairs (low half the
// lower column), rows 16 w + g and 16 w + g + 8 at columns 2 t, 2 t + 1 and
// at 2 t + 8, 2 t + 9, in the order (g, 2t) (g+8, 2t) (g, 2t+8) (g+8, 2t+8).
// That is the accumulator layout above, so the columns 16 s .. 16 s + 15 of
// an m64n128 accumulator, rounded to bf16, are A's k-step s.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

#define HOPPER_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D32_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory: the
// m64n128 form's layout with columns 0-63, so d[4 j + e] is row 16 w + g + 8
// (e / 2), column 8 j + 2 t + (e % 2) for j < 8, and columns 16 s .. 16 s + 15,
// rounded to bf16, are the RS form's A for k-step s (a[0..3] = d[8 s ..
// 8 s + 7] in pairs).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_D32_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef HOPPER_D64
#undef HOPPER_D64_OPS
#undef HOPPER_D32
#undef HOPPER_D32_OPS

// --------------------------------------------------------- host: tensor maps
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no link against libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A map over a bf16 tensor of dims[4] (innermost first; dim 0 contiguous) with
// element strides strides[3] for dims 1-3, read in boxes of 64 x box_rows x 1 x
// 1 with the 128-byte swizzle and zeros past the edges. The stride of a dim
// of size 1 is never used, and any value is replaced by a valid one. False if
// the driver refuses (a base not 16-byte aligned, a stride not a multiple of
// 8 elements).
inline bool make_map_bf16_4d(CUtensorMap* map, const void* base,
                             const int64_t* dims, const int64_t* strides,
                             uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  for (int i = 0; i < 4; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dense = (i == 0 ? gdim[0] * 2 : gstride[i - 1] * gdim[i]);
    gstride[i] = dims[i + 1] == 1 ? dense : (cuuint64_t)strides[i] * 2;
  }
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
