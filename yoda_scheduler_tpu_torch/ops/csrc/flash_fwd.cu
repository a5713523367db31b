// Flash attention forward for Hopper (sm_90a): O and the per-row log-sum-exp.
//
// Replaces yoda_scheduler_tpu/ops/attention.py:_flash_kernel (the Pallas TPU
// kernel launched by _flash_forward). It computes the same function:
//   O   = softmax(Q K^T / sqrt(d) + causal/window mask) V
//   LSE = m + log(l)  (fp32, natural log)
// with an fp32 online softmax, q aligned to the end of a longer kv
// (kv_offset = Sk - Sq), GQA by index (q head h reads kv head h / (H/KvH),
// no repeated K/V), and the same -1e30 mask and 1e-30 clamp on l.
//
// What bounds it on an H100: at the main path's shape (B=1, H=32, S=2048,
// D=128, causal, bf16) the work is ~34.4 GFLOP against ~67 MB of traffic,
// so it is bound by operations (~35 us at the 989 TF/s bf16 tensor-core peak;
// the bytes alone would take ~20 us at 3.35 TB/s).
//
// Design. The Pallas kernel keeps a whole K/V sequence in VMEM per program;
// that does not fit in 227 KB of shared memory, so here one thread block
// owns a 64-row q tile of one (batch, head) and streams 64-key K/V tiles
// through shared memory. Causal tiles stop at the diagonal and windowed
// tiles start at the window's first tile, as in the Pallas loop bounds;
// ragged q and k tails are masked in the kernel, so every shape runs here.
// Two kernels share that plan:
// - flash_fwd_mma_kernel (bf16, the main path): 4 warps, each owning 16 q
//   rows, run both products on the tensor cores with mma.sync m16n8k16
//   (bf16 operands, fp32 sums). Scores, probabilities and the output sum
//   stay in registers; P is rounded to bf16 for P.V as the plain version
//   rounds its probabilities. The tensor cores take bf16 operands, so the
//   1/sqrt(d) scale is applied to the fp32 scores rather than to Q (which
//   would round Q a second time). A warp skips the tiles that are masked
//   for all of its rows.
// - flash_fwd_simt_kernel (fp32, and bf16 rows not 16-byte aligned): scalar
//   fp32 FMAs from shared memory with Q pre-scaled in fp32 as in the Pallas
//   kernel; 256 threads as a 16 x 16 grid, each owning 4 q rows.
// Neither uses wgmma, TMA or a pipeline of K/V tiles yet.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int BKP = BK + 4;   // padded P row: the two half-warps hit other banks
constexpr int NT = 256;       // threads per block of the SIMT kernel (16 x 16)

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    int H, int KvH, int Sq, int Sk,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int causal, int window, float scale) {
  constexpr int DP = D + 1;     // padded Q/K row: column reads are conflict-free
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP], pre-scaled by 1/sqrt(d)
  float* sK = sQ + BQ * DP;     // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][D]
  float* sP = sV + BK * D;      // [BQ][BKP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's rows: 4*ty .. 4*ty+3
  const int tx = tid & 15;      // this thread's score columns: tx + 16*j
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + kvh * k_sh;
  const T* vp = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f32(qp[(int64_t)(q0 + r) * q_ss + c]) * scale;
    sQ[r * DP + c] = x;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  int first_tile = 0;
  if (causal) {
    // keys past the tile's last row are masked for every row: stop there
    const int last_key = kv_offset + min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_key / BK + 1);
    if (window > 0) {
      // keys before the tile's first row's window are masked for every row
      const int first_key = kv_offset + q0 - (window - 1);
      first_tile = max(first_key, 0) / BK;
    }
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = first_tile; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's reads of sK/sV/sP are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk) {
        kx = to_f32(kp[(int64_t)(k0 + r) * k_ss + c]);
        vx = to_f32(vp[(int64_t)(k0 + r) * v_ss + c]);
      }
      sK[r * DP + c] = kx;
      sV[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = kv_offset + q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        bool ok = key < Sk;
        if (causal) {
          ok = ok && key <= qpos;
          if (window > 0) ok = ok && key > qpos - window;
        }
        if (!ok) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a half-warp hold one row between them
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(4 * ty + i) * BKP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * ty + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 16 * c, acc[i][c] / lc);
    if (tx == 0) lse[(int64_t)bh * Sq + row] = m[i] + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_MMA) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int KvH, int Sq, int Sk,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int causal, int window, float scale) {
  constexpr int DS = D + 8;     // padded smem row: fragment reads are conflict-free
  constexpr int KS = D / 16;    // k-steps of Q.K^T
  constexpr int NO = D / 8;     // n-tiles of the output
  constexpr int NS = BK / 8;    // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DS]
  __nv_bfloat16* sK = sQ + BQ * DS;                                  // [BK][DS]
  __nv_bfloat16* sV = sK + BK * DS;                                  // [BK][DS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;
  const __nv_bfloat16* kp = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + kvh * v_sh;

  load_tile<D>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  __syncthreads();
  // this warp's 16 rows of Q as A fragments, for the whole loop
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a<DS>(qf[kk], sQ + 16 * warp * DS, kk, g, t4);

  int n_tiles = (Sk + BK - 1) / BK;
  int first_tile = 0;
  if (causal) {
    const int last_key = kv_offset + min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_key / BK + 1);
    if (window > 0) first_tile = max(kv_offset + q0 - (window - 1), 0) / BK;
  }
  // this warp's query positions; a warp wholly past Sq computes nothing
  const int w_row0 = q0 + 16 * warp;
  const bool w_live = w_row0 < Sq;
  const int w_first = kv_offset + w_row0;
  const int w_last = kv_offset + min(w_row0 + 15, Sq - 1);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the last tile
    load_tile<D>(sK, kp, k_ss, k0, Sk);
    load_tile<D>(sV, vp, v_ss, k0, Sk);
    __syncthreads();
    // tiles masked for every row of this warp contribute nothing
    if (!w_live) continue;
    if (causal && (k0 > w_last || (window > 0 && k0 + BK - 1 <= w_first - window)))
      continue;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = sK + (8 * n + g) * DS + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[n], qf[kk], ld_pair(kr + 16 * kk), ld_pair(kr + 16 * kk + 8));
    }

    const bool need_mask =
        k0 + BK > Sk ||
        (causal && (k0 + BK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (need_mask) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qpos = w_first + g + (e >> 1) * 8;
          bool ok = key < Sk;
          if (causal) {
            ok = ok && key <= qpos;
            if (window > 0) ok = ok && key > qpos - window;
          }
          if (!ok) s[n][e] = NEG;
        }
      }
    }

    // online softmax: row g in elements 0-1, row g+8 in 2-3; a row's 64
    // scores sit in the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = expf(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = expf(s[n][2 * r + 1] - m_new);
        rs += s[n][2 * r] + s[n][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are the A
    // fragment of key step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = sV + (16 * j + 2 * t4) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vc = vr + 8 * n;
        mma_bf16(acc[n], pa, pack_raw(vc[0], vc[DS]),
                 pack_raw(vc[8 * DS], vc[9 * DS]));
      }
    }
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row0 + g + 8 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + ((int64_t)bh * Sq + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
    if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] + logf(lc);
  }
}

// ---- host entry
template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int KvH, int Sq, int Sk,
                        const int64_t* st, int causal, int window, float scale,
                        cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * BKP);
  auto kernel = flash_fwd_simt_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, KvH, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int KvH, int Sq, int Sk,
                       const int64_t* st, int causal, int window, float scale,
                       cudaStream_t stream) {
  const int smem = (int)sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (D + 8);
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT_MMA, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, H, KvH, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, void* lse, int B, int H, int KvH, int Sq, int Sk,
                     const int64_t* st, int causal, int window, float scale,
                     cudaStream_t stream) {
#define FLASH_ARGS q, k, v, o, lse, B, H, KvH, Sq, Sk, st, causal, window, scale, stream
  const void* ptrs[3] = {q, k, v};
  if (sizeof(T) == 2 && rows_aligned(ptrs, 3, st, 9)) {
    switch (D) {
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return launch_simt<T, 32>(FLASH_ARGS);
    case 64: return launch_simt<T, 64>(FLASH_ARGS);
    case 128: return launch_simt<T, 128>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

// q, k, v: [B, H|KvH, S, D] with the given (batch, head, seq) strides and a
// contiguous last dim; o: contiguous [B, H, Sq, D]; lse: contiguous fp32
// [B, H, Sq]. dtype 0 = fp32, 1 = bf16. window <= 0 means no window.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int device, int B, int H,
                         int KvH, int Sq, int Sk, int D,
                         int64_t q_sb, int64_t q_sh, int64_t q_ss,
                         int64_t k_sb, int64_t k_sh, int64_t k_ss,
                         int64_t v_sb, int64_t v_sh, int64_t v_ss,
                         int causal, int window, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: err = dispatch<float>(D, q, k, v, o, lse, B, H, KvH, Sq, Sk, st, causal, window, scale, s); break;
    case 1: err = dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KvH, Sq, Sk, st, causal, window, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
