// Flash attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the two Pallas TPU kernels of yoda_scheduler_tpu/ops/attention.py
// launched by _flash_backward: _flash_bwd_dq_kernel (flash_bwd_dq here) and
// _flash_bwd_dkv_kernel (flash_bwd_dkv here). They compute the same function:
//   P  = exp(Q K^T / sqrt(d) + mask - LSE)   (re-derived from the forward's LSE)
//   dP = dO V^T,  dS = P * (dP - delta) / sqrt(d)
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO
// with delta = rowsum(dO * O) - g_lse computed outside (plain torch, as it
// is plain XLA outside the Pallas kernels), the forward's -1e30 mask, q
// aligned to the end of a longer kv (kv_offset = Sk - Sq), and the window
// only with causal. Two kernels with no atomics, so the result is the same
// bits on every run. GQA: K/V are read through the group index (q head h
// reads kv head h / (H / KvH)), and dK/dV come out per q head, [B, H, Sk,
// D], to be group-summed outside as the JAX package does.
//
// What bounds them on an H100: at the main path's shape (B=1, H=32, S=2048,
// D=128, causal, bf16) dQ does 6 D flops per visible (query, key) pair and
// dK/dV 8 D, about 52 and 69 GFLOP against under 100 MB of traffic each, so
// both are bound by operations (~52 and ~70 us at the 989 TF/s bf16 peak).
//
// Design. The Pallas programs hold a whole K/V (or Q/dO/LSE/delta) sequence
// in VMEM; here a block owns a tile of one side and streams tiles of the
// other side through shared memory, with the Pallas loop bounds (dQ: stop at
// the diagonal, start at the window's first tile; dK/dV: start at the first
// q tile crossing the diagonal, stop at the window's last). Ragged q and k
// tails are masked in the kernel. Three routes; the caller names one
// (ops/attention.py:_route picks it from dtype, head_dim and alignment):
// - *_wgmma kernels (route 2; bf16, D = 128, 16-byte aligned rows: the main
//   path): TMA-fed and warp-specialised on wgmma, as flash_fwd.cu's wgmma
//   kernel. Below.
// - *_mma kernels (route 1; aligned bf16, the route of D = 32 and 64; they
//   take D = 128 too, to be held against the wgmma kernels): 4 warps each
//   own 16 rows of a 64-row tile and run all products on the tensor cores
//   with mma.sync m16n8k16, 16 streamed rows at a time, skipping 16-row
//   steps masked for all of their rows; the streamed tiles are copied
//   through registers with no pipeline. The dK/dV kernel computes S^T = K
//   Q^T directly, so its accumulator tiles are already the A operands of
//   P^T dO and dS^T Q.
// - *_simt kernels (route 0; fp32, and bf16 rows not 16-byte aligned):
//   scalar fp32 FMAs from shared memory, 256 threads as a 16 x 16 grid, each
//   owning 4 rows of the block's tile.
// P and dS are rounded to bf16 as operands of the following products, where
// the plain version rounds them too.
//
// The wgmma kernels. Three warpgroups: warpgroup 0 is the producer (it gives
// up registers with setmaxnreg) and warpgroups 1 and 2 are consumers of 64
// rows each, so a block owns 128 rows of its side. The block's own tiles
// arrive once by TMA; the streamed tiles of 64 rows pass through a ring of
// W_STAGES (2) stages with a "full" and an "empty" mbarrier each. TMA reads
// the strided views through 4-D maps (head_dim, seq, heads, batch), so the
// model's transposed [B, S, H, D] views need no copy, and rows past the
// sequence arrive as zeros. Per streamed tile each consumer issues its two
// score products together (SS wgmma m64n64k16, both operands K-major), waits,
// forms P and dS in registers (exp2 of log2e-scaled scores with
// ex2.approx.ftz, as the forward; the mask only on diagonal, window-edge and
// ragged tiles), rounds them to bf16 as the A operands of the RS form (the
// accumulator's columns 16 s .. 16 s + 15 are A's k-step s), and adds the
// products into its fp32 sums with RS wgmma m64n128k16, the streamed tile an
// MN-major B operand (head_dim contiguous; halves 8 KB apart). The two steps
// are kept apart in time, as the forward's basic order, so the sums, the
// scores and the operands fit the consumers' 240 registers without spills.
// - flash_bwd_dkv_wgmma_kernel: a block is one (b, q head) and 128 keys;
//   K and V once, then Q and dO tiles of 64 rows with their LSE and delta.
//   S^T = K Q^T and dP^T = V dO^T; dV += P^T dO and dK += dS^T Q, both sums
//   (64 + 64 fp32 a thread) held across the q loop; dK scale and dV stored
//   once. LSE and delta (64 fp32 a tile each) are staged into the ring by
//   the producer's first warp with plain loads: (b H + h) Sq 4 bytes need
//   not be 16-byte aligned for a bulk copy. Rows past Sq read as zeros from
//   TMA, and are masked so that no LSE or delta beyond Sq reaches P or dS.
// - flash_bwd_dq_wgmma_kernel: a block is one (b, q head) and 128 q rows;
//   Q and dO once, LSE and delta of each thread's two rows in registers,
//   then K and V tiles of 64 keys. S = Q K^T and dP = dO V^T; dQ += dS K
//   with K as an MN-major B (the same tile that is S's K-major B); dQ scale
//   stored once.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int BKP = BK + 4;   // padded row of the P / dS tiles
constexpr int NT = 256;       // threads per block of the SIMT kernels (16 x 16)

struct Strides {              // (batch, head, seq) strides in elements
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(int key, int qpos, int Sk, int causal, int window) {
  bool ok = key < Sk;
  if (causal) {
    ok = ok && key <= qpos;
    if (window > 0) ok = ok && key > qpos - window;
  }
  return ok;
}

// the tiles of `bk` keys [first, last) that q rows [q0, q0 + rows) reach:
// the Pallas dQ kernel's bounds (attention.py:256-266)
__device__ __forceinline__ void key_tiles(int q0, int rows, int bk, int Sq, int Sk,
                                          int causal, int window, int& first, int& last) {
  const int kv_offset = Sk - Sq;
  last = (Sk + bk - 1) / bk;
  first = 0;
  if (causal) {
    last = min(last, (kv_offset + min(q0 + rows, Sq) - 1) / bk + 1);
    if (window > 0) first = max(kv_offset + q0 - (window - 1), 0) / bk;
  }
}

// the tiles of `bq` q rows [first, last) that keys [k0, k0 + keys) reach:
// the Pallas dK/dV kernel's bounds (attention.py:315-327)
__device__ __forceinline__ void q_tiles(int k0, int keys, int bq, int Sq, int Sk,
                                        int causal, int window, int& first, int& last) {
  const int kv_offset = Sk - Sq;
  last = (Sq + bq - 1) / bq;
  first = 0;
  if (causal) {
    first = max(floor_div(k0 - kv_offset, bq), 0);
    if (window > 0)
      last = min(max(floor_div(k0 + keys - 1 + (window - 1) - kv_offset, bq) + 1, first),
                 last);
  }
}

// ------------------------------------------------------------------ SIMT dQ
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    int H, int KvH, int Sq, int Sk, Strides st, int causal, int window, float scale) {
  constexpr int DP = D + 1;     // padded row: column reads are conflict-free
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sDO = sQ + BQ * DP;    // [BQ][DP]
  float* sK = sDO + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sS = sV + BK * DP;     // [BQ][BKP]: dS

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's rows: 4*ty .. 4*ty+3
  const int tx = tid & 15;      // this thread's key columns: tx + 16*j
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;
  const T* qp = q + b * st.q_sb + h * st.q_sh;
  const T* dp_ = dout + b * st.o_sb + h * st.o_sh;
  const T* kp = k + b * st.k_sb + kvh * st.k_sh;
  const T* vp = v + b * st.v_sb + kvh * st.v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f, y = 0.f;
    if (q0 + r < Sq) {
      x = to_f32(qp[(int64_t)(q0 + r) * st.q_ss + c]);
      y = to_f32(dp_[(int64_t)(q0 + r) * st.o_ss + c]);
    }
    sQ[r * DP + c] = x;
    sDO[r * DP + c] = y;
  }
  float lse_r[4], dlt_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dlt_r[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  int first_tile, n_tiles;
  key_tiles(q0, BQ, BK, Sq, Sk, causal, window, first_tile, n_tiles);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = first_tile; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's reads of sK/sV/sS are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk) {
        kx = to_f32(kp[(int64_t)(k0 + r) * st.k_ss + c]);
        vx = to_f32(vp[(int64_t)(k0 + r) * st.v_ss + c]);
      }
      sK[r * DP + c] = kx;
      sV[r * DP + c] = vx;
    }
    __syncthreads();

    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(4 * ty + i) * DP + d];
        ov[i] = sDO[(4 * ty + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * DP + d];
        vv[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dpv[i][j] = fmaf(ov[i], vv[j], dpv[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = kv_offset + q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float p = visible(key, qpos, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sS[(4 * ty + i) * BKP + tx + 16 * j] =
            round_as(p * (dpv[i][j] - dlt_r[i]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(4 * ty + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    T* out = dq + ((int64_t)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(out + tx + 16 * c, acc[i][c]);
  }
}

// --------------------------------------------------------------- SIMT dK/dV
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int KvH, int Sq, int Sk, Strides st, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][DP]
  float* sQ = sV + BK * DP;     // [BQ][DP]
  float* sDO = sQ + BQ * DP;    // [BQ][DP]
  float* sP = sDO + BQ * DP;    // [BK][BKP]: P^T
  float* sS = sP + BK * BKP;    // [BK][BKP]: dS^T
  float* sL = sS + BK * BKP;    // [BQ]: LSE
  float* sD = sL + BQ;          // [BQ]: delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's keys: 4*ty .. 4*ty+3
  const int tx = tid & 15;      // this thread's q columns: tx + 16*j
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.x * BK;  // low tiles have the most q tiles: first
  const int kv_offset = Sk - Sq;
  const T* qp = q + b * st.q_sb + h * st.q_sh;
  const T* dp_ = dout + b * st.o_sb + h * st.o_sh;
  const T* kp = k + b * st.k_sb + kvh * st.k_sh;
  const T* vp = v + b * st.v_sb + kvh * st.v_sh;

  for (int i = tid; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < Sk) {
      kx = to_f32(kp[(int64_t)(k0 + r) * st.k_ss + c]);
      vx = to_f32(vp[(int64_t)(k0 + r) * st.v_ss + c]);
    }
    sK[r * DP + c] = kx;
    sV[r * DP + c] = vx;
  }
  int first_tile, n_tiles;
  q_tiles(k0, BK, BQ, Sq, Sk, causal, window, first_tile, n_tiles);

  float gk[4][CPT], gv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t = first_tile; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the last tile's reads of sQ/sDO/sP/sS are done
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D, c = i % D;
      float x = 0.f, y = 0.f;
      if (q0 + r < Sq) {
        x = to_f32(qp[(int64_t)(q0 + r) * st.q_ss + c]);
        y = to_f32(dp_[(int64_t)(q0 + r) * st.o_ss + c]);
      }
      sQ[r * DP + c] = x;
      sDO[r * DP + c] = y;
    }
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < Sq;
      sL[i] = in ? lse[(int64_t)bh * Sq + q0 + i] : 0.f;
      sD[i] = in ? delta[(int64_t)bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(4 * ty + i) * DP + d];
        vv[i] = sV[(4 * ty + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * DP + d];
        ov[j] = sDO[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dpv[i][j] = fmaf(vv[i], ov[j], dpv[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool ok = q0 + r < Sq &&
                        visible(key, kv_offset + q0 + r, Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sP[(4 * ty + i) * BKP + r] = round_as(p, T());
        sS[(4 * ty + i) * BKP + r] = round_as(p * (dpv[i][j] - sD[r]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(4 * ty + i) * BKP + r];
        sv[i] = sS[(4 * ty + i) * BKP + r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = sDO[r * DP + tx + 16 * c];
        qv[c] = sQ[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gv[i][c] = fmaf(pv[i], ov[c], gv[i][c]);
          gk[i][c] = fmaf(sv[i], qv[c], gk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Sk) continue;
    T* krow = dk + ((int64_t)bh * Sk + key) * D;
    T* vrow = dv + ((int64_t)bh * Sk + key) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store(krow + tx + 16 * c, gk[i][c]);
      store(vrow + tx + 16 * c, gv[i][c]);
    }
  }
}

// ------------------------------------------------------------ tensor-core dQ
template <int D>
__global__ void __launch_bounds__(NT_MMA) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq,
    int H, int KvH, int Sq, int Sk, Strides st, int causal, int window, float scale) {
  constexpr int DS = D + 8;     // padded smem row: fragment reads are conflict-free
  constexpr int KS = D / 16;    // k-steps over the head dim
  constexpr int NO = D / 8;     // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DS]
  __nv_bfloat16* sDO = sQ + BQ * DS;                                 // [BQ][DS]
  __nv_bfloat16* sK = sDO + BQ * DS;                                 // [BK][DS]
  __nv_bfloat16* sV = sK + BK * DS;                                  // [BK][DS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;
  const __nv_bfloat16* kp = k + b * st.k_sb + kvh * st.k_sh;
  const __nv_bfloat16* vp = v + b * st.v_sb + kvh * st.v_sh;

  load_tile<D>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq);
  load_tile<D>(sDO, dout + b * st.o_sb + h * st.o_sh, st.o_ss, q0, Sq);
  __syncthreads();
  // this warp's 16 rows of Q and dO as A fragments, for the whole loop
  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a<DS>(qf[kk], sQ + 16 * warp * DS, kk, g, t4);
    load_a<DS>(of[kk], sDO + 16 * warp * DS, kk, g, t4);
  }
  // this warp's query positions; a warp wholly past Sq computes nothing
  const int w_row0 = q0 + 16 * warp;
  const bool w_live = w_row0 < Sq;
  const int w_first = kv_offset + w_row0;
  const int w_last = kv_offset + min(w_row0 + 15, Sq - 1);
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row0 + g + 8 * r;
    lse_r[r] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dlt_r[r] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  int first_tile, n_tiles;
  key_tiles(q0, BQ, BK, Sq, Sk, causal, window, first_tile, n_tiles);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the last tile
    load_tile<D>(sK, kp, st.k_ss, k0, Sk);
    load_tile<D>(sV, vp, st.v_ss, k0, Sk);
    __syncthreads();
    if (!w_live) continue;
#pragma unroll 1
    for (int j = 0; j < BK / 16; ++j) {
      const int kc = k0 + 16 * j;  // this step's 16 keys
      if (kc >= Sk) break;
      // steps masked for every row of this warp contribute nothing
      if (causal && (kc > w_last || (window > 0 && kc + 15 <= w_first - window))) continue;
      const bool need_mask =
          kc + 16 > Sk ||
          (causal && (kc + 15 > w_first || (window > 0 && kc <= w_last - window)));
      // S = Q K^T and dP = dO V^T for 16 rows x 16 keys (two n-tiles of 8)
      float s[2][4], dpv[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dpv[n][0] = dpv[n][1] = dpv[n][2] = dpv[n][3] = 0.f;
        const __nv_bfloat16* kr = sK + (16 * j + 8 * n + g) * DS + 2 * t4;
        const __nv_bfloat16* vr = sV + (16 * j + 8 * n + g) * DS + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          mma_bf16(s[n], qf[kk], ld_pair(kr + 16 * kk), ld_pair(kr + 16 * kk + 8));
          mma_bf16(dpv[n], of[kk], ld_pair(vr + 16 * kk), ld_pair(vr + 16 * kk + 8));
        }
      }
      // dS = P (dP - delta) scale with P = exp(S scale - LSE); row g in
      // elements 0-1, row g+8 in 2-3
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] * scale - lse_r[e >> 1]);
          if (need_mask &&
              !visible(kc + 8 * n + 2 * t4 + (e & 1), w_first + g + 8 * (e >> 1), Sk,
                       causal, window))
            p = 0.f;
          s[n][e] = p * (dpv[n][e] - dlt_r[e >> 1]) * scale;
        }
      const uint32_t da[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // dQ += dS K: B = K rows (the 16 keys) x 8 head-dim columns
      const __nv_bfloat16* kc_ = sK + (16 * j + 2 * t4) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* c = kc_ + 8 * n;
        mma_bf16(acc[n], da, pack_raw(c[0], c[DS]), pack_raw(c[8 * DS], c[9 * DS]));
      }
    }
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row0 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + ((int64_t)bh * Sq + row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// --------------------------------------------------------- tensor-core dK/dV
template <int D>
__global__ void __launch_bounds__(NT_MMA) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int KvH, int Sq, int Sk, Strides st, int causal, int window, float scale) {
  constexpr int DS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][DS]
  __nv_bfloat16* sV = sK + BK * DS;                                  // [BK][DS]
  __nv_bfloat16* sQ = sV + BK * DS;                                  // [BQ][DS]
  __nv_bfloat16* sDO = sQ + BQ * DS;                                 // [BQ][DS]
  float* sL = reinterpret_cast<float*>(sDO + BQ * DS);               // [BQ]
  float* sD = sL + BQ;                                               // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.x * BK;  // low tiles have the most q tiles: first
  const int kv_offset = Sk - Sq;
  const __nv_bfloat16* qp = q + b * st.q_sb + h * st.q_sh;
  const __nv_bfloat16* op = dout + b * st.o_sb + h * st.o_sh;

  load_tile<D>(sK, k + b * st.k_sb + kvh * st.k_sh, st.k_ss, k0, Sk);
  load_tile<D>(sV, v + b * st.v_sb + kvh * st.v_sh, st.v_ss, k0, Sk);
  // this warp's 16 keys; a warp wholly past Sk computes nothing
  const int w_key0 = k0 + 16 * warp;
  const bool w_live = w_key0 < Sk;
  const __nv_bfloat16* kw = sK + 16 * warp * DS;
  const __nv_bfloat16* vw = sV + 16 * warp * DS;
  int first_tile, n_tiles;
  q_tiles(k0, BK, BQ, Sq, Sk, causal, window, first_tile, n_tiles);

  // dK and dV of this warp's keys: row g in elements 0-1, row g+8 in 2-3
  float gk[NO][4], gv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();  // every warp is done with the last tile
    load_tile<D>(sQ, qp, st.q_ss, q0, Sq);
    load_tile<D>(sDO, op, st.o_ss, q0, Sq);
    for (int i = threadIdx.x; i < BQ; i += NT_MMA) {
      const bool in = q0 + i < Sq;
      sL[i] = in ? lse[(int64_t)bh * Sq + q0 + i] : 0.f;
      sD[i] = in ? delta[(int64_t)bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();
    if (!w_live) continue;
#pragma unroll 1
    for (int c = 0; c < BQ / 16; ++c) {
      const int r0 = q0 + 16 * c;  // this step's 16 q rows
      if (r0 >= Sq) break;
      const int p_first = kv_offset + r0;
      const int p_last = kv_offset + min(r0 + 15, Sq - 1);
      // steps masked for every key of this warp contribute nothing
      if (causal && (w_key0 > p_last || (window > 0 && w_key0 + 15 <= p_first - window)))
        continue;
      const bool need_mask =
          r0 + 16 > Sq || w_key0 + 16 > Sk ||
          (causal && (w_key0 + 15 > p_first || (window > 0 && w_key0 <= p_last - window)));
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 q rows
      float s[2][4], dpv[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a<DS>(ka, kw, kk, g, t4);
        load_a<DS>(va, vw, kk, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat16* qr = sQ + (16 * c + 8 * n + g) * DS + 16 * kk + 2 * t4;
          const __nv_bfloat16* orr = sDO + (16 * c + 8 * n + g) * DS + 16 * kk + 2 * t4;
          mma_bf16(s[n], ka, ld_pair(qr), ld_pair(qr + 8));
          mma_bf16(dpv[n], va, ld_pair(orr), ld_pair(orr + 8));
        }
      }
      // P^T and dS^T; element e of n-tile n is (key g + 8 (e >> 1), q row
      // 16 c + 8 n + 2 t + (e & 1))
      float pt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * c + 8 * n + 2 * t4 + (e & 1);
          float p = expf(s[n][e] * scale - sL[r]);
          if (need_mask &&
              !(q0 + r < Sq && visible(w_key0 + g + 8 * (e >> 1), kv_offset + q0 + r, Sk,
                                       causal, window)))
            p = 0.f;
          pt[n][e] = p;
          s[n][e] = p * (dpv[n][e] - sD[r]) * scale;
        }
      const uint32_t pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
      const uint32_t sa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // dV += P^T dO and dK += dS^T Q: B = 16 q rows x 8 head-dim columns
      const __nv_bfloat16* oc = sDO + (16 * c + 2 * t4) * DS + g;
      const __nv_bfloat16* qc = sQ + (16 * c + 2 * t4) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* o_ = oc + 8 * n;
        const __nv_bfloat16* q_ = qc + 8 * n;
        mma_bf16(gv[n], pa, pack_raw(o_[0], o_[DS]), pack_raw(o_[8 * DS], o_[9 * DS]));
        mma_bf16(gk[n], sa, pack_raw(q_[0], q_[DS]), pack_raw(q_[8 * DS], q_[9 * DS]));
      }
    }
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w_key0 + g + 8 * r;
    if (key >= Sk) continue;
    const int64_t base = ((int64_t)bh * Sk + key) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + 8 * n) = pack_bf16(gk[n][2 * r], gk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * n) = pack_bf16(gv[n][2 * r], gv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------- the wgmma kernels (D = 128)
constexpr int WG_THREADS = 128;
constexpr int W_STAGES = 2;
constexpr int W_HALF64 = 64 * 128;     // bytes of one 64-column half of a 64-row tile
constexpr int W_HALF128 = 128 * 128;   // ... of a 128-row tile
constexpr int W_T64 = 2 * W_HALF64;    // a 64 x 128 bf16 tile
constexpr int W_T128 = 2 * W_HALF128;  // a 128 x 128 bf16 tile

// dK/dV: K, V (128 keys), then per stage Q and dO (64 rows), then per stage
// LSE (in log2 units) and delta (64 fp32 each), then the barriers
constexpr int DKV_Q = 2 * W_T128;
constexpr int DKV_STAGE = 2 * W_T64;
constexpr int DKV_STATS = DKV_Q + W_STAGES * DKV_STAGE;
constexpr int DKV_BARS = DKV_STATS + W_STAGES * 128 * 4;
constexpr int DKV_SMEM = DKV_BARS + 8 * (1 + 2 * W_STAGES) + 1024;  // + alignment slack
// dQ: Q, dO (128 rows), then per stage K and V (64 keys), then the barriers
constexpr int DQ_K = 2 * W_T128;
constexpr int DQ_STAGE = 2 * W_T64;
constexpr int DQ_BARS = DQ_K + W_STAGES * DQ_STAGE;
constexpr int DQ_SMEM = DQ_BARS + 8 * (1 + 2 * W_STAGES) + 1024;

// the start-address step of k-step kk (of 8, 16 head dims each) in a
// K-major operand whose two 64-column halves lie `half` bytes apart
__device__ __forceinline__ uint64_t kstep(int kk, int half) {
  return (uint64_t)(((kk / 4) * half + (kk % 4) * 32) >> 4);
}

// an m64n64 accumulator rounded to bf16 as the RS form's A operand: k-step s
// is columns 16 s .. 16 s + 15
__device__ __forceinline__ void to_a_operand(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = pack_bf16(d[8 * s + 2 * i], d[8 * s + 2 * i + 1]);
}

__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int KvH, int Sq, int Sk, int causal, int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + W_T128;
  float* stats = reinterpret_cast<float*>(smem + DKV_STATS);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + DKV_BARS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + W_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.y * 128;  // low key blocks have the most q tiles: first
  int first, last;
  q_tiles(k0, 128, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx, and the 32 lanes staging LSE/delta
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: lane 0 issues every TMA load, the first warp stages
    // LSE and delta with plain loads
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 2 * W_T128);
        tma_load_4d(sK, &tm_k, full_kv, 0, k0, kvh, b);
        tma_load_4d(sK + W_HALF128, &tm_k, full_kv, 64, k0, kvh, b);
        tma_load_4d(sV, &tm_v, full_kv, 0, k0, kvh, b);
        tma_load_4d(sV + W_HALF128, &tm_v, full_kv, 64, k0, kvh, b);
      }
      const float* lse_bh = lse + (int64_t)bh * Sq;
      const float* delta_bh = delta + (int64_t)bh * Sq;
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        const int q0 = t * 64;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* sQ = smem + DKV_Q + DKV_STAGE * s;
          mbar_arrive_expect_tx(&full[s], 2 * W_T64);
          tma_load_4d(sQ, &tm_q, &full[s], 0, q0, h, b);
          tma_load_4d(sQ + W_HALF64, &tm_q, &full[s], 64, q0, h, b);
          tma_load_4d(sQ + W_T64, &tm_do, &full[s], 0, q0, h, b);
          tma_load_4d(sQ + W_T64 + W_HALF64, &tm_do, &full[s], 64, q0, h, b);
        }
        // rows past Sq get 0 here and are masked by the consumers
        float* st = stats + 128 * s;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          const bool in = q0 + r < Sq;
          st[r] = in ? lse_bh[q0 + r] * LOG2E : 0.f;
          st[64 + r] = in ? delta_bh[q0 + r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_key0 = k0 + 64 * cw;
    const bool w_live = w_key0 < Sk;
    const int key0 = w_key0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const float c = scale * LOG2E;  // raw score -> log2 units
    float gk[64], gv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gk[i] = gv[i] = 0.f;
    const uint64_t da_k = desc_kmajor(sK + 64 * 128 * cw);
    const uint64_t da_v = desc_kmajor(sV + 64 * 128 * cw);

    mbar_wait(full_kv, 0);
    for (int t = first, i = 0; t < last; ++t, ++i) {
      const int s = i % W_STAGES;
      const int q0 = t * 64;
      const int p_first = kv_offset + q0;
      const int p_last = kv_offset + min(q0 + 63, Sq - 1);
      mbar_wait(&full[s], (i / W_STAGES) & 1);
      // a tile masked for every key of this warpgroup is only released
      if (!w_live || (causal && (w_key0 > p_last ||
                                 (window > 0 && w_key0 + 63 <= p_first - window)))) {
        mbar_arrive(&empty[s]);
        continue;
      }
      unsigned char* sQ = smem + DKV_Q + DKV_STAGE * s;
      unsigned char* sDO = sQ + W_T64;

      // S^T = K Q^T and dP^T = V dO^T, 8 k-steps of 16 head dims each
      float sc[32], dp[32];
      const uint64_t db_q = desc_kmajor(sQ), db_o = desc_kmajor(sDO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_ss<0, 0>(sc, da_k + kstep(kk, W_HALF128), db_q + kstep(kk, W_HALF64),
                                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_ss<0, 0>(dp, da_v + kstep(kk, W_HALF128), db_o + kstep(kk, W_HALF64),
                                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T / scale, rounded to bf16 as the A operands k-step by
      // k-step (16 q rows), so that each step's fp32 values die at once;
      // element 4 j + e is key key0 + 8 (e / 2), q row q0 + 8 j + 2 t4 +
      // (e % 2)
      const bool need_mask =
          q0 + 64 > Sq ||
          (causal && (w_key0 + 63 > p_first || (window > 0 && w_key0 <= p_last - window)));
      const float* st = stats + 128 * s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
        const float2 dl = *reinterpret_cast<const float2*>(st + 64 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (need_mask) {
            const int r = q0 + 8 * j + 2 * t4 + (e & 1);
            if (!(r < Sq && visible(key0 + 8 * (e >> 1), kv_offset + r, Sk, causal, window)))
              x = NEG;
          }
          const float p = exp2_ftz(fmaf(x, c, -((e & 1) ? l2.y : l2.x)));
          sc[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      uint32_t pa[4][4], sa[4][4];
      to_a_operand(sc, pa);
      to_a_operand(dp, sa);

      // dV += P^T dO and dK += dS^T Q: dO and Q are MN-major B operands
      // (head_dim contiguous), halves 8 KB apart, a k-step of 16 q rows
      // 2048 bytes
      const uint64_t db_o_mn = desc_mnmajor(sDO, W_HALF64);
      const uint64_t db_q_mn = desc_mnmajor(sQ, W_HALF64);
      fence_regs(gv);
      fence_regs(gk);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n128k16_rs<1>(gv, pa[k4], db_o_mn + ((k4 * 2048) >> 4), 1);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n128k16_rs<1>(gk, sa[k4], db_q_mn + ((k4 * 2048) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
      mbar_arrive(&empty[s]);
    }

    // dK scale and dV in bf16, one copy per q head; gk[4 j + e] is key key0
    // + 8 (e / 2), head dim 8 j + 2 t4 + (e % 2)
    if (w_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t base = ((int64_t)bh * Sk + key) * 128 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
              pack_bf16(gk[4 * j + 2 * r] * scale, gk[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + base + 8 * j) =
              pack_bf16(gv[4 * j + 2 * r], gv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + W_T128;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + DQ_BARS);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + W_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * 128;
  int first, last;
  key_tiles(q0, 128, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, 2 * W_T128);
      tma_load_4d(sQ, &tm_q, full_q, 0, q0, h, b);
      tma_load_4d(sQ + W_HALF128, &tm_q, full_q, 64, q0, h, b);
      tma_load_4d(sDO, &tm_do, full_q, 0, q0, h, b);
      tma_load_4d(sDO + W_HALF128, &tm_do, full_q, 64, q0, h, b);
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + DQ_K + DQ_STAGE * s;
        mbar_arrive_expect_tx(&full[s], 2 * W_T64);
        tma_load_4d(sK, &tm_k, &full[s], 0, t * 64, kvh, b);
        tma_load_4d(sK + W_HALF64, &tm_k, &full[s], 64, t * 64, kvh, b);
        tma_load_4d(sK + W_T64, &tm_v, &full[s], 0, t * 64, kvh, b);
        tma_load_4d(sK + W_T64 + W_HALF64, &tm_v, &full[s], 64, t * 64, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_row0 = q0 + 64 * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + 63, Sq - 1);
    const int row0 = w_row0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const float c = scale * LOG2E;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      l2[r] = row < Sq ? lse[(int64_t)bh * Sq + row] * LOG2E : 0.f;
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint64_t da_q = desc_kmajor(sQ + 64 * 128 * cw);
    const uint64_t da_o = desc_kmajor(sDO + 64 * 128 * cw);

    mbar_wait(full_q, 0);
    for (int t = first, i = 0; t < last; ++t, ++i) {
      const int s = i % W_STAGES;
      const int k0 = t * 64;
      mbar_wait(&full[s], (i / W_STAGES) & 1);
      // a tile masked for every row of this warpgroup is only released
      if (!w_live || (causal && (k0 > w_last ||
                                 (window > 0 && k0 + 63 <= w_first - window)))) {
        mbar_arrive(&empty[s]);
        continue;
      }
      unsigned char* sK = smem + DQ_K + DQ_STAGE * s;
      unsigned char* sV = sK + W_T64;

      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
      const uint64_t db_k = desc_kmajor(sK), db_v = desc_kmajor(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_ss<0, 0>(sc, da_q + kstep(kk, W_HALF128), db_k + kstep(kk, W_HALF64),
                                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_ss<0, 0>(dp, da_o + kstep(kk, W_HALF128), db_v + kstep(kk, W_HALF64),
                                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS / scale; element 4 j + e is row row0 + 8 (e / 2), key k0 + 8 j +
      // 2 t4 + (e % 2)
      const bool need_mask =
          k0 + 64 > Sk ||
          (causal && (k0 + 63 > w_first || (window > 0 && k0 <= w_last - window)));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (need_mask && !visible(k0 + 8 * j + 2 * t4 + (e & 1),
                                    kv_offset + row0 + 8 * (e >> 1), Sk, causal, window))
            x = NEG;
          const float p = exp2_ftz(fmaf(x, c, -l2[e >> 1]));
          dp[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
        }
      }
      uint32_t sa[4][4];
      to_a_operand(dp, sa);

      // dQ += dS K: K [keys][head_dim] as an MN-major B operand
      const uint64_t db_k_mn = desc_mnmajor(sK, W_HALF64);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n128k16_rs<1>(acc, sa[k4], db_k_mn + ((k4 * 2048) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    if (w_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        __nv_bfloat16* out = dq + ((int64_t)bh * Sq + row) * 128 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

// ---- host side
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, KvH, Sq, Sk;
  Strides st;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D>
cudaError_t launch_dq_simt(const Args& a) {
  const int smem = (int)sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * BKP);
  auto kernel = flash_bwd_dq_simt_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
      a.H, a.KvH, a.Sq, a.Sk, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_simt(const Args& a) {
  const int smem = (int)sizeof(float) *
                   (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * BKP + 2 * BQ);
  auto kernel = flash_bwd_dkv_simt_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
      a.H, a.KvH, a.Sq, a.Sk, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  const int smem = (int)sizeof(__nv_bfloat16) * (2 * BQ + 2 * BK) * (D + 8);
  auto kernel = flash_bwd_dq_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  typedef const __nv_bfloat16* P;
  kernel<<<grid, NT_MMA, smem, a.stream>>>(
      (P)a.q, (P)a.k, (P)a.v, (P)a.dout, (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)a.dq, a.H, a.KvH, a.Sq, a.Sk, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  const int smem = (int)sizeof(__nv_bfloat16) * (2 * BK + 2 * BQ) * (D + 8) +
                   (int)sizeof(float) * 2 * BQ;
  auto kernel = flash_bwd_dkv_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  typedef const __nv_bfloat16* P;
  kernel<<<grid, NT_MMA, smem, a.stream>>>(
      (P)a.q, (P)a.k, (P)a.v, (P)a.dout, (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv,
      a.H, a.KvH, a.Sq, a.Sk, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// the four 4-D maps (q, k, v, dO) of a wgmma launch, boxes of `q_rows` rows
// of q and dO and `kv_rows` of k and v; false if cuTensorMapEncodeTiled refuses one
bool bwd_maps(const Args& a, uint32_t q_rows, uint32_t kv_rows, CUtensorMap (&maps)[4]) {
  const int64_t q_dims[4] = {128, a.Sq, a.H, a.B};
  const int64_t kv_dims[4] = {128, a.Sk, a.KvH, a.B};
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  const int64_t* st = &a.st.q_sb;
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    // strides (seq, head, batch), innermost first after head_dim
    const int64_t strides[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    if (!hopper::make_map_bf16_4d(&maps[i], bases[i], is_q ? q_dims : kv_dims, strides,
                                  is_q ? q_rows : kv_rows))
      return false;
  }
  return true;
}

cudaError_t launch_dkv_wgmma(const Args& a) {
  static const cudaError_t attr = set_smem(flash_bwd_dkv_wgmma_kernel, DKV_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  if (!bwd_maps(a, 64, 128, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sk + 127) / 128);
  flash_bwd_dkv_wgmma_kernel<<<grid, 3 * WG_THREADS, DKV_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.H, a.KvH, a.Sq, a.Sk, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_wgmma(const Args& a) {
  static const cudaError_t attr = set_smem(flash_bwd_dq_wgmma_kernel, DQ_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  if (!bwd_maps(a, 128, 64, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sq + 127) / 128);
  flash_bwd_dq_wgmma_kernel<<<grid, 3 * WG_THREADS, DQ_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta,
      (__nv_bfloat16*)a.dq, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// which: 0 = dQ, 1 = dK/dV
template <typename T>
cudaError_t launch_simt(int which, int D, const Args& a) {
  switch (D) {
    case 32: return which ? launch_dkv_simt<T, 32>(a) : launch_dq_simt<T, 32>(a);
    case 64: return which ? launch_dkv_simt<T, 64>(a) : launch_dq_simt<T, 64>(a);
    case 128: return which ? launch_dkv_simt<T, 128>(a) : launch_dq_simt<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// route 0 = simt (any input), 1 = mma (bf16, 16-byte aligned bases, strides
// that are multiples of 8), 2 = wgmma (as mma, and D = 128, Sk > 0); a route
// that cannot take the inputs launches nothing
cudaError_t dispatch(int which, int dtype, int route, int D, const Args& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const bool tensor_core = dtype == 1 && rows_aligned(ptrs, 4, &a.st.q_sb, 12);
  switch (route) {
    case 0:
      if (dtype == 0) return launch_simt<float>(which, D, a);
      if (dtype == 1) return launch_simt<__nv_bfloat16>(which, D, a);
      return cudaErrorInvalidValue;
    case 1:
      if (!tensor_core) return cudaErrorInvalidValue;
      switch (D) {
        case 32: return which ? launch_dkv_mma<32>(a) : launch_dq_mma<32>(a);
        case 64: return which ? launch_dkv_mma<64>(a) : launch_dq_mma<64>(a);
        case 128: return which ? launch_dkv_mma<128>(a) : launch_dq_mma<128>(a);
        default: return cudaErrorInvalidValue;
      }
    case 2:
      if (!tensor_core || D != 128 || a.Sk <= 0) return cudaErrorInvalidValue;
      return which ? launch_dkv_wgmma(a) : launch_dq_wgmma(a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int which, int dtype, int route, int device, const Args& a, int D) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch(which, dtype, route, D, a);
}

}  // namespace

// q, dout: [B, H, Sq, D] and k, v: [B, KvH, Sk, D] with the given (batch,
// head, seq) strides and a contiguous last dim; lse, delta: contiguous fp32
// [B, H, Sq]; dq: contiguous [B, H, Sq, D]; dk, dv: contiguous [B, H, Sk,
// D], one per q head. dtype 0 = fp32, 1 = bf16. route: 0 = simt, 1 = mma,
// 2 = wgmma (the conditions at `dispatch`); a route that cannot take the
// inputs returns cudaErrorInvalidValue and launches nothing. window <= 0
// means no window. Each returns the launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int dtype, int route, int device, int B, int H, int KvH,
                            int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss,
                            int causal, int window, float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, KvH, Sq, Sk,
                  {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss},
                  causal, window, scale, (cudaStream_t)stream};
  return run(0, dtype, route, device, a, D);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int dtype, int route, int device, int B, int H, int KvH,
                             int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss,
                             int64_t v_sb, int64_t v_sh, int64_t v_ss,
                             int64_t o_sb, int64_t o_sh, int64_t o_ss,
                             int causal, int window, float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, KvH, Sq, Sk,
                  {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss},
                  causal, window, scale, (cudaStream_t)stream};
  return run(1, dtype, route, device, a, D);
}
