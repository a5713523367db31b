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
//   kernel. Below; flash_bwd_dq_wgmma96_kernel and
//   flash_bwd_dkv_wgmma96_kernel are route 2 at D = 96 (Phi-3-mini's
//   attention), the D = 128 kernels' bodies at the true width, as are
//   flash_bwd_dq_wgmma80_kernel and flash_bwd_dkv_wgmma80_kernel at D = 80
//   (StableLM-3B-4E1T's), and
//   flash_bwd_dq_wgmma100_kernel and flash_bwd_dkv_wgmma100_kernel route 2
//   at D = 100 (OpenLLaMA-3B's, 200-byte rows with 8-byte aligned bases,
//   which their producers copy with cp.async where TMA cannot read them),
//   with flash_bwd_dq_wgmma100_f16_kernel and
//   flash_bwd_dkv_wgmma100_f16_kernel the same bodies in fp16 (OpenLLaMA-3B's
//   published dtype); flash_bwd_dq_wgmma_f16_kernel and
//   flash_bwd_dkv_wgmma_f16_kernel are route 2 in fp16 at D = 128 (Llama-2's
//   published dtype), the D = 128 kernels' bodies on fp16 operands;
//   flash_bwd_dkv_wgmma64_kernel and
//   flash_bwd_dq_wgmma64_kernel are route 2 at D = 64 (bench_mfu's d1024
//   widths), and flash_bwd_dkv_wgmma64_f16_kernel and
//   flash_bwd_dq_wgmma64_f16_kernel route 2 in fp16 at D = 64 (OPT-1.3B's
//   attention in its published dtype), the D = 64 kernels' bodies on fp16
//   operands; flash_bwd_dq_wgmma256_kernel and
//   flash_bwd_dkv_wgmma256_kernel are route 2 at D = 256 (Gemma's
//   attention, tiles of 64 rows), each with its own note, and
//   flash_bwd_dq_wgmma256_f16_kernel and flash_bwd_dkv_wgmma256_f16_kernel
//   the same bodies in fp16 (GPT-J-6B's attention in its published dtype);
//   flash_bwd_dq_wgmma96_f16_kernel and flash_bwd_dkv_wgmma96_f16_kernel
//   are the D = 96 bodies in fp16 (GPT-NeoX-20B's attention in its published
//   dtype), and flash_bwd_dq_wgmma80_f16_kernel and
//   flash_bwd_dkv_wgmma80_f16_kernel the D = 80 bodies in fp16 (OPT-2.7B's).
//   Route 2 refuses every other D (it runs on mma or simt).
// - *_mma kernels (route 1; aligned bf16 and fp16, D a multiple of 8 up to
//   256; they take bf16 at D = 64 and 128 too, to be held against the wgmma
//   kernels): 4 warps each own 16 rows of a 64-row tile and run all products
//   on the tensor cores with mma.sync m16n8k16, 16 streamed rows at a time,
//   skipping 16-row steps masked for all of their rows; the streamed tiles
//   are copied through registers with no pipeline. The dK/dV kernel computes
//   S^T = K Q^T directly, so its accumulator tiles are already the A operands
//   of P^T dO and dS^T Q. At DP = 256 dQ reads its Q and dO fragments from
//   shared memory at each step, and two dK/dV blocks take 128 columns each.
// - *_simt kernels (route 0; fp32, bf16 or fp16 rows the mma kernels do not
//   take, and D past 256 in every dtype): scalar fp32 FMAs from shared
//   memory, 256 threads as a 16 x 16 grid, each owning 4 rows of the block's
//   tile (2 at DP = 256, 1 at 512).
// The simt and mma kernels are built at a padded width DP of 32, 64, 128 or
// 256, and the simt kernels at 512 too, and take the true D at run time, as
// flash_fwd.cu's. P and dS are
// rounded to the input type as operands of the following products, where
// the plain version rounds them too (in fp16, ops/attention.py scales the
// cotangents first, so that dS stays in fp16's normal range, and passes the
// inverse scale as out_scale: each kernel multiplies its fp32 sums by it
// before their one rounding to fp16, so dQ, dK and dV are rounded at their
// true size).
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
// ragged tiles; dS = P (dP scale - delta scale), one FMA with delta scaled
// where it is staged, so that the scale is applied before the rounding, as
// the plain version and the simt and mma kernels apply it, and every route
// rounds the same value at head dims whose scale is not a power of two),
// rounds them to the input type as the A operands of the RS
// form (the accumulator's columns 16 s .. 16 s + 15 are A's k-step s), and
// adds the products into its fp32 sums with RS wgmma m64n128k16 (m64n80k16 at
// D = 80, m64n96k16 at 96, m64n104k16 at 100), the streamed tile an MN-major
// B operand (head_dim contiguous; halves 8 KB apart). The two steps are kept
// apart in time, as the forward's basic order, so the sums, the scores and
// the operands fit the consumers' 240 registers without spills.
// - flash_bwd_dkv_wgmma_kernel: a block is one (b, q head) and 128 keys;
//   K and V once, then Q and dO tiles of 64 rows with their LSE and delta.
//   S^T = K Q^T and dP^T = V dO^T; dV += P^T dO and dK += dS^T Q, both sums
//   (64 + 64 fp32 a thread) held across the q loop; dK and dV stored
//   once. LSE and delta scale (64 fp32 a tile each) are staged into the ring by
//   the producer's first warp with plain loads: (b H + h) Sq 4 bytes need
//   not be 16-byte aligned for a bulk copy. Rows past Sq read as zeros from
//   TMA, and are masked so that no LSE or delta beyond Sq reaches P or dS.
// - flash_bwd_dq_wgmma_kernel: a block is one (b, q head) and 128 q rows;
//   Q and dO once, LSE and delta scale of each thread's two rows in registers,
//   then K and V tiles of 64 keys. S = Q K^T and dP = dO V^T; dQ += dS K
//   with K as an MN-major B (the same tile that is S's K-major B); dQ
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
// Both SIMT kernels are built at a padded width DP (flash_common.cuh's
// padded_dim) with tiles of SB = simt_tile(DP) rows: columns d .. DP read
// as zeros and are not stored.
template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int d,
    Strides st, int causal, int window, float scale) {
  constexpr int SB = simt_tile(DP);  // q rows per block, keys per tile
  constexpr int RPT = SB / 16;       // rows (and key columns) per thread
  constexpr int SBP = SB + 4;        // padded dS row
  constexpr int DQ = DP + 1;         // padded row: column reads are conflict-free
  constexpr int CPT = DP / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [SB][DQ]
  float* sDO = sQ + SB * DQ;    // [SB][DQ]
  float* sK = sDO + SB * DQ;    // [SB][DQ]
  float* sV = sK + SB * DQ;     // [SB][DQ]
  float* sS = sV + SB * DQ;     // [SB][SBP]: dS

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's rows: RPT*ty .. RPT*ty+RPT-1
  const int tx = tid & 15;      // this thread's key columns: tx + 16*j
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * SB;
  const int kv_offset = Sk - Sq;
  const T* qp = q + b * st.q_sb + h * st.q_sh;
  const T* dp_ = dout + b * st.o_sb + h * st.o_sh;
  const T* kp = k + b * st.k_sb + kvh * st.k_sh;
  const T* vp = v + b * st.v_sb + kvh * st.v_sh;

  for (int i = tid; i < SB * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f, y = 0.f;
    if (q0 + r < Sq && c < d) {
      x = to_f32(qp[(int64_t)(q0 + r) * st.q_ss + c]);
      y = to_f32(dp_[(int64_t)(q0 + r) * st.o_ss + c]);
    }
    sQ[r * DQ + c] = x;
    sDO[r * DQ + c] = y;
  }
  float lse_r[RPT], dlt_r[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + RPT * ty + i;
    lse_r[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dlt_r[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }
  int first_tile, n_tiles;
  key_tiles(q0, SB, SB, Sq, Sk, causal, window, first_tile, n_tiles);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = first_tile; t < n_tiles; ++t) {
    const int k0 = t * SB;
    __syncthreads();  // the last tile's reads of sK/sV/sS are done
    for (int i = tid; i < SB * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && c < d) {
        kx = to_f32(kp[(int64_t)(k0 + r) * st.k_ss + c]);
        vx = to_f32(vp[(int64_t)(k0 + r) * st.v_ss + c]);
      }
      sK[r * DQ + c] = kx;
      sV[r * DQ + c] = vx;
    }
    __syncthreads();

    float s[RPT][RPT], dpv[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qv[RPT], ov[RPT], kv[RPT], vv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = sQ[(RPT * ty + i) * DQ + dd];
        ov[i] = sDO[(RPT * ty + i) * DQ + dd];
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        kv[j] = sK[(tx + 16 * j) * DQ + dd];
        vv[j] = sV[(tx + 16 * j) * DQ + dd];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dpv[i][j] = fmaf(ov[i], vv[j], dpv[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = kv_offset + q0 + RPT * ty + i;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int key = k0 + tx + 16 * j;
        const float p = visible(key, qpos, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sS[(RPT * ty + i) * SBP + tx + 16 * j] =
            round_as(p * (dpv[i][j] - dlt_r[i]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < SB; ++kk) {
      float sv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sS[(RPT * ty + i) * SBP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[kk * DQ + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  const float os = out_scale ? *out_scale : 1.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + RPT * ty + i;
    if (row >= Sq) continue;
    T* out = dq + ((int64_t)bh * Sq + row) * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tx + 16 * c < d) store(out + tx + 16 * c, acc[i][c] * os);
  }
}

// --------------------------------------------------------------- SIMT dK/dV
template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int d,
    Strides st, int causal, int window, float scale) {
  constexpr int SB = simt_tile(DP);  // keys per block, q rows per tile
  constexpr int RPT = SB / 16;       // keys (and q columns) per thread
  constexpr int SBP = SB + 4;
  constexpr int DQ = DP + 1;
  constexpr int CPT = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [SB][DQ]
  float* sV = sK + SB * DQ;     // [SB][DQ]
  float* sQ = sV + SB * DQ;     // [SB][DQ]
  float* sDO = sQ + SB * DQ;    // [SB][DQ]
  float* sP = sDO + SB * DQ;    // [SB][SBP]: P^T
  float* sS = sP + SB * SBP;    // [SB][SBP]: dS^T
  float* sL = sS + SB * SBP;    // [SB]: LSE
  float* sD = sL + SB;          // [SB]: delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's keys: RPT*ty .. RPT*ty+RPT-1
  const int tx = tid & 15;      // this thread's q columns: tx + 16*j
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.x * SB;  // low tiles have the most q tiles: first
  const int kv_offset = Sk - Sq;
  const T* qp = q + b * st.q_sb + h * st.q_sh;
  const T* dp_ = dout + b * st.o_sb + h * st.o_sh;
  const T* kp = k + b * st.k_sb + kvh * st.k_sh;
  const T* vp = v + b * st.v_sb + kvh * st.v_sh;

  for (int i = tid; i < SB * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < Sk && c < d) {
      kx = to_f32(kp[(int64_t)(k0 + r) * st.k_ss + c]);
      vx = to_f32(vp[(int64_t)(k0 + r) * st.v_ss + c]);
    }
    sK[r * DQ + c] = kx;
    sV[r * DQ + c] = vx;
  }
  int first_tile, n_tiles;
  q_tiles(k0, SB, SB, Sq, Sk, causal, window, first_tile, n_tiles);

  float gk[RPT][CPT], gv[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t = first_tile; t < n_tiles; ++t) {
    const int q0 = t * SB;
    __syncthreads();  // the last tile's reads of sQ/sDO/sP/sS are done
    for (int i = tid; i < SB * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float x = 0.f, y = 0.f;
      if (q0 + r < Sq && c < d) {
        x = to_f32(qp[(int64_t)(q0 + r) * st.q_ss + c]);
        y = to_f32(dp_[(int64_t)(q0 + r) * st.o_ss + c]);
      }
      sQ[r * DQ + c] = x;
      sDO[r * DQ + c] = y;
    }
    for (int i = tid; i < SB; i += NT) {
      const bool in = q0 + i < Sq;
      sL[i] = in ? lse[(int64_t)bh * Sq + q0 + i] : 0.f;
      sD[i] = in ? delta[(int64_t)bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[RPT][RPT], dpv[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float kv[RPT], vv[RPT], qv[RPT], ov[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = sK[(RPT * ty + i) * DQ + dd];
        vv[i] = sV[(RPT * ty + i) * DQ + dd];
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        qv[j] = sQ[(tx + 16 * j) * DQ + dd];
        ov[j] = sDO[(tx + 16 * j) * DQ + dd];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dpv[i][j] = fmaf(vv[i], ov[j], dpv[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int key = k0 + RPT * ty + i;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = tx + 16 * j;
        const bool ok = q0 + r < Sq &&
                        visible(key, kv_offset + q0 + r, Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sP[(RPT * ty + i) * SBP + r] = round_as(p, T());
        sS[(RPT * ty + i) * SBP + r] = round_as(p * (dpv[i][j] - sD[r]) * scale, T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < SB; ++r) {
      float pv[RPT], sv[RPT], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = sP[(RPT * ty + i) * SBP + r];
        sv[i] = sS[(RPT * ty + i) * SBP + r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = sDO[r * DQ + tx + 16 * c];
        qv[c] = sQ[r * DQ + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gv[i][c] = fmaf(pv[i], ov[c], gv[i][c]);
          gk[i][c] = fmaf(sv[i], qv[c], gk[i][c]);
        }
    }
  }

  const float os = out_scale ? *out_scale : 1.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + RPT * ty + i;
    if (key >= Sk) continue;
    T* krow = dk + ((int64_t)bh * Sk + key) * d;
    T* vrow = dv + ((int64_t)bh * Sk + key) * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (tx + 16 * c >= d) continue;
      store(krow + tx + 16 * c, gk[i][c] * os);
      store(vrow + tx + 16 * c, gv[i][c] * os);
    }
  }
}

// ------------------------------------------------------------ tensor-core dQ
// Both mma kernels are built for bf16 or fp16 (T) at a padded width DP, as
// flash_fwd_mma_kernel is: an exact build (PAD false) for D = DP, a padded
// one for D below DP:
// columns d .. DP load as zeros, which add nothing to the products, and
// nothing past d is stored (d is a multiple of 8). Their loops run over all
// of DP, as at d = DP: skipping the k-steps and n-tiles past d behind a
// branch made every product slower, d = DP's too.
template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(NT_MMA) flash_bwd_dq_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int d_arg,
    Strides st, int causal, int window, float scale) {
  constexpr int DS = DP + 8;    // padded smem row: fragment reads are conflict-free
  constexpr int KS = DP / 16;   // k-steps over the head dim
  constexpr int NO = DP / 8;    // n-tiles of dQ
  // up to DP = 128 a warp keeps its Q and dO fragments in registers for the
  // whole loop; at 256 they would not fit beside dQ's 128 fp32 sums, and are
  // read from shared memory at each k-step
  constexpr bool QREG = DP <= 128;
  const int d = PAD ? d_arg : DP;  // as flash_fwd_mma_kernel's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][DS]
  T* sDO = sQ + BQ * DS;                   // [BQ][DS]
  T* sK = sDO + BQ * DS;                   // [BK][DS]
  T* sV = sK + BK * DS;                    // [BK][DS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;
  const T* kp = k + b * st.k_sb + kvh * st.k_sh;
  const T* vp = v + b * st.v_sb + kvh * st.v_sh;

  load_tile<DP>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq, d);
  load_tile<DP>(sDO, dout + b * st.o_sb + h * st.o_sh, st.o_ss, q0, Sq, d);
  __syncthreads();
  // this warp's 16 rows of Q and dO as A fragments
  const T* qw = sQ + 16 * warp * DS;
  const T* ow = sDO + 16 * warp * DS;
  uint32_t qf[QREG ? KS : 1][4], of[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_a<DS>(qf[kk], qw, kk, g, t4);
      load_a<DS>(of[kk], ow, kk, g, t4);
    }
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
    load_tile<DP>(sK, kp, st.k_ss, k0, Sk, d);
    load_tile<DP>(sV, vp, st.v_ss, k0, Sk, d);
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
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
      if constexpr (QREG) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const T* kr = sK + (16 * j + 8 * n + g) * DS + 2 * t4;
          const T* vr = sV + (16 * j + 8 * n + g) * DS + 2 * t4;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            mma_t<T>(s[n], qf[kk], ld_pair(kr + 16 * kk), ld_pair(kr + 16 * kk + 8));
            mma_t<T>(dpv[n], of[kk], ld_pair(vr + 16 * kk), ld_pair(vr + 16 * kk + 8));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qa[4], oa[4];
          load_a<DS>(qa, qw, kk, g, t4);
          load_a<DS>(oa, ow, kk, g, t4);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const T* kr = sK + (16 * j + 8 * n + g) * DS + 2 * t4 + 16 * kk;
            const T* vr = sV + (16 * j + 8 * n + g) * DS + 2 * t4 + 16 * kk;
            mma_t<T>(s[n], qa, ld_pair(kr), ld_pair(kr + 8));
            mma_t<T>(dpv[n], oa, ld_pair(vr), ld_pair(vr + 8));
          }
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
      const uint32_t da[4] = {pack_t<T>(s[0][0], s[0][1]), pack_t<T>(s[0][2], s[0][3]),
                              pack_t<T>(s[1][0], s[1][1]), pack_t<T>(s[1][2], s[1][3])};
      // dQ += dS K: B = K rows (the 16 keys) x 8 head-dim columns
      const T* kc_ = sK + (16 * j + 2 * t4) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* c = kc_ + 8 * n;
        mma_t<T>(acc[n], da, pack_raw(c[0], c[DS]), pack_raw(c[8 * DS], c[9 * DS]));
      }
    }
  }

  if (!w_live) return;
  const float os = out_scale ? *out_scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row0 + g + 8 * r;
    if (row >= Sq) continue;
    T* out = dq + ((int64_t)bh * Sq + row) * d + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < d)
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_t<T>(acc[n][2 * r] * os, acc[n][2 * r + 1] * os);
  }
}

// --------------------------------------------------------- tensor-core dK/dV
// OC: the head-dim columns of dK and dV a block sums, DP up to 128; at DP =
// 256 two blocks (blockIdx.z) take 128 columns each, each computing the
// whole S^T and dP^T, as a warp's dK and dV of all 256 columns (256 fp32 a
// thread) would not fit in its registers
template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(NT_MMA) flash_bwd_dkv_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int d_arg,
    Strides st, int causal, int window, float scale) {
  constexpr int DS = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int OC = DP <= 128 ? DP : 128;
  constexpr int NO = OC / 8;    // n-tiles of this block's dK and dV columns
  const int d = PAD ? d_arg : DP;  // as flash_fwd_mma_kernel's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);             // [BK][DS]
  T* sV = sK + BK * DS;                               // [BK][DS]
  T* sQ = sV + BK * DS;                               // [BQ][DS]
  T* sDO = sQ + BQ * DS;                              // [BQ][DS]
  float* sL = reinterpret_cast<float*>(sDO + BQ * DS);  // [BQ]
  float* sD = sL + BQ;                                // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.x * BK;  // low tiles have the most q tiles: first
  const int kv_offset = Sk - Sq;
  const int c0 = OC < DP ? OC * blockIdx.z : 0;  // this block's first column
  const T* qp = q + b * st.q_sb + h * st.q_sh;
  const T* op = dout + b * st.o_sb + h * st.o_sh;

  load_tile<DP>(sK, k + b * st.k_sb + kvh * st.k_sh, st.k_ss, k0, Sk, d);
  load_tile<DP>(sV, v + b * st.v_sb + kvh * st.v_sh, st.v_ss, k0, Sk, d);
  // this warp's 16 keys; a warp wholly past Sk computes nothing
  const int w_key0 = k0 + 16 * warp;
  const bool w_live = w_key0 < Sk;
  const T* kw = sK + 16 * warp * DS;
  const T* vw = sV + 16 * warp * DS;
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
    load_tile<DP>(sQ, qp, st.q_ss, q0, Sq, d);
    load_tile<DP>(sDO, op, st.o_ss, q0, Sq, d);
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
          const T* qr = sQ + (16 * c + 8 * n + g) * DS + 16 * kk + 2 * t4;
          const T* orr = sDO + (16 * c + 8 * n + g) * DS + 16 * kk + 2 * t4;
          mma_t<T>(s[n], ka, ld_pair(qr), ld_pair(qr + 8));
          mma_t<T>(dpv[n], va, ld_pair(orr), ld_pair(orr + 8));
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
      const uint32_t pa[4] = {pack_t<T>(pt[0][0], pt[0][1]), pack_t<T>(pt[0][2], pt[0][3]),
                              pack_t<T>(pt[1][0], pt[1][1]), pack_t<T>(pt[1][2], pt[1][3])};
      const uint32_t sa[4] = {pack_t<T>(s[0][0], s[0][1]), pack_t<T>(s[0][2], s[0][3]),
                              pack_t<T>(s[1][0], s[1][1]), pack_t<T>(s[1][2], s[1][3])};
      // dV += P^T dO and dK += dS^T Q: B = 16 q rows x 8 head-dim columns
      const T* oc = sDO + (16 * c + 2 * t4) * DS + g + c0;
      const T* qc = sQ + (16 * c + 2 * t4) * DS + g + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* o_ = oc + 8 * n;
        const T* q_ = qc + 8 * n;
        mma_t<T>(gv[n], pa, pack_raw(o_[0], o_[DS]), pack_raw(o_[8 * DS], o_[9 * DS]));
        mma_t<T>(gk[n], sa, pack_raw(q_[0], q_[DS]), pack_raw(q_[8 * DS], q_[9 * DS]));
      }
    }
  }

  if (!w_live) return;
  const float os = out_scale ? *out_scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w_key0 + g + 8 * r;
    if (key >= Sk) continue;
    const int64_t base = ((int64_t)bh * Sk + key) * d + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (c0 + 8 * n >= d) continue;
      *reinterpret_cast<uint32_t*>(dk + base + 8 * n) =
          pack_t<T>(gk[n][2 * r] * os, gk[n][2 * r + 1] * os);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * n) =
          pack_t<T>(gv[n][2 * r] * os, gv[n][2 * r + 1] * os);
    }
  }
}

// ------------------------------------------------- the wgmma kernels (D = 128)
constexpr int WG_THREADS = 128;
constexpr int W_STAGES = 2;
constexpr int W_HALF64 = 64 * 128;     // bytes of one 64-column half of a 64-row tile
constexpr int W_HALF128 = 128 * 128;   // ... of a 128-row tile
constexpr int W_T64 = 2 * W_HALF64;    // a 64 x 128 tile of bf16 or fp16
constexpr int W_T128 = 2 * W_HALF128;  // a 128 x 128 tile of bf16 or fp16

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

// an m64n64 accumulator rounded to T (bf16 or fp16) as the RS form's A
// operand: k-step s is columns 16 s .. 16 s + 15
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void to_a_operand(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = pack_t<T>(d[8 * s + 2 * i], d[8 * s + 2 * i + 1]);
}

// The q, k, v and dO rows of a launch whose producer copies them itself
// (the D = 100 kernels): bases, and (batch, head, seq) strides of q, k, v and
// dO in elements, in Strides' order.
template <typename T>
struct BwdRows {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  int64_t st[12];
};

// The body of flash_bwd_dkv_wgmma_kernel (bf16, D = 128),
// flash_bwd_dkv_wgmma96_kernel (bf16, D = 96),
// flash_bwd_dkv_wgmma80_kernel (bf16, D = 80),
// flash_bwd_dkv_wgmma100_kernel (bf16, D = 100),
// flash_bwd_dkv_wgmma_f16_kernel (fp16, D = 128),
// flash_bwd_dkv_wgmma96_f16_kernel (fp16, D = 96),
// flash_bwd_dkv_wgmma80_f16_kernel (fp16, D = 80) and
// flash_bwd_dkv_wgmma100_f16_kernel (fp16, D = 100). fp16 differs from bf16
// only in names, as in flash_fwd.cu's fwd_wgmma_body: the wgmma instructions (.f16
// for .bf16), the tensor maps' data type, and the roundings of P^T and dS^T
// (the A operands) and of dK and dV; tiles, swizzle, ring and grid are the
// same. At D = 96 the tiles keep D = 128's
// shared-memory layout, the second box of each row zero-filled by TMA past
// column 96 (every expect_tx counts whole boxes); S^T and dP^T run 6 k-steps
// (the last two in the second half), dV and dK are m64n96k16 sums (48 + 48
// fp32 a thread, not 64 + 64), and the epilogue stores the 96 columns alone.
// D = 80 (StableLM-3B-4E1T's 160-byte rows, which TMA reads) is the same
// body with 5 k-steps, the 5th over the second box's columns 64-79 (80-127
// zero-filled), m64n80k16 sums (40 + 40 fp32 a thread) whose B is the 64-row
// tile's two boxes 8 KB apart, and an epilogue of 80 columns.
// At D = 100 (OpenLLaMA-3B's 200-byte rows, half of a [B, S, H, 100] view's
// heads 8 bytes off a 16-byte boundary) TMA cannot read the rows, and the
// producer warpgroup's 128 threads copy them in 8-byte cp.async pieces into
// the same layout, as flash_fwd.cu's D = 100 kernel: K and V as 128-row
// tiles, and each stage's Q and dO as 64-row tiles in one pass of 25 pieces a
// thread (`cp_async_rows<D, 64>`). Each thread's cp.async.mbarrier.arrive
// .noinc counts one of 128 arrivals, so a stage's barrier waits for 128 + 32
// (the first warp still stages LSE and delta with plain stores and arrives
// after them); columns 100-127 of every tile are zeroed once for the whole
// run, and the consumers fence the generic proxy's writes against wgmma's
// reads after each wait. S^T and dP^T run 7 k-steps (the 7th over columns
// 96-111), dV and dK are m64n104k16 sums (52 + 52 fp32 a thread), whose
// columns 100-103 are not stored. The producer keeps 40 registers for its
// copies (24 under TMA) and the consumers get 232. In fp16 (OpenLLaMA-3B's
// published weights) D = 100 is the same body on a BwdRows<__half>: the
// copies move bytes whatever the element type, and the m64n104k16 sums take
// their f16 form.
// At Phi-3-mini's attention (B=1, H=32, S=2048, D=96, causal) dK/dV does
// ~51.6 GFLOP against ~76 MB, bound by operations (~52 us at 989 TF/s); at
// OpenLLaMA-3B's (D=100) ~53.7 GFLOP, ~54 us; at StableLM-3B-4E1T's (D=80)
// ~43.0 GFLOP against ~63 MB, ~43.4 us. At GPT-NeoX-20B's (fp16, 64 q heads
// over 64 KV heads, S=2048, D=96) ~103 GFLOP against ~152 MB, ~104 us
// (ops/bounds.py), 1024 blocks; at OPT-2.7B's (fp16, 32 heads of 80) as at
// StableLM-3B-4E1T's, ~43.4 us, 512 blocks.
template <typename T, int D>
__device__ __forceinline__ void dkv_wgmma_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const BwdRows<T>& src, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  constexpr int KSTEPS = (D + 15) / 16;  // k-steps of S^T and dP^T
  constexpr int DN = (D + 7) / 8 * 8;    // the sums' width: D rounded up to 8
  constexpr bool COPY = D % 8 != 0;      // rows TMA cannot read: cp.async
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
    const uint32_t fills = COPY ? WG_THREADS : 1;  // arrivals that fill a tile
    mbar_init(full_kv, fills);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], fills + 32);  // the fill, and the 32 lanes staging LSE/delta
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  if constexpr (COPY) {
    zero_cols_past<D>(sK, threadIdx.x, blockDim.x);
    zero_cols_past<D>(sV, threadIdx.x, blockDim.x);
    for (int t = 0; t < 2 * W_STAGES; ++t)
      zero_cols_past<D, 64>(smem + DKV_Q + W_T64 * t, threadIdx.x, blockDim.x);
    fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: lane 0 issues every TMA load, or all 128 copy; the
    // first warp stages LSE and delta with plain loads
    setmaxnreg_dec<COPY ? 40 : 24>();
    if constexpr (COPY) {
      const int p = threadIdx.x;
      const int64_t* st = src.st;
      cp_async_rows<D>(sK, src.k + b * st[3] + kvh * st[4], st[5], k0, Sk, p);
      cp_async_rows<D>(sV, src.v + b * st[6] + kvh * st[7], st[8], k0, Sk, p);
      cp_async_arrive_noinc(full_kv);
      const T* qp = src.q + b * st[0] + h * st[1];
      const T* dop = src.dout + b * st[9] + h * st[10];
      const float* lse_bh = lse + (int64_t)bh * Sq;
      const float* delta_bh = delta + (int64_t)bh * Sq;
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        const int q0 = t * 64;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sQ = smem + DKV_Q + DKV_STAGE * s;
        cp_async_rows<D, 64>(sQ, qp, st[2], q0, Sq, p, sQ + W_T64, dop, st[11]);
        cp_async_arrive_noinc(&full[s]);
        if (p < 32) {
          // rows past Sq get 0 here and are masked by the consumers
          float* sts = stats + 128 * s;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = p + 32 * half;
            const bool in = q0 + r < Sq;
            sts[r] = in ? lse_bh[q0 + r] * LOG2E : 0.f;
            sts[64 + r] = in ? delta_bh[q0 + r] * scale : 0.f;
          }
          mbar_arrive(&full[s]);
        }
      }
      cp_async_wait_all();
    } else if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(full_kv, 2 * W_T128);
        tma_load_4d(sK, tm_k, full_kv, 0, k0, kvh, b);
        tma_load_4d(sK + W_HALF128, tm_k, full_kv, 64, k0, kvh, b);
        tma_load_4d(sV, tm_v, full_kv, 0, k0, kvh, b);
        tma_load_4d(sV + W_HALF128, tm_v, full_kv, 64, k0, kvh, b);
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
          tma_load_4d(sQ, tm_q, &full[s], 0, q0, h, b);
          tma_load_4d(sQ + W_HALF64, tm_q, &full[s], 64, q0, h, b);
          tma_load_4d(sQ + W_T64, tm_do, &full[s], 0, q0, h, b);
          tma_load_4d(sQ + W_T64 + W_HALF64, tm_do, &full[s], 64, q0, h, b);
        }
        // rows past Sq get 0 here and are masked by the consumers
        float* st = stats + 128 * s;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          const bool in = q0 + r < Sq;
          st[r] = in ? lse_bh[q0 + r] * LOG2E : 0.f;
          st[64 + r] = in ? delta_bh[q0 + r] * scale : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<COPY ? 232 : 240>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_key0 = k0 + 64 * cw;
    const bool w_live = w_key0 < Sk;
    const int key0 = w_key0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const float c = scale * LOG2E;  // raw score -> log2 units
    float gk[DN / 2], gv[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) gk[i] = gv[i] = 0.f;
    const uint64_t da_k = desc_kmajor(sK + 64 * 128 * cw);
    const uint64_t da_v = desc_kmajor(sV + 64 * 128 * cw);

    // a tile the producer copied is read by wgmma only after this fence
    mbar_wait(full_kv, 0);
    if constexpr (COPY) fence_proxy_async();
    for (int t = first, i = 0; t < last; ++t, ++i) {
      const int s = i % W_STAGES;
      const int q0 = t * 64;
      const int p_first = kv_offset + q0;
      const int p_last = kv_offset + min(q0 + 63, Sq - 1);
      mbar_wait(&full[s], (i / W_STAGES) & 1);
      if constexpr (COPY) fence_proxy_async();
      // a tile masked for every key of this warpgroup is only released
      if (!w_live || (causal && (w_key0 > p_last ||
                                 (window > 0 && w_key0 + 63 <= p_first - window)))) {
        mbar_arrive(&empty[s]);
        continue;
      }
      unsigned char* sQ = smem + DKV_Q + DKV_STAGE * s;
      unsigned char* sDO = sQ + W_T64;

      // S^T = K Q^T and dP^T = V dO^T, D / 16 k-steps of 16 head dims each
      float sc[32], dp[32];
      const uint64_t db_q = desc_kmajor(sQ), db_o = desc_kmajor(sDO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(sc, da_k + kstep(kk, W_HALF128),
                                    db_q + kstep(kk, W_HALF64), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(dp, da_v + kstep(kk, W_HALF128),
                                    db_o + kstep(kk, W_HALF64), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T, rounded to T as the A operands k-step by k-step (16
      // q rows), so that each step's fp32 values die at once;
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
          dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -((e & 1) ? dl.y : dl.x));
        }
      }
      uint32_t pa[4][4], sa[4][4];
      to_a_operand<T>(sc, pa);
      to_a_operand<T>(dp, sa);

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
        wgmma_rs<DN, 1, T>(gv, pa[k4], db_o_mn + ((k4 * 2048) >> 4), 1);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_rs<DN, 1, T>(gk, sa[k4], db_q_mn + ((k4 * 2048) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
      mbar_arrive(&empty[s]);
    }

    // dK and dV in T (times *out_scale), one copy per q head; gk[4 j + e]
    // is key key0 + 8 (e / 2), head dim 8 j + 2 t4 + (e % 2) (at D = 100
    // the last n-tile's columns 100-103 are not stored)
    if (w_live) {
      const float os = out_scale ? *out_scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t base = ((int64_t)bh * Sk + key) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          if (D % 8 != 0 && 8 * j + 2 * t4 >= D) continue;
          *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
              pack_t<T>(gk[4 * j + 2 * r] * os, gk[4 * j + 2 * r + 1] * os);
          *reinterpret_cast<uint32_t*>(dv + base + 8 * j) =
              pack_t<T>(gv[4 * j + 2 * r] * os, gv[4 * j + 2 * r + 1] * os);
        }
      }
    }
  }
}

// the TMA-fed dK/dV kernels: dkv_wgmma_body over maps of (T, D)
#define BWD_DKV_WGMMA_KERNEL(NAME, T, D)                                                   \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                               \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,  \
      T* __restrict__ dv, const float* __restrict__ out_scale, int H, int KvH, int Sq,     \
      int Sk, int causal, int window, float scale) {                                       \
    dkv_wgmma_body<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, BwdRows<T>{}, lse, delta, dk, dv,     \
                         out_scale, H, KvH, Sq, Sk, causal, window, scale);                \
  }
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma_kernel, __nv_bfloat16, 128)
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma96_kernel, __nv_bfloat16, 96)
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma80_kernel, __nv_bfloat16, 80)
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma_f16_kernel, __half, 128)
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma96_f16_kernel, __half, 96)
BWD_DKV_WGMMA_KERNEL(flash_bwd_dkv_wgmma80_f16_kernel, __half, 80)
#undef BWD_DKV_WGMMA_KERNEL

// the D = 100 dK/dV kernels, whose producers copy the rows themselves
__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dkv_wgmma100_kernel(
    const __grid_constant__ BwdRows<__nv_bfloat16> src, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const float* __restrict__ out_scale, int H, int KvH,
    int Sq, int Sk, int causal, int window, float scale) {
  dkv_wgmma_body<__nv_bfloat16, 100>(nullptr, nullptr, nullptr, nullptr, src, lse, delta, dk,
                                     dv, out_scale, H, KvH, Sq, Sk, causal, window, scale);
}

__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dkv_wgmma100_f16_kernel(
    const __grid_constant__ BwdRows<__half> src, const float* __restrict__ lse,
    const float* __restrict__ delta, __half* __restrict__ dk, __half* __restrict__ dv,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  dkv_wgmma_body<__half, 100>(nullptr, nullptr, nullptr, nullptr, src, lse, delta, dk, dv,
                              out_scale, H, KvH, Sq, Sk, causal, window, scale);
}

// ---- the dK/dV wgmma kernels at head dim 64 (bf16 and fp16)
// A 64-column bf16 or fp16 row is one 128-byte swizzle box, so every tile is
// one TMA box and each product has 4 k-steps of 16 head dims; the sums dK
// and dV are m64n64 (32 floats a thread each). With the registers that
// frees, a block keeps 192 keys in three consumer warpgroups (64 keys and
// 160 registers each) against Q and dO tiles of 64 rows, so that the tensor
// cores have two warpgroups' products to run while the third forms P and
// dS. Each warpgroup takes its steps in order, as the D = 128 kernel does:
// issuing the next tile's score products before this tile's sums needs
// more registers than 160, and at two warpgroups it was slower than three
// (PERF.md). A stage of Q and dO is 16 KB, so the ring holds four.
// At bench_mfu's d1024 shape (B=8, H=16, S=2048, causal) the work is ~137
// GFLOP against ~203 MB, bound by operations (~139 us at 989 TF/s); at
// OPT-1.3B's attention (B=1, H=32, S=2048, causal, fp16) ~34.4 GFLOP against
// ~51 MB, ~35 us.
constexpr int K64_STAGES = 4;
constexpr int K64_CONS = 3;                    // consumer warpgroups
constexpr int K64_KEYS = 64 * K64_CONS;        // keys per block
constexpr int K64_TILE = 64 * 128;             // bytes of a 64-row tile of 64 bf16 or fp16 columns
constexpr int K64_Q = 2 * K64_CONS * K64_TILE;  // K and V
constexpr int K64_STAGE = 2 * K64_TILE;        // Q and dO
constexpr int K64_STATS = K64_Q + K64_STAGES * K64_STAGE;
constexpr int K64_BARS = K64_STATS + K64_STAGES * 128 * 4;
constexpr int K64_SMEM = K64_BARS + 8 * (1 + 2 * K64_STAGES) + 1024;  // + alignment slack

// The body of flash_bwd_dkv_wgmma64_kernel (bf16) and
// flash_bwd_dkv_wgmma64_f16_kernel (fp16: OPT-1.3B's published dtype). fp16
// differs from bf16 only in names, as dkv_wgmma_body's: the wgmma
// instructions (.f16 for .bf16), the tensor maps' data type and the
// roundings of P^T and dS^T (the A operands) and of dK and dV, which in
// fp16 are first multiplied by *out_scale (the cotangent scale's inverse;
// bf16 takes none).
template <typename T>
__device__ __forceinline__ void dkv_wgmma64_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + K64_CONS * K64_TILE;
  float* stats = reinterpret_cast<float*>(smem + K64_STATS);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + K64_BARS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + K64_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.y * K64_KEYS;  // low key blocks have the most q tiles: first
  int first, last;
  q_tiles(k0, K64_KEYS, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < K64_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx, and the 32 lanes staging LSE/delta
      mbar_init(&empty[s], K64_CONS * WG_THREADS);
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
        mbar_arrive_expect_tx(full_kv, K64_Q);
        tma_load_4d(sK, tm_k, full_kv, 0, k0, kvh, b);
        tma_load_4d(sV, tm_v, full_kv, 0, k0, kvh, b);
      }
      const float* lse_bh = lse + (int64_t)bh * Sq;
      const float* delta_bh = delta + (int64_t)bh * Sq;
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % K64_STAGES;
        const int q0 = t * 64;
        mbar_wait(&empty[s], ((i / K64_STAGES) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* sQ = smem + K64_Q + K64_STAGE * s;
          mbar_arrive_expect_tx(&full[s], K64_STAGE);
          tma_load_4d(sQ, tm_q, &full[s], 0, q0, h, b);
          tma_load_4d(sQ + K64_TILE, tm_do, &full[s], 0, q0, h, b);
        }
        // rows past Sq get 0 here and are masked by the consumers
        float* st = stats + 128 * s;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          const bool in = q0 + r < Sq;
          st[r] = in ? lse_bh[q0 + r] * LOG2E : 0.f;
          st[64 + r] = in ? delta_bh[q0 + r] * scale : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<160>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_key0 = k0 + 64 * cw;
    const bool w_live = w_key0 < Sk;
    const int key0 = w_key0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const float c = scale * LOG2E;  // raw score -> log2 units
    float gk[32], gv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;
    const uint64_t da_k = desc_kmajor(sK + K64_TILE * cw);
    const uint64_t da_v = desc_kmajor(sV + K64_TILE * cw);

    // the q tiles this warpgroup sees are [lo, hi): the masked ones are a
    // prefix (before the diagonal) and a suffix (past the window), which it
    // only releases, in loops of their own, as the forward does
    auto sees = [&](int t) {
      const int p_first = kv_offset + t * 64;
      const int p_last = kv_offset + min(t * 64 + 63, Sq - 1);
      return w_live && !(causal && (w_key0 > p_last ||
                                    (window > 0 && w_key0 + 63 <= p_first - window)));
    };
    int lo = first;
    while (lo < last && !sees(lo)) ++lo;
    int hi = lo;
    while (hi < last && sees(hi)) ++hi;
    auto release = [&](int t) {
      const int i = t - first;
      mbar_wait(&full[i % K64_STAGES], (i / K64_STAGES) & 1);
      mbar_arrive(&empty[i % K64_STAGES]);
    };
    for (int t = first; t < lo; ++t) release(t);

    mbar_wait(full_kv, 0);
    for (int t = lo; t < hi; ++t) {
      const int i = t - first, s = i % K64_STAGES;
      const int q0 = t * 64;
      const int p_first = kv_offset + q0;
      const int p_last = kv_offset + min(q0 + 63, Sq - 1);
      mbar_wait(&full[s], (i / K64_STAGES) & 1);
      unsigned char* sQ = smem + K64_Q + K64_STAGE * s;
      unsigned char* sDO = sQ + K64_TILE;

      // S^T = K Q^T and dP^T = V dO^T, 4 k-steps of 16 head dims each
      float sc[32], dp[32];
      const uint64_t db_q = desc_kmajor(sQ), db_o = desc_kmajor(sDO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(sc, da_k + 2 * kk, db_q + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(dp, da_v + 2 * kk, db_o + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T, as in flash_bwd_dkv_wgmma_kernel; element
      // 4 j + e is key key0 + 8 (e / 2), q row q0 + 8 j + 2 t4 + (e % 2)
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
          dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -((e & 1) ? dl.y : dl.x));
        }
      }
      uint32_t pa[4][4], sa[4][4];
      to_a_operand<T>(sc, pa);
      to_a_operand<T>(dp, sa);

      // dV += P^T dO and dK += dS^T Q: dO and Q are MN-major B operands
      // (head_dim contiguous), a k-step of 16 q rows 2048 bytes
      const uint64_t db_o_mn = desc_mnmajor(sDO, K64_TILE);
      const uint64_t db_q_mn = desc_mnmajor(sQ, K64_TILE);
      fence_regs(gv);
      fence_regs(gk);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n64k16_rs<1, T>(gv, pa[k4], db_o_mn + k4 * 128, 1);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n64k16_rs<1, T>(gk, sa[k4], db_q_mn + k4 * 128, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);
      fence_regs(gk);
      mbar_arrive(&empty[s]);
    }
    for (int t = hi; t < last; ++t) release(t);

    // dK and dV in T (in fp16 times *out_scale), one copy per q head; gk[4
    // j + e] is key key0 + 8 (e / 2), head dim 8 j + 2 t4 + (e % 2)
    if (w_live) {
      float os = 1.f;
      if constexpr (std::is_same<T, __half>::value) os = out_scale ? *out_scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= Sk) continue;
        const int64_t base = ((int64_t)bh * Sk + key) * 64 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + base + 8 * j) =
              pack_t<T>(gk[4 * j + 2 * r] * os, gk[4 * j + 2 * r + 1] * os);
          *reinterpret_cast<uint32_t*>(dv + base + 8 * j) =
              pack_t<T>(gv[4 * j + 2 * r] * os, gv[4 * j + 2 * r + 1] * os);
        }
      }
    }
  }
}

#define BWD_DKV64_KERNEL(NAME, T)                                                          \
  __global__ void __launch_bounds__((K64_CONS + 1) * WG_THREADS, 1) NAME(                  \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,  \
      T* __restrict__ dv, const float* __restrict__ out_scale, int H, int KvH, int Sq,     \
      int Sk, int causal, int window, float scale) {                                       \
    dkv_wgmma64_body<T>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, out_scale, H, KvH, \
                        Sq, Sk, causal, window, scale);                                    \
  }
BWD_DKV64_KERNEL(flash_bwd_dkv_wgmma64_kernel, __nv_bfloat16)
BWD_DKV64_KERNEL(flash_bwd_dkv_wgmma64_f16_kernel, __half)
#undef BWD_DKV64_KERNEL

// The body of flash_bwd_dq_wgmma_kernel (bf16, D = 128),
// flash_bwd_dq_wgmma96_kernel (bf16, D = 96), flash_bwd_dq_wgmma80_kernel
// (bf16, D = 80), flash_bwd_dq_wgmma100_kernel (bf16, D = 100),
// flash_bwd_dq_wgmma_f16_kernel (fp16, D = 128),
// flash_bwd_dq_wgmma96_f16_kernel (fp16, D = 96),
// flash_bwd_dq_wgmma80_f16_kernel (fp16, D = 80) and
// flash_bwd_dq_wgmma100_f16_kernel (fp16, D = 100), as dkv_wgmma_body (in fp16
// dS and dQ round to fp16): at D = 96 the tiles keep D = 128's shared-memory
// layout and grid, the second box of each row zero-filled by TMA past column
// 96 (every expect_tx counts whole boxes); S and dP run 6 k-steps (the last
// two in the second half), dQ is an m64n96k16 sum (48 fp32 a thread, not 64)
// with K the n96 MN-major B, and the epilogue stores the 96 columns alone;
// at D = 80 likewise with 5 k-steps, an m64n80k16 sum (40 fp32 a thread, K's
// columns 64-79 the second box's first 16) and 80 columns. At D = 100 the
// producer warpgroup copies the rows with cp.async, as dkv_wgmma_body's: Q
// and dO as 128-row tiles, each stage's K and V as 64-row tiles in one pass;
// a stage's barrier waits for the 128 copying threads; S and dP run 7 k-steps
// and dQ is an m64n104k16 sum (52 fp32 a thread), K the n104 MN-major B,
// whose columns 100-103 are not stored. At Phi-3-mini's attention (B=1,
// H=32, S=2048, D=96, causal) dQ does ~38.7 GFLOP against ~63 MB, bound by
// operations (~39 us at 989 TF/s); at OpenLLaMA-3B's (D=100) ~40.3 GFLOP,
// ~41 us; at StableLM-3B-4E1T's (D=80) ~32.2 GFLOP against ~53 MB, ~32.6 us;
// at GPT-NeoX-20B's (fp16, 64 heads of 96) ~77.3 GFLOP against ~126 MB,
// ~78 us (ops/bounds.py), 1024 blocks; at OPT-2.7B's (fp16, 32 heads of 80)
// as at StableLM-3B-4E1T's, ~32.6 us, 512 blocks.
template <typename T, int D>
__device__ __forceinline__ void dq_wgmma_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const BwdRows<T>& src, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH,
    int Sq, int Sk, int causal, int window, float scale) {
  using namespace hopper;
  constexpr int KSTEPS = (D + 15) / 16;  // k-steps of S and dP
  constexpr int DN = (D + 7) / 8 * 8;    // dQ's width: D rounded up to 8
  constexpr bool COPY = D % 8 != 0;      // rows TMA cannot read: cp.async
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
    const uint32_t fills = COPY ? WG_THREADS : 1;  // arrivals that fill a tile
    mbar_init(full_q, fills);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  if constexpr (COPY) {
    zero_cols_past<D>(sQ, threadIdx.x, blockDim.x);
    zero_cols_past<D>(sDO, threadIdx.x, blockDim.x);
    for (int t = 0; t < 2 * W_STAGES; ++t)
      zero_cols_past<D, 64>(smem + DQ_K + W_T64 * t, threadIdx.x, blockDim.x);
    fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load, or all 128 copy
    setmaxnreg_dec<COPY ? 40 : 24>();
    if constexpr (COPY) {
      const int p = threadIdx.x;
      const int64_t* st = src.st;
      cp_async_rows<D>(sQ, src.q + b * st[0] + h * st[1], st[2], q0, Sq, p);
      cp_async_rows<D>(sDO, src.dout + b * st[9] + h * st[10], st[11], q0, Sq, p);
      cp_async_arrive_noinc(full_q);
      const T* kp = src.k + b * st[3] + kvh * st[4];
      const T* vp = src.v + b * st[6] + kvh * st[7];
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + DQ_K + DQ_STAGE * s;
        cp_async_rows<D, 64>(sK, kp, st[5], t * 64, Sk, p, sK + W_T64, vp, st[8]);
        cp_async_arrive_noinc(&full[s]);
      }
      cp_async_wait_all();
    } else if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, 2 * W_T128);
      tma_load_4d(sQ, tm_q, full_q, 0, q0, h, b);
      tma_load_4d(sQ + W_HALF128, tm_q, full_q, 64, q0, h, b);
      tma_load_4d(sDO, tm_do, full_q, 0, q0, h, b);
      tma_load_4d(sDO + W_HALF128, tm_do, full_q, 64, q0, h, b);
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + DQ_K + DQ_STAGE * s;
        mbar_arrive_expect_tx(&full[s], 2 * W_T64);
        tma_load_4d(sK, tm_k, &full[s], 0, t * 64, kvh, b);
        tma_load_4d(sK + W_HALF64, tm_k, &full[s], 64, t * 64, kvh, b);
        tma_load_4d(sK + W_T64, tm_v, &full[s], 0, t * 64, kvh, b);
        tma_load_4d(sK + W_T64 + W_HALF64, tm_v, &full[s], 64, t * 64, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<COPY ? 232 : 240>();
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
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] * scale : 0.f;
    }
    float acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
    const uint64_t da_q = desc_kmajor(sQ + 64 * 128 * cw);
    const uint64_t da_o = desc_kmajor(sDO + 64 * 128 * cw);

    // a tile the producer copied is read by wgmma only after this fence
    mbar_wait(full_q, 0);
    if constexpr (COPY) fence_proxy_async();
    for (int t = first, i = 0; t < last; ++t, ++i) {
      const int s = i % W_STAGES;
      const int k0 = t * 64;
      mbar_wait(&full[s], (i / W_STAGES) & 1);
      if constexpr (COPY) fence_proxy_async();
      // a tile masked for every row of this warpgroup is only released
      if (!w_live || (causal && (k0 > w_last ||
                                 (window > 0 && k0 + 63 <= w_first - window)))) {
        mbar_arrive(&empty[s]);
        continue;
      }
      unsigned char* sK = smem + DQ_K + DQ_STAGE * s;
      unsigned char* sV = sK + W_T64;

      // S = Q K^T and dP = dO V^T, D / 16 k-steps of 16 head dims each
      float sc[32], dp[32];
      const uint64_t db_k = desc_kmajor(sK), db_v = desc_kmajor(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(sc, da_q + kstep(kk, W_HALF128),
                                    db_k + kstep(kk, W_HALF64), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(dp, da_o + kstep(kk, W_HALF128),
                                    db_v + kstep(kk, W_HALF64), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS; element 4 j + e is row row0 + 8 (e / 2), key k0 + 8 j + 2 t4 +
      // (e % 2)
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
          dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -dl[e >> 1]);
        }
      }
      uint32_t sa[4][4];
      to_a_operand<T>(dp, sa);

      // dQ += dS K: K [keys][head_dim] as an MN-major B operand (n96 at D =
      // 96: its columns 64-95 the second half's first 32; n80 at 80, n104 at
      // 100)
      const uint64_t db_k_mn = desc_mnmajor(sK, W_HALF64);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_rs<DN, 1, T>(acc, sa[k4], db_k_mn + ((k4 * 2048) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    if (w_live) {
      const float qs = out_scale ? *out_scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        T* out = dq + ((int64_t)bh * Sq + row) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j)
          if (D % 8 == 0 || 8 * j + 2 * t4 < D)
            *reinterpret_cast<uint32_t*>(out + 8 * j) =
                pack_t<T>(acc[4 * j + 2 * r] * qs, acc[4 * j + 2 * r + 1] * qs);
      }
    }
  }
}

// the TMA-fed dQ kernels: dq_wgmma_body over maps of (T, D)
#define BWD_DQ_WGMMA_KERNEL(NAME, T, D)                                                    \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                               \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,  \
      const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,     \
      int window, float scale) {                                                           \
    dq_wgmma_body<T, D>(&tm_q, &tm_k, &tm_v, &tm_do, BwdRows<T>{}, lse, delta, dq,          \
                        out_scale, H, KvH, Sq, Sk, causal, window, scale);                 \
  }
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma_kernel, __nv_bfloat16, 128)
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma96_kernel, __nv_bfloat16, 96)
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma80_kernel, __nv_bfloat16, 80)
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma_f16_kernel, __half, 128)
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma96_f16_kernel, __half, 96)
BWD_DQ_WGMMA_KERNEL(flash_bwd_dq_wgmma80_f16_kernel, __half, 80)
#undef BWD_DQ_WGMMA_KERNEL

// the D = 100 dQ kernels, whose producers copy the rows themselves
__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dq_wgmma100_kernel(
    const __grid_constant__ BwdRows<__nv_bfloat16> src, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  dq_wgmma_body<__nv_bfloat16, 100>(nullptr, nullptr, nullptr, nullptr, src, lse, delta, dq,
                                    out_scale, H, KvH, Sq, Sk, causal, window, scale);
}

__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_bwd_dq_wgmma100_f16_kernel(
    const __grid_constant__ BwdRows<__half> src, const float* __restrict__ lse,
    const float* __restrict__ delta, __half* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  dq_wgmma_body<__half, 100>(nullptr, nullptr, nullptr, nullptr, src, lse, delta, dq,
                             out_scale, H, KvH, Sq, Sk, causal, window, scale);
}

// ---- the dQ wgmma kernels at head dim 64 (bf16 and fp16)
// The dK/dV kernel's plan with the sides swapped: a block is one (b, q head)
// and 192 q rows in three consumer warpgroups of 64 rows at 160 registers;
// their Q and dO (one 128-byte swizzle box a row) arrive once, and K and V
// tiles of 64 keys (16 KB a stage) stream through a ring of four. Per tile
// a warpgroup issues S = Q K^T and dP = dO V^T (SS m64n64k16, 4 k-steps
// each) as two groups, forms P from S while dP is computed, then dS, and
// adds dS K into its m64n64 sum (RS m64n64k16, K the MN-major B) before
// the next tile: the sum, S and dP are 96 floats a thread, and leaving the
// dS K product in flight over the next tile's barrier wait made ptxas
// serialise the wgmma (PERF.md). The producer streams the union of the three
// warpgroups' key ranges (their diagonals, and window starts, differ by
// one tile); each warpgroup releases the tiles outside its own range in
// loops of their own. The grid puts every head's last q blocks, which
// reach the most keys, first. At bench_mfu's d1024 shape (B=8, H=16,
// S=2048, causal) the work is ~103 GFLOP against ~170 MB, bound by
// operations (~104 us at 989 TF/s); at OPT-1.3B's attention (B=1, H=32,
// S=2048, causal, fp16) ~25.8 GFLOP against ~42 MB, ~26 us.
constexpr int Q64_STAGES = 4;
constexpr int Q64_CONS = 3;                      // consumer warpgroups
constexpr int Q64_ROWS = 64 * Q64_CONS;          // q rows per block
constexpr int Q64_Q = 2 * Q64_CONS * K64_TILE;   // Q and dO
constexpr int Q64_STAGE = 2 * K64_TILE;          // K and V
constexpr int Q64_BARS = Q64_Q + Q64_STAGES * Q64_STAGE;
constexpr int Q64_SMEM = Q64_BARS + 8 * (1 + 2 * Q64_STAGES) + 1024;  // + alignment slack

// The body of flash_bwd_dq_wgmma64_kernel (bf16) and
// flash_bwd_dq_wgmma64_f16_kernel (fp16), as dkv_wgmma64_body's: in fp16 dS
// and dQ round to fp16, dQ first multiplied by *out_scale.
template <typename T>
__device__ __forceinline__ void dq_wgmma64_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + Q64_CONS * K64_TILE;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + Q64_BARS);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + Q64_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * Q64_ROWS;
  int first, last;
  key_tiles(q0, Q64_ROWS, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < Q64_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Q64_CONS * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, Q64_Q);
      tma_load_4d(sQ, tm_q, full_q, 0, q0, h, b);
      tma_load_4d(sDO, tm_do, full_q, 0, q0, h, b);
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % Q64_STAGES;
        mbar_wait(&empty[s], ((i / Q64_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + Q64_Q + Q64_STAGE * s;
        mbar_arrive_expect_tx(&full[s], Q64_STAGE);
        tma_load_4d(sK, tm_k, &full[s], 0, t * 64, kvh, b);
        tma_load_4d(sK + K64_TILE, tm_v, &full[s], 0, t * 64, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<160>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_row0 = q0 + 64 * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + 63, Sq - 1);
    const int row0 = w_row0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const float c = scale * LOG2E;            // raw score -> log2 units
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      l2[r] = row < Sq ? lse[(int64_t)bh * Sq + row] * LOG2E : 0.f;
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] * scale : 0.f;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const uint64_t da_q = desc_kmajor(sQ + K64_TILE * cw);
    const uint64_t da_o = desc_kmajor(sDO + K64_TILE * cw);

    // the key tiles this warpgroup sees are [lo, hi): the masked ones are a
    // prefix (before the window) and a suffix (past the diagonal), which it
    // only releases
    auto sees = [&](int t) {
      const int k0 = t * 64;
      return w_live && !(causal && (k0 > w_last ||
                                    (window > 0 && k0 + 63 <= w_first - window)));
    };
    int lo = first;
    while (lo < last && !sees(lo)) ++lo;
    int hi = lo;
    while (hi < last && sees(hi)) ++hi;
    auto release = [&](int t) {
      const int i = t - first;
      mbar_wait(&full[i % Q64_STAGES], (i / Q64_STAGES) & 1);
      mbar_arrive(&empty[i % Q64_STAGES]);
    };
    for (int t = first; t < lo; ++t) release(t);

    mbar_wait(full_q, 0);
    for (int t = lo; t < hi; ++t) {
      const int i = t - first, s = i % Q64_STAGES;
      const int k0 = t * 64;
      mbar_wait(&full[s], (i / Q64_STAGES) & 1);
      unsigned char* sK = smem + Q64_Q + Q64_STAGE * s;
      unsigned char* sV = sK + K64_TILE;

      // S = Q K^T and dP = dO V^T, 4 k-steps of 16 head dims each, in two
      // groups: P is formed while dP is computed
      float sc[32], dp[32];
      const uint64_t db_k = desc_kmajor(sK), db_v = desc_kmajor(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(sc, da_q + 2 * kk, db_k + 2 * kk, kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(dp, da_o + 2 * kk, db_v + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P, then dS; element 4 j + e is row row0 + 8 (e / 2), key
      // k0 + 8 j + 2 t4 + (e % 2)
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
          sc[4 * j + e] = exp2_ftz(fmaf(x, c, -l2[e >> 1]));
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * fmaf(dp[4 * j + e], scale, -dl[e >> 1]);
      uint32_t sa[4][4];
      to_a_operand<T>(dp, sa);

      // dQ += dS K: K [keys][64] as an MN-major B operand, a k-step of 16
      // keys 2048 bytes
      const uint64_t db_k_mn = desc_mnmajor(sK, K64_TILE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
        wgmma_m64n64k16_rs<1, T>(acc, sa[k4], db_k_mn + k4 * 128, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
    for (int t = hi; t < last; ++t) release(t);

    // dQ in T (in fp16 times *out_scale); acc[4 j + e] is row row0 + 8 (e /
    // 2), head dim 8 j + 2 t4 + (e % 2)
    if (w_live) {
      float ks = 1.f;
      if constexpr (std::is_same<T, __half>::value) ks = out_scale ? *out_scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= Sq) continue;
        T* out = dq + ((int64_t)bh * Sq + row) * 64 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_t<T>(acc[4 * j + 2 * r] * ks, acc[4 * j + 2 * r + 1] * ks);
      }
    }
  }
}

#define BWD_DQ64_KERNEL(NAME, T)                                                           \
  __global__ void __launch_bounds__((Q64_CONS + 1) * WG_THREADS, 1) NAME(                  \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,  \
      const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,     \
      int window, float scale) {                                                           \
    dq_wgmma64_body<T>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, out_scale, H, KvH, Sq,  \
                       Sk, causal, window, scale);                                         \
  }
BWD_DQ64_KERNEL(flash_bwd_dq_wgmma64_kernel, __nv_bfloat16)
BWD_DQ64_KERNEL(flash_bwd_dq_wgmma64_f16_kernel, __half)
#undef BWD_DQ64_KERNEL

// ---- the dQ and dK/dV wgmma kernels at head dim 256 (bf16: Gemma's attention;
// fp16: GPT-J-6B's)
// A 256-wide row is four 128-byte boxes, so a 64-row tile is 32 KB and the
// D = 128 plans fit neither shared memory nor registers: 128 resident rows
// (64 KB a tile) beside two stages of 64 streamed rows of two tiles (128
// KB) pass the 227 KB, and a warpgroup's dK and dV sums of all 256 columns
// would be 256 fp32 a thread. Here every tile is 64 rows: the block's own
// pair (K and V, or Q and dO) takes 64 KB and two stages of the streamed
// pair 128 KB. Products over the head dim (S, dP and their transposes) are
// 16 SS m64n64k16 k-steps, four in each box of both 64-row operands, whose
// boxes lie 8 KB apart (`scores256`); the sums over 256 columns are two RS
// m64n128k16 products a k-step over the MN-major streamed tile's column
// halves, boxes 0-1 and 2-3 (`sum256`), as flash_fwd_wgmma256_kernel's P V.
// Both kernels keep every sum in one warpgroup's registers (128 fp32 a
// thread beside the two 32-float score tiles) and split the work between
// their two consumer warpgroups without adding to it:
// - flash_bwd_dkv_wgmma256_kernel: a block is one (b, q head) and 64 keys.
//   Warpgroup 1 computes S^T = K Q^T, forms P^T and adds dV += P^T dO;
//   warpgroup 2 computes dP^T = V dO^T, forms dS^T from the P^T that
//   warpgroup 1 hands it through shared memory (16 KB of fp32, each
//   thread's 32 values at the same place for the thread of the other
//   warpgroup that holds the same elements; a "full" and an "empty"
//   mbarrier a tile) and adds dK += dS^T Q. Four 64 x 64 x 256 products a
//   tile, where splitting dK's and dV's columns would recompute S^T and
//   dP^T in both warpgroups (six) and one warpgroup a sum each with S^T in
//   both five. Q and dO of 64 rows stream through two stages with their
//   LSE and delta, as in dkv_wgmma_body.
// - flash_bwd_dq_wgmma256_kernel: a block is one (b, q head) and 64 q rows.
//   Both consumer warpgroups hold the same rows and take alternate key
//   tiles, each stage its own warpgroup's (the producer's warps 0 and 1
//   feed one stage each), each with its own dQ sum; at the end the second
//   adds its sum to the first's through its stage's shared memory, in one
//   order, so the bits repeat. S = Q K^T, dP = dO V^T, dQ += dS K with K
//   the MN-major B.
// Grids of 64 rows give Gemma-2B's attention (B=1, 8 q heads, S=2048) 256
// blocks, two per SM and a tail, where 128-row blocks would be one wave
// that its longest block sets (PERF.md: the forward's d=256 finding); the
// longest blocks go first. There dQ does ~25.8 GFLOP against ~12 MB and
// dK/dV ~34.4 GFLOP against ~26 MB, bound by operations (~26 and ~35 us at
// 989 TF/s). At GPT-J-6B's (fp16, 16 q heads over 16 KV heads, S=2048) dQ
// does ~51.6 GFLOP against ~84 MB and dK/dV ~68.8 GFLOP against ~101 MB,
// ~52 and ~70 us (ops/bounds.py), 512 blocks each. fp16 differs from bf16
// only in the wgmma forms' element type, the maps' data type and the
// roundings of P^T and dS (as operands) and of the outputs, which are
// multiplied by *out_scale first, as in dq_wgmma_body; the bf16 kernels are
// the bodies' <__nv_bfloat16> instances.
constexpr int W256_BOX = 64 * 128;         // bytes of one 64-column box of a 64-row tile
constexpr int W256_TILE = 4 * W256_BOX;    // a 64 x 256 tile of 2-byte elements, 32 KB
constexpr int W256_PAIR = 2 * W256_TILE;   // the block's own pair, and a stage's
// dK/dV: K, V, then per stage Q and dO, then per stage LSE (log2 units) and
// delta (64 fp32 each), then P^T's hand-over (64 x 64 fp32), then the
// barriers (K/V full, the stages' full and empty, P^T's full and empty)
constexpr int DKV256_STATS = W256_PAIR + W_STAGES * W256_PAIR;
constexpr int DKV256_XCHG = DKV256_STATS + W_STAGES * 128 * 4;
constexpr int DKV256_BARS = DKV256_XCHG + 64 * 64 * 4;
constexpr int DKV256_SMEM = DKV256_BARS + 8 * (3 + 2 * W_STAGES) + 1024;  // + alignment slack
// dQ: Q, dO, then per stage K and V, then the barriers
constexpr int DQ256_BARS = W256_PAIR + W_STAGES * W256_PAIR;
constexpr int DQ256_SMEM = DQ256_BARS + 8 * (1 + 2 * W_STAGES) + 1024;

// d = A B^T over the head dim, A and B K-major 64 x 256 tiles (four boxes 8
// KB apart): 16 SS m64n64k16 k-steps, k-step kk 32 (kk % 4) bytes into box
// kk / 4 of each, of T (bf16 or fp16); the caller fences, commits and waits
template <typename T>
__device__ __forceinline__ void scores256(float (&d)[32], const unsigned char* a,
                                          const unsigned char* b) {
  const uint64_t da = hopper::desc_kmajor(a), db = hopper::desc_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint64_t step = (uint64_t)(((kk / 4) * W256_BOX + (kk % 4) * 32) >> 4);
    hopper::wgmma_m64n64k16_ss<0, 0, T>(d, da + step, db + step, kk > 0);
  }
}

// acc += A B, A 64 x 64 from registers (4 k-steps of 16 rows of B, the RS
// form's layout) and B a 64 x 256 MN-major tile: per k-step two RS
// m64n128k16 over B's column halves, 16 KB apart (its boxes LBO = 8 KB
// apart; a k-step 2048 bytes); acc[hf] holds columns 128 hf .. 128 hf + 127
// in the m64n128 layout; A and B of T. The caller fences, commits and waits.
template <typename T>
__device__ __forceinline__ void sum256(float (&acc)[2][64], const uint32_t (&a)[4][4],
                                       const unsigned char* b) {
  const uint64_t db = hopper::desc_mnmajor(b, W256_BOX);
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    hopper::wgmma_m64n128k16_rs<1, T>(acc[0], a[k4], db + ((k4 * 2048) >> 4), 1);
    hopper::wgmma_m64n128k16_rs<1, T>(acc[1], a[k4], db + ((2 * W256_BOX + k4 * 2048) >> 4), 1);
  }
}

// the four boxes of rows [row0, row0 + 64) of a 256-wide map into `tile`
__device__ __forceinline__ void tma_tile256(unsigned char* tile, const CUtensorMap* map,
                                            uint64_t* bar, int row0, int head, int b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) hopper::tma_load_4d(tile + W256_BOX * c, map, bar, 64 * c, row0, head, b);
}

// this thread's row r (r = 0, 1: row 16 warp + g + 8 r of the warpgroup's
// 64) of two m64n128 sums, times `mul`, in T (bf16 or fp16) at `out`, the
// row's column 2 t4: its columns 128 hf + 8 j + 2 t4 and the next
template <typename T>
__device__ __forceinline__ void store_row256(T* out, const float (&acc)[2][64], int r,
                                             float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(out + 128 * hf + 8 * j) =
          pack_t<T>(acc[hf][4 * j + 2 * r] * mul, acc[hf][4 * j + 2 * r + 1] * mul);
}

// The body of flash_bwd_dkv_wgmma256_kernel (bf16) and
// flash_bwd_dkv_wgmma256_f16_kernel (fp16: GPT-J-6B's published dtype)
template <typename T>
__device__ __forceinline__ void dkv_wgmma256_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ out_scale, int H,
    int KvH, int Sq, int Sk, int causal, int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + W256_TILE;
  float* stats = reinterpret_cast<float*>(smem + DKV256_STATS);
  float4* xchg = reinterpret_cast<float4*>(smem + DKV256_XCHG);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + DKV256_BARS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + W_STAGES;
  uint64_t* p_full = empty + W_STAGES;
  uint64_t* p_empty = p_full + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int k0 = blockIdx.y * 64;  // low key blocks have the most q tiles: first
  int first, last;
  q_tiles(k0, 64, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx, and the 32 lanes staging LSE/delta
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init(p_full, WG_THREADS);
    mbar_init(p_empty, WG_THREADS);
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
        mbar_arrive_expect_tx(full_kv, W256_PAIR);
        tma_tile256(sK, tm_k, full_kv, k0, kvh, b);
        tma_tile256(sV, tm_v, full_kv, k0, kvh, b);
      }
      const float* lse_bh = lse + (int64_t)bh * Sq;
      const float* delta_bh = delta + (int64_t)bh * Sq;
      for (int t = first, i = 0; t < last; ++t, ++i) {
        const int s = i % W_STAGES;
        const int q0 = t * 64;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* sQ = smem + W256_PAIR + W256_PAIR * s;
          mbar_arrive_expect_tx(&full[s], W256_PAIR);
          tma_tile256(sQ, tm_q, &full[s], q0, h, b);
          tma_tile256(sQ + W256_TILE, tm_do, &full[s], q0, h, b);
        }
        // rows past Sq get 0 here and are masked by the consumers
        float* st = stats + 128 * s;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half;
          const bool in = q0 + r < Sq;
          st[r] = in ? lse_bh[q0 + r] * LOG2E : 0.f;
          st[64 + r] = in ? delta_bh[q0 + r] * scale : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 S^T, P^T and dV; warpgroup 2 dP^T, dS^T
    // and dK; both over the block's 64 keys
    setmaxnreg_inc<240>();
    const bool dv_side = threadIdx.x < 2 * WG_THREADS;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const float c = scale * LOG2E;        // raw score -> log2 units
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;

    mbar_wait(full_kv, 0);
    int handed = 0;  // tiles whose P^T passed between the warpgroups
    for (int t = first, i = 0; t < last; ++t, ++i) {
      const int s = i % W_STAGES;
      const int q0 = t * 64;
      const int p_first = kv_offset + q0;
      const int p_last = kv_offset + min(q0 + 63, Sq - 1);
      mbar_wait(&full[s], (i / W_STAGES) & 1);
      // a tile masked for every key of the block is only released, by both
      if (causal && (k0 > p_last || (window > 0 && k0 + 63 <= p_first - window))) {
        mbar_arrive(&empty[s]);
        continue;
      }
      unsigned char* sQ = smem + W256_PAIR + W256_PAIR * s;
      unsigned char* sDO = sQ + W256_TILE;
      const float* st = stats + 128 * s;

      // S^T = K Q^T (dV's side) or dP^T = V dO^T (dK's); element 4 j + e
      // is key key0 + 8 (e / 2), q row q0 + 8 j + 2 t4 + (e % 2)
      float sc[32];
      wgmma_fence();
      scores256<T>(sc, dv_side ? sK : sV, dv_side ? sQ : sDO);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (dv_side) {
        // P^T, handed to the other warpgroup in fp32 as it is
        const bool need_mask =
            q0 + 64 > Sq ||
            (causal && (k0 + 63 > p_first || (window > 0 && k0 <= p_last - window)));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e];
            if (need_mask) {
              const int r = q0 + 8 * j + 2 * t4 + (e & 1);
              if (!(r < Sq && visible(key0 + 8 * (e >> 1), kv_offset + r, Sk, causal, window)))
                x = NEG;
            }
            sc[4 * j + e] = exp2_ftz(fmaf(x, c, -((e & 1) ? l2.y : l2.x)));
          }
        }
        mbar_wait(p_empty, (handed & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          xchg[u * WG_THREADS + tid] =
              make_float4(sc[4 * u], sc[4 * u + 1], sc[4 * u + 2], sc[4 * u + 3]);
        mbar_arrive(p_full);
      } else {
        // dS^T = P^T (dP^T - delta) scale, delta by q row
        mbar_wait(p_full, handed & 1);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 p = xchg[u * WG_THREADS + tid];
          const float2 dl = *reinterpret_cast<const float2*>(st + 64 + 8 * u + 2 * t4);
          sc[4 * u] = p.x * fmaf(sc[4 * u], scale, -dl.x);
          sc[4 * u + 1] = p.y * fmaf(sc[4 * u + 1], scale, -dl.y);
          sc[4 * u + 2] = p.z * fmaf(sc[4 * u + 2], scale, -dl.x);
          sc[4 * u + 3] = p.w * fmaf(sc[4 * u + 3], scale, -dl.y);
        }
        mbar_arrive(p_empty);
      }
      ++handed;
      uint32_t a[4][4];
      to_a_operand<T>(sc, a);

      // dV += P^T dO or dK += dS^T Q: dO and Q are MN-major B operands
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      sum256<T>(acc, a, dv_side ? sDO : sQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[s]);
    }

    // dV or dK (times *out_scale) in T, one copy per q head; acc[hf][4 j + e]
    // is key key0 + 8 (e / 2), head dim 128 hf + 8 j + 2 t4 + (e % 2)
    const float os = out_scale ? *out_scale : 1.f;
    T* out = dv_side ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < Sk)
        store_row256(out + ((int64_t)bh * Sk + key) * 256 + 2 * t4, acc, r, os);
    }
  }
}

#define BWD_DKV256_KERNEL(NAME, T)                                                         \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                               \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,  \
      T* __restrict__ dv, const float* __restrict__ out_scale, int H, int KvH, int Sq,     \
      int Sk, int causal, int window, float scale) {                                       \
    dkv_wgmma256_body<T>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, out_scale, H,    \
                         KvH, Sq, Sk, causal, window, scale);                              \
  }
BWD_DKV256_KERNEL(flash_bwd_dkv_wgmma256_kernel, __nv_bfloat16)
BWD_DKV256_KERNEL(flash_bwd_dkv_wgmma256_f16_kernel, __half)
#undef BWD_DKV256_KERNEL

// The body of flash_bwd_dq_wgmma256_kernel (bf16) and
// flash_bwd_dq_wgmma256_f16_kernel (fp16)
template <typename T>
__device__ __forceinline__ void dq_wgmma256_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk,
    int causal, int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + W256_TILE;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + DQ256_BARS);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + W_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * 64;
  int first, last;
  key_tiles(q0, 64, 64, Sq, Sk, causal, window, first, last);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_THREADS);  // a stage is one warpgroup's
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: lane 0 of warp w feeds stage w, key tiles first + w,
    // first + w + 2, ...; warp 0 loads Q and dO first
    setmaxnreg_dec<24>();
    const int w = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && w < W_STAGES) {
      if (w == 0) {
        mbar_arrive_expect_tx(full_q, W256_PAIR);
        tma_tile256(sQ, tm_q, full_q, q0, h, b);
        tma_tile256(sDO, tm_do, full_q, q0, h, b);
      }
      unsigned char* sK = smem + W256_PAIR + W256_PAIR * w;
      for (int i = w; first + i < last; i += W_STAGES) {
        const int k0 = (first + i) * 64;
        mbar_wait(&empty[w], ((i / W_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[w], W256_PAIR);
        tma_tile256(sK, tm_k, &full[w], k0, kvh, b);
        tma_tile256(sK + W256_TILE, tm_v, &full[w], k0, kvh, b);
      }
    }
  } else {
    // ---- consumers: the block's 64 q rows each, warpgroup 1 + cw over key
    // tiles first + cw, first + cw + 2, ... from stage cw
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kv_offset = Sk - Sq;
    const int w_first = kv_offset + q0;
    const int w_last = kv_offset + min(q0 + 63, Sq - 1);
    const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const float c = scale * LOG2E;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      l2[r] = row < Sq ? lse[(int64_t)bh * Sq + row] * LOG2E : 0.f;
      dl[r] = row < Sq ? delta[(int64_t)bh * Sq + row] * scale : 0.f;
    }
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    unsigned char* sK = smem + W256_PAIR + W256_PAIR * cw;
    unsigned char* sV = sK + W256_TILE;

    mbar_wait(full_q, 0);
    for (int i = cw; first + i < last; i += W_STAGES) {
      const int k0 = (first + i) * 64;
      mbar_wait(&full[cw], (i / W_STAGES) & 1);
      // a tile masked for every row of the block is only released
      if (causal && (k0 > w_last || (window > 0 && k0 + 63 <= w_first - window))) {
        mbar_arrive(&empty[cw]);
        continue;
      }

      // S = Q K^T and dP = dO V^T
      float sc[32], dp[32];
      wgmma_fence();
      scores256<T>(sc, sQ, sK);
      scores256<T>(dp, sDO, sV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS; element 4 j + e is row row0 + 8 (e / 2), key k0 + 8 j + 2 t4 +
      // (e % 2)
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
          dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -dl[e >> 1]);
        }
      }
      uint32_t sa[4][4];
      to_a_operand<T>(dp, sa);

      // dQ += dS K: K [keys][256] as the MN-major B
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      sum256<T>(acc, sa, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[cw]);
    }

    // warpgroup 2's sum joins warpgroup 1's through stage 1, which no load
    // targets once warpgroup 2 has consumed its last tile: thread tid's 128
    // floats as 32 float4 at [32 u + v][tid], then warpgroup 1 adds them
    float4* red = reinterpret_cast<float4*>(smem + 2 * W256_PAIR);
    if (cw == 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int u = 0; u < 16; ++u)
          red[(16 * hf + u) * WG_THREADS + tid] =
              make_float4(acc[hf][4 * u], acc[hf][4 * u + 1], acc[hf][4 * u + 2],
                          acc[hf][4 * u + 3]);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(2 * WG_THREADS) : "memory");
    if (cw == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float4 o = red[(16 * hf + u) * WG_THREADS + tid];
          acc[hf][4 * u] += o.x;
          acc[hf][4 * u + 1] += o.y;
          acc[hf][4 * u + 2] += o.z;
          acc[hf][4 * u + 3] += o.w;
        }
      const float qs = out_scale ? *out_scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Sq) store_row256(dq + ((int64_t)bh * Sq + row) * 256 + 2 * t4, acc, r, qs);
      }
    }
  }
}

#define BWD_DQ256_KERNEL(NAME, T)                                                          \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                               \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,   \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,  \
      const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,  \
      const float* __restrict__ out_scale, int H, int KvH, int Sq, int Sk, int causal,     \
      int window, float scale) {                                                           \
    dq_wgmma256_body<T>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, out_scale, H, KvH, Sq, \
                        Sk, causal, window, scale);                                        \
  }
BWD_DQ256_KERNEL(flash_bwd_dq_wgmma256_kernel, __nv_bfloat16)
BWD_DQ256_KERNEL(flash_bwd_dq_wgmma256_f16_kernel, __half)
#undef BWD_DQ256_KERNEL

// ---- host side
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  const float* out_scale;  // fp16 alone: the outputs times *out_scale; null: 1
  int B, H, KvH, Sq, Sk, D;
  Strides st;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int DP>
cudaError_t launch_dq_simt(const Args& a) {
  constexpr int SB = simt_tile(DP);
  constexpr int smem = (int)sizeof(float) * (4 * SB * (DP + 1) + SB * (SB + 4));
  auto kernel = flash_bwd_dq_simt_kernel<T, DP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + SB - 1) / SB, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
      a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.D, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv_simt(const Args& a) {
  constexpr int SB = simt_tile(DP);
  constexpr int smem =
      (int)sizeof(float) * (4 * SB * (DP + 1) + 2 * SB * (SB + 4) + 2 * SB);
  auto kernel = flash_bwd_dkv_simt_kernel<T, DP>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + SB - 1) / SB, a.B * a.H);
  kernel<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
      a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.D, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP, bool PAD>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr int smem = (int)sizeof(T) * (2 * BQ + 2 * BK) * (DP + 8);
  auto kernel = flash_bwd_dq_mma_kernel<T, DP, PAD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  typedef const T* P;
  kernel<<<grid, NT_MMA, smem, a.stream>>>(
      (P)a.q, (P)a.k, (P)a.v, (P)a.dout, (const float*)a.lse, (const float*)a.delta,
      (T*)a.dq, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.D, a.st, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP, bool PAD>
cudaError_t launch_dkv_mma(const Args& a) {
  constexpr int smem = (int)sizeof(T) * (2 * BK + 2 * BQ) * (DP + 8) +
                       (int)sizeof(float) * 2 * BQ;
  auto kernel = flash_bwd_dkv_mma_kernel<T, DP, PAD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // at DP = 256 two blocks split the head-dim columns (the kernel's OC)
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H, DP > 128 ? 2 : 1);
  typedef const T* P;
  kernel<<<grid, NT_MMA, smem, a.stream>>>(
      (P)a.q, (P)a.k, (P)a.v, (P)a.dout, (const float*)a.lse, (const float*)a.delta,
      (T*)a.dk, (T*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.D, a.st, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

// the four 4-D maps (q, k, v, dO; head_dim D) of a wgmma launch over tensors
// of `type`, boxes of `q_rows` rows of q and dO and `kv_rows` of k and v;
// false if cuTensorMapEncodeTiled refuses one
bool bwd_maps(const Args& a, int D, CUtensorMapDataType type, uint32_t q_rows,
              uint32_t kv_rows, CUtensorMap (&maps)[4]) {
  const int64_t q_dims[4] = {D, a.Sq, a.H, a.B};
  const int64_t kv_dims[4] = {D, a.Sk, a.KvH, a.B};
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  const int64_t* st = &a.st.q_sb;
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    // strides (seq, head, batch), innermost first after head_dim
    const int64_t strides[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    if (!hopper::make_map_4d(&maps[i], type, bases[i], is_q ? q_dims : kv_dims, strides,
                             is_q ? q_rows : kv_rows))
      return false;
  }
  return true;
}

// the tensor maps' element type of T (bf16 or fp16)
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a dK/dV kernel over T on D = 128's grid (D = 128, 96 or 80, bf16 or
// fp16): 128 keys a block, boxes of 64 rows of q and dO
template <typename T, typename K>
cudaError_t dkv_wgmma128(K kernel, const Args& a, int D) {
  CUtensorMap m[4];
  if (!bwd_maps(a, D, map_type<T>(), 64, 128, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sk + 127) / 128);
  kernel<<<grid, 3 * WG_THREADS, DKV_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dk,
      (T*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// the rows of a launch whose producer copies them itself (the D = 100
// kernels, over T), from its arguments
template <typename T>
BwdRows<T> bwd_rows(const Args& a) {
  BwdRows<T> src{(const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, {}};
  const int64_t* st = &a.st.q_sb;
  for (int i = 0; i < 12; ++i) src.st[i] = st[i];
  return src;
}

// whether a wgmma kernel of dQ and dK/dV takes (dtype, D): bf16 (dtype 1)
// and fp16 (dtype 2) alike at 64, 80, 96, 100, 128 and 256
bool has_wgmma(int dtype, int D) {
  return (dtype == 1 || dtype == 2) &&
         (D == 64 || D == 80 || D == 96 || D == 100 || D == 128 || D == 256);
}

// a dK/dV kernel over T at D = 256 (bf16 or fp16): 64 keys a block, boxes
// of 64 rows of every map
template <typename T, typename K>
cudaError_t dkv_wgmma256(K kernel, const Args& a) {
  CUtensorMap m[4];
  if (!bwd_maps(a, 256, map_type<T>(), 64, 64, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sk + 63) / 64);
  kernel<<<grid, 3 * WG_THREADS, DKV256_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dk,
      (T*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// a dK/dV kernel over T at D = 64 (bf16 or fp16): 192 keys a block, boxes
// of 64 rows of q and dO
template <typename T, typename K>
cudaError_t dkv_wgmma64(K kernel, const Args& a) {
  CUtensorMap m[4];
  if (!bwd_maps(a, 64, map_type<T>(), 64, K64_KEYS, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sk + K64_KEYS - 1) / K64_KEYS);
  kernel<<<grid, (K64_CONS + 1) * WG_THREADS, K64_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dk,
      (T*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// The kernel of (dtype, D), each chosen by both: bf16 (dtype 1) at D = 128:
// flash_bwd_dkv_wgmma_kernel; at D = 96, 80 and 100:
// flash_bwd_dkv_wgmma96_kernel, flash_bwd_dkv_wgmma80_kernel and
// flash_bwd_dkv_wgmma100_kernel (which takes the rows themselves, not maps),
// on the same grid; at D = 64: flash_bwd_dkv_wgmma64_kernel; at D = 256:
// flash_bwd_dkv_wgmma256_kernel, 64 keys a block. fp16 (dtype 2) at D = 128,
// 96, 80 and 100: flash_bwd_dkv_wgmma_f16_kernel,
// flash_bwd_dkv_wgmma96_f16_kernel, flash_bwd_dkv_wgmma80_f16_kernel and
// flash_bwd_dkv_wgmma100_f16_kernel (its rows too), on the D = 128 grid; at
// D = 64: flash_bwd_dkv_wgmma64_f16_kernel, on the D = 64 grid; at D = 256:
// flash_bwd_dkv_wgmma256_f16_kernel, on the D = 256 one. Any other pair
// returns cudaErrorInvalidValue and launches nothing.
cudaError_t launch_dkv_wgmma(const Args& a, int D, int dtype) {
  if (!has_wgmma(dtype, D)) return cudaErrorInvalidValue;
  static const cudaError_t attr128 = set_smem(flash_bwd_dkv_wgmma_kernel, DKV_SMEM);
  static const cudaError_t attr96 = set_smem(flash_bwd_dkv_wgmma96_kernel, DKV_SMEM);
  static const cudaError_t attr80 = set_smem(flash_bwd_dkv_wgmma80_kernel, DKV_SMEM);
  static const cudaError_t attr100 = set_smem(flash_bwd_dkv_wgmma100_kernel, DKV_SMEM);
  static const cudaError_t attr64 = set_smem(flash_bwd_dkv_wgmma64_kernel, K64_SMEM);
  static const cudaError_t attr256 = set_smem(flash_bwd_dkv_wgmma256_kernel, DKV256_SMEM);
  static const cudaError_t attr_f16 = set_smem(flash_bwd_dkv_wgmma_f16_kernel, DKV_SMEM);
  static const cudaError_t attr100_f16 =
      set_smem(flash_bwd_dkv_wgmma100_f16_kernel, DKV_SMEM);
  static const cudaError_t attr64_f16 =
      set_smem(flash_bwd_dkv_wgmma64_f16_kernel, K64_SMEM);
  static const cudaError_t attr256_f16 =
      set_smem(flash_bwd_dkv_wgmma256_f16_kernel, DKV256_SMEM);
  static const cudaError_t attr96_f16 = set_smem(flash_bwd_dkv_wgmma96_f16_kernel, DKV_SMEM);
  static const cudaError_t attr80_f16 = set_smem(flash_bwd_dkv_wgmma80_f16_kernel, DKV_SMEM);
  const bool f16 = dtype == 2;
  // D is one of has_wgmma's six here
  const cudaError_t attr = D == 64    ? (f16 ? attr64_f16 : attr64)
                           : D == 100 ? (f16 ? attr100_f16 : attr100)
                           : D == 128 ? (f16 ? attr_f16 : attr128)
                           : D == 256 ? (f16 ? attr256_f16 : attr256)
                           : D == 96  ? (f16 ? attr96_f16 : attr96)
                                      : (f16 ? attr80_f16 : attr80);
  if (attr != cudaSuccess) return attr;
  if (D == 100) {
    const dim3 grid(a.B * a.H, (a.Sk + 127) / 128);
    if (f16)
      flash_bwd_dkv_wgmma100_f16_kernel<<<grid, 3 * WG_THREADS, DKV_SMEM, a.stream>>>(
          bwd_rows<__half>(a), (const float*)a.lse, (const float*)a.delta, (__half*)a.dk,
          (__half*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
    else
      flash_bwd_dkv_wgmma100_kernel<<<grid, 3 * WG_THREADS, DKV_SMEM, a.stream>>>(
          bwd_rows<__nv_bfloat16>(a), (const float*)a.lse, (const float*)a.delta,
          (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.out_scale, a.H, a.KvH, a.Sq, a.Sk,
          a.causal, a.window, a.scale);
    return cudaGetLastError();
  }
  if (D == 256)
    return f16 ? dkv_wgmma256<__half>(flash_bwd_dkv_wgmma256_f16_kernel, a)
               : dkv_wgmma256<__nv_bfloat16>(flash_bwd_dkv_wgmma256_kernel, a);
  if (f16)
    return D == 64   ? dkv_wgmma64<__half>(flash_bwd_dkv_wgmma64_f16_kernel, a)
           : D == 96 ? dkv_wgmma128<__half>(flash_bwd_dkv_wgmma96_f16_kernel, a, D)
           : D == 80 ? dkv_wgmma128<__half>(flash_bwd_dkv_wgmma80_f16_kernel, a, D)
                     : dkv_wgmma128<__half>(flash_bwd_dkv_wgmma_f16_kernel, a, D);
  if (D == 64) return dkv_wgmma64<__nv_bfloat16>(flash_bwd_dkv_wgmma64_kernel, a);
  return dkv_wgmma128<__nv_bfloat16>(D == 96   ? flash_bwd_dkv_wgmma96_kernel
                                     : D == 80 ? flash_bwd_dkv_wgmma80_kernel
                                               : flash_bwd_dkv_wgmma_kernel,
                                     a, D);
}

// a dQ kernel over T on D = 128's grid (D = 128, 96 or 80, bf16 or fp16):
// 128 queries a block, boxes of 64 rows of k and v
template <typename T, typename K>
cudaError_t dq_wgmma128(K kernel, const Args& a, int D) {
  CUtensorMap m[4];
  if (!bwd_maps(a, D, map_type<T>(), 128, 64, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sq + 127) / 128);
  kernel<<<grid, 3 * WG_THREADS, DQ_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
      a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// a dQ kernel over T at D = 256 (bf16 or fp16): 64 q rows a block, boxes of
// 64 rows of every map
template <typename T, typename K>
cudaError_t dq_wgmma256(K kernel, const Args& a) {
  CUtensorMap m[4];
  if (!bwd_maps(a, 256, map_type<T>(), 64, 64, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sq + 63) / 64);
  kernel<<<grid, 3 * WG_THREADS, DQ256_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
      a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// a dQ kernel over T at D = 64 (bf16 or fp16): 192 q rows a block, boxes of
// 64 rows of k and v
template <typename T, typename K>
cudaError_t dq_wgmma64(K kernel, const Args& a) {
  CUtensorMap m[4];
  if (!bwd_maps(a, 64, map_type<T>(), Q64_ROWS, 64, m)) return cudaErrorInvalidValue;
  const dim3 grid(a.B * a.H, (a.Sq + Q64_ROWS - 1) / Q64_ROWS);
  kernel<<<grid, (Q64_CONS + 1) * WG_THREADS, Q64_SMEM, a.stream>>>(
      m[0], m[1], m[2], m[3], (const float*)a.lse, (const float*)a.delta, (T*)a.dq,
      a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// The kernel of (dtype, D), each chosen by both: bf16 (dtype 1) at D = 128:
// flash_bwd_dq_wgmma_kernel; at D = 96, 80 and 100:
// flash_bwd_dq_wgmma96_kernel, flash_bwd_dq_wgmma80_kernel and
// flash_bwd_dq_wgmma100_kernel (which takes the rows themselves, not maps),
// on the same grid; at D = 64: flash_bwd_dq_wgmma64_kernel; at D = 256:
// flash_bwd_dq_wgmma256_kernel, 64 q rows a block. fp16 (dtype 2) at D = 128,
// 96, 80 and 100: flash_bwd_dq_wgmma_f16_kernel,
// flash_bwd_dq_wgmma96_f16_kernel, flash_bwd_dq_wgmma80_f16_kernel and
// flash_bwd_dq_wgmma100_f16_kernel (its rows too), on the D = 128 grid; at
// D = 64: flash_bwd_dq_wgmma64_f16_kernel, on the D = 64 grid; at D = 256:
// flash_bwd_dq_wgmma256_f16_kernel, on the D = 256 one. Any other pair
// returns cudaErrorInvalidValue and launches nothing.
cudaError_t launch_dq_wgmma(const Args& a, int D, int dtype) {
  if (!has_wgmma(dtype, D)) return cudaErrorInvalidValue;
  static const cudaError_t attr128 = set_smem(flash_bwd_dq_wgmma_kernel, DQ_SMEM);
  static const cudaError_t attr96 = set_smem(flash_bwd_dq_wgmma96_kernel, DQ_SMEM);
  static const cudaError_t attr80 = set_smem(flash_bwd_dq_wgmma80_kernel, DQ_SMEM);
  static const cudaError_t attr100 = set_smem(flash_bwd_dq_wgmma100_kernel, DQ_SMEM);
  static const cudaError_t attr64 = set_smem(flash_bwd_dq_wgmma64_kernel, Q64_SMEM);
  static const cudaError_t attr256 = set_smem(flash_bwd_dq_wgmma256_kernel, DQ256_SMEM);
  static const cudaError_t attr_f16 = set_smem(flash_bwd_dq_wgmma_f16_kernel, DQ_SMEM);
  static const cudaError_t attr100_f16 = set_smem(flash_bwd_dq_wgmma100_f16_kernel, DQ_SMEM);
  static const cudaError_t attr64_f16 = set_smem(flash_bwd_dq_wgmma64_f16_kernel, Q64_SMEM);
  static const cudaError_t attr256_f16 =
      set_smem(flash_bwd_dq_wgmma256_f16_kernel, DQ256_SMEM);
  static const cudaError_t attr96_f16 = set_smem(flash_bwd_dq_wgmma96_f16_kernel, DQ_SMEM);
  static const cudaError_t attr80_f16 = set_smem(flash_bwd_dq_wgmma80_f16_kernel, DQ_SMEM);
  const bool f16 = dtype == 2;
  // D is one of has_wgmma's six here
  const cudaError_t attr = D == 64    ? (f16 ? attr64_f16 : attr64)
                           : D == 100 ? (f16 ? attr100_f16 : attr100)
                           : D == 128 ? (f16 ? attr_f16 : attr128)
                           : D == 256 ? (f16 ? attr256_f16 : attr256)
                           : D == 96  ? (f16 ? attr96_f16 : attr96)
                                      : (f16 ? attr80_f16 : attr80);
  if (attr != cudaSuccess) return attr;
  if (D == 100) {
    const dim3 grid(a.B * a.H, (a.Sq + 127) / 128);
    if (f16)
      flash_bwd_dq_wgmma100_f16_kernel<<<grid, 3 * WG_THREADS, DQ_SMEM, a.stream>>>(
          bwd_rows<__half>(a), (const float*)a.lse, (const float*)a.delta, (__half*)a.dq,
          a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window, a.scale);
    else
      flash_bwd_dq_wgmma100_kernel<<<grid, 3 * WG_THREADS, DQ_SMEM, a.stream>>>(
          bwd_rows<__nv_bfloat16>(a), (const float*)a.lse, (const float*)a.delta,
          (__nv_bfloat16*)a.dq, a.out_scale, a.H, a.KvH, a.Sq, a.Sk, a.causal, a.window,
          a.scale);
    return cudaGetLastError();
  }
  if (D == 256)
    return f16 ? dq_wgmma256<__half>(flash_bwd_dq_wgmma256_f16_kernel, a)
               : dq_wgmma256<__nv_bfloat16>(flash_bwd_dq_wgmma256_kernel, a);
  if (f16)
    return D == 64   ? dq_wgmma64<__half>(flash_bwd_dq_wgmma64_f16_kernel, a)
           : D == 96 ? dq_wgmma128<__half>(flash_bwd_dq_wgmma96_f16_kernel, a, D)
           : D == 80 ? dq_wgmma128<__half>(flash_bwd_dq_wgmma80_f16_kernel, a, D)
                     : dq_wgmma128<__half>(flash_bwd_dq_wgmma_f16_kernel, a, D);
  if (D == 64) return dq_wgmma64<__nv_bfloat16>(flash_bwd_dq_wgmma64_kernel, a);
  return dq_wgmma128<__nv_bfloat16>(D == 96   ? flash_bwd_dq_wgmma96_kernel
                                    : D == 80 ? flash_bwd_dq_wgmma80_kernel
                                              : flash_bwd_dq_wgmma_kernel,
                                    a, D);
}

// which: 0 = dQ, 1 = dK/dV; the simt (mma 0) or mma (mma 1) kernel of T at
// the padded width of a.D
template <typename T, int DP>
cudaError_t launch_at(int which, int mma, const Args& a) {
  if constexpr (std::is_same<T, float>::value || DP > 256) {
    if (mma) return cudaErrorInvalidValue;  // fp32 and DP = 512 have no mma kernel
  } else if (mma) {
    // the exact build at D = 32, 64 and 128, the padded one below them; DP =
    // 256 has the padded build alone
    if constexpr (DP < 256) {
      if (a.D == DP) return which ? launch_dkv_mma<T, DP, false>(a) : launch_dq_mma<T, DP, false>(a);
    }
    return which ? launch_dkv_mma<T, DP, true>(a) : launch_dq_mma<T, DP, true>(a);
  }
  return which ? launch_dkv_simt<T, DP>(a) : launch_dq_simt<T, DP>(a);
}

template <typename T>
cudaError_t at_padded_dim(int which, int mma, const Args& a) {
  switch (padded_dim(a.D)) {
    case 32: return launch_at<T, 32>(which, mma, a);
    case 64: return launch_at<T, 64>(which, mma, a);
    case 128: return launch_at<T, 128>(which, mma, a);
    case 256: return launch_at<T, 256>(which, mma, a);
    case 512: return launch_at<T, 512>(which, mma, a);
    default: return cudaErrorInvalidValue;
  }
}

// dtype 0 = fp32, 1 = bf16, 2 = fp16. route 0 = simt (any dtype, D from 1
// to 512), 1 = mma (bf16 or fp16, D a multiple of 8 up to 256, 16-byte
// aligned bases, strides that are multiples of 8), 2 = wgmma (Sk > 0 and a
// kernel for (dtype, D), `has_wgmma`: rows as mma's at D = 64, 80, 96, 128
// or 256, bf16 or fp16; at D = 100, 8-byte aligned bases and strides that
// are multiples of 4); a route that cannot take the
// inputs launches nothing, and so does an out_scale in fp32 or bf16
cudaError_t dispatch(int which, int dtype, int route, int D, const Args& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const bool aligned = rows_aligned(ptrs, 4, &a.st.q_sb, 12, D);
  if (a.out_scale && dtype != 2) return cudaErrorInvalidValue;
  switch (route) {
    case 0:
      if (dtype == 0) return at_padded_dim<float>(which, 0, a);
      if (dtype == 1) return at_padded_dim<__nv_bfloat16>(which, 0, a);
      if (dtype == 2) return at_padded_dim<__half>(which, 0, a);
      return cudaErrorInvalidValue;
    case 1:
      if (!aligned) return cudaErrorInvalidValue;
      if (dtype == 1) return at_padded_dim<__nv_bfloat16>(which, 1, a);
      if (dtype == 2) return at_padded_dim<__half>(which, 1, a);
      return cudaErrorInvalidValue;
    case 2: {
      // the D = 100 kernels copy their 200-byte rows in 8-byte pieces; the
      // launchers refuse a (dtype, D) without a kernel themselves
      const bool rows_ok = D == 100 ? rows_aligned(ptrs, 4, &a.st.q_sb, 12, D, 8) : aligned;
      if (!rows_ok || a.Sk <= 0) return cudaErrorInvalidValue;
      return which ? launch_dkv_wgmma(a, D, dtype) : launch_dq_wgmma(a, D, dtype);
    }
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
// D], one per q head. out_scale: null, or in fp16 alone a device fp32 that
// every output is multiplied by in fp32 before its one rounding to fp16.
// dtype 0 = fp32, 1 = bf16, 2 = fp16. route: 0 = simt,
// 1 = mma, 2 = wgmma (what each takes is at `dispatch`); a route that cannot
// take the inputs returns cudaErrorInvalidValue and launches nothing. window
// <= 0 means no window. Each returns the launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            const float* out_scale, int dtype, int route, int device,
                            int B, int H, int KvH, int Sq, int Sk, int D,
                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss,
                            int causal, int window, float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr, out_scale, B, H, KvH, Sq,
                  Sk, D,
                  {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss},
                  causal, window, scale, (cudaStream_t)stream};
  return run(0, dtype, route, device, a, D);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             const float* out_scale, int dtype, int route, int device,
                             int B, int H, int KvH, int Sq, int Sk, int D,
                             int64_t q_sb, int64_t q_sh, int64_t q_ss,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss,
                             int64_t v_sb, int64_t v_sh, int64_t v_ss,
                             int64_t o_sb, int64_t o_sh, int64_t o_ss,
                             int causal, int window, float scale, void* stream) {
  const Args a = {q, k, v, dout, lse, delta, nullptr, dk, dv, out_scale, B, H, KvH, Sq,
                  Sk, D,
                  {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss},
                  causal, window, scale, (cudaStream_t)stream};
  return run(1, dtype, route, device, a, D);
}
