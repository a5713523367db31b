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
// The Pallas kernel keeps a whole K/V sequence in VMEM per program; that does
// not fit in 227 KB of shared memory, so here a block owns a tile of q rows of
// one (batch, head) and streams K/V tiles through shared memory. Causal tiles
// stop at the diagonal and windowed tiles start at the window's first tile, as
// in the Pallas loop bounds; ragged q and k tails are masked in the kernel, so
// every shape runs here. Fourteen kernels share that plan; the caller names a
// route (ops/attention.py:_route picks it from dtype, head_dim and alignment):
// - flash_fwd_wgmma_kernel (route 2 at D = 128; bf16, 16-byte aligned rows:
//   the main path): TMA-fed and warp-specialised, on wgmma. Below.
// - flash_fwd_wgmma96_kernel (route 2 at D = 96: Phi-3-mini's attention) and
//   flash_fwd_wgmma80_kernel (D = 80: StableLM-3B's): the D = 128 kernel's
//   body at the true width, 6 (5) k-steps and P.V at n96 (n80).
// - flash_fwd_wgmma100_kernel (route 2 at D = 100: OpenLLaMA-3B's 200-byte
//   rows, 8-byte aligned): the same body, its producer copying the rows with
//   cp.async where TMA cannot read them; 7 k-steps and P.V at n104.
// - flash_fwd_wgmma_f16_kernel (route 2 in fp16 at D = 128: Llama-2's
//   published dtype), flash_fwd_wgmma96_f16_kernel (fp16 at D = 96:
//   GPT-NeoX-20B's), flash_fwd_wgmma80_f16_kernel (fp16 at D = 80:
//   OPT-2.7B's) and flash_fwd_wgmma100_f16_kernel (fp16 at D = 100:
//   OpenLLaMA-3B's): the D = 128, 96, 80 and 100 kernels' body on fp16
//   operands.
// - flash_fwd_wgmma64_kernel (route 2 at D = 64: bench_mfu's d1024 widths)
//   and flash_fwd_wgmma64_f16_kernel (fp16 at D = 64: OPT-1.3B's published
//   dtype): the same plan with three consumer warpgroups; the note is below.
// - flash_fwd_wgmma256_kernel (route 2 at D = 256: Gemma's attention) and
//   flash_fwd_wgmma256_f16_kernel (fp16 at D = 256: GPT-J-6B's): the same
//   plan on stages of 64 keys, each row in four boxes; its note is below.
// - flash_fwd_mma_kernel (route 1; aligned bf16 and fp16, D a multiple of 8
//   up to 256: every other model's head dim; it takes bf16 and fp16 at D =
//   64, 80, 96, 128 and 256 too, to be held against the wgmma kernels): 4 warps, each owning 16 of 64 q rows, mma.sync
//   m16n8k16 (.bf16 or .f16) for both products; K/V tiles of 64 keys copied through registers.
//   Scores, probabilities and the output sum stay in registers; P is rounded
//   to the input type for P.V as the plain version rounds its probabilities.
//   The fp32 scores are scaled (rather than Q, which would round Q a second
//   time). A warp skips the tiles that are masked for all of its rows. At DP
//   = 256 a warp's O sum is 128 fp32 a thread, so its Q fragments are read
//   from shared memory at each k-step rather than held in registers.
// - flash_fwd_simt_kernel (route 0; fp32, bf16 or fp16 rows the mma kernel
//   does not take, and D past 256 in every dtype): scalar fp32 FMAs from
//   shared memory with Q pre-scaled in fp32 as in the Pallas kernel; 256
//   threads as a 16 x 16 grid, each owning 4 q rows (2 at DP = 256 and 1 at
//   512, whose tiles are 32 and 16 rows).
// The simt and mma kernels are built at a padded width DP of 32, 64, 128 or
// 256, and the simt kernel at 512 too (flash_common.cuh's padded_dim), and
// take the true D at run time: columns past D load as zeros and are not
// stored, so D = 32, 64 and 128 run the code of their own width, and any
// other D that of the next one up.
//
// The wgmma kernel. Three warpgroups: warpgroup 0 is the producer, which gives
// up registers (setmaxnreg) and has one thread issue every TMA load; warpgroups
// 1 and 2 are consumers of 64 q rows each (a block owns 128 q rows) and take
// the registers. Q arrives once, then K and V tiles of 128 keys stream through
// a ring of W_STAGES (2) stages with their own "full" barriers (so Q.K^T starts
// before V lands) and one "empty" barrier per stage that all 256 consumer
// threads arrive on when done. TMA reads the strided views through a 4-D map
// (head_dim, seq, heads, batch), so the model's transposed [B, S, H, D] views
// need no copy, and rows past the sequence come back as zeros (keys past Sk are
// still masked: a zero key scores 0, not -inf). Per tile, each consumer
// warpgroup computes S = Q K^T with 8 SS wgmma m64n128k16 (both operands
// K-major), masks only on diagonal, window-edge and ragged tiles, runs the
// online softmax on the raw scores with exp2 (ex2.approx.ftz) and the scale
// folded into one FMA (m is kept in raw-score units; LSE = m scale + ln l),
// rounds P to the input type in registers (the m64n128 accumulator is laid
// out as the A operand of the RS form) and adds P V with 8 RS wgmma (V as an
// MN-major B operand). The row sums l stay per thread until the epilogue.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block of the mma kernel
constexpr int BK = 64;        // keys per streamed tile of the mma kernel
constexpr int NT = 256;       // threads per block of the SIMT kernel (16 x 16)

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    int H, int KvH, int Sq, int Sk, int d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int causal, int window, float scale) {
  constexpr int SB = simt_tile(DP);  // q rows per block, keys per tile
  constexpr int RPT = SB / 16;       // rows (and key columns) per thread
  constexpr int SBP = SB + 4;        // padded P row: the two half-warps hit other banks
  constexpr int DQ = DP + 1;         // padded Q/K row: column reads are conflict-free
  constexpr int CPT = DP / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [SB][DQ], pre-scaled by 1/sqrt(d)
  float* sK = sQ + SB * DQ;     // [SB][DQ]
  float* sV = sK + SB * DQ;     // [SB][DP]
  float* sP = sV + SB * DP;     // [SB][SBP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // this thread's rows: RPT*ty .. RPT*ty+RPT-1
  const int tx = tid & 15;      // this thread's score columns: tx + 16*j
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * SB;
  const int kv_offset = Sk - Sq;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + kvh * k_sh;
  const T* vp = v + b * v_sb + kvh * v_sh;

  // columns d .. DP read as zeros
  for (int i = tid; i < SB * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < Sq && c < d) x = to_f32(qp[(int64_t)(q0 + r) * q_ss + c]) * scale;
    sQ[r * DQ + c] = x;
  }

  int n_tiles = (Sk + SB - 1) / SB;
  int first_tile = 0;
  if (causal) {
    // keys past the tile's last row are masked for every row: stop there
    const int last_key = kv_offset + min(q0 + SB, Sq) - 1;
    n_tiles = min(n_tiles, last_key / SB + 1);
    if (window > 0) {
      // keys before the tile's first row's window are masked for every row
      const int first_key = kv_offset + q0 - (window - 1);
      first_tile = max(first_key, 0) / SB;
    }
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = first_tile; t < n_tiles; ++t) {
    const int k0 = t * SB;
    __syncthreads();  // the last tile's reads of sK/sV/sP are done
    for (int i = tid; i < SB * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && c < d) {
        kx = to_f32(kp[(int64_t)(k0 + r) * k_ss + c]);
        vx = to_f32(vp[(int64_t)(k0 + r) * v_ss + c]);
      }
      sK[r * DQ + c] = kx;
      sV[r * DP + c] = vx;
    }
    __syncthreads();

    float s[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      float qv[RPT], kv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(RPT * ty + i) * DQ + dd];
#pragma unroll
      for (int j = 0; j < RPT; ++j) kv[j] = sK[(tx + 16 * j) * DQ + dd];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = kv_offset + q0 + RPT * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
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
      for (int j = 0; j < RPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(RPT * ty + i) * SBP + tx + 16 * j] = p;
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
    for (int kk = 0; kk < SB; ++kk) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(RPT * ty + i) * SBP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + RPT * ty + i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + row) * d;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tx + 16 * c < d) store(orow + tx + 16 * c, acc[i][c] / lc);
    if (tx == 0) lse[(int64_t)bh * Sq + row] = m[i] + logf(lc);
  }
}

template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(NT_MMA) flash_fwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int d_arg,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int causal, int window, float scale) {
  constexpr int DS = DP + 8;    // padded smem row: fragment reads are conflict-free
  constexpr int KS = DP / 16;   // k-steps of Q.K^T
  constexpr int NO = DP / 8;    // n-tiles of the output
  constexpr int NS = BK / 8;    // n-tiles of the scores
  // up to DP = 128 a warp keeps its Q fragments in registers for the whole
  // loop; at 256 they would not fit beside O's 128 fp32 sums, and are read
  // from shared memory at each k-step
  constexpr bool QREG = DP <= 128;
  // the head dim: d_arg in a padded build, DP itself in an exact one (d =
  // DP), whose code is then that of its width alone: a run-time d in the
  // tile copies cost the DP = 128 build the registers of one block an SM,
  // and time (PERF.md section 6)
  const int d = PAD ? d_arg : DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][DS]
  T* sK = sQ + BQ * DS;                    // [BK][DS]
  T* sV = sK + BK * DS;                    // [BK][DS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * BQ;
  const int kv_offset = Sk - Sq;
  const T* kp = k + b * k_sb + kvh * k_sh;
  const T* vp = v + b * v_sb + kvh * v_sh;

  load_tile<DP>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, Sq, d);
  __syncthreads();
  const T* qw = sQ + 16 * warp * DS;  // this warp's 16 rows of Q
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_a<DS>(qf[kk], qw, kk, g, t4);
  }

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
    load_tile<DP>(sK, kp, k_ss, k0, Sk, d);
    load_tile<DP>(sV, vp, v_ss, k0, Sk, d);
    __syncthreads();
    // tiles masked for every row of this warp contribute nothing
    if (!w_live) continue;
    if (causal && (k0 > w_last || (window > 0 && k0 + BK - 1 <= w_first - window)))
      continue;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (QREG) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const T* kr = sK + (8 * n + g) * DS + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_t<T>(s[n], qf[kk], ld_pair(kr + 16 * kk), ld_pair(kr + 16 * kk + 8));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4];
        load_a<DS>(qa, qw, kk, g, t4);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = sK + (8 * n + g) * DS + 2 * t4 + 16 * kk;
          mma_t<T>(s[n], qa, ld_pair(kr), ld_pair(kr + 8));
        }
      }
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
    // fragment of key step j; P is rounded to the input type here, where
    // the plain version rounds its probabilities
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_t<T>(s[2 * j][0], s[2 * j][1]),
                              pack_t<T>(s[2 * j][2], s[2 * j][3]),
                              pack_t<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_t<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
      const T* vr = sV + (16 * j + 2 * t4) * DS + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* vc = vr + 8 * n;
        mma_t<T>(acc[n], pa, pack_raw(vc[0], vc[DS]), pack_raw(vc[8 * DS], vc[9 * DS]));
      }
    }
  }

  if (!w_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row0 + g + 8 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + ((int64_t)bh * Sq + row) * d + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < d)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_t<T>(acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
    if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] + logf(lc);
  }
}


// ---- the wgmma kernels at D = 128, 100, 96 and 80 (bf16 and fp16)
constexpr int WG_THREADS = 128;
constexpr int W_ROWS = 64;                  // q rows per consumer warpgroup
constexpr int W_BQ = 2 * W_ROWS;            // q rows per block
constexpr int W_BK = 128;                   // keys per stage
constexpr int W_STAGES = 2;
constexpr int W_HALF = 128 * 128;           // bytes of one 64-column half of a 128-row tile
constexpr int W_TILE = 2 * W_HALF;          // bytes of a 128 x 128 bf16 tile
constexpr int W_BARS = W_TILE * (1 + 2 * W_STAGES);  // barriers after Q, K[], V[]
constexpr int W_SMEM = W_BARS + 8 * (1 + 3 * W_STAGES) + 1024;  // + alignment slack

// The q, k and v rows of a launch whose producer copies them itself
// (flash_fwd_wgmma100_kernel, flash_fwd_wgmma100_f16_kernel): bases, and
// (batch, head, seq) strides of q, k, v in elements.
template <typename T>
struct RowSrc {
  const T* q;
  const T* k;
  const T* v;
  int64_t st[9];
};

// The body of flash_fwd_wgmma_kernel (bf16, D = 128), flash_fwd_wgmma96_kernel
// (bf16, D = 96), flash_fwd_wgmma80_kernel (bf16, D = 80),
// flash_fwd_wgmma100_kernel (bf16, D = 100), flash_fwd_wgmma_f16_kernel
// (fp16, D = 128), flash_fwd_wgmma96_f16_kernel (fp16, D = 96: GPT-NeoX-20B's
// published dtype), flash_fwd_wgmma80_f16_kernel (fp16, D = 80: OPT-2.7B's,
// Pythia-2.8B's and Phi-2's) and flash_fwd_wgmma100_f16_kernel (fp16, D = 100:
// OpenLLaMA-3B's). fp16 differs from bf16 only in names: the wgmma
// instructions (.f16 for .bf16), the tensor maps' data type and the roundings
// of P (for P.V, where the plain version rounds its probabilities) and of O;
// both are 2 bytes and the H100 runs both at one tensor rate, so tiles,
// swizzle, ring and grid are the same. At D = 96 and 80 the tiles keep D =
// 128's shared-memory layout: each row's second box reads columns 64-127 of a
// tensor 96 (80) wide, so TMA fills columns 96-127 (80-127) with zeros and
// every expect_tx counts the whole box. Q.K^T runs D / 16 k-steps (6, 5;
// those past the fourth in the second half) and P.V is m64n96k16 (m64n80k16:
// 48, 40 fp32 sums a thread, not 64); the epilogue stores the D columns alone.
// At D = 100 a row is 200 bytes, and half of a [B, S, H, 100] view's heads
// start 8 bytes off a 16-byte boundary, so TMA cannot read it: the producer
// warpgroup's 128 threads copy Q, K and V in 8-byte cp.async pieces straight
// into that layout (`cp_async_rows`, the swizzle computed by hand; rows past
// the sequence zero-filled), and each thread's cp.async.mbarrier.arrive.noinc
// counts one of the 128 arrivals a stage's barrier waits for. Columns 100-127
// are zeroed once for the whole run (no copy writes them); Q.K^T runs 7
// k-steps, the 7th over columns 96-111, and P.V is m64n104k16 (52 sums), whose
// columns 100-103 are not stored: in the last n-tile threads with 2 t4 >= 4
// write nothing. The consumers fence the generic proxy's writes against
// wgmma's reads after each wait.
// At Phi-3-mini's attention (B=1, H=32, S=2048, D=96, causal) the work is
// ~25.8 GFLOP against ~51 MB, bound by operations (~26 us at 989 TF/s); at
// StableLM-3B's (D=80) ~21.5 GFLOP, ~22 us; at OpenLLaMA-3B's (D=100)
// ~26.9 GFLOP, ~27 us; fp16 at each the same; at GPT-NeoX-20B's (fp16, H=64,
// D=96) ~51.5 GFLOP, ~52 us.
template <typename T, int D>
__device__ __forceinline__ void fwd_wgmma_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const RowSrc<T>& src, T* __restrict__ o, float* __restrict__ lse, int H, int KvH,
    int Sq, int Sk, int causal, int window, float scale) {
  using namespace hopper;
  constexpr int KSTEPS = (D + 15) / 16;  // k-steps of Q.K^T
  constexpr int DN = (D + 7) / 8 * 8;    // P.V's width: D rounded up to 8
  constexpr bool COPY = D % 8 != 0;      // rows TMA cannot read: cp.async
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W_BARS);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + W_STAGES;
  uint64_t* empty = full_v + W_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * W_BQ;
  const int kv_offset = Sk - Sq;
  int n_tiles = (Sk + W_BK - 1) / W_BK;
  int first_tile = 0;
  if (causal) {
    const int last_key = kv_offset + min(q0 + W_BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_key / W_BK + 1);
    if (window > 0) first_tile = max(kv_offset + q0 - (window - 1), 0) / W_BK;
  }

  if (threadIdx.x == 0) {
    const uint32_t fills = COPY ? WG_THREADS : 1;  // arrivals that fill a tile
    mbar_init(full_q, fills);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full_k[s], fills);
      mbar_init(&full_v[s], fills);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  if constexpr (COPY) {
    for (int t = 0; t < 1 + 2 * W_STAGES; ++t)
      zero_cols_past<D>(smem + W_TILE * t, threadIdx.x, blockDim.x);
    fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every TMA load, or all 128 copy
    setmaxnreg_dec<COPY ? 40 : 24>();
    if constexpr (COPY) {
      const int p = threadIdx.x;
      const int64_t* st = src.st;
      const T* kp = src.k + b * st[3] + kvh * st[4];
      const T* vp = src.v + b * st[6] + kvh * st[7];
      cp_async_rows<D>(sQ, src.q + b * st[0] + h * st[1], st[2], q0, Sq, p);
      cp_async_arrive_noinc(full_q);
      for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        cp_async_rows<D>(smem + W_TILE * (1 + s), kp, st[5], t * W_BK, Sk, p);
        cp_async_arrive_noinc(&full_k[s]);
        cp_async_rows<D>(smem + W_TILE * (1 + W_STAGES + s), vp, st[8], t * W_BK, Sk, p);
        cp_async_arrive_noinc(&full_v[s]);
      }
      cp_async_wait_all();
    } else if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, W_TILE);
      tma_load_4d(sQ, tm_q, full_q, 0, q0, h, b);
      tma_load_4d(sQ + W_HALF, tm_q, full_q, 64, q0, h, b);
      for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + W_TILE * (1 + s);
        unsigned char* sV = smem + W_TILE * (1 + W_STAGES + s);
        mbar_arrive_expect_tx(&full_k[s], W_TILE);
        tma_load_4d(sK, tm_k, &full_k[s], 0, t * W_BK, kvh, b);
        tma_load_4d(sK + W_HALF, tm_k, &full_k[s], 64, t * W_BK, kvh, b);
        mbar_arrive_expect_tx(&full_v[s], W_TILE);
        tma_load_4d(sV, tm_v, &full_v[s], 0, t * W_BK, kvh, b);
        tma_load_4d(sV + W_HALF, tm_v, &full_v[s], 64, t * W_BK, kvh, b);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<COPY ? 232 : 240>();
    const int cw = threadIdx.x / WG_THREADS - 1;  // this consumer's 64 rows
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int w_row0 = q0 + W_ROWS * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + W_ROWS - 1, Sq - 1);
    const float c = scale * LOG2E;  // raw score -> log2 units
    // a tile the producer copied is read by wgmma only after this fence
    auto wait_full = [&](uint64_t* bar, uint32_t ph) {
      mbar_wait(bar, ph);
      if constexpr (COPY) fence_proxy_async();
    };
    // rows 16 warp + g (r = 0) and + 8 (r = 1) of this warpgroup's 64
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
    const uint64_t dq = desc_kmajor(sQ + W_ROWS * 128 * cw);

    wait_full(full_q, 0);
    for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
      const int s = i % W_STAGES;
      const uint32_t ph = (i / W_STAGES) & 1;
      const int k0 = t * W_BK;
      unsigned char* sK = smem + W_TILE * (1 + s);
      unsigned char* sV = smem + W_TILE * (1 + W_STAGES + s);
      wait_full(&full_k[s], ph);
      // a tile masked for every row of this warpgroup is only released
      if (!w_live || (causal && (k0 > w_last ||
                                 (window > 0 && k0 + W_BK - 1 <= w_first - window)))) {
        mbar_wait(&full_v[s], ph);
        mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q K^T: KSTEPS k-steps of 16 over head_dim, 4 in the first
      // 64-column half and the rest in the second
      float sc[64];
      const uint64_t dk = desc_kmajor(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t off = ((kk / 4) * W_HALF + (kk % 4) * 32) >> 4;
        wgmma_m64n128k16_ss<0, 0, T>(sc, dq + off, dk + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4 j + e]: row 16 warp + g + 8 (e / 2), key k0 + 8 j + 2 t4 + (e % 2)
      const bool need_mask =
          k0 + W_BK > Sk ||
          (causal && (k0 + W_BK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = w_first + 16 * warp + g + 8 * (e >> 1);
            bool ok = key < Sk;
            if (causal) {
              ok = ok && key <= qpos;
              if (window > 0) ok = ok && key > qpos - window;
            }
            if (!ok) sc[4 * j + e] = NEG;
          }
        }
      }

      // online softmax in log2 units; a row's 128 scores lie in the 4 lanes
      // of a quad. While a row has seen only masked keys (m = NEG) its
      // probabilities are 0 here, where the Pallas kernel sums exp(0) = 1
      // per masked key: the first visible key's alpha = 0 clears either.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_ftz((m[r] - mx) * c);
        const float mc = mx == NEG ? 0.f : mx * c;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float p0 = exp2_ftz(fmaf(sc[4 * j + 2 * r], c, -mc));
          const float p1 = exp2_ftz(fmaf(sc[4 * j + 2 * r + 1], c, -mc));
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          rs += p0 + p1;
        }
        l[r] = l[r] * alpha + rs;  // this thread's part of the row sum
        m[r] = mx;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          acc[4 * j + 2 * r] *= alpha;
          acc[4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P in T as the A operand: k-step jj is keys 16 jj .. 16 jj + 15
      uint32_t pa[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        pa[jj][0] = pack_t<T>(sc[8 * jj + 0], sc[8 * jj + 1]);
        pa[jj][1] = pack_t<T>(sc[8 * jj + 2], sc[8 * jj + 3]);
        pa[jj][2] = pack_t<T>(sc[8 * jj + 4], sc[8 * jj + 5]);
        pa[jj][3] = pack_t<T>(sc[8 * jj + 6], sc[8 * jj + 7]);
      }

      // O += P V: V [keys][head_dim] is B, MN-major; its two 64-column
      // halves are LBO apart and each k-step of 16 keys is 2048 bytes
      wait_full(&full_v[s], ph);
      const uint64_t dv = desc_mnmajor(sV, W_HALF);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        wgmma_rs<DN, 1, T>(acc, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (w_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w_row0 + 16 * warp + g + 8 * r;
        if (row >= Sq) continue;
        const float lc = fmaxf(l[r], 1e-30f);
        T* orow = o + ((int64_t)bh * Sq + row) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j)
          if (D % 8 == 0 || 8 * j + 2 * t4 < D)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_t<T>(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
        if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] * scale + logf(lc);
      }
    }
  }
}

#define FWD_WGMMA_TMA_KERNEL(NAME, T, D)                                               \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                             \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k, \
      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,                       \
      float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal, int window,   \
      float scale) {                                                                     \
    fwd_wgmma_body<T, D>(&tm_q, &tm_k, &tm_v, RowSrc<T>{}, o, lse, H, KvH, Sq, Sk,       \
                         causal, window, scale);                                          \
  }
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma_kernel, __nv_bfloat16, 128)
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma96_kernel, __nv_bfloat16, 96)
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma80_kernel, __nv_bfloat16, 80)
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma_f16_kernel, __half, 128)
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma80_f16_kernel, __half, 80)
FWD_WGMMA_TMA_KERNEL(flash_fwd_wgmma96_f16_kernel, __half, 96)
#undef FWD_WGMMA_TMA_KERNEL

#define FWD_WGMMA_COPY_KERNEL(NAME, T, D)                                                \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                             \
      const __grid_constant__ RowSrc<T> src, T* __restrict__ o, float* __restrict__ lse, \
      int H, int KvH, int Sq, int Sk, int causal, int window, float scale) {             \
    fwd_wgmma_body<T, D>(nullptr, nullptr, nullptr, src, o, lse, H, KvH, Sq, Sk, causal,  \
                         window, scale);                                                  \
  }
FWD_WGMMA_COPY_KERNEL(flash_fwd_wgmma100_kernel, __nv_bfloat16, 100)
FWD_WGMMA_COPY_KERNEL(flash_fwd_wgmma100_f16_kernel, __half, 100)
#undef FWD_WGMMA_COPY_KERNEL

// ---- the wgmma kernels at head dim 64 (bf16 and fp16)
// A 64-column bf16 row is 128 bytes, one box of the 128-byte swizzle: every
// tile is one TMA box, Q.K^T has 4 k-steps, and a K or V stage of 128 keys
// is 16 KB, so the ring holds three. A consumer's score tile stays 64 x 128
// (m64n128); P.V is m64n64 with a 32-float sum. At this width one exp2 per
// score weighs as much as the 4 D flops of its two products (the MUFU does
// 16 a cycle on an SM, the tensor cores about 4,096 bf16 flops), so a
// warpgroup's softmax takes as long as its products. Three consumer
// warpgroups (192 q rows a block, 160 registers each) keep the tensor cores
// fed while the other two run their softmax; each takes its steps in order,
// as the D = 128 kernel does. Issuing S(j + 1) before the softmax of S(j)
// inside a warpgroup was slower here on an H100 (PERF.md). At
// bench_mfu's d1024 shape (B=8, H=16, S=2048, causal) the work is ~68.7
// GFLOP against ~135 MB, bound by operations (~69 us at 989 TF/s).
constexpr int F_BK = 128;                  // keys per stage
constexpr int F_STAGES = 3;
constexpr int F_CONS = 3;                  // consumer warpgroups
constexpr int F_BQ = W_ROWS * F_CONS;      // q rows per block
constexpr int F_QTILE = F_BQ * 128;        // bytes of the Q tile
constexpr int F_TILE = F_BK * 128;         // bytes of a K or V stage
constexpr int F_BARS = F_QTILE + 2 * F_STAGES * F_TILE;  // barriers after Q, K[], V[]
constexpr int F_SMEM = F_BARS + 8 * (1 + 3 * F_STAGES) + 1024;  // + alignment slack

// The body of flash_fwd_wgmma64_kernel (bf16) and flash_fwd_wgmma64_f16_kernel
// (fp16: OPT-1.3B's published dtype); as at D = 128, the two differ only in
// the wgmma instructions' type, the maps' and the roundings of P and O.
template <typename T>
__device__ __forceinline__ void fwd_wgmma64_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + F_BARS);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + F_STAGES;
  uint64_t* empty = full_v + F_STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * F_BQ;
  const int kv_offset = Sk - Sq;
  int n_tiles = (Sk + F_BK - 1) / F_BK;
  int first_tile = 0;
  if (causal) {
    const int last_key = kv_offset + min(q0 + F_BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_key / F_BK + 1);
    if (window > 0) first_tile = max(kv_offset + q0 - (window - 1), 0) / F_BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], F_CONS * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, F_QTILE);
      tma_load_4d(sQ, tm_q, full_q, 0, q0, h, b);
      for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
        const int s = i % F_STAGES;
        mbar_wait(&empty[s], ((i / F_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_k[s], F_TILE);
        tma_load_4d(smem + F_QTILE + F_TILE * s, tm_k, &full_k[s], 0, t * F_BK, kvh, b);
        mbar_arrive_expect_tx(&full_v[s], F_TILE);
        tma_load_4d(smem + F_QTILE + F_TILE * (F_STAGES + s), tm_v, &full_v[s], 0,
                    t * F_BK, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<160>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int w_row0 = q0 + W_ROWS * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + W_ROWS - 1, Sq - 1);
    const float c = scale * LOG2E;  // raw score -> log2 units
    // rows 16 warp + g (r = 0) and + 8 (r = 1) of this warpgroup's 64
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const uint64_t dq = desc_kmajor(sQ + W_ROWS * 128 * cw);

    // the tiles this warpgroup sees are [lo, hi): the masked ones are a
    // prefix (before the window) and a suffix (past the diagonal), which it
    // only releases, in loops of their own (a skip inside the one loop cost
    // 7% at the d1024 shape, PERF.md)
    auto sees = [&](int t) {
      const int k0 = t * F_BK;
      return w_live && !(causal && (k0 > w_last ||
                                    (window > 0 && k0 + F_BK - 1 <= w_first - window)));
    };
    int lo = first_tile;
    while (lo < n_tiles && !sees(lo)) ++lo;
    int hi = lo;
    while (hi < n_tiles && sees(hi)) ++hi;
    auto release = [&](int t) {
      const int i = t - first_tile, s = i % F_STAGES;
      const uint32_t ph = (i / F_STAGES) & 1;
      mbar_wait(&full_k[s], ph);
      mbar_wait(&full_v[s], ph);
      mbar_arrive(&empty[s]);
    };
    for (int t = first_tile; t < lo; ++t) release(t);

    mbar_wait(full_q, 0);
    for (int t = lo; t < hi; ++t) {
      const int i = t - first_tile, s = i % F_STAGES;
      const uint32_t ph = (i / F_STAGES) & 1;
      const int k0 = t * F_BK;
      unsigned char* sK = smem + F_QTILE + F_TILE * s;
      unsigned char* sV = smem + F_QTILE + F_TILE * (F_STAGES + s);
      mbar_wait(&full_k[s], ph);

      // S = Q K^T: 4 k-steps of 16 over head_dim, 32 bytes apart
      float sc[64];
      const uint64_t dk = desc_kmajor(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_ss<0, 0, T>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4 j + e]: row 16 warp + g + 8 (e / 2), key k0 + 8 j + 2 t4 + (e % 2)
      const bool need_mask =
          k0 + F_BK > Sk ||
          (causal && (k0 + F_BK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = w_first + 16 * warp + g + 8 * (e >> 1);
            bool ok = key < Sk;
            if (causal) {
              ok = ok && key <= qpos;
              if (window > 0) ok = ok && key > qpos - window;
            }
            if (!ok) sc[4 * j + e] = NEG;
          }
        }
      }

      // online softmax in log2 units, as in flash_fwd_wgmma_kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_ftz((m[r] - mx) * c);
        const float mc = mx == NEG ? 0.f : mx * c;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float p0 = exp2_ftz(fmaf(sc[4 * j + 2 * r], c, -mc));
          const float p1 = exp2_ftz(fmaf(sc[4 * j + 2 * r + 1], c, -mc));
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          rs += p0 + p1;
        }
        l[r] = l[r] * alpha + rs;  // this thread's part of the row sum
        m[r] = mx;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 2 * r] *= alpha;
          acc[4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P in T as the A operand: k-step jj is keys 16 jj .. 16 jj + 15
      uint32_t pa[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[jj][q] = pack_t<T>(sc[8 * jj + 2 * q], sc[8 * jj + 2 * q + 1]);

      // O += P V: V [keys][64] is an MN-major B operand (one 128-byte line a
      // key); a k-step of 16 keys is 2048 bytes
      mbar_wait(&full_v[s], ph);
      const uint64_t dv = desc_mnmajor(sV, F_TILE);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) wgmma_m64n64k16_rs<1, T>(acc, pa[jj], dv + jj * 128, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
    for (int t = hi; t < n_tiles; ++t) release(t);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (w_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w_row0 + 16 * warp + g + 8 * r;
        if (row >= Sq) continue;
        const float lc = fmaxf(l[r], 1e-30f);
        T* orow = o + ((int64_t)bh * Sq + row) * 64 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_t<T>(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
        if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] * scale + logf(lc);
      }
    }
  }
}

#define FWD_WGMMA64_KERNEL(NAME, T)                                                      \
  __global__ void __launch_bounds__((F_CONS + 1) * WG_THREADS, 1) NAME(                  \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k, \
      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,                       \
      float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal, int window,   \
      float scale) {                                                                     \
    fwd_wgmma64_body<T>(&tm_q, &tm_k, &tm_v, o, lse, H, KvH, Sq, Sk, causal, window,     \
                        scale);                                                           \
  }
FWD_WGMMA64_KERNEL(flash_fwd_wgmma64_kernel, __nv_bfloat16)
FWD_WGMMA64_KERNEL(flash_fwd_wgmma64_f16_kernel, __half)
#undef FWD_WGMMA64_KERNEL

// ---- the wgmma kernels at head dim 256 (bf16: Gemma's attention; fp16:
// GPT-J-6B's)
// A 256-wide row is four 128-byte boxes, so Q's 128-row tile is 64 KB, and
// the D = 128 plan does not fit: two stages of 128 keys of K and V would take
// 256 KB beside it, and its 64 fp32 scores beside DN / 2 = 128 output sums a
// thread pass the consumers' 240 registers. Here a stage is 64 keys (K and
// V 32 KB each; two stages and Q make 192 KB of the 227), and each consumer
// warpgroup keeps a 64 x 64 score tile (m64n64k16: 32 floats) beside its
// 64 x 256 O (two m64n128 sums, 128 floats) and P's 16 registers. Q.K^T is
// 16 SS k-steps, four in each 64-column box: Q's boxes (128 rows) lie 16 KB
// apart and K's (64 rows) 8 KB, so each operand steps by its own offset.
// P.V is 4 k-steps of 16 keys, each two RS m64n128k16 over V's column
// halves (boxes 0-1 and 2-3, 16 KB apart; the boxes of a half LBO = 8 KB
// apart). Producer, ring, masks and softmax are the D = 128 kernel's. At
// Gemma-2B's attention (B=1, H=8 over one KV head, S=2048, causal) the work
// is ~17.2 GFLOP against ~10 MB, bound by operations (~17 us at 989 TF/s);
// its 128 blocks are one wave on 132 SMs, so the longest (32 stages) sets
// the time. At GPT-J-6B's (fp16, H=16 with 16 KV heads) ~34.4 GFLOP against
// ~67 MB, ~35 us: 256 blocks, two waves.
constexpr int G_BK = 64;                 // keys per stage
constexpr int G_STAGES = 2;
constexpr int G_QBOX = W_BQ * 128;       // bytes of one 64-column box of Q
constexpr int G_KBOX = G_BK * 128;       // ... of a K or V stage
constexpr int G_QTILE = 4 * G_QBOX;      // the Q tile, 64 KB
constexpr int G_TILE = 4 * G_KBOX;       // a K or V stage, 32 KB
constexpr int G_BARS = G_QTILE + 2 * G_STAGES * G_TILE;  // barriers after Q, K[], V[]
constexpr int G_SMEM = G_BARS + 8 * (1 + 3 * G_STAGES) + 1024;  // + alignment slack

// The body of flash_fwd_wgmma256_kernel (bf16) and
// flash_fwd_wgmma256_f16_kernel (fp16: GPT-J-6B's published dtype); fp16
// differs only in the wgmma forms' element type, the maps' data type and the
// roundings of P and O, as in fwd_wgmma_body.
template <typename T>
__device__ __forceinline__ void fwd_wgmma256_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G_BARS);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + G_STAGES;
  uint64_t* empty = full_v + G_STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KvH);
  const int q0 = qt * W_BQ;
  const int kv_offset = Sk - Sq;
  int n_tiles = (Sk + G_BK - 1) / G_BK;
  int first_tile = 0;
  if (causal) {
    const int last_key = kv_offset + min(q0 + W_BQ, Sq) - 1;
    n_tiles = min(n_tiles, last_key / G_BK + 1);
    if (window > 0) first_tile = max(kv_offset + q0 - (window - 1), 0) / G_BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load, four boxes a tile
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, G_QTILE);
      for (int c = 0; c < 4; ++c) tma_load_4d(sQ + G_QBOX * c, tm_q, full_q, 64 * c, q0, h, b);
      for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
        const int s = i % G_STAGES;
        mbar_wait(&empty[s], ((i / G_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + G_QTILE + G_TILE * s;
        unsigned char* sV = smem + G_QTILE + G_TILE * (G_STAGES + s);
        mbar_arrive_expect_tx(&full_k[s], G_TILE);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(sK + G_KBOX * c, tm_k, &full_k[s], 64 * c, t * G_BK, kvh, b);
        mbar_arrive_expect_tx(&full_v[s], G_TILE);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(sV + G_KBOX * c, tm_v, &full_v[s], 64 * c, t * G_BK, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int w_row0 = q0 + W_ROWS * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + W_ROWS - 1, Sq - 1);
    const float c = scale * LOG2E;  // raw score -> log2 units
    // rows 16 warp + g (r = 0) and + 8 (r = 1) of this warpgroup's 64;
    // acc[hf] holds O's columns 128 hf .. 128 hf + 127 in the m64n128 layout
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    const uint64_t dq = desc_kmajor(sQ + W_ROWS * 128 * cw);

    mbar_wait(full_q, 0);
    for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
      const int s = i % G_STAGES;
      const uint32_t ph = (i / G_STAGES) & 1;
      const int k0 = t * G_BK;
      unsigned char* sK = smem + G_QTILE + G_TILE * s;
      unsigned char* sV = smem + G_QTILE + G_TILE * (G_STAGES + s);
      mbar_wait(&full_k[s], ph);
      // a tile masked for every row of this warpgroup is only released
      if (!w_live || (causal && (k0 > w_last ||
                                 (window > 0 && k0 + G_BK - 1 <= w_first - window)))) {
        mbar_wait(&full_v[s], ph);
        mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q K^T: 16 k-steps of 16 over head_dim; k-step kk is 32 (kk % 4)
      // bytes into box kk / 4 of each operand
      float sc[32];
      const uint64_t dk = desc_kmajor(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_m64n64k16_ss<0, 0, T>(sc, dq + (((kk / 4) * G_QBOX + (kk % 4) * 32) >> 4),
                                    dk + (((kk / 4) * G_KBOX + (kk % 4) * 32) >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4 j + e]: row 16 warp + g + 8 (e / 2), key k0 + 8 j + 2 t4 + (e % 2)
      const bool need_mask =
          k0 + G_BK > Sk ||
          (causal && (k0 + G_BK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = w_first + 16 * warp + g + 8 * (e >> 1);
            bool ok = key < Sk;
            if (causal) {
              ok = ok && key <= qpos;
              if (window > 0) ok = ok && key > qpos - window;
            }
            if (!ok) sc[4 * j + e] = NEG;
          }
        }
      }

      // online softmax in log2 units, as in flash_fwd_wgmma_kernel; a row's
      // 64 scores lie in the 4 lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_ftz((m[r] - mx) * c);
        const float mc = mx == NEG ? 0.f : mx * c;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = exp2_ftz(fmaf(sc[4 * j + 2 * r], c, -mc));
          const float p1 = exp2_ftz(fmaf(sc[4 * j + 2 * r + 1], c, -mc));
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          rs += p0 + p1;
        }
        l[r] = l[r] * alpha + rs;  // this thread's part of the row sum
        m[r] = mx;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[0][4 * j + 2 * r] *= alpha;
          acc[0][4 * j + 2 * r + 1] *= alpha;
          acc[1][4 * j + 2 * r] *= alpha;
          acc[1][4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P in T as the A operand: k-step jj is keys 16 jj .. 16 jj + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[jj][q] = pack_t<T>(sc[8 * jj + 2 * q], sc[8 * jj + 2 * q + 1]);

      // O += P V: V [64 keys][256] is an MN-major B operand in four boxes of
      // 64 columns, 8 KB apart (LBO); a k-step of 16 keys is 2048 bytes, and
      // the second half of the columns starts two boxes on
      mbar_wait(&full_v[s], ph);
      const uint64_t dv = desc_mnmajor(sV, G_KBOX);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        wgmma_m64n128k16_rs<1, T>(acc[0], pa[jj], dv + ((jj * 2048) >> 4), 1);
        wgmma_m64n128k16_rs<1, T>(acc[1], pa[jj], dv + ((2 * G_KBOX + jj * 2048) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (w_live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = w_row0 + 16 * warp + g + 8 * r;
        if (row >= Sq) continue;
        const float lc = fmaxf(l[r], 1e-30f);
        T* orow = o + ((int64_t)bh * Sq + row) * 256 + 2 * t4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<uint32_t*>(orow + 128 * hf + 8 * j) =
                pack_t<T>(acc[hf][4 * j + 2 * r] / lc, acc[hf][4 * j + 2 * r + 1] / lc);
        if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] * scale + logf(lc);
      }
    }
  }
}

#define FWD_WGMMA256_KERNEL(NAME, T)                                                     \
  __global__ void __launch_bounds__(3 * WG_THREADS, 1) NAME(                             \
      const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k, \
      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,                       \
      float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal, int window,   \
      float scale) {                                                                     \
    fwd_wgmma256_body<T>(&tm_q, &tm_k, &tm_v, o, lse, H, KvH, Sq, Sk, causal, window,    \
                         scale);                                                          \
  }
FWD_WGMMA256_KERNEL(flash_fwd_wgmma256_kernel, __nv_bfloat16)
FWD_WGMMA256_KERNEL(flash_fwd_wgmma256_f16_kernel, __half)
#undef FWD_WGMMA256_KERNEL

// ---- host entry
// cudaFuncSetAttribute once per kernel instantiation (C++ statics initialise
// once, thread-safe), not on every launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, H, KvH, Sq, Sk, D;
  const int64_t* st;  // (batch, head, seq) strides of q, k, v in elements
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_simt(const Args& a) {
  constexpr int SB = simt_tile(DP);
  constexpr int smem = (int)sizeof(float) * (SB * (DP + 1) * 2 + SB * DP + SB * (SB + 4));
  static const cudaError_t attr = allow_smem(flash_fwd_simt_kernel<T, DP>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + SB - 1) / SB, a.B * a.H);
  const int64_t* st = a.st;
  flash_fwd_simt_kernel<T, DP><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.lse, a.H,
      a.KvH, a.Sq, a.Sk, a.D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DP, bool PAD>
cudaError_t launch_mma(const Args& a) {
  constexpr int smem = (int)sizeof(T) * (BQ + 2 * BK) * (DP + 8);
  static const cudaError_t attr = allow_smem(flash_fwd_mma_kernel<T, DP, PAD>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  const int64_t* st = a.st;
  flash_fwd_mma_kernel<T, DP, PAD><<<grid, NT_MMA, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.lse, a.H, a.KvH,
      a.Sq, a.Sk, a.D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// the three 4-D maps (head_dim D, seq, heads, batch) of a wgmma launch over
// tensors of `type`, boxes of `q_rows` rows of q and `kv_rows` of k and v;
// false if cuTensorMapEncodeTiled refuses one
bool fwd_maps(const Args& a, int D, CUtensorMapDataType type, uint32_t q_rows,
              uint32_t kv_rows, CUtensorMap (&maps)[3]) {
  const int64_t* st = a.st;
  const int64_t q_dims[4] = {D, a.Sq, a.H, a.B};
  const int64_t kv_dims[4] = {D, a.Sk, a.KvH, a.B};
  const void* bases[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    // strides (seq, head, batch), innermost first after head_dim
    const int64_t strides[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    if (!hopper::make_map_4d(&maps[i], type, bases[i], i == 0 ? q_dims : kv_dims,
                             strides, i == 0 ? q_rows : kv_rows))
      return false;
  }
  return true;
}

// whether a wgmma kernel takes (dtype, D): bf16 (dtype 1) and fp16 (dtype 2)
// alike at 64, 80, 96, 100, 128 and 256
bool has_wgmma(int dtype, int D) {
  return (dtype == 1 || dtype == 2) &&
         (D == 64 || D == 80 || D == 96 || D == 100 || D == 128 || D == 256);
}

// the rows of q, k and v for a kernel that copies them itself (D = 100)
template <typename T>
RowSrc<T> row_src(const Args& a) {
  RowSrc<T> src{(const T*)a.q, (const T*)a.k, (const T*)a.v, {}};
  for (int i = 0; i < 9; ++i) src.st[i] = a.st[i];
  return src;
}

// The kernel of (dtype, D), each chosen by both: bf16 (dtype 1) at D = 128:
// flash_fwd_wgmma_kernel; at D = 96, 80 and 100: flash_fwd_wgmma96_kernel,
// flash_fwd_wgmma80_kernel and flash_fwd_wgmma100_kernel (which takes the
// rows themselves, not maps), on the same grid; at D = 256:
// flash_fwd_wgmma256_kernel, on that grid too; at D = 64:
// flash_fwd_wgmma64_kernel, its grid with the q tiles of one (batch, head)
// side by side. fp16 (dtype 2) at D = 128, 96, 80 and 100:
// flash_fwd_wgmma_f16_kernel, flash_fwd_wgmma96_f16_kernel,
// flash_fwd_wgmma80_f16_kernel and flash_fwd_wgmma100_f16_kernel, on the D =
// 128 grid; at D = 256: flash_fwd_wgmma256_f16_kernel, on that grid too; at
// D = 64: flash_fwd_wgmma64_f16_kernel, on the D = 64 one. Any other pair
// returns cudaErrorInvalidValue and launches nothing.
cudaError_t launch_wgmma(const Args& a, int D, int dtype) {
  if (!has_wgmma(dtype, D)) return cudaErrorInvalidValue;
  static const cudaError_t attr128 = allow_smem(flash_fwd_wgmma_kernel, W_SMEM);
  static const cudaError_t attr96 = allow_smem(flash_fwd_wgmma96_kernel, W_SMEM);
  static const cudaError_t attr80 = allow_smem(flash_fwd_wgmma80_kernel, W_SMEM);
  static const cudaError_t attr100 = allow_smem(flash_fwd_wgmma100_kernel, W_SMEM);
  static const cudaError_t attr256 = allow_smem(flash_fwd_wgmma256_kernel, G_SMEM);
  static const cudaError_t attr64 = allow_smem(flash_fwd_wgmma64_kernel, F_SMEM);
  static const cudaError_t attr64_f16 = allow_smem(flash_fwd_wgmma64_f16_kernel, F_SMEM);
  static const cudaError_t attr_f16 = allow_smem(flash_fwd_wgmma_f16_kernel, W_SMEM);
  static const cudaError_t attr80_f16 = allow_smem(flash_fwd_wgmma80_f16_kernel, W_SMEM);
  static const cudaError_t attr100_f16 = allow_smem(flash_fwd_wgmma100_f16_kernel, W_SMEM);
  static const cudaError_t attr96_f16 = allow_smem(flash_fwd_wgmma96_f16_kernel, W_SMEM);
  static const cudaError_t attr256_f16 = allow_smem(flash_fwd_wgmma256_f16_kernel, G_SMEM);
  const bool f16 = dtype == 2;
  const cudaError_t attr = D == 64    ? (f16 ? attr64_f16 : attr64)
                           : D == 80  ? (f16 ? attr80_f16 : attr80)
                           : D == 96  ? (f16 ? attr96_f16 : attr96)
                           : D == 100 ? (f16 ? attr100_f16 : attr100)
                           : D == 128 ? (f16 ? attr_f16 : attr128)
                                      : (f16 ? attr256_f16 : attr256);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.B * a.H, (a.Sq + W_BQ - 1) / W_BQ);
  if (D == 100) {
    if (f16)
      flash_fwd_wgmma100_f16_kernel<<<grid, 3 * WG_THREADS, W_SMEM, a.stream>>>(
          row_src<__half>(a), (__half*)a.o, (float*)a.lse, a.H, a.KvH, a.Sq, a.Sk,
          a.causal, a.window, a.scale);
    else
      flash_fwd_wgmma100_kernel<<<grid, 3 * WG_THREADS, W_SMEM, a.stream>>>(
          row_src<__nv_bfloat16>(a), (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
          a.Sq, a.Sk, a.causal, a.window, a.scale);
    return cudaGetLastError();
  }
  CUtensorMap maps[3];
  const CUtensorMapDataType type =
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (D == 64) {
    if (!fwd_maps(a, D, type, F_BQ, F_BK, maps)) return cudaErrorInvalidValue;
    const dim3 grid64((a.Sq + F_BQ - 1) / F_BQ, a.B * a.H);
    if (f16)
      flash_fwd_wgmma64_f16_kernel<<<grid64, (F_CONS + 1) * WG_THREADS, F_SMEM, a.stream>>>(
          maps[0], maps[1], maps[2], (__half*)a.o, (float*)a.lse, a.H, a.KvH, a.Sq, a.Sk,
          a.causal, a.window, a.scale);
    else
      flash_fwd_wgmma64_kernel<<<grid64, (F_CONS + 1) * WG_THREADS, F_SMEM, a.stream>>>(
          maps[0], maps[1], maps[2], (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
          a.Sq, a.Sk, a.causal, a.window, a.scale);
  } else if (D == 256) {
    if (!fwd_maps(a, D, type, W_BQ, G_BK, maps)) return cudaErrorInvalidValue;
    if (f16)
      flash_fwd_wgmma256_f16_kernel<<<grid, 3 * WG_THREADS, G_SMEM, a.stream>>>(
          maps[0], maps[1], maps[2], (__half*)a.o, (float*)a.lse, a.H, a.KvH, a.Sq, a.Sk,
          a.causal, a.window, a.scale);
    else
      flash_fwd_wgmma256_kernel<<<grid, 3 * WG_THREADS, G_SMEM, a.stream>>>(
          maps[0], maps[1], maps[2], (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
          a.Sq, a.Sk, a.causal, a.window, a.scale);
  } else if (f16) {
    if (!fwd_maps(a, D, type, W_BQ, W_BK, maps)) return cudaErrorInvalidValue;
    auto kernel = D == 96   ? flash_fwd_wgmma96_f16_kernel
                  : D == 80 ? flash_fwd_wgmma80_f16_kernel
                            : flash_fwd_wgmma_f16_kernel;
    kernel<<<grid, 3 * WG_THREADS, W_SMEM, a.stream>>>(
        maps[0], maps[1], maps[2], (__half*)a.o, (float*)a.lse, a.H, a.KvH, a.Sq, a.Sk,
        a.causal, a.window, a.scale);
  } else {
    if (!fwd_maps(a, D, type, W_BQ, W_BK, maps)) return cudaErrorInvalidValue;
    auto kernel = D == 96   ? flash_fwd_wgmma96_kernel
                  : D == 80 ? flash_fwd_wgmma80_kernel
                            : flash_fwd_wgmma_kernel;
    kernel<<<grid, 3 * WG_THREADS, W_SMEM, a.stream>>>(
        maps[0], maps[1], maps[2], (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
        a.Sq, a.Sk, a.causal, a.window, a.scale);
  }
  return cudaGetLastError();
}

// the launch of kernel `Launch<T, DP>` at the padded width of a.D
template <typename T, template <typename, int> class Launch>
cudaError_t at_padded_dim(const Args& a) {
  switch (padded_dim(a.D)) {
    case 32: return Launch<T, 32>::run(a);
    case 64: return Launch<T, 64>::run(a);
    case 128: return Launch<T, 128>::run(a);
    case 256: return Launch<T, 256>::run(a);
    case 512: return Launch<T, 512>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int DP>
struct Simt {
  static cudaError_t run(const Args& a) { return launch_simt<T, DP>(a); }
};
// the exact build at D = 32, 64 and 128, the padded one below them; DP =
// 256 has the padded build alone, and DP = 512 none (simt alone)
template <typename T, int DP>
struct Mma {
  static cudaError_t run(const Args& a) {
    if constexpr (DP > 256) {
      return cudaErrorInvalidValue;
    } else {
      if constexpr (DP < 256) {
        if (a.D == DP) return launch_mma<T, DP, false>(a);
      }
      return launch_mma<T, DP, true>(a);
    }
  }
};

}  // namespace

// q, k, v: [B, H|KvH, S, D] with the given (batch, head, seq) strides and a
// contiguous last dim; o: contiguous [B, H, Sq, D]; lse: contiguous fp32
// [B, H, Sq]. dtype 0 = fp32, 1 = bf16, 2 = fp16. window <= 0 means no
// window. route: 0 = simt (any dtype, D from 1 to 512), 1 = mma (bf16 or
// fp16, D a multiple of 8 up to 256, 16-byte aligned bases, strides that
// are multiples of 8), 2 = wgmma (as mma, and Sk > 0, with bf16 or fp16 at
// D = 64, 80, 96, 128 or 256; or bf16 or fp16 at D = 100 with 8-byte aligned
// bases and strides that are multiples of 4). The simt and mma kernels run at
// the padded width of D (padded_dim), the wgmma kernels at D itself. A route that cannot take the
// inputs returns cudaErrorInvalidValue and launches nothing. Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int route, int device, int B,
                         int H, int KvH, int Sq, int Sk, int D,
                         int64_t q_sb, int64_t q_sh, int64_t q_ss,
                         int64_t k_sb, int64_t k_sh, int64_t k_ss,
                         int64_t v_sb, int64_t v_sh, int64_t v_ss,
                         int causal, int window, float scale, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const Args a{q, k, v, o, lse, B, H, KvH, Sq, Sk, D, st, causal, window, scale,
               (cudaStream_t)stream};
  const void* ptrs[3] = {q, k, v};
  const bool aligned = rows_aligned(ptrs, 3, st, 9, D);
  switch (route) {
    case 0:
      if (dtype == 0) return (int)at_padded_dim<float, Simt>(a);
      if (dtype == 1) return (int)at_padded_dim<__nv_bfloat16, Simt>(a);
      if (dtype == 2) return (int)at_padded_dim<__half, Simt>(a);
      return (int)cudaErrorInvalidValue;
    case 1:
      if (!aligned) return (int)cudaErrorInvalidValue;
      if (dtype == 1) return (int)at_padded_dim<__nv_bfloat16, Mma>(a);
      if (dtype == 2) return (int)at_padded_dim<__half, Mma>(a);
      return (int)cudaErrorInvalidValue;
    case 2: {
      // the D = 100 kernels copy their 200-byte rows in 8-byte pieces; a
      // (dtype, D) without a kernel is refused by launch_wgmma
      const bool rows_ok = D == 100 ? rows_aligned(ptrs, 3, st, 9, D, 8) : aligned;
      if (!rows_ok || Sk <= 0) return (int)cudaErrorInvalidValue;
      return (int)launch_wgmma(a, D, dtype);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
