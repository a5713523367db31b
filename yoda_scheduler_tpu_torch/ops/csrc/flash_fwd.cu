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
// every shape runs here. Three kernels share that plan; the caller names one
// (ops/attention.py:_route picks it from dtype, head_dim and alignment):
// - flash_fwd_wgmma_kernel (route 2; bf16, D = 128, 16-byte aligned rows: the
//   main path): TMA-fed and warp-specialised, on wgmma. Below.
// - flash_fwd_mma_kernel (route 1; aligned bf16, the route of D = 32 and 64;
//   it takes D = 128 too, to be held against the wgmma kernel): 4 warps, each
//   owning 16 of 64 q rows, mma.sync m16n8k16 for both products; K/V
//   tiles of 64 keys copied through registers. Scores, probabilities and the
//   output sum stay in registers; P is rounded to bf16 for P.V as the plain
//   version rounds its probabilities. The fp32 scores are scaled (rather than
//   Q, which would round Q a second time). A warp skips the tiles that are
//   masked for all of its rows.
// - flash_fwd_simt_kernel (route 0; fp32, and bf16 rows not 16-byte aligned):
//   scalar fp32 FMAs from shared memory with Q pre-scaled in fp32 as in the
//   Pallas kernel; 256 threads as a 16 x 16 grid, each owning 4 q rows.
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
// rounds P to bf16 in registers (the m64n128 accumulator is laid out as the A
// operand of the RS form) and adds P V with 8 RS wgmma (V as an MN-major B
// operand). The row sums l stay per thread until the epilogue.
#include "flash_common.cuh"
#include "hopper.cuh"

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


// ---- the wgmma kernel (bf16, D = 128)
constexpr int WG_THREADS = 128;
constexpr int W_ROWS = 64;                  // q rows per consumer warpgroup
constexpr int W_BQ = 2 * W_ROWS;            // q rows per block
constexpr int W_BK = 128;                   // keys per stage
constexpr int W_STAGES = 2;
constexpr int W_HALF = 128 * 128;           // bytes of one 64-column half of a 128-row tile
constexpr int W_TILE = 2 * W_HALF;          // bytes of a 128 x 128 bf16 tile
constexpr int W_BARS = W_TILE * (1 + 2 * W_STAGES);  // barriers after Q, K[], V[]
constexpr int W_SMEM = W_BARS + 8 * (1 + 3 * W_STAGES) + 1024;  // + alignment slack

__global__ void __launch_bounds__(3 * WG_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int KvH, int Sq, int Sk, int causal,
    int window, float scale) {
  using namespace hopper;
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
    mbar_init(full_q, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // ---- producer: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_q, W_TILE);
      tma_load_4d(sQ, &tm_q, full_q, 0, q0, h, b);
      tma_load_4d(sQ + W_HALF, &tm_q, full_q, 64, q0, h, b);
      for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
        const int s = i % W_STAGES;
        mbar_wait(&empty[s], ((i / W_STAGES) & 1) ^ 1);
        unsigned char* sK = smem + W_TILE * (1 + s);
        unsigned char* sV = smem + W_TILE * (1 + W_STAGES + s);
        mbar_arrive_expect_tx(&full_k[s], W_TILE);
        tma_load_4d(sK, &tm_k, &full_k[s], 0, t * W_BK, kvh, b);
        tma_load_4d(sK + W_HALF, &tm_k, &full_k[s], 64, t * W_BK, kvh, b);
        mbar_arrive_expect_tx(&full_v[s], W_TILE);
        tma_load_4d(sV, &tm_v, &full_v[s], 0, t * W_BK, kvh, b);
        tma_load_4d(sV + W_HALF, &tm_v, &full_v[s], 64, t * W_BK, kvh, b);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG_THREADS - 1;  // this consumer's 64 rows
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int w_row0 = q0 + W_ROWS * cw;
    const bool w_live = w_row0 < Sq;
    const int w_first = kv_offset + w_row0;
    const int w_last = kv_offset + min(w_row0 + W_ROWS - 1, Sq - 1);
    const float c = scale * LOG2E;  // raw score -> log2 units
    // rows 16 warp + g (r = 0) and + 8 (r = 1) of this warpgroup's 64
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint64_t dq = desc_kmajor(sQ + W_ROWS * 128 * cw);

    mbar_wait(full_q, 0);
    for (int t = first_tile, i = 0; t < n_tiles; ++t, ++i) {
      const int s = i % W_STAGES;
      const uint32_t ph = (i / W_STAGES) & 1;
      const int k0 = t * W_BK;
      unsigned char* sK = smem + W_TILE * (1 + s);
      unsigned char* sV = smem + W_TILE * (1 + W_STAGES + s);
      mbar_wait(&full_k[s], ph);
      // a tile masked for every row of this warpgroup is only released
      if (!w_live || (causal && (k0 > w_last ||
                                 (window > 0 && k0 + W_BK - 1 <= w_first - window)))) {
        mbar_wait(&full_v[s], ph);
        mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q K^T: 8 k-steps of 16 over head_dim, 4 in each 64-column half
      float sc[64];
      const uint64_t dk = desc_kmajor(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t off = ((kk / 4) * W_HALF + (kk % 4) * 32) >> 4;
        wgmma_m64n128k16_ss<0, 0>(sc, dq + off, dk + off, kk > 0);
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
        for (int j = 0; j < 16; ++j) {
          acc[4 * j + 2 * r] *= alpha;
          acc[4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P in bf16 as the A operand: k-step jj is keys 16 jj .. 16 jj + 15
      uint32_t pa[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        pa[jj][0] = pack_bf16(sc[8 * jj + 0], sc[8 * jj + 1]);
        pa[jj][1] = pack_bf16(sc[8 * jj + 2], sc[8 * jj + 3]);
        pa[jj][2] = pack_bf16(sc[8 * jj + 4], sc[8 * jj + 5]);
        pa[jj][3] = pack_bf16(sc[8 * jj + 6], sc[8 * jj + 7]);
      }

      // O += P V: V [keys][head_dim] is B, MN-major; its two 64-column
      // halves are LBO apart and each k-step of 16 keys is 2048 bytes
      mbar_wait(&full_v[s], ph);
      const uint64_t dv = desc_mnmajor(sV, W_HALF);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        wgmma_m64n128k16_rs<1>(acc, pa[jj], dv + ((jj * 16 * 128) >> 4), 1);
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
        __nv_bfloat16* orow = o + ((int64_t)bh * Sq + row) * 128 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
        if (t4 == 0) lse[(int64_t)bh * Sq + row] = m[r] * scale + logf(lc);
      }
    }
  }
}

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
  int B, H, KvH, Sq, Sk;
  const int64_t* st;  // (batch, head, seq) strides of q, k, v in elements
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_simt(const Args& a) {
  constexpr int smem = (int)sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * BKP);
  static const cudaError_t attr = allow_smem(flash_fwd_simt_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  const int64_t* st = a.st;
  flash_fwd_simt_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.lse, a.H,
      a.KvH, a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  constexpr int smem = (int)sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (D + 8);
  static const cudaError_t attr = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  const int64_t* st = a.st;
  flash_fwd_mma_kernel<D><<<grid, NT_MMA, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
      a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const Args& a) {
  static const cudaError_t attr = allow_smem(flash_fwd_wgmma_kernel, W_SMEM);
  if (attr != cudaSuccess) return attr;
  const int64_t* st = a.st;
  CUtensorMap maps[3];
  const int64_t q_dims[4] = {128, a.Sq, a.H, a.B};
  const int64_t kv_dims[4] = {128, a.Sk, a.KvH, a.B};
  const void* bases[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    // strides (seq, head, batch), innermost first after head_dim
    const int64_t strides[3] = {st[3 * i + 2], st[3 * i + 1], st[3 * i]};
    const uint32_t rows = i == 0 ? W_BQ : W_BK;
    if (!hopper::make_map_bf16_4d(&maps[i], bases[i], i == 0 ? q_dims : kv_dims,
                                  strides, rows))
      return cudaErrorInvalidValue;
  }
  const dim3 grid(a.B * a.H, (a.Sq + W_BQ - 1) / W_BQ);
  flash_fwd_wgmma_kernel<<<grid, 3 * WG_THREADS, W_SMEM, a.stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)a.o, (float*)a.lse, a.H, a.KvH,
      a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_d(int D, const Args& a) {
  switch (D) {
    case 32: return launch_simt<T, 32>(a);
    case 64: return launch_simt<T, 64>(a);
    case 128: return launch_simt<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, H|KvH, S, D] with the given (batch, head, seq) strides and a
// contiguous last dim; o: contiguous [B, H, Sq, D]; lse: contiguous fp32
// [B, H, Sq]. dtype 0 = fp32, 1 = bf16. window <= 0 means no window. route:
// 0 = simt (any input), 1 = mma (bf16, 16-byte aligned bases, strides that
// are multiples of 8), 2 = wgmma (as mma, and D = 128, Sk > 0). A route that
// cannot take the inputs returns cudaErrorInvalidValue and launches nothing.
// Returns the launch's cudaError_t (0 on success).
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
  const Args a{q, k, v, o, lse, B, H, KvH, Sq, Sk, st, causal, window, scale,
               (cudaStream_t)stream};
  const void* ptrs[3] = {q, k, v};
  const bool tensor_core = dtype == 1 && rows_aligned(ptrs, 3, st, 9);
  switch (route) {
    case 0:
      if (dtype == 0) return (int)launch_simt_d<float>(D, a);
      if (dtype == 1) return (int)launch_simt_d<__nv_bfloat16>(D, a);
      return (int)cudaErrorInvalidValue;
    case 1:
      if (!tensor_core) return (int)cudaErrorInvalidValue;
      switch (D) {
        case 32: return (int)launch_mma<32>(a);
        case 64: return (int)launch_mma<64>(a);
        case 128: return (int)launch_mma<128>(a);
        default: return (int)cudaErrorInvalidValue;
      }
    case 2:
      if (!tensor_core || D != 128 || Sk <= 0) return (int)cudaErrorInvalidValue;
      return (int)launch_wgmma(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
