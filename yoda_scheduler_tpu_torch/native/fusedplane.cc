// Fused scheduling kernel: one GIL-releasing filter+score+top-k pass.
//
// C++ twin of the engine's per-cycle hot path over the ColumnarTable
// (scheduler/columnar.py): in ONE call it computes
//
//   1. the combined feasibility mask — TelemetryFilter's capacity/
//      staleness/partition predicates and NodeAdmission's cordon +
//      nodeSelector fast checks — replayed over the table rows in the
//      engine's rotating-offset early-stop scan order, stopping once
//      `want` (= core.Scheduler._num_feasible_to_find) candidates pass;
//   2. per-candidate qualifying-chip aggregates: the six attribute sums
//      TelemetryScore.basic reads, and the per-node maxima MaxCollection
//      folds into the cycle's MaxValue (integer ops — exact in both
//      languages);
//   3. the raw score terms for TelemetryScore (basic + allocate +
//      actual) and FragmentationScore, written OP-FOR-OP like the numpy
//      batch forms so every float is bit-identical (IEEE 754 double ops
//      are deterministic given the same values in the same order);
//   4. optionally the fused normalize+weighted totals — minmax exactly
//      as framework.min_max_normalize folded the way
//      core.Scheduler._fold_scores folds it (EDIT IN LOCKSTEP with
//      those two and _commit_batch's vectorized fold) — used by the
//      engine only when every active scorer is native.
//
// The caller (scheduler/nativeplane.py) passes raw pointers into the
// ColumnarTable's numpy buffers — zero copies — and ctypes releases the
// GIL for the call's duration, so reflector threads and binder workers
// ingest DURING a scan instead of behind it. The Python paths (scalar
// per-node, numpy columnar) stay wired in as fallback and ground truth;
// parity is pinned by tests/test_native_plane.py.
//
// Build: utils/nativeloader.py compiles it into libyodaplace.so with the
// other planes at first use (g++ -O2 -std=c++17 -shared -fPIC).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// ABI handshake: the loader refuses a stale .so whose struct layout
// predates the Python side's expectations (per-kernel fallback, never a
// crash). Bump on ANY layout or semantic change below.
int64_t yoda_plane_abi(void) { return 1; }

// Zero-copy views of the ColumnarTable's columns. Node columns are
// length n; chip columns are row-major n x width. numpy bool_ is one
// byte, so bool columns arrive as uint8.
struct YodaPlaneCols {
  int64_t n;
  int64_t width;
  const uint8_t* valid;
  const double* heartbeat;
  const int64_t* accel;
  const int64_t* gen;
  const uint8_t* unsched;
  const int64_t* label_class;
  const int64_t* free_count;
  const int64_t* hbm_total_sum;
  const int64_t* hbm_free_sum;
  const int64_t* claimed_hbm;
  const uint8_t* chip_free;
  const int64_t* chip_hbm_free;
  const int64_t* chip_hbm_total;
  const int64_t* chip_clock;
  const int64_t* chip_bw;
  const int64_t* chip_core;
  const int64_t* chip_power;
};

// One pod's fused request: filter predicates, scan window, scorer
// weights. Field semantics mirror the plugins' filter_batch/score_batch
// args exactly (plugins/filter.py, plugins/admission.py,
// plugins/score.py).
struct YodaPlaneReq {
  // TelemetryFilter (0 = plugin relevance-gated out of this cycle)
  int64_t tel_filter;
  int64_t degraded;        // blackout mode: staleness gate waived
  double now;
  double max_age;
  int64_t use_accel;       // 0 = no accelerator partition constraint
  int64_t accel_id;        // interned id (columnar.intern_of)
  int64_t use_gen;
  int64_t gen_id;
  int64_t chips;           // spec.chips
  int64_t min_free_mb;     // per-chip class floors
  int64_t min_clock_mhz;
  // NodeAdmission fast checks
  int64_t check_cordon;    // pod does not tolerate cordon
  const uint8_t* sel_by_class;  // per-label-class selector verdict, or null
  int64_t n_classes;
  // rotating early-stop scan (core._columnar_filter semantics)
  int64_t start;
  int64_t want;
  // scorers
  int64_t tel_score;       // TelemetryScore active this cycle
  int64_t frag_score;      // FragmentationScore active this cycle
  int64_t frag_single;     // spec.chips == 1 (else frag raw is all zeros)
  double w_bw, w_clock, w_core, w_power, w_fm, w_tm;  // ScoreWeights
  double w_alloc, w_actual;
  double tel_weight;       // plugin weights in the engine's fold
  double frag_weight;
  int64_t compute_totals;  // every active scorer is native: emit totals
};

// Outputs; every pointer is caller-allocated with capacity `want`
// (contrib: want x 6). mv6 is the cycle MaxValue fold over the selected
// candidates, order (bandwidth, clock, core, free_memory, power,
// total_memory) — ClassStats.maxima order.
struct YodaPlaneOut {
  int64_t* rows;     // selected row indices, scan order
  int64_t* contrib;  // per-candidate qualifying maxima (row-major x6)
  int64_t* qcount;   // per-candidate qualifying-chip count
  double* tel;       // TelemetryScore raw terms
  double* frag;      // FragmentationScore raw terms
  double* totals;    // fused normalize+weighted sum (compute_totals)
  int64_t checked;   // rows visited, for the engine's _filter_start
  int64_t mv6[6];
};

namespace {

// Combined feasibility verdict for one row — predicate-for-predicate
// the AND of TelemetryFilter.filter_batch and NodeAdmission.filter_batch
// (order-independent boolean checks, so early exits are safe).
inline bool row_feasible(const YodaPlaneCols* c, const YodaPlaneReq* r,
                         int64_t i) {
  if (r->check_cordon && c->unsched[i]) return false;
  if (r->sel_by_class != nullptr) {
    int64_t lc = c->label_class[i];
    if (lc < 0 || lc >= r->n_classes || !r->sel_by_class[lc]) return false;
  }
  if (r->tel_filter) {
    if (!c->valid[i]) return false;
    if (!r->degraded && (r->now - c->heartbeat[i]) > r->max_age)
      return false;
    if (r->use_accel && c->accel[i] != r->accel_id) return false;
    if (r->use_gen && c->gen[i] != r->gen_id) return false;
    if (c->free_count[i] < r->chips) return false;
    // qualifying-chip count with early exit at the class floor
    const uint8_t* cf = c->chip_free + i * c->width;
    const int64_t* hf = c->chip_hbm_free + i * c->width;
    const int64_t* ck = c->chip_clock + i * c->width;
    int64_t q = 0;
    for (int64_t j = 0; j < c->width; ++j) {
      if (cf[j] && hf[j] >= r->min_free_mb && ck[j] >= r->min_clock_mhz) {
        if (++q >= r->chips) return true;
      }
    }
    return q >= r->chips;  // chips == 0: trivially true, like numpy
  }
  return true;
}

}  // namespace

// Returns the number of selected candidates (0 = no row passed; the
// engine then falls back to the scalar scan, which owns the per-node
// failure diagnostics), or -1 on malformed input.
int64_t yoda_fused_cycle(const YodaPlaneCols* c, const YodaPlaneReq* r,
                         YodaPlaneOut* o) {
  const int64_t n = c->n;
  const int64_t w = c->width;
  if (n <= 0 || w <= 0 || r->want <= 0 || r->start < 0 || r->start >= n)
    return -1;

  // ---- pass 1: rotating early-stop scan over the combined mask.
  // Visits rows in the engine's order ((start + k) % n); `checked`
  // follows core._columnar_filter exactly: position of the want-th
  // passer + 1, or n when the scan exhausted the table.
  int64_t found = 0;
  int64_t checked = n;
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = r->start + k;
    if (i >= n) i -= n;
    if (row_feasible(c, r, i)) {
      o->rows[found++] = i;
      if (found >= r->want) {
        checked = k + 1;
        break;
      }
    }
  }
  o->checked = checked;
  if (found == 0) return 0;

  // ---- pass 2: qualifying-chip aggregates per candidate — the six
  // attribute sums (TelemetryScore.basic) and per-node maxima
  // (MaxCollection contribution), integer-exact in both languages.
  // Attribute order everywhere: (bw, clock, core, hbm_free, power,
  // hbm_total) = ClassStats.maxima/.sums order.
  std::vector<int64_t> sums(static_cast<size_t>(found) * 6, 0);
  for (int64_t s = 0; s < found; ++s) {
    const int64_t i = o->rows[s];
    const uint8_t* cf = c->chip_free + i * w;
    const int64_t* hf = c->chip_hbm_free + i * w;
    const int64_t* ht = c->chip_hbm_total + i * w;
    const int64_t* ck = c->chip_clock + i * w;
    const int64_t* bw = c->chip_bw + i * w;
    const int64_t* co = c->chip_core + i * w;
    const int64_t* pw = c->chip_power + i * w;
    int64_t q = 0;
    int64_t* sm = &sums[static_cast<size_t>(s) * 6];
    int64_t* mx = &o->contrib[s * 6];
    mx[0] = mx[1] = mx[2] = mx[3] = mx[4] = mx[5] = 0;
    for (int64_t j = 0; j < w; ++j) {
      if (cf[j] && hf[j] >= r->min_free_mb && ck[j] >= r->min_clock_mhz) {
        ++q;
        sm[0] += bw[j]; sm[1] += ck[j]; sm[2] += co[j];
        sm[3] += hf[j]; sm[4] += pw[j]; sm[5] += ht[j];
        if (bw[j] > mx[0]) mx[0] = bw[j];
        if (ck[j] > mx[1]) mx[1] = ck[j];
        if (co[j] > mx[2]) mx[2] = co[j];
        if (hf[j] > mx[3]) mx[3] = hf[j];
        if (pw[j] > mx[4]) mx[4] = pw[j];
        if (ht[j] > mx[5]) mx[5] = ht[j];
      }
    }
    o->qcount[s] = q;
  }

  // ---- MaxValue fold (prescore.MaxCollection): init 1 (normalisation
  // floor), nodes with zero qualifying chips contribute nothing.
  for (int t = 0; t < 6; ++t) o->mv6[t] = 1;
  for (int64_t s = 0; s < found; ++s) {
    if (o->qcount[s] == 0) continue;
    const int64_t* mx = &o->contrib[s * 6];
    for (int t = 0; t < 6; ++t)
      if (mx[t] > o->mv6[t]) o->mv6[t] = mx[t];
  }

  // ---- pass 3: raw score terms, op-for-op the numpy batch forms.
  if (r->tel_score) {
    const double mvb = static_cast<double>(o->mv6[0]);
    const double mvc = static_cast<double>(o->mv6[1]);
    const double mvco = static_cast<double>(o->mv6[2]);
    const double mvfm = static_cast<double>(o->mv6[3]);
    const double mvp = static_cast<double>(o->mv6[4]);
    const double mvtm = static_cast<double>(o->mv6[5]);
    for (int64_t s = 0; s < found; ++s) {
      const int64_t i = o->rows[s];
      const int64_t* sm = &sums[static_cast<size_t>(s) * 6];
      // TelemetryScore.score_batch's expression, same operation order:
      //   100.0 * sum / mv * weight, terms summed left-to-right
      double basic =
          100.0 * static_cast<double>(sm[0]) / mvb * r->w_bw
          + 100.0 * static_cast<double>(sm[1]) / mvc * r->w_clock
          + 100.0 * static_cast<double>(sm[2]) / mvco * r->w_core
          + 100.0 * static_cast<double>(sm[4]) / mvp * r->w_power
          + 100.0 * static_cast<double>(sm[3]) / mvfm * r->w_fm
          + 100.0 * static_cast<double>(sm[5]) / mvtm * r->w_tm;
      const int64_t tot = c->hbm_total_sum[i];
      const int64_t cl = c->claimed_hbm[i];
      const int64_t fr = c->hbm_free_sum[i];
      double alloc = (tot == 0 || cl > tot)
          ? 0.0
          : 100.0 * static_cast<double>(tot - cl)
                / static_cast<double>(tot) * r->w_alloc;
      double act = (tot == 0)
          ? 0.0
          : 100.0 * static_cast<double>(fr)
                / static_cast<double>(tot) * r->w_actual;
      o->tel[s] = basic + (alloc + act);
    }
  }
  if (r->frag_score) {
    for (int64_t s = 0; s < found; ++s) {
      const int64_t i = o->rows[s];
      o->frag[s] = (r->frag_single && c->valid[i] && c->free_count[i] == 2)
          ? -100.0 : 0.0;
    }
  }

  // ---- fused normalize + weighted sum (engine uses this only when
  // every active scorer is native, in profile order tel-then-frag):
  // exactly core._fold_scores' minmax fold then identity fold.
  if (r->compute_totals) {
    for (int64_t s = 0; s < found; ++s) o->totals[s] = 0.0;
    if (r->tel_score) {
      double lo = o->tel[0], hi = o->tel[0];
      for (int64_t s = 1; s < found; ++s) {
        if (o->tel[s] < lo) lo = o->tel[s];
        if (o->tel[s] > hi) hi = o->tel[s];
      }
      const double span = hi - lo;
      if (span == 0.0) {
        for (int64_t s = 0; s < found; ++s)
          o->totals[s] += r->tel_weight * 100.0;
      } else {
        for (int64_t s = 0; s < found; ++s)
          o->totals[s] +=
              r->tel_weight * (0.0 + (o->tel[s] - lo) * 100.0 / span);
      }
    }
    if (r->frag_score) {
      for (int64_t s = 0; s < found; ++s)
        o->totals[s] += r->frag_weight * o->frag[s];
    }
  }
  return found;
}

// ---------------------------------------------------------------------------
// Incremental-commit helpers: the batch-commit loop's per-bind repair path
// (core._commit_batch) runs thousands of times per drain, each iteration
// paying a handful of tiny numpy calls whose per-op dispatch overhead
// dwarfs the arithmetic at row sizes of ~100. These two kernels collapse
// that path into one C call each. Bound separately from the fused-cycle
// symbols (nativeplane.IncrementalKernels), so an older .so degrades only
// this path back to numpy.

// ABI handshake for the incremental helpers alone — bump on any layout or
// semantic change to the two functions below.
int64_t yoda_incremental_abi(void) { return 1; }

// Post-bind row refresh (columnar.ColumnarTable._fill_row's dynamic-column
// path): rewrite one row of the free-chip mask from the allocator's free
// set (as chip indices), zeroing the rest of the padded row. The caller
// still owns free_count / claimed_hbm (scalar writes; they carry values
// the allocator computed anyway).
void yoda_row_refresh(uint8_t* chip_free_row, int64_t width,
                      const int64_t* free_idx, int64_t n_idx) {
  for (int64_t j = 0; j < width; ++j) chip_free_row[j] = 0;
  for (int64_t j = 0; j < n_idx; ++j) {
    const int64_t i = free_idx[j];
    if (i >= 0 && i < width) chip_free_row[i] = 1;
  }
}

// Fused normalize + weighted sum + argmax-with-ties over the batch
// commit's per-scorer raw score matrix (row-major n_scorers x stride,
// live length m). kinds[k]: 1 = minmax normalization, 0 = identity.
// Written OP-FOR-OP like the numpy fold in core._commit_batch (and so
// like the scalar _fold_scores): lo/hi scan, span == 0 -> flat 100.0,
// else 0.0 + (v - lo) * 100.0 / span, folded totals[j] += w * v — IEEE
// double ops in the same order, so every float is bit-identical and the
// `totals[j] == best` tie set matches numpy's flatnonzero exactly.
// Returns the tie count (tie indices in `ties`, ascending), -1 on
// malformed input.
int64_t yoda_batch_fold(const double* scores, int64_t n_scorers,
                        int64_t stride, const int64_t* kinds,
                        const double* weights, int64_t m,
                        double* totals, int64_t* ties) {
  if (m <= 0 || n_scorers < 0 || stride < m) return -1;
  for (int64_t j = 0; j < m; ++j) totals[j] = 0.0;
  for (int64_t k = 0; k < n_scorers; ++k) {
    const double* arr = scores + k * stride;
    const double w = weights[k];
    if (kinds[k]) {
      double lo = arr[0], hi = arr[0];
      for (int64_t j = 1; j < m; ++j) {
        if (arr[j] < lo) lo = arr[j];
        if (arr[j] > hi) hi = arr[j];
      }
      const double span = hi - lo;
      if (span == 0.0) {
        for (int64_t j = 0; j < m; ++j)
          totals[j] = totals[j] + w * 100.0;
      } else {
        for (int64_t j = 0; j < m; ++j)
          totals[j] = totals[j] + w * (0.0 + (arr[j] - lo) * 100.0 / span);
      }
    } else {
      for (int64_t j = 0; j < m; ++j)
        totals[j] = totals[j] + w * arr[j];
    }
  }
  double best = totals[0];
  for (int64_t j = 1; j < m; ++j)
    if (totals[j] > best) best = totals[j];
  int64_t n_ties = 0;
  for (int64_t j = 0; j < m; ++j)
    if (totals[j] == best) ties[n_ties++] = j;
  return n_ties;
}

}  // extern "C"
