// Native EVENT plane (ISSUE 20): the churn side of equilibrium. At the
// 50k steady state every bind has a matching completion, and each dirty
// node used to be absorbed one columnar row at a time — a Python
// _fill_row per row, a ctypes yoda_row_refresh per row, a numpy scalar
// store per column. This kernel applies a whole batch of dirty rows in
// ONE call: the dynamic scalar columns (unsched, label class,
// free count, claimed HBM) and the padded chip free mask, row by row,
// from flat delta vectors the engine gathered while walking the change
// log. Bound behind its own ABI handshake (nativeplane.EventKernels),
// so a stale .so degrades exactly this plane back to the numpy scatter
// while the scan/commit kernels keep serving.
//
// House rule: every store is written OP-FOR-OP like its Python ground
// truth — columnar._fill_row's dynamic-column branch — so a batched
// sync leaves the table byte-identical to the per-row path (parity
// fuzz: tests/test_churn_plane.py).

#include <cstdint>

extern "C" {

// ABI handshake for the event plane alone — bump on any layout or
// semantic change to the kernel below.
int64_t yoda_event_abi(void) { return 1; }

// Batched dirty-row application, the delta-vector twin of
// columnar._fill_row's dynamic-column path (telemetry identity
// unchanged). Inputs:
//   chip_free     table.chip_free base (uint8/bool, C-contiguous,
//                 row stride = width)
//   width         chip padding width
//   rows[]        table row index per dirty node, length n
//   idx[]         concatenated free-chip indices for all rows
//   offs[]        length n+1; row r's free chips are idx[offs[r]:offs[r+1]]
//   unsched_v[]   per-row unschedulable verdicts (uint8)
//   scalars[]     n x 3 int64, row-major: label class, free count,
//                 claimed HBM MB
// Output columns (written at rows[r]):
//   unsched_col, label_col, free_count_col, claimed_col
void yoda_event_apply(uint8_t* chip_free, int64_t width,
                      const int64_t* rows, int64_t n,
                      const int64_t* idx, const int64_t* offs,
                      const uint8_t* unsched_v, const int64_t* scalars,
                      uint8_t* unsched_col, int64_t* label_col,
                      int64_t* free_count_col, int64_t* claimed_col) {
  for (int64_t r = 0; r < n; ++r) {
    const int64_t i = rows[r];
    unsched_col[i] = unsched_v[r];
    label_col[i] = scalars[r * 3];
    free_count_col[i] = scalars[r * 3 + 1];
    claimed_col[i] = scalars[r * 3 + 2];
    // the free-mask rewrite: zero the padded row, then set the free
    // chips — same order as yoda_row_refresh (fusedplane.cc)
    uint8_t* row = chip_free + i * width;
    for (int64_t j = 0; j < width; ++j) row[j] = 0;
    for (int64_t k = offs[r]; k < offs[r + 1]; ++k) row[idx[k]] = 1;
  }
}

}  // extern "C"
