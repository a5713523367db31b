// Native COMMIT plane (ISSUE 17): the GIL-holding Python left on the
// per-pod hot path AFTER the fused scan kernel (fusedplane.cc) — the
// topology packing/blend evaluated per candidate through a Python
// score() call each — collapsed into one GIL-releasing call over the
// candidate arrays. Bound behind its own ABI handshake
// (nativeplane.CommitKernels), so a stale .so degrades exactly this
// plane back to the scalar path while the fused scan and the
// incremental helpers keep serving.
//
// House rule (same as yoda_batch_fold): every arithmetic statement is
// written OP-FOR-OP like its Python ground truth — here
// plugins/topology.py TopologyScore._packing + the score() blend — as
// IEEE double ops in the same order, so every emitted float is
// bit-identical to the scalar path and the engine's max/tie-set
// selection cannot diverge (parity fuzz: tests/test_native_commit.py).

#include <cstdint>

extern "C" {

// ABI handshake for the commit plane alone — bump on any layout or
// semantic change to the kernels below.
int64_t yoda_commit_abi(void) { return 1; }

// Per-candidate topology packing + contiguity blend, the batch twin of
// TopologyScore.score (plugins/topology.py). Inputs are parallel
// arrays of length m, one entry per feasible candidate (row order):
//   cont[]   contiguity term (allocator.contiguity — already native
//            underneath via placement.cc; memoised Python supplies it)
//   used[]   the candidate's slice-usage entry, used chips
//   total[]  the candidate's slice-usage entry, total chips
//   free_c[] len(allocator.free_coords(node))
//   chip_c[] metrics.chip_count
//   multi[]  1 = slice member on a multi-host slice (slice_id truthy
//            AND num_hosts > 1); 0 = standalone-node branch
//   valid[]  1 = metrics present; 0 = score is flat 0.0 (the scalar
//            path's `if m is None` early return)
// Scalars: is_gang (spec.is_gang), cf (contiguity_frac).
// out[] receives the blended raw score.
void yoda_topo_pack(const double* cont, const int64_t* used,
                    const int64_t* total, const int64_t* free_c,
                    const int64_t* chip_c, const uint8_t* multi,
                    const uint8_t* valid, int64_t m, int64_t is_gang,
                    double cf, double* out) {
  for (int64_t j = 0; j < m; ++j) {
    if (!valid[j]) {
      out[j] = 0.0;
      continue;
    }
    double packing;
    if (!multi[j]) {
      // standalone node (or single-host slice): base 50, intra-node
      // bin-pack on top — `50.0 + 50.0 * node_used`
      const double node_used =
          chip_c[j] ? 1.0 - (double)free_c[j] / (double)chip_c[j] : 0.0;
      packing = 50.0 + 50.0 * node_used;
    } else if (is_gang) {
      // gangs consume hosts wholesale; pristine slices are ideal —
      // `100.0 * (total - used) / total`
      packing = total[j] ? 100.0 * (double)(total[j] - used[j]) /
                               (double)total[j]
                         : 0.0;
    } else {
      // single-node job on a multi-host slice: concentrate
      // fragmentation — `100.0 * (0.5 * slice_used + 0.5 * node_used)`
      const double slice_used =
          total[j] ? (double)used[j] / (double)total[j] : 0.0;
      const double node_used =
          chip_c[j] ? 1.0 - (double)free_c[j] / (double)chip_c[j] : 0.0;
      packing = 100.0 * (0.5 * slice_used + 0.5 * node_used);
    }
    out[j] = cf * cont[j] + (1.0 - cf) * packing;
  }
}

}  // extern "C"
