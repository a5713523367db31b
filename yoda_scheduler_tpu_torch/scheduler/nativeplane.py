"""ctypes bridge to the fused scheduling kernel (native/fusedplane.cc).

One GIL-releasing call evaluates a pod's whole filter+score pipeline
over the ColumnarTable's arrays — zero-copy pointers into the numpy
buffers — returning the rotating early-stop candidate selection, the
cycle's MaxValue fold, and the native scorers' raw terms. The engine
(core.Scheduler._native_scan) drives it; the numpy columnar path and the
scalar per-node path stay wired in as fallbacks and ground truth
(fallback chain: native -> numpy columnar -> scalar; parity pinned by
tests/test_native_plane.py).

Because the call releases the GIL, the module also hosts the overlapped
scan PREFETCH worker: while the current pod commits/binds, the worker
runs the next queue head's memo-miss scan against the same snapshot
version. The engine validates the result at consume time by the
change-log version vector — any intervening change discards it (counted
as prefetch_stale), exactly like the batch-conflict fallback — so a
consumed prefetch is bit-identical to the scan the cycle would have run
itself.

Thread-safety contract: the ColumnarTable is mutated only on the engine
thread (sync / refresh_row), and the engine never mutates it while a
prefetch is in flight — core._schedule_one_locked waits for the worker
before its first table access. The job holds references to the array
OBJECTS, so a table rebuild mid-flight cannot free the buffers under
the kernel.
"""

from __future__ import annotations

import ctypes
import threading
import time

from ..utils import nativeloader

# must match yoda_plane_abi() in native/fusedplane.cc — a mismatch means
# the .so predates (or postdates) this bridge's struct layout
_ABI = 1

_i64 = ctypes.c_int64
_f64 = ctypes.c_double
_p_u8 = ctypes.POINTER(ctypes.c_uint8)
_p_i64 = ctypes.POINTER(_i64)
_p_f64 = ctypes.POINTER(_f64)


class _Cols(ctypes.Structure):
    _fields_ = [
        ("n", _i64), ("width", _i64),
        ("valid", _p_u8), ("heartbeat", _p_f64),
        ("accel", _p_i64), ("gen", _p_i64),
        ("unsched", _p_u8), ("label_class", _p_i64),
        ("free_count", _p_i64), ("hbm_total_sum", _p_i64),
        ("hbm_free_sum", _p_i64), ("claimed_hbm", _p_i64),
        ("chip_free", _p_u8), ("chip_hbm_free", _p_i64),
        ("chip_hbm_total", _p_i64), ("chip_clock", _p_i64),
        ("chip_bw", _p_i64), ("chip_core", _p_i64),
        ("chip_power", _p_i64),
    ]


class _Req(ctypes.Structure):
    _fields_ = [
        ("tel_filter", _i64), ("degraded", _i64),
        ("now", _f64), ("max_age", _f64),
        ("use_accel", _i64), ("accel_id", _i64),
        ("use_gen", _i64), ("gen_id", _i64),
        ("chips", _i64), ("min_free_mb", _i64), ("min_clock_mhz", _i64),
        ("check_cordon", _i64), ("sel_by_class", _p_u8),
        ("n_classes", _i64),
        ("start", _i64), ("want", _i64),
        ("tel_score", _i64), ("frag_score", _i64), ("frag_single", _i64),
        ("w_bw", _f64), ("w_clock", _f64), ("w_core", _f64),
        ("w_power", _f64), ("w_fm", _f64), ("w_tm", _f64),
        ("w_alloc", _f64), ("w_actual", _f64),
        ("tel_weight", _f64), ("frag_weight", _f64),
        ("compute_totals", _i64),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("rows", _p_i64), ("contrib", _p_i64), ("qcount", _p_i64),
        ("tel", _p_f64), ("frag", _p_f64), ("totals", _p_f64),
        ("checked", _i64), ("mv6", _i64 * 6),
    ]


def _ptr(arr, ctype):
    return ctypes.cast(arr.ctypes.data, ctypes.POINTER(ctype))


class FusedResult:
    """One fused call's outputs, with the numpy output buffers pinned
    (a prefetch result outlives the call that produced it)."""

    __slots__ = ("rows", "checked", "mv6", "contrib", "qcount",
                 "tel", "frag", "totals", "found", "_bufs")

    def __init__(self, found, out_bufs, checked, mv6):
        rows_a, contrib_a, qcount_a, tel_a, frag_a, totals_a = out_bufs
        self.found = found
        self.checked = checked
        self.mv6 = mv6
        # plain Python lists: downstream consumers build dicts keyed by
        # node name anyway, and .tolist() floats are exactly the array's
        self.rows = rows_a[:found].tolist()
        self.qcount = qcount_a[:found].tolist()
        self.contrib = contrib_a[:found].tolist()
        self.tel = tel_a[:found].tolist()
        self.frag = frag_a[:found].tolist()
        self.totals = totals_a[:found].tolist()
        self._bufs = out_bufs


_INCR_ABI = 1


class IncrementalKernels:
    """ctypes bridge to the incremental-commit helpers (fusedplane.cc):
    the post-bind columnar row refresh and the batch-commit fold. Bound
    independently of the fused-cycle kernel so an older .so degrades only
    these paths back to numpy (loader docstring). Both are bit-identical
    twins of the numpy forms they replace — the per-op numpy dispatch
    overhead, not the arithmetic, is what they remove from the post-bind
    repair path."""

    __slots__ = ("refresh_fn", "fold_fn")

    def __init__(self, lib) -> None:
        # bound with c_void_p pointer params: callers pass plain ints
        # (.ctypes.data captured ONCE per buffer) — a ctypes.cast per
        # call costs more than the numpy ops these kernels replace
        self.refresh_fn = lib.yoda_row_refresh
        self.fold_fn = lib.yoda_batch_fold

    @classmethod
    def load(cls) -> "IncrementalKernels | None":
        vp = ctypes.c_void_p
        lib = nativeloader.bind_symbols({
            "yoda_incremental_abi": (_i64, []),
            "yoda_row_refresh": (None, [vp, _i64, vp, _i64]),
            "yoda_batch_fold": (_i64, [vp, _i64, _i64, vp, vp,
                                       _i64, vp, vp]),
        })
        if lib is None or lib.yoda_incremental_abi() != _INCR_ABI:
            return None
        return cls(lib)

    def row_refresh(self, chip_free, row: int, scratch, n_idx: int) -> None:
        """Rewrite `chip_free[row]` (2-D uint8/bool, C-contiguous) from
        the first `n_idx` chip indices in `scratch` (int64). Convenience
        form; the hot path calls refresh_fn with cached base pointers."""
        width = chip_free.shape[1]
        self.refresh_fn(chip_free.ctypes.data + row * width, width,
                        scratch.ctypes.data, n_idx)

    def batch_fold(self, smat, kinds, weights, m: int, totals, ties) -> int:
        """Fold `smat[:, :m]` (row-major float64, stride = smat.shape[1])
        into `totals[:m]` and write the argmax tie indices; returns the
        tie count (< 0 = malformed input, caller falls back to numpy)."""
        return self.fold_fn(
            smat.ctypes.data, smat.shape[0], smat.shape[1],
            kinds.ctypes.data, weights.ctypes.data, m,
            totals.ctypes.data, ties.ctypes.data)


_EVENT_ABI = 1


class EventKernels:
    """ctypes bridge to the event-plane kernel (eventplane.cc), gated by
    the `churnPlane` knob: a whole batch of dirty columnar rows — the
    equilibrium churn of completions answering binds — applied in ONE
    GIL-releasing call from flat delta vectors, instead of a Python
    _fill_row plus a per-row refresh call each. Bound behind its own ABI
    handshake so a stale .so degrades exactly this plane back to the
    numpy scatter (parity: tests/test_churn_plane.py)."""

    __slots__ = ("apply_fn",)

    def __init__(self, lib) -> None:
        # c_void_p pointer params: callers pass plain .ctypes.data ints,
        # same convention as IncrementalKernels
        self.apply_fn = lib.yoda_event_apply

    @classmethod
    def load(cls) -> "EventKernels | None":
        vp = ctypes.c_void_p
        lib = nativeloader.bind_symbols({
            "yoda_event_abi": (_i64, []),
            "yoda_event_apply": (None, [vp, _i64, vp, _i64, vp, vp,
                                        vp, vp, vp, vp, vp, vp]),
        })
        if lib is None or lib.yoda_event_abi() != _EVENT_ABI:
            return None
        return cls(lib)


_COMMIT_ABI = 1


class CommitKernels:
    """ctypes bridge to the commit-plane kernels (commitplane.cc),
    gated by the `nativeCommit` knob. Today's one kernel is the
    topology packing/blend batch twin — the last per-candidate Python
    loop on the hot path once the fused scan and the incremental
    fold/refresh are native. Bound behind its own ABI handshake so a
    stale .so degrades exactly this plane back to the scalar
    TopologyScore.score path (parity: tests/test_native_commit.py)."""

    __slots__ = ("topo_pack",)

    def __init__(self, lib) -> None:
        # c_void_p pointer params: callers pass plain .ctypes.data ints,
        # same convention as IncrementalKernels
        self.topo_pack = lib.yoda_topo_pack

    @classmethod
    def load(cls) -> "CommitKernels | None":
        vp = ctypes.c_void_p
        lib = nativeloader.bind_symbols({
            "yoda_commit_abi": (_i64, []),
            "yoda_topo_pack": (None, [vp, vp, vp, vp, vp, vp, vp,
                                      _i64, _i64, _f64, vp]),
        })
        if lib is None or lib.yoda_commit_abi() != _COMMIT_ABI:
            return None
        return cls(lib)


class FusedPlane:
    """Loaded fused kernel + its prefetch worker."""

    def __init__(self, lib) -> None:
        self._lib = lib
        self._fn = lib.yoda_fused_cycle
        # prefetch worker state (engine thread submits, worker computes)
        self._cond = threading.Condition()
        self._job = None        # (tag, cols_struct, req_struct, bufs, refs)
        self._result = None     # (tag, FusedResult | None)
        self._busy = False
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls) -> "FusedPlane | None":
        """Bind the fused kernel's symbols; None when the library is
        missing, was built before this kernel existed, or carries a
        different ABI — each a silent per-kernel fallback (the engine
        counts it and keeps the numpy path)."""
        lib = nativeloader.bind_symbols({
            "yoda_plane_abi": (_i64, []),
            "yoda_fused_cycle": (_i64, [ctypes.POINTER(_Cols),
                                        ctypes.POINTER(_Req),
                                        ctypes.POINTER(_Out)]),
        })
        if lib is None:
            return None
        if lib.yoda_plane_abi() != _ABI:
            return None
        return cls(lib)

    # ----------------------------------------------------------- marshalling
    @staticmethod
    def _cols_of(table) -> tuple:
        """(struct, refs) — refs pin the numpy arrays for the call's (or
        prefetch job's) lifetime, so a concurrent table REBUILD on the
        engine thread cannot free buffers under the kernel."""
        refs = (table.valid, table.heartbeat, table.accel, table.gen,
                table.unsched, table.label_class, table.free_count,
                table.hbm_total_sum, table.hbm_free_sum, table.claimed_hbm,
                table.chip_free, table.chip_hbm_free, table.chip_hbm_total,
                table.chip_clock, table.chip_bw, table.chip_core,
                table.chip_power)
        c = _Cols(
            n=len(table), width=table.chip_free.shape[1],
            valid=_ptr(table.valid, ctypes.c_uint8),
            heartbeat=_ptr(table.heartbeat, _f64),
            accel=_ptr(table.accel, _i64), gen=_ptr(table.gen, _i64),
            unsched=_ptr(table.unsched, ctypes.c_uint8),
            label_class=_ptr(table.label_class, _i64),
            free_count=_ptr(table.free_count, _i64),
            hbm_total_sum=_ptr(table.hbm_total_sum, _i64),
            hbm_free_sum=_ptr(table.hbm_free_sum, _i64),
            claimed_hbm=_ptr(table.claimed_hbm, _i64),
            chip_free=_ptr(table.chip_free, ctypes.c_uint8),
            chip_hbm_free=_ptr(table.chip_hbm_free, _i64),
            chip_hbm_total=_ptr(table.chip_hbm_total, _i64),
            chip_clock=_ptr(table.chip_clock, _i64),
            chip_bw=_ptr(table.chip_bw, _i64),
            chip_core=_ptr(table.chip_core, _i64),
            chip_power=_ptr(table.chip_power, _i64),
        )
        return c, refs

    @staticmethod
    def _req_of(req: dict, sel_ref) -> _Req:
        r = _Req(**{k: v for k, v in req.items() if k != "sel_by_class"})
        if sel_ref is not None:
            r.sel_by_class = _ptr(sel_ref, ctypes.c_uint8)
            r.n_classes = len(sel_ref)
        return r

    @staticmethod
    def _out_bufs(want: int):
        import numpy as np

        return (np.empty(want, dtype=np.int64),
                np.empty((want, 6), dtype=np.int64),
                np.empty(want, dtype=np.int64),
                np.empty(want, dtype=np.float64),
                np.empty(want, dtype=np.float64),
                np.empty(want, dtype=np.float64))

    def _call(self, cols, req, bufs) -> "FusedResult | None":
        rows_a, contrib_a, qcount_a, tel_a, frag_a, totals_a = bufs
        out = _Out(rows=_ptr(rows_a, _i64), contrib=_ptr(contrib_a, _i64),
                   qcount=_ptr(qcount_a, _i64), tel=_ptr(tel_a, _f64),
                   frag=_ptr(frag_a, _f64), totals=_ptr(totals_a, _f64))
        found = self._fn(ctypes.byref(cols), ctypes.byref(req),
                         ctypes.byref(out))  # ctypes releases the GIL here
        if found < 0:
            return None  # malformed input: the numpy path owns this pod
        if found == 0:
            # zero feasible rows: the scalar scan owns the diagnostics —
            # but the verdicts ARE final (parity with the numpy mask), so
            # the engine can skip the redundant numpy attempt
            return FusedResult(0, bufs, int(out.checked), (1,) * 6)
        return FusedResult(int(found), bufs, int(out.checked),
                           tuple(out.mv6))

    # --------------------------------------------------------------- running
    def run(self, table, req: dict, sel_by_class=None
            ) -> "FusedResult | None":
        """Synchronous fused cycle. None = kernel input error (the
        engine counts a fallback and re-runs the numpy path); a
        FusedResult with found == 0 = zero feasible rows, which IS a
        final verdict (the engine skips numpy and hands the pod to the
        scalar scan for its per-node diagnostics)."""
        cols, _refs = self._cols_of(table)
        return self._call(cols, self._req_of(req, sel_by_class),
                          self._out_bufs(req["want"]))

    # -------------------------------------------------------------- prefetch
    def prefetch_submit(self, tag, table, req: dict, sel_by_class=None
                        ) -> None:
        """Queue one prefetch job (engine thread). `tag` is opaque
        validation state the engine rechecks at consume time. Struct
        marshalling happens HERE, while the table is quiescent."""
        cols, refs = self._cols_of(table)
        job = (tag, cols, self._req_of(req, sel_by_class),
               self._out_bufs(req["want"]), (refs, sel_by_class))
        with self._cond:
            while self._busy:  # never overlap two scans (table contract)
                self._cond.wait()
            if self._thread is None:  # first job, or the worker retired
                t = threading.Thread(
                    target=self._worker, name="yoda-native-prefetch",
                    daemon=True)
                try:
                    t.start()
                except Exception:
                    # thread exhaustion: skip this prefetch and leave the
                    # plane clean (no job, not busy) — a poisoned _thread
                    # here would park the engine's next prefetch_wait
                    # forever instead of degrading
                    return
                self._thread = t
            self._job = job
            self._result = None
            self._busy = True
            self._cond.notify_all()

    def prefetch_wait(self):
        """Block until no scan is in flight; return (tag, result) of the
        completed job, or None when nothing was prefetched. The engine
        calls this before ANY table mutation — the thread-safety
        contract above."""
        with self._cond:
            while self._busy:
                self._cond.wait()
            out, self._result = self._result, None
            return out

    @property
    def inflight(self) -> bool:
        with self._cond:
            return self._busy or self._result is not None

    def _worker(self) -> None:
        while True:
            with self._cond:
                deadline = time.monotonic() + 5.0
                while self._job is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # idle worker retires (test suites create many
                        # short-lived engines; a parked thread per
                        # engine would accumulate). prefetch_submit
                        # restarts one lazily — all transitions under
                        # the condition's lock, so no job is lost.
                        self._thread = None
                        return
                    self._cond.wait(timeout=remaining)
                tag, cols, req, bufs, _refs = self._job
                self._job = None
            try:
                res = self._call(cols, req, bufs)
            except Exception:
                res = None  # a failed prefetch is just a cold cycle
            with self._cond:
                self._result = (tag, res)
                self._busy = False
                self._cond.notify_all()
