"""Columnar scheduling data plane: the cluster as parallel numpy arrays.

The paper's core loop — score every node from telemetry each cycle — is
the shape columnar batch evaluation accelerates (Tesserae and Gavel both
formulate placement as matrix operations over the full node set,
PAPERS.md). This module packs the per-cycle filter/score inputs into
parallel arrays with a stable node→row index:

- node columns: telemetry validity, heartbeat, accelerator/generation
  ids (interned strings), cordon flag, node-label class id, free-chip
  count, HBM free/total sums, label-claimed HBM;
- chip columns (2-D, padded to the widest node): free mask (healthy,
  unclaimed, unreserved), per-chip HBM free/total, clock, ICI bandwidth,
  core count, power, duty cycle.

The table is maintained INCREMENTALLY from the same directed change logs
(utils/changelog.py) the class memos consume: a bind updates one row,
never rebuilds the table. Row order mirrors ``snapshot.list()`` so the
engine's rotating-offset early-stop scan (percentageOfNodesToScore) is
reproduced index-for-index — the vectorized path must pick the SAME
candidates the scalar path would, in the same order (the scalar path
stays wired in as the fallback and ground truth; the parity fuzz in
tests/test_columnar.py pins agreement, same pattern as native/
placement.cc ↔ topology/native.py).

Plugins opt in per pod through ``filter_batch``/``score_batch``
(framework.py): anything the columns cannot express — gang slice state,
contiguous-block search, nominated-capacity holds, inter-pod affinity —
returns None and the pod takes the scalar path unchanged.
"""

from __future__ import annotations

import time
import zlib

try:  # numpy ships with the jax toolchain this image bakes in, but the
    import numpy as np  # scheduler must degrade to the scalar path without it

    HAVE_NUMPY = True
except Exception:  # pragma: no cover - exercised only on stripped images
    np = None
    HAVE_NUMPY = False

from ..telemetry.schema import HEALTHY


def pool_of(name: str) -> str:
    """Node -> node-pool key: the name with its trailing replica digits
    (and separator) stripped — ``s12-host-3`` and ``s12-host-0`` share
    pool ``s12-host``; ``t5-1`` -> ``t5``. Real fleets name nodes
    ``<pool>-<ordinal>`` (GKE node pools, TPU slice hosts), so the prefix
    IS the pool. A name with no digit suffix is its own pool."""
    stripped = name.rstrip("0123456789")
    if stripped != name:
        stripped = stripped.rstrip("-")
    return stripped or name


def shard_of_pool(pool: str, shard_count: int) -> int:
    """Stable pool -> shard hash (crc32: identical across processes and
    runs, the same discipline as fleet.shard_of)."""
    return zlib.crc32(pool.encode()) % max(shard_count, 1)


class ColumnarTable:
    """Parallel-array snapshot of the cluster, row-aligned with the
    engine's object snapshot (``snapshot.list()`` order)."""

    def __init__(self, allocator, shards: int = 0) -> None:
        self.allocator = allocator
        # pool sharding (columnarShards knob, 0 = off): rows carry a
        # shard id hashed from their node POOL (pool_of), and three
        # things become O(shard) instead of O(cluster):
        #   - membership rebuilds: rows of untouched pools are block-
        #     copied from the previous arrays (one vectorized gather per
        #     column) instead of re-filled through Python per row;
        #   - qualifying-chip memo invalidation: a row update bumps only
        #     its shard's serial, and qual() re-evaluates only the rows
        #     of moved shards in place of a full-table recompute;
        #   - change-log row repair: unchanged-shard rows are never
        #     revisited.
        # 0 keeps the pre-shard behaviour bit-for-bit (full refill on
        # membership change, whole-cache qual invalidation).
        self.shards = max(int(shards), 0)
        # incremental-commit kernels (nativeplane.IncrementalKernels),
        # attached by the engine when the native plane is live: the
        # post-bind row refresh rewrites the free-chip mask row in one C
        # call instead of a numpy op per column. None = numpy path.
        self.native_refresh = None
        self._idx_scratch = None
        # churn plane (config.churn_plane): attached by the engine —
        # sync() applies multi-row dirt as ONE batched delta-vector pass
        # (_sync_batched) instead of a _fill_row per row. event_kernels
        # (nativeplane.EventKernels) folds the whole batch in one C call;
        # None degrades the batch to a numpy scatter, and batch_events
        # False keeps the per-row scalar path (the ground truth).
        self.batch_events = False
        self.event_kernels = None
        # set by the engine: dirty node names since a version vector,
        # IGNORING membership movement (the ordinary changes_since
        # refuses across membership changes; the sharded rebuild needs
        # exactly that delta to know which surviving rows moved). None /
        # unattributable -> full rebuild, same as before.
        self.membership_dirty_fn = None
        self._vers: tuple | None = None
        self._names: list[str] = []
        self.index: dict[str, int] = {}
        # pool -> shard memo (names repeat across rebuilds; crc32 per
        # node per rebuild would be pure waste)
        self._pool_shard: dict[str, int] = {}
        # string interning for accelerator/generation equality masks; -1
        # never appears in a column, so unknown spec strings match nothing
        self._intern: dict[str, int] = {}
        # node-label classes: distinct labels dicts interned to small ids
        # so nodeSelector matching is one fancy-index over the id column
        self._label_classes: list[dict] = []
        self._label_key: dict[tuple, int] = {}
        self._sel_cache: dict = {}
        # per-(min_free, min_clock) qualifying-chip masks, invalidated by
        # sync serial (any row change)
        self._qual_cache: dict = {}
        self._serial = 0
        self._width = 1
        # per-shard change serials (sharded mode): qual() caches carry a
        # snapshot of this vector and repair only the shards that moved
        self._shard_serials = None
        self._row_shard = None
        # observability (tests + bench)
        # engine metrics sink (set by the engine): when present, sync()
        # stamps its wall time into the cycle_event_apply_ms histogram —
        # the "event application" share of the cycle-phase breakdown
        # (bench run_serve_steady folds it into
        # BENCH_SERVE50K.json). None keeps sync stamp-free.
        self.metrics = None
        self.rebuilds = 0
        self.row_updates = 0
        self.shard_rebuilds = 0   # membership rebuilds served sharded
        self.rows_copied = 0      # rows block-copied instead of refilled
        self.qual_repairs = 0     # qual() cache entries repaired in place

    def __len__(self) -> int:
        return len(self._names)

    # ------------------------------------------------------------- sharding
    def _shard_id(self, name: str) -> int:
        pool = pool_of(name)
        hit = self._pool_shard.get(pool)
        if hit is None:
            hit = shard_of_pool(pool, self.shards)
            if len(self._pool_shard) > 65536:
                self._pool_shard.clear()
            self._pool_shard[pool] = hit
        return hit

    def _row_dirtied(self, i: int) -> None:
        """One row changed in place: invalidate the qualifying-chip memo
        at the finest granularity available — the row's SHARD when
        sharding is on (qual() repairs just that shard's rows), the whole
        cache otherwise (the pre-shard behaviour)."""
        self._serial += 1
        if self._row_shard is not None:
            self._shard_serials[self._row_shard[i]] += 1
        else:
            self._qual_cache.clear()

    def shard_views(self):
        """Contiguous (shard, start, stop) row runs in table order — the
        per-shard array views sharded consumers (per-shard scans, the
        native refresh path) slice the global columns with. Row order is
        still snapshot order, so concatenating the runs IS the table."""
        if self._row_shard is None or not len(self._names):
            return [(0, 0, len(self._names))]
        out = []
        rs = self._row_shard
        start = 0
        cur = int(rs[0])
        for i in range(1, len(rs)):
            s = int(rs[i])
            if s != cur:
                out.append((cur, start, i))
                start, cur = i, s
        out.append((cur, start, len(rs)))
        return out

    # ------------------------------------------------------------- interning
    def _intern_id(self, s: str) -> int:
        hit = self._intern.get(s)
        if hit is None:
            hit = len(self._intern)
            self._intern[s] = hit
        return hit

    def intern_of(self, s: str) -> int:
        """Id of an already-seen string; -1 (matches no row) otherwise."""
        return self._intern.get(s, -1)

    def intern_table(self) -> dict[str, int]:
        """The live string -> id intern map (READ-ONLY; accel and
        generation strings share one id space). Batch scorers that map
        interned ids to per-value weights (HeterogeneityScore) build
        their lookup vectors from it — ids are dense [0, len)."""
        return self._intern

    def _label_id(self, labels: dict) -> int:
        key = tuple(sorted(labels.items()))
        hit = self._label_key.get(key)
        if hit is None:
            hit = len(self._label_classes)
            self._label_key[key] = hit
            self._label_classes.append(dict(labels))
        return hit

    def selector_classes(self, selector: dict):
        """Per-label-CLASS verdict vector for an exact-match nodeSelector
        (index = class id). The native fused kernel consumes this
        directly (one byte per class, broadcast through the class-id
        column inside the kernel); selector_mask broadcasts it here."""
        key = (tuple(sorted(selector.items())), len(self._label_classes))
        by_class = self._sel_cache.get(key)
        if by_class is None:
            by_class = np.fromiter(
                (all(ls.get(k) == v for k, v in selector.items())
                 for ls in self._label_classes),
                dtype=bool, count=len(self._label_classes))
            if len(self._sel_cache) > 64:
                self._sel_cache.clear()
            self._sel_cache[key] = by_class
        return by_class

    def selector_mask(self, selector: dict, rows=None):
        """Rows whose node labels satisfy an exact-match nodeSelector.
        Label classes are few, so the per-class check is done once and the
        verdict broadcast through the class-id column (whole table, or
        the given row subset)."""
        by_class = self.selector_classes(selector)
        lc = self.label_class if rows is None else self.label_class[rows]
        return by_class[lc]

    def new_true(self):
        return np.ones(len(self._names), dtype=bool)

    # ------------------------------------------------------------ allocation
    def _alloc(self, n: int, width: int) -> None:
        self._width = width
        # per-row telemetry identity: (id(metrics), generation). Chip
        # attribute columns move only on telemetry updates; binds and
        # reservations only flip the free mask — so a bind-dirtied row
        # re-fills the dynamic columns and skips the per-chip attribute
        # writes entirely (the hot path at drain time).
        self._row_gen: list = [None] * n
        self._row_chips: list = [()] * n  # (healthy, coords) per chip
        self.valid = np.zeros(n, dtype=bool)
        self.heartbeat = np.zeros(n, dtype=np.float64)
        self.accel = np.full(n, -2, dtype=np.int64)
        self.gen = np.full(n, -2, dtype=np.int64)
        self.unsched = np.zeros(n, dtype=bool)
        self.label_class = np.zeros(n, dtype=np.int64)
        self.free_count = np.zeros(n, dtype=np.int64)
        # per-pool torus geometry: this host's coordinate on its slice's
        # wrapped host grid (scheduler/carve.slice_host_coord), -1 for
        # standalone nodes / slices without coherent torus metadata.
        # Derived from slice_topology + generation + host_index, so it
        # rides the telemetry-identity gate like the chip attributes.
        self.host_cx = np.full(n, -1, dtype=np.int64)
        self.host_cy = np.full(n, -1, dtype=np.int64)
        self.host_cz = np.full(n, -1, dtype=np.int64)
        self.hbm_total_sum = np.zeros(n, dtype=np.int64)
        self.hbm_free_sum = np.zeros(n, dtype=np.int64)
        self.claimed_hbm = np.zeros(n, dtype=np.int64)
        self.chip_free = np.zeros((n, width), dtype=bool)
        self.chip_hbm_free = np.zeros((n, width), dtype=np.int64)
        self.chip_hbm_total = np.zeros((n, width), dtype=np.int64)
        self.chip_clock = np.zeros((n, width), dtype=np.int64)
        self.chip_bw = np.zeros((n, width), dtype=np.int64)
        self.chip_core = np.zeros((n, width), dtype=np.int64)
        self.chip_power = np.zeros((n, width), dtype=np.int64)
        self.chip_duty = np.zeros((n, width), dtype=np.float64)
        # native row-refresh scratch + cached base pointers (recomputed
        # here because every rebuild reallocates the buffers)
        self._idx_scratch = np.empty(max(width, 1), dtype=np.int64)
        self._chip_free_base = self.chip_free.ctypes.data
        self._scratch_ptr = self._idx_scratch.ctypes.data

    def _fill_row(self, i: int, ni) -> bool:
        """Recompute one row from a NodeInfo + the allocator's free set.
        The chip ATTRIBUTE columns are re-written only when the node's
        telemetry identity (object, generation) moved; bind/claim dirt
        touches only the dynamic columns (free mask, counts, claimed
        HBM). False = the row no longer fits the table shape (a node
        grew more chips than the padding width): caller rebuilds."""
        self.unsched[i] = ni.unschedulable
        self.label_class[i] = self._label_id(ni.labels)
        m = ni.metrics
        if m is None:
            if self._row_gen[i] is not None:
                self._row_gen[i] = None
                self._row_chips[i] = ()
                self.valid[i] = False
                self.heartbeat[i] = 0.0
                self.accel[i] = -2
                self.gen[i] = -2
                self.host_cx[i] = -1
                self.host_cy[i] = -1
                self.host_cz[i] = -1
                self.hbm_total_sum[i] = 0
                self.hbm_free_sum[i] = 0
                self.chip_free[i, :] = False
                self.chip_hbm_free[i, :] = 0
                self.chip_hbm_total[i, :] = 0
                self.chip_clock[i, :] = 0
                self.chip_bw[i, :] = 0
                self.chip_core[i, :] = 0
                self.chip_power[i, :] = 0
                self.chip_duty[i, :] = 0.0
            self.free_count[i] = 0
            self.claimed_hbm[i] = 0
            return True
        chips = m.chips
        if len(chips) > self._width:
            return False
        gen_key = (id(m), m.generation, len(chips))
        if self._row_gen[i] != gen_key:
            self._row_gen[i] = gen_key
            self._row_chips[i] = tuple(
                (c.health == HEALTHY, c.coords) for c in chips)
            k = len(chips)
            w = self._width
            self.valid[i] = True
            self.heartbeat[i] = m.heartbeat
            self.accel[i] = self._intern_id(m.accelerator)
            self.gen[i] = self._intern_id(m.tpu_generation)
            cx = cy = cz = -1
            if m.slice_id and m.num_hosts > 1:
                from .carve import slice_grid, slice_host_coord

                gw = slice_grid(m)
                if gw is not None:
                    cx, cy, cz = slice_host_coord(m, gw[0])
            self.host_cx[i] = cx
            self.host_cy[i] = cy
            self.host_cz[i] = cz
            self.hbm_total_sum[i] = m.hbm_total_sum
            self.hbm_free_sum[i] = m.hbm_free_sum
            self.chip_hbm_free[i, :k] = [c.hbm_free_mb for c in chips]
            self.chip_hbm_total[i, :k] = [c.hbm_total_mb for c in chips]
            self.chip_clock[i, :k] = [c.clock_mhz for c in chips]
            self.chip_bw[i, :k] = [c.ici_bandwidth_gbps for c in chips]
            self.chip_core[i, :k] = [c.core_count for c in chips]
            self.chip_power[i, :k] = [c.power_w for c in chips]
            self.chip_duty[i, :k] = [c.duty_cycle_pct for c in chips]
            if k < w:
                self.chip_hbm_free[i, k:] = 0
                self.chip_hbm_total[i, k:] = 0
                self.chip_clock[i, k:] = 0
                self.chip_bw[i, k:] = 0
                self.chip_core[i, k:] = 0
                self.chip_power[i, k:] = 0
                self.chip_duty[i, k:] = 0.0
        free = self.allocator.free_coords(ni)
        self.free_count[i] = len(free)
        self.claimed_hbm[i] = ni.claimed_hbm_mb()
        k = len(chips)
        nk = self.native_refresh
        if nk is not None:
            # one C call rewrites the whole padded free-mask row (zeroing
            # included) from the free chip indices — bit-identical to the
            # numpy writes below, minus their per-op dispatch. Pointers
            # are cached at _alloc time; the scratch round-trips through
            # numpy only for the bulk index assign.
            idx = [j for j, (h, co) in enumerate(self._row_chips[i])
                   if h and co in free]
            self._idx_scratch[:len(idx)] = idx
            nk.refresh_fn(self._chip_free_base + i * self._width,
                          self._width, self._scratch_ptr, len(idx))
        else:
            self.chip_free[i, :k] = [h and (co in free)
                                     for h, co in self._row_chips[i]]
            if k < self._width:
                self.chip_free[i, k:] = False
        return True

    # ----------------------------------------------------------------- sync
    def sync(self, snapshot, vers, changes_since_fn) -> bool:
        """Bring the table to the cycle's version vector. Dirty rows from
        the change logs are re-filled in place; membership changes, a
        trimmed log, or an unattributable allocator change ("*") rebuild
        from scratch. False = the backend exposes no version counters, so
        the table cannot be maintained (callers use the scalar path)."""
        if not HAVE_NUMPY or vers is None:
            return False
        if self._vers == vers:
            return len(self._names) == len(snapshot)
        if self.metrics is None:
            return self._sync_apply(snapshot, vers, changes_since_fn)
        # phase attribution: only real application work is stamped — the
        # version-vector no-op above costs two tuple compares and stays
        # out of the histogram
        t0 = time.perf_counter()
        try:
            return self._sync_apply(snapshot, vers, changes_since_fn)
        finally:
            self.metrics.observe("cycle_event_apply_ms",
                                 (time.perf_counter() - t0) * 1e3)

    def _sync_apply(self, snapshot, vers, changes_since_fn) -> bool:
        if self._vers is None or vers[2] != self._vers[2] \
                or len(snapshot) != len(self._names):
            # membership moved (or first sync): the sharded fast path
            # refills only the pools the delta touched and block-copies
            # the rest; everything else rebuilds from scratch
            if (self.shards and self._vers is not None
                    and self.membership_dirty_fn is not None):
                dirty = self.membership_dirty_fn(self._vers)
                if dirty is not None \
                        and self._rebuild_sharded(snapshot, vers, dirty):
                    return True
            return self._rebuild(snapshot, vers)
        _, dirty = changes_since_fn(self._vers)
        if dirty is None:
            return self._rebuild(snapshot, vers)
        if self.batch_events and len(dirty) > 1:
            return self._sync_batched(snapshot, vers, dirty)
        for name in dirty:
            i = self.index.get(name)
            if i is None:
                # telemetry for a non-member node: no row to update (the
                # object snapshot skips these identically)
                continue
            ni = snapshot.get(name)
            if ni is None or not self._fill_row(i, ni):
                return self._rebuild(snapshot, vers)
            self.row_updates += 1
            self._row_dirtied(i)
        self._vers = vers
        return True

    def _sync_batched(self, snapshot, vers, dirty) -> bool:
        """Churn-plane sync (config.churn_plane): apply a multi-row dirty
        set as one batched delta-vector pass. Rows whose telemetry
        identity is UNCHANGED — the equilibrium common case: binds and
        completions only move the free mask and the dynamic scalars — are
        gathered into flat vectors and applied together
        (_apply_rows_batched); rows whose identity moved (telemetry
        publish, node cleared) still take the scalar _fill_row, which is
        the only writer of the chip-attribute columns. Final table bytes,
        row_updates, and dirty-serial counts are identical to the scalar
        loop in sync() — only the per-row numpy/ctypes dispatch is
        amortized (parity fuzz: tests/test_churn_plane.py)."""
        fast: list = []
        for name in dirty:
            i = self.index.get(name)
            if i is None:
                # telemetry for a non-member node: no row to update (the
                # object snapshot skips these identically)
                continue
            ni = snapshot.get(name)
            if ni is None:
                return self._rebuild(snapshot, vers)
            m = ni.metrics
            if m is not None and len(m.chips) > self._width:
                return self._rebuild(snapshot, vers)
            if m is None \
                    or self._row_gen[i] != (id(m), m.generation,
                                            len(m.chips)):
                if not self._fill_row(i, ni):
                    return self._rebuild(snapshot, vers)
            else:
                fast.append((i, ni))
            self.row_updates += 1
            self._row_dirtied(i)
        if fast:
            self._apply_rows_batched(fast)
        self._vers = vers
        return True

    def _apply_rows_batched(self, fast) -> None:
        """Write a batch of identity-unchanged dirty rows from flat delta
        vectors: per-row scalars (unsched, label class, free count,
        claimed HBM) plus the concatenated free-chip indices with
        offsets. One eventplane C call when the kernel is bound; a numpy
        scatter otherwise. Both are store-for-store twins of
        _fill_row's dynamic-column branch."""
        n = len(fast)
        free_coords = self.allocator.free_coords
        rows = np.empty(n, dtype=np.int64)
        unsched_v = np.empty(n, dtype=np.uint8)
        scalars = np.empty((n, 3), dtype=np.int64)
        idx_all: list[int] = []
        offs = np.empty(n + 1, dtype=np.int64)
        offs[0] = 0
        for r, (i, ni) in enumerate(fast):
            rows[r] = i
            unsched_v[r] = ni.unschedulable
            scalars[r, 0] = self._label_id(ni.labels)
            free = free_coords(ni)
            idx_all.extend(j for j, (h, co)
                           in enumerate(self._row_chips[i])
                           if h and co in free)
            offs[r + 1] = len(idx_all)
            scalars[r, 1] = len(free)
            scalars[r, 2] = ni.claimed_hbm_mb()
        ek = self.event_kernels
        if ek is not None:
            idx = np.asarray(idx_all, dtype=np.int64)
            ek.apply_fn(self._chip_free_base, self._width,
                        rows.ctypes.data, n,
                        idx.ctypes.data, offs.ctypes.data,
                        unsched_v.ctypes.data, scalars.ctypes.data,
                        self.unsched.ctypes.data,
                        self.label_class.ctypes.data,
                        self.free_count.ctypes.data,
                        self.claimed_hbm.ctypes.data)
        else:
            self.unsched[rows] = unsched_v.astype(bool)
            self.label_class[rows] = scalars[:, 0]
            self.free_count[rows] = scalars[:, 1]
            self.claimed_hbm[rows] = scalars[:, 2]
            mask = np.zeros((n, self._width), dtype=bool)
            for r in range(n):
                mask[r, idx_all[offs[r]:offs[r + 1]]] = True
            self.chip_free[rows] = mask

    def refresh_row(self, name: str, ni, old_vers, new_vers) -> bool:
        """In-place single-row refresh for the batch commit loop
        (core._commit_batch): the caller has PROVEN — via change-log
        attribution — that every cluster change between `old_vers` and
        `new_vers` is on `name`, so re-filling that one row from the
        freshly-rebuilt NodeInfo brings the whole table to `new_vers`
        without a changes_since walk. Filling from the NodeInfo (rather
        than applying just the bind's chip delta) keeps the row correct
        even when something ELSE also moved on that node inside the bind
        window — a telemetry publish, a cordon, an async-bind rollback
        all attribute to the same name and are absorbed by the refill.
        The common case (bind only, telemetry identity unchanged) skips
        the chip-attribute columns and rewrites only the free mask and
        counts — the in-place decrement, by way of _fill_row's
        dynamic-column path. No-ops (False) unless the table currently
        sits exactly at `old_vers`; the ordinary sync() then repairs from
        the change logs later, so a refused refresh costs nothing but the
        skipped shortcut."""
        if not HAVE_NUMPY or self._vers is None or self._vers != old_vers \
                or new_vers is None:
            return False
        i = self.index.get(name)
        if i is None:
            return False
        if not self._fill_row(i, ni):
            return False  # shape outgrew the padding: next sync rebuilds
        self.row_updates += 1
        self._row_dirtied(i)
        self._vers = new_vers
        return True

    def _rebuild(self, snapshot, vers) -> bool:
        nodes = snapshot.list()
        width = 1
        for ni in nodes:
            if ni.metrics is not None and len(ni.metrics.chips) > width:
                width = len(ni.metrics.chips)
        self._alloc(len(nodes), width)
        self._names = [ni.name for ni in nodes]
        self.index = {name: i for i, name in enumerate(self._names)}
        self._install_shard_map()
        for i, ni in enumerate(nodes):
            self._fill_row(i, ni)
        self._vers = vers
        self._serial += 1
        self._qual_cache.clear()
        self.rebuilds += 1
        return True

    def _install_shard_map(self) -> None:
        if not self.shards:
            return
        self._row_shard = np.fromiter(
            (self._shard_id(n) for n in self._names),
            dtype=np.int64, count=len(self._names))
        self._shard_serials = np.zeros(self.shards, dtype=np.int64)
        self._qual_cache.clear()

    def _rebuild_sharded(self, snapshot, vers, dirty) -> bool:
        """Membership rebuild at pool granularity: rows whose node
        SURVIVED the membership change untouched (name present before and
        after, no change-log entry) are block-copied from the previous
        arrays with one vectorized gather per column; only new nodes and
        change-log-dirty rows pay the Python per-row fill. The dirty set
        comes from membership_dirty_fn — the change logs WITHOUT the
        membership-version gate — so a copied row is provably
        bit-identical to what _fill_row would recompute. False = the
        table shape moved (padding width changed) or the fast path can't
        serve this delta; the caller runs the full rebuild."""
        nodes = snapshot.list()
        width = 1
        for ni in nodes:
            if ni.metrics is not None and len(ni.metrics.chips) > width:
                width = len(ni.metrics.chips)
        if width != self._width or self._row_shard is None:
            return False
        old_index = self.index
        old_row_gen, old_row_chips = self._row_gen, self._row_chips
        old_cols = [self.valid, self.heartbeat, self.accel, self.gen,
                    self.unsched, self.label_class, self.free_count,
                    self.host_cx, self.host_cy, self.host_cz,
                    self.hbm_total_sum, self.hbm_free_sum,
                    self.claimed_hbm, self.chip_free, self.chip_hbm_free,
                    self.chip_hbm_total, self.chip_clock, self.chip_bw,
                    self.chip_core, self.chip_power, self.chip_duty]
        self._alloc(len(nodes), width)
        self._names = [ni.name for ni in nodes]
        self.index = {name: i for i, name in enumerate(self._names)}
        self._install_shard_map()
        new_cols = [self.valid, self.heartbeat, self.accel, self.gen,
                    self.unsched, self.label_class, self.free_count,
                    self.host_cx, self.host_cy, self.host_cz,
                    self.hbm_total_sum, self.hbm_free_sum,
                    self.claimed_hbm, self.chip_free, self.chip_hbm_free,
                    self.chip_hbm_total, self.chip_clock, self.chip_bw,
                    self.chip_core, self.chip_power, self.chip_duty]
        src: list[int] = []
        dst: list[int] = []
        fill: list[int] = []
        for i, ni in enumerate(nodes):
            j = old_index.get(ni.name)
            if j is None or ni.name in dirty:
                fill.append(i)
            else:
                src.append(j)
                dst.append(i)
        if src:
            src_a = np.asarray(src, dtype=np.int64)
            dst_a = np.asarray(dst, dtype=np.int64)
            for old_c, new_c in zip(old_cols, new_cols):
                new_c[dst_a] = old_c[src_a]
            for j, i in zip(src, dst):
                self._row_gen[i] = old_row_gen[j]
                self._row_chips[i] = old_row_chips[j]
        for i in fill:
            if not self._fill_row(i, nodes[i]):
                return self._rebuild(snapshot, vers)
        self._vers = vers
        self._serial += 1
        self._qual_cache.clear()
        self.shard_rebuilds += 1
        self.rows_copied += len(src)
        self.row_updates += len(fill)
        return True

    # ----------------------------------------------------------------- views
    def qual(self, min_free_mb: int, min_clock_mhz: int):
        """(2-D qualifying-chip mask, per-row qualifying count) for one
        workload class: free chips meeting the class's HBM/clock floors —
        the columnar twin of allocator.class_stats, cached per class until
        any row changes."""
        key = (min_free_mb, min_clock_mhz)
        hit = self._qual_cache.get(key)
        if hit is not None:
            if self._row_shard is None:
                return hit
            # sharded repair: entries survive row updates and re-evaluate
            # ONLY the rows of shards whose serial moved since the entry
            # was cached — O(shard), not O(cluster), per invalidation
            q, qc, serials = hit
            moved = np.flatnonzero(self._shard_serials != serials)
            if moved.size == 0:
                return q, qc
            rows = np.flatnonzero(np.isin(self._row_shard, moved))
            sub = (self.chip_free[rows]
                   & (self.chip_hbm_free[rows] >= min_free_mb)
                   & (self.chip_clock[rows] >= min_clock_mhz))
            q[rows] = sub
            qc[rows] = sub.sum(axis=1)
            serials[moved] = self._shard_serials[moved]
            self.qual_repairs += 1
            return q, qc
        q = (self.chip_free
             & (self.chip_hbm_free >= min_free_mb)
             & (self.chip_clock >= min_clock_mhz))
        qc = q.sum(axis=1)
        if len(self._qual_cache) > 16:
            self._qual_cache.clear()
        entry = ((q, qc) if self._row_shard is None
                 else (q, qc, self._shard_serials.copy()))
        self._qual_cache[key] = entry
        return q, qc

    def name_at(self, row: int) -> str:
        """Node name for a table row (the inverse of `index`) — batch
        scorers that must re-enter object-keyed memos (allocator
        contiguity, slice usage) map their row indices back here."""
        return self._names[row]

    def rows_for(self, infos):
        """Row indices for a list of NodeInfos; None when any name is
        unknown to the table (callers fall back to the scalar path)."""
        idx = self.index
        try:
            return np.fromiter((idx[ni.name] for ni in infos),
                               dtype=np.int64, count=len(infos))
        except KeyError:
            return None
