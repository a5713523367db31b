"""Topology-aware score plugin — new TPU-native capability (SURVEY §7.7).

Two terms, both absent from the GPU reference:

- contiguity: how cleanly the pod's chips can be carved as one axis-aligned
  ICI block on this node, and how little fragmentation the best placement
  leaves behind (torus.contiguity_score). XLA collectives ride ICI between
  torus neighbours; non-contiguous assignments force longer paths.
- slice conservation/packing: single-host jobs prefer standalone nodes, and
  among slice nodes prefer already-dented slices over pristine ones — whole
  slices stay free for multi-host gangs, and fragmentation concentrates
  (classic best-fit bin-packing behaviour).

Both scored 0..100 and blended; the plugin's weight (config.topology_weight)
sets its strength against the telemetry score.
"""

from __future__ import annotations

from ..framework import (
    CycleState,
    EnqueueExtensions,
    NodeInfo,
    POD_DELETED,
    PreScorePlugin,
    QUEUE,
    ScorePlugin,
    Status,
    min_max_normalize,
)
from ...utils.labels import WorkloadSpec
from .allocator import ChipAllocator, _node_shape
from .prescore import SPEC_KEY

try:  # commit-plane batch path only; the scalar path needs no numpy
    import numpy as np
except Exception:  # pragma: no cover - numpy-less install
    np = None

SLICE_USE_KEY = "slice_usage"


# churn plane: overlay views flatten back to materialized arrays once
# the override dict outgrows this — the array memcpy is then amortized
# over that many copy() calls instead of paid per batch member
_OVERLAY_FLATTEN = 128


class _SliceUsage:
    """Array-backed slice-usage map (nativeCommit plane): the per-slice
    (used, total) sums as two int64 arrays over an APPEND-ONLY shared
    slice-id intern, so the copy-on-write the engine's memo contract
    demands (each batch member and each cycle must publish its own
    snapshot) is three memcpys instead of a ~#slices dict rebuild.
    Quacks like the dict it replaces for every live consumer: .get
    returns the same (int, int) tuples (the engine's memo compares and
    score()'s pack key hash them), __setitem__ serves _patch, truthiness
    via __len__, and copy() is the COW point — a published view is never
    mutated afterwards (pre_score/pre_score_update copy BEFORE patching,
    exactly like the dict form).

    Under the churn plane (config.churn_plane; the plugin arms `cow` via
    enable_churn_plane) copy() gets cheaper still: instead of three
    array memcpys per batch member — at 50k single-host slices that is
    ~1MB of memcpy per bind — a copy is an OVERLAY view sharing the
    parent's arrays with a small {slot: (used, total)} override dict on
    top. get() consults the overlay first; __setitem__ writes only the
    overlay; once the overlay outgrows _OVERLAY_FLATTEN the next copy()
    materializes fresh arrays, so the memcpy is amortized across that
    many members. Observationally identical to the memcpy form for
    every consumer (tests/test_churn_plane.py runs the quacks-like-a-
    dict fuzz in overlay mode; placements stay bit-identical because
    only .get values reach any scoring arithmetic)."""

    __slots__ = ("_intern", "_used", "_total", "_has", "_count",
                 "_over", "_cow")

    def __init__(self, intern_map, used, total, has, count,
                 over=None, cow=False):
        self._intern = intern_map  # shared across copies; only grows
        self._used = used
        self._total = total
        self._has = has
        self._count = count
        # overlay override dict (None = direct mode: setitem writes the
        # arrays). Any overlay instance is implicitly cow.
        self._over = over
        self._cow = cow or over is not None

    @classmethod
    def empty(cls, cap: int = 64, cow: bool = False) -> "_SliceUsage":
        return cls({}, np.zeros(cap, dtype=np.int64),
                   np.zeros(cap, dtype=np.int64),
                   np.zeros(cap, dtype=np.uint8), 0, None, cow)

    def get(self, sid, default=None):
        i = self._intern.get(sid)
        if i is None:
            return default
        ov = self._over
        if ov is not None:
            hit = ov.get(i)
            if hit is not None:
                return hit
        # the intern map outgrows older views (it is shared); an index
        # past this view's arrays is a slice this view never held
        if i >= len(self._has) or not self._has[i]:
            return default
        return (int(self._used[i]), int(self._total[i]))

    def __setitem__(self, sid, ut) -> None:
        i = self._intern.get(sid)
        if i is None:
            i = len(self._intern)
            self._intern[sid] = i
        ov = self._over
        if ov is not None:
            # overlay mode: the shared base arrays are frozen — the
            # write lands in this view's override dict alone
            if i not in ov and not (i < len(self._has) and self._has[i]):
                self._count += 1
            ov[i] = (int(ut[0]), int(ut[1]))
            return
        if i >= len(self._used):
            grow = max(len(self._used) * 2, i + 1)
            for name in ("_used", "_total", "_has"):
                old = getattr(self, name)
                arr = np.zeros(grow, dtype=old.dtype)
                arr[:len(old)] = old
                setattr(self, name, arr)
        if not self._has[i]:
            self._has[i] = 1
            self._count += 1
        self._used[i] = ut[0]
        self._total[i] = ut[1]

    def __len__(self) -> int:
        return self._count

    def copy(self) -> "_SliceUsage":
        ov = self._over
        if ov is not None:
            if len(ov) <= _OVERLAY_FLATTEN:
                return _SliceUsage(self._intern, self._used, self._total,
                                   self._has, self._count, dict(ov))
            return self._flatten()
        if self._cow:
            # first copy of a direct-fill map under the churn plane:
            # share the arrays and start an overlay chain. Sound because
            # published views are never mutated (writers only touch
            # objects they just created via empty() or copy() — the same
            # contract the memcpy form already relies on).
            return _SliceUsage(self._intern, self._used, self._total,
                               self._has, self._count, {})
        return _SliceUsage(self._intern, self._used.copy(),
                           self._total.copy(), self._has.copy(),
                           self._count)

    def _flatten(self) -> "_SliceUsage":
        """Materialize overlay + base into fresh arrays (the amortized
        memcpy); the result starts a new, empty overlay chain."""
        ov = self._over
        n = max(len(self._used), max(ov) + 1)
        used = np.zeros(n, dtype=np.int64)
        total = np.zeros(n, dtype=np.int64)
        has = np.zeros(n, dtype=np.uint8)
        used[:len(self._used)] = self._used
        total[:len(self._total)] = self._total
        has[:len(self._has)] = self._has
        for i, (u, t) in ov.items():
            used[i] = u
            total[i] = t
            has[i] = 1
        return _SliceUsage(self._intern, used, total, has,
                           self._count, {})


class TopologyScore(ScorePlugin, PreScorePlugin, EnqueueExtensions):
    name = "topology-score"
    # score-memo contract: a node's raw score additionally depends on its
    # SLICE's usage entry (the packing term) — the engine rescures a
    # clean node whenever its slice's usage entry moved (a bind anywhere
    # on the slice dents it)
    score_inputs = "node+slice_usage"
    # normalize below deliberately returns None (absolute 0..100 scale)
    normalize_kind = "identity"

    def equivalence_key(self, pod):
        """Batch-cycle contract: contiguity/packing read only spec.chips,
        spec.is_gang (always False for batchable pods — GangPermit votes
        NO_BATCH for gangs), and node/slice state."""
        return ()

    # Scoring never rejects, so this plugin rarely appears in a pod's
    # rejecting set — but topology-shaped Reserve failures routed to it
    # (no contiguous block left after a racing claim) wake on departures,
    # the one event that de-fragments a torus.
    def events_to_register(self) -> tuple:
        return (POD_DELETED,)

    def queueing_hint(self, event, pod) -> str:
        return QUEUE

    def __init__(self, allocator: ChipAllocator, weight: int = 2,
                 contiguity_frac: float = 0.5) -> None:
        self.allocator = allocator
        self.weight = weight
        self.contiguity_frac = contiguity_frac
        # packing-term cache per node: keyed by (serial, slice usage
        # entry, is_gang) — all of its inputs (contiguity is memoised
        # separately in the allocator)
        self._pack_cache: dict[str, tuple[tuple, float]] = {}
        # per-node used-chip count for the slice-usage map
        self._used_cache: dict[str, tuple] = {}
        # incremental slice-usage state: (cluster version vector, usage
        # map, per-node contributions) — repaired from the engine's change
        # logs instead of rescanning 1000 nodes per cycle
        self._usage_state: tuple | None = None
        # nativeCommit plane (engine arms via enable_commit_plane):
        # _commit_plane switches the pure-Python half on (in-place
        # contribution patch, _SliceUsage array map); _nk carries the
        # CommitKernels bridge for score_batch, None when the .so lacks
        # the commit ABI (batch scoring then stays scalar)
        self._commit_plane = False
        self._nk = None
        self._batch_bufs: tuple | None = None
        # churn plane (engine arms via enable_churn_plane): slice-usage
        # snapshots become copy-on-write overlay views — the per-member
        # array memcpy amortizes across _OVERLAY_FLATTEN copies
        self._churn_plane = False

    def enable_commit_plane(self, kernels) -> None:
        """Arm the nativeCommit plane for this plugin instance (engine
        init, per head — instances are never shared across heads, so the
        in-place patch needs no lock)."""
        self._commit_plane = np is not None
        self._nk = kernels if np is not None else None

    def enable_churn_plane(self) -> None:
        """Arm the churn plane (config.churn_plane) for this instance:
        _SliceUsage maps built here are flagged copy-on-write, so each
        batch member's usage snapshot is an overlay view instead of
        three array memcpys (observationally identical — see
        _SliceUsage; parity pinned by tests/test_churn_plane.py)."""
        self._churn_plane = np is not None

    def forget_nodes(self, gone: set[str]) -> None:
        for n in gone:
            self._pack_cache.pop(n, None)
            self._used_cache.pop(n, None)
        self._usage_state = None

    def pre_score(self, state: CycleState, pod, feasible: list[NodeInfo]) -> Status:
        """Compute per-slice usage over the WHOLE snapshot — a slice's full
        hosts are exactly the ones missing from the feasible list, and they
        are what makes the slice 'dented'. Incremental: a bind dirties one
        node, so the per-slice sums are repaired for the dirty nodes only
        (via the engine's ``changes_since_fn``); any condition the change
        logs can't describe falls back to the full walk."""
        snapshot = state.read_or("snapshot")
        nodes = snapshot.list() if snapshot is not None else feasible
        cb = state.read_or("changes_since_fn")
        # store under the CYCLE's pre-snapshot version vector, never a
        # live re-sample — a later sample would absorb an event that
        # landed after the snapshot was built (version covers it, data
        # predates it) and changes_since would never report it again
        vers = state.read_or("cycle_versions")
        if cb is not None and self._usage_state is not None:
            cvers, usage, contrib = self._usage_state
            _, dirty = cb(cvers)
            if dirty is not None and vers is not None:
                if dirty:
                    usage = usage.copy()
                    if self._commit_plane:
                        # commit plane: contrib never leaves this plugin
                        # (_usage_state is its only holder), so patch it
                        # in place — copying the per-node map (one entry
                        # per slice host, ~50k at fleet scale) every
                        # dirty cycle was pre-score's dominant cost.
                        # Torn guard: drop the memo across the loop so
                        # an exception mid-patch forces a full walk next
                        # cycle instead of serving a half-patched map.
                        self._usage_state = None
                    else:
                        contrib = dict(contrib)
                    for name in dirty:
                        node = snapshot.get(name) if snapshot else None
                        self._patch(usage, contrib, name, node)
                self._usage_state = (vers, usage, contrib)
                state.write(SLICE_USE_KEY, usage)
                return Status.success()
        usage = (_SliceUsage.empty(cow=self._churn_plane)
                 if self._commit_plane else {})
        contrib: dict[str, tuple] = {}
        for node in nodes:
            c = self._contribution(node)
            if c is None:
                continue
            contrib[node.name] = c
            u, t = usage.get(c[0], (0, 0))
            usage[c[0]] = (u + c[1], t + c[2])
        if cb is not None and vers is not None:
            self._usage_state = (vers, usage, contrib)
        state.write(SLICE_USE_KEY, usage)
        return Status.success()

    def _patch(self, usage: dict, contrib: dict, name: str,
               node: NodeInfo | None) -> None:
        """Replace one node's contribution in the slice-usage map (shared
        by pre_score's incremental branch and the batch-commit hook —
        the two must stay arithmetic-identical or batched and per-pod
        usage maps diverge)."""
        old = contrib.pop(name, None)
        if old is not None:
            u, t = usage.get(old[0], (0, 0))
            usage[old[0]] = (u - old[1], t - old[2])
        new = self._contribution(node)
        if new is not None:
            contrib[name] = new
            u, t = usage.get(new[0], (0, 0))
            usage[new[0]] = (u + new[1], t + new[2])

    def pre_score_update(self, state: CycleState, pod, node_info,
                         names) -> bool:
        """Batch-commit hook (framework.PreScorePlugin): one classmate
        just bound on `node_info`; patch its contribution in the slice
        usage map — the same arithmetic pre_score's incremental branch
        runs for a single dirty node — and advance the plugin memo to the
        cycle's new version vector."""
        if self._usage_state is None:
            return False
        vers = state.read_or("cycle_versions")
        if vers is None:
            return False
        _, usage, contrib = self._usage_state
        # usage is COPIED: references escape into cycle state and the
        # engine's score memo, which must see this member's snapshot
        # (under the commit plane the copy is the _SliceUsage memcpy).
        # contrib never leaves this plugin (_usage_state is its only
        # holder), so the one-key patch mutates it in place — copying
        # its per-node map per batch member was the hook's main cost.
        usage = usage.copy()
        self._patch(usage, contrib, node_info.name, node_info)
        self._usage_state = (vers, usage, contrib)
        state.write(SLICE_USE_KEY, usage)
        return True

    def _contribution(self, node: NodeInfo | None) -> tuple | None:
        """(slice_id, used chips, total chips) this node adds to the
        slice-usage map; None for non-slice/unknown nodes. Memoised per
        (serial, pending version)."""
        if node is None:
            return None
        m = node.metrics
        if m is None or not m.slice_id:
            return None
        ukey = (node.serial, self.allocator.pending_version(node.name))
        hit = self._used_cache.get(node.name)
        if hit is not None and hit[0] == ukey:
            used_here = hit[1]
        else:
            used_here = m.chip_count - len(self.allocator.free_coords(node))
            self._used_cache[node.name] = (ukey, used_here)
        return (m.slice_id, used_here, m.chip_count)

    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        m = node.metrics
        if m is None:
            return 0.0, Status.success()
        spec: WorkloadSpec = state.read(SPEC_KEY)
        cont = self.allocator.contiguity(node, spec.chips)
        usage = state.read_or(SLICE_USE_KEY, {}).get(m.slice_id, (0, 0)) \
            if m.slice_id else (0, 0)
        pkey = (node.serial, self.allocator.pending_version(node.name),
                usage, spec.is_gang)
        hit = self._pack_cache.get(node.name)
        if hit is not None and hit[0] == pkey:
            packing = hit[1]
        else:
            packing = self._packing(m, node, usage, spec.is_gang)
            self._pack_cache[node.name] = (pkey, packing)
        s = self.contiguity_frac * cont + (1.0 - self.contiguity_frac) * packing
        return s, Status.success()

    def score_batch(self, state: CycleState, pod, table, rows):
        """Commit-plane batch form of `score` (nativeCommit knob): one
        Python gather pass re-enters the memoised inputs (allocator
        contiguity — itself native underneath — free sets, slice usage),
        then a single GIL-releasing yoda_topo_pack call computes the
        packing/blend for every candidate. commitplane.cc mirrors
        `_packing` op-for-op, so the floats agree bit-for-bit with the
        scalar path (parity: tests/test_native_commit.py). None when the
        plane is unarmed or the .so lacks the commit ABI."""
        nk = self._nk
        if nk is None:
            return None
        snapshot = state.read_or("snapshot")
        if snapshot is None:
            return None
        spec: WorkloadSpec = state.read(SPEC_KEY)
        m_rows = len(rows)
        bufs = self._batch_bufs
        if bufs is None or len(bufs[0]) < m_rows:
            cap = max(m_rows, 256)
            bufs = (np.empty(cap, dtype=np.float64),   # cont
                    np.empty(cap, dtype=np.int64),     # slice used
                    np.empty(cap, dtype=np.int64),     # slice total
                    np.empty(cap, dtype=np.int64),     # free chips
                    np.empty(cap, dtype=np.int64),     # chip count
                    np.empty(cap, dtype=np.uint8),     # multi-host slice
                    np.empty(cap, dtype=np.uint8),     # metrics present
                    np.empty(cap, dtype=np.float64))   # out
            self._batch_bufs = bufs
        cont, used, total, free_c, chip_c, multi, valid, out = bufs
        usage_map = state.read_or(SLICE_USE_KEY, {})
        alloc = self.allocator
        chips = spec.chips
        for j in range(m_rows):
            node = snapshot.get(table.name_at(rows[j]))
            m = node.metrics if node is not None else None
            if m is None:
                # scalar path's `if m is None: return 0.0` early-out
                valid[j] = 0
                continue
            valid[j] = 1
            cont[j] = alloc.contiguity(node, chips)
            u, t = usage_map.get(m.slice_id, (0, 0)) \
                if m.slice_id else (0, 0)
            used[j] = u
            total[j] = t
            free_c[j] = len(alloc.free_coords(node))
            chip_c[j] = m.chip_count
            multi[j] = 1 if (m.slice_id and m.num_hosts > 1) else 0
        nk.topo_pack(cont.ctypes.data, used.ctypes.data,
                     total.ctypes.data, free_c.ctypes.data,
                     chip_c.ctypes.data, multi.ctypes.data,
                     valid.ctypes.data, m_rows,
                     1 if spec.is_gang else 0,
                     float(self.contiguity_frac), out.ctypes.data)
        return out[:m_rows]

    def _packing(self, m, node: NodeInfo, usage: tuple[int, int],
                 is_gang: bool) -> float:
        free = self.allocator.free_coords(node)
        if not m.slice_id or m.num_hosts <= 1:
            # standalone node: always preferable to denting a pristine slice
            # for non-gang work (base 50), and among standalone nodes prefer
            # the already-dented one (intra-node bin-pack) so whole boards
            # survive for block-shaped requests
            node_used = 1.0 - len(free) / m.chip_count if m.chip_count else 0.0
            return 50.0 + 50.0 * node_used
        used, total = usage
        if is_gang:
            # a gang consumes hosts wholesale; pristine slices are ideal
            return 100.0 * (total - used) / total if total else 0.0
        # single-node job on a multi-host slice: prefer dented slices
        # (concentrate fragmentation) and, within a slice, dented hosts — a
        # leftover lone chip is "contiguous" by the frag metric but useless
        # to block-shaped requests, so host-level consolidation must be
        # rewarded explicitly
        slice_used = used / total if total else 0.0
        node_used = 1.0 - len(free) / m.chip_count if m.chip_count else 0.0
        return 100.0 * (0.5 * slice_used + 0.5 * node_used)

    def normalize(self, state: CycleState, pod, scores: dict[str, float]) -> None:
        # already on a 0..100 scale by construction; min-max would erase the
        # absolute meaning (a lone feasible node with poor contiguity must not
        # inflate to 100)
        return None
