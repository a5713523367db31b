"""Score plugin: max-normalised weighted telemetry score with
allocated-vs-actual dual accounting.

Capability parity with the reference's scoring algorithm (pkg/yoda/score/
algorithm.go:28-87): node score = Basic + Allocate + Actual where

- Basic (algorithm.go:41-68): for each qualifying chip, each attribute is
  scaled to a percentage of the cluster max from PreScore, then weighted and
  summed. Two reference defects not replicated: the clock term divided by
  MaxBandwidth instead of MaxClock (algorithm.go:60), and integer division
  losing sub-percent resolution (we score in float).
- Allocate (algorithm.go:74-87): label-*claimed* HBM headroom — resists
  over-commit when telemetry lags bound-but-not-yet-running pods. We count
  per-chip claims x chips (the reference summed the per-chip ``scv/memory``
  label as if it were a node total, under-counting multi-chip pods).
- Actual (algorithm.go:70-72): *measured* free/total HBM ratio — resists
  stale labels. Keeping both views is the deliberate capability (SURVEY §3.3).

Weights are configuration (ScoreWeights), not compile-time constants.
Normalisation to [0,100] follows the reference's min-max NormalizeScore
(pkg/yoda/scheduler.go:132-157).
"""

from __future__ import annotations

from ..columnar import np
from ..config import ScoreWeights
from ..framework import CycleState, NodeInfo, ScorePlugin, Status, min_max_normalize
from ...utils.labels import WorkloadSpec
from .allocator import ChipAllocator
from .prescore import MAX_KEY, SPEC_KEY, MaxValue


class TelemetryScore(ScorePlugin):
    name = "telemetry-score"
    # dropped from the scorer set while the engine runs telemetry-blackout
    # degraded mode: stale quality numbers (clock/bandwidth/duty) would
    # steer placement on noise, while the capacity scorers (topology,
    # fragmentation) still read the last-known inventory soundly
    telemetry_dependent = True
    # score-memo contract (core._schedule_one_locked score section): this
    # plugin's raw score for a node is a pure function of the node's
    # serial, the allocator pending version, the pod's label class, and
    # the cycle's MaxValue — all covered by the engine's dirty-set +
    # maxima checks, so clean nodes' scores may be replayed verbatim.
    score_inputs = "node"
    # normalize is exactly min_max_normalize with default bounds — the
    # engine fuses it into the weighted sum (and the batch commit loop
    # replays it vectorized) without the per-cycle dict copy
    normalize_kind = "minmax"

    def __init__(self, allocator: ChipAllocator, weights: ScoreWeights | None = None,
                 weight: int = 1) -> None:
        self.allocator = allocator
        self.weights = weights or ScoreWeights()
        self.weight = weight
        # allocate+actual are spec-independent: cache per node keyed by the
        # NodeInfo serial (new serial whenever telemetry or bound pods
        # change) — at 1000 nodes these two terms dominate scoring cost
        self._aa_cache: dict[str, tuple[int, float]] = {}
        # basic is class- and max-dependent: cache per node keyed by
        # (serial, pending version, min_free_mb, min_clock_mhz, MaxValue
        # fields) — exactly the inputs basic_score reads (the same two
        # spec fields class_stats keys on; chips/priority/gang fields
        # don't enter the term, so pods differing only there share hits).
        # Classmate bursts repeat identical keys against unchanged nodes
        # — a bind dirties ONE node and usually leaves the cluster
        # maxima untouched, so the other candidates' basic terms are
        # verbatim repeats (measured: burst p50 30.9 -> 27.2ms).
        # MaxValue is mutable-by-construction, so the key carries its
        # field tuple, never the object.
        self._basic_cache: dict[str, tuple[tuple, float]] = {}
        # preallocated score_batch buffers, keyed by the candidate-row
        # matrix shape: the six per-attribute masked sums each built two
        # throwaway arrays per cycle at 1000-node scale (the issue's
        # measured 170 us/bind floor names this replay cost) — np.take/
        # np.multiply/sum into reused storage keeps the values
        # bit-identical while dropping the allocator churn
        self._bufs: tuple | None = None

    def equivalence_key(self, pod):
        """Batch-cycle contract: raw scores read only the WorkloadSpec's
        HBM/clock floors plus node/ledger state (score_inputs above)."""
        return ()

    def forget_nodes(self, gone: set[str]) -> None:
        for n in gone:
            self._aa_cache.pop(n, None)
            self._basic_cache.pop(n, None)

    # ------------------------------------------------------------ components
    def basic_score(self, mv: MaxValue, spec: WorkloadSpec, node: NodeInfo,
                    state: CycleState | None = None) -> float:
        m = node.metrics
        if m is None:
            return 0.0
        w = self.weights
        # Σ over qualifying chips distributes over the per-attribute sums
        # (allocator.ClassStats, memoised per node state + label class):
        # Σ_c Σ_a 100·a(c)/mv_a·w_a == Σ_a (100·w_a/mv_a)·Σ_c a(c)
        st = self.allocator.class_stats(node, spec.min_free_mb,
                                        spec.min_clock_mhz)
        if st.count == 0:
            return 0.0
        sbw, sck, sco, sfm, spw, stm = st.sums
        total = (
            100.0 * sbw / mv.bandwidth * w.bandwidth
            + 100.0 * sck / mv.clock * w.clock
            + 100.0 * sco / mv.core * w.core
            + 100.0 * spw / mv.power * w.power
            + 100.0 * sfm / mv.free_memory * w.free_memory
            + 100.0 * stm / mv.total_memory * w.total_memory
        )
        if w.duty_cycle:
            # utilisation-aware term (default off): sink nodes whose chips
            # are MEASURED busy — live MXU duty cycle sees noisy neighbours
            # the clock-as-performance proxy cannot. A PENALTY (average per
            # qualifying chip), never a bonus: a node whose publisher
            # reports no duty at all contributes exactly 0, so unmeasured
            # fleets (GPU nodes, the zero-reporting first-party sniffer)
            # neither gain nor lose against measured ones — only measured
            # busyness moves a ranking.
            total -= (st.duty_sum / st.count) * w.duty_cycle
        return total

    def allocate_score(self, node: NodeInfo) -> float:
        """Label-claimed headroom, clamped at 0 when oversubscribed
        (reference algorithm.go:82-84)."""
        m = node.metrics
        if m is None or m.hbm_total_sum == 0:
            return 0.0
        claimed = node.claimed_hbm_mb()
        if claimed > m.hbm_total_sum:
            return 0.0
        return 100.0 * (m.hbm_total_sum - claimed) / m.hbm_total_sum * self.weights.allocate

    def actual_score(self, node: NodeInfo) -> float:
        m = node.metrics
        if m is None or m.hbm_total_sum == 0:
            return 0.0
        return 100.0 * m.hbm_free_sum / m.hbm_total_sum * self.weights.actual

    # -------------------------------------------------------------- plugin API
    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        mv: MaxValue = state.read_or(MAX_KEY)
        if mv is None:
            # the reference hard-errors here because its PostFilter never ran
            # (algorithm.go:29-32); with a real PreScore this cannot happen —
            # keep the guard as an internal error, not a scheduling failure
            return 0.0, Status.error("PreScore never wrote Max")
        spec: WorkloadSpec = state.read(SPEC_KEY)
        hit = self._aa_cache.get(node.name)
        if hit is not None and hit[0] == node.serial:
            aa = hit[1]
        else:
            aa = self.allocate_score(node) + self.actual_score(node)
            self._aa_cache[node.name] = (node.serial, aa)
        bkey = (node.serial, self.allocator.pending_version(node.name),
                spec.min_free_mb, spec.min_clock_mhz,
                mv.bandwidth, mv.clock, mv.core, mv.free_memory,
                mv.power, mv.total_memory)
        bhit = self._basic_cache.get(node.name)
        if bhit is not None and bhit[0] == bkey:
            basic = bhit[1]
        else:
            basic = self.basic_score(mv, spec, node, state)
            self._basic_cache[node.name] = (bkey, basic)
        return basic + aa, Status.success()

    def native_score_args(self, state: CycleState, pod, table):
        """Fused-kernel capability hook (framework.ScorePlugin): the
        ScoreWeights the kernel folds into basic + allocate + actual,
        written there op-for-op like score_batch below. Veto (None) when
        the duty-cycle penalty is enabled — same reason score_batch
        bails: its fold order is the scalar path's, not the kernel's."""
        if self.weights.duty_cycle:
            return None
        w = self.weights
        return {"kind": "telemetry",
                "w_bw": float(w.bandwidth), "w_clock": float(w.clock),
                "w_core": float(w.core), "w_power": float(w.power),
                "w_fm": float(w.free_memory), "w_tm": float(w.total_memory),
                "w_alloc": float(w.allocate), "w_actual": float(w.actual),
                "tel_weight": float(self.weight)}

    def score_batch(self, state: CycleState, pod, table, rows):
        """Columnar raw scores: basic + allocate + actual for every
        candidate row in one set of array ops. Arithmetic is written in
        the SAME operation order as the scalar path (the integer chip
        sums are exact in both, so the float expressions then agree
        bit-for-bit — the parity fuzz depends on that). Bails (None)
        when the duty-cycle penalty is enabled: numpy's pairwise float
        summation can differ from the scalar fold in the last ulp."""
        if self.weights.duty_cycle:
            return None
        mv: MaxValue = state.read_or(MAX_KEY)
        if mv is None:
            return None
        spec: WorkloadSpec = state.read(SPEC_KEY)
        q, _qcount = table.qual(spec.min_free_mb, spec.min_clock_mhz)
        q = q[rows]
        w = self.weights
        # masked per-attribute sums through preallocated buffers (see
        # _bufs): np.take + in-place multiply + sum produce exactly the
        # integers `(col[rows] * q).sum(axis=1)` would, without the two
        # temporaries per attribute per cycle
        n_rows, width = q.shape
        bufs = self._bufs
        if bufs is None or bufs[0] != (n_rows, width):
            bufs = ((n_rows, width),
                    np.empty((n_rows, width), dtype=np.int64),
                    np.empty((6, n_rows), dtype=np.int64))
            self._bufs = bufs
        _, tmp, sums = bufs
        for j, col in enumerate((table.chip_bw, table.chip_clock,
                                 table.chip_core, table.chip_hbm_free,
                                 table.chip_power, table.chip_hbm_total)):
            np.take(col, rows, axis=0, out=tmp)
            np.multiply(tmp, q, out=tmp)
            tmp.sum(axis=1, out=sums[j])
        sbw, sck, sco, sfm, spw, stm = sums
        basic = (
            100.0 * sbw / mv.bandwidth * w.bandwidth
            + 100.0 * sck / mv.clock * w.clock
            + 100.0 * sco / mv.core * w.core
            + 100.0 * spw / mv.power * w.power
            + 100.0 * sfm / mv.free_memory * w.free_memory
            + 100.0 * stm / mv.total_memory * w.total_memory
        )
        # count==0 rows: every sum is 0 so basic is already exactly 0.0,
        # matching the scalar early return
        tot = table.hbm_total_sum[rows]
        cl = table.claimed_hbm[rows]
        fr = table.hbm_free_sum[rows]
        with np.errstate(divide="ignore", invalid="ignore"):
            alloc = 100.0 * (tot - cl) / tot * w.allocate
            act = 100.0 * fr / tot * w.actual
        alloc = np.where((tot == 0) | (cl > tot), 0.0, alloc)
        act = np.where(tot == 0, 0.0, act)
        return basic + (alloc + act)

    def normalize(self, state: CycleState, pod, scores: dict[str, float]) -> None:
        min_max_normalize(scores)


class FragmentationScore(ScorePlugin):
    """Fragmentation-aware packing term (columnar column: free-chip
    count). Steers SINGLE-chip pods away from nodes whose free set is
    down to its last pair (exactly 2 free chips): taking one of those
    chips removes the node from the 2-chip-capable pool, and deep into a
    drain that pool is what decides whether 2-chip jobs bind or strand
    against a cluster of lone free chips (the tpu-2c vs tpu-1c failure
    gap at the 1000-node tier).

    An absolute penalty, not min-max normalized: it must only tip a
    choice when comparable alternatives exist — when the 2-free node is
    the ONLY feasible one, the pod still binds there (capacity is never
    sacrificed to the preference).

    With the torusPlacement knob on (`carver` set) a GEOMETRIC term
    rides along: a non-gang pod landing on a fully-free host of a
    multi-host slice is penalised -100 when that host is part of the
    slice's last largest carvable whole-host block — denting it shrinks
    the biggest contiguous gang the slice can still take (topology/
    carve.largest_carvable), the geometric analogue of breaking the last
    pair. Armed, the plugin declares slice-coupled score inputs and
    folds in Python (native/batch kernels know only the free-count
    comparison); unarmed, every contract below is byte-identical to the
    classic plugin."""

    name = "fragmentation-score"
    # score-memo contract: the raw score is a pure function of the node's
    # free-chip count (serial + pending version) and the pod's label
    # class. The armed (carver) instance overrides this per-instance to
    # "node+slice_usage": the geometric term also moves when ANOTHER
    # node of the same slice gains/loses a resident, which is exactly
    # the slice-usage coupling the memo protocol already repairs for
    # TopologyScore.
    score_inputs = "node"
    # normalize below deliberately returns None (absolute semantics)
    normalize_kind = "identity"

    def equivalence_key(self, pod):
        """Batch-cycle contract: the penalty reads only spec.chips /
        spec.is_gang and per-slice state the batch commit already
        repairs per member (slice-usage identity, see _slice_geometry)."""
        return ()

    def __init__(self, allocator: ChipAllocator, weight: int = 1,
                 carver=None) -> None:
        self.allocator = allocator
        self.weight = weight
        self.carver = carver
        if carver is not None:
            # slice-coupled inputs: rescore when a same-slice entry moves
            self.score_inputs = "node+slice_usage"

    def native_score_args(self, state: CycleState, pod, table):
        """Fused-kernel capability hook: the last-pair penalty is one
        comparison over the free-count column — always expressible.
        The geometric term is not (whole-host sets + carve search), so
        the armed plugin folds in Python (returning None is a fold, not
        a veto — core.py's fused gate)."""
        if self.carver is not None:
            return None
        spec: WorkloadSpec = state.read(SPEC_KEY)
        return {"kind": "fragmentation",
                "frag_single": 1 if spec.chips == 1 else 0,
                "frag_weight": float(self.weight)}

    def score_relevant(self, pod, snapshot) -> bool:
        """Hot-loop gate (core.py): the classic term only moves for
        SINGLE-chip pods, so multi-chip classes drop the plugin from the
        per-node score loop entirely instead of paying a no-op call per
        node. Armed, every non-gang pod can trip the geometric term."""
        from ...utils.labels import LabelError, spec_for

        try:
            spec = spec_for(pod)
        except LabelError:
            return True  # malformed pods never reach scoring anyway
        if self.carver is not None:
            return spec.chips == 1 or not spec.is_gang
        return spec.chips == 1

    def _slice_geometry(self, state: CycleState, snapshot):
        """Per-slice (grid, wrap, fully-free host coords) off this
        cycle's snapshot, cached in CycleState KEYED ON THE SLICE-USAGE
        MAP'S OBJECT IDENTITY: the batch commit publishes a fresh usage
        copy per member (plugins/topology.py pre_score_update), so the
        identity changing is exactly the signal that same-slice
        occupancy moved and the free-host sets must rebuild."""
        from .topology import SLICE_USE_KEY

        usage = state.read_or(SLICE_USE_KEY)
        cached = state.read_or("frag_geo_hosts")
        if (cached is not None and cached[0] is usage
                and cached[1] is snapshot):
            return cached[2]
        from ..carve import slice_grid, slice_host_coord

        per: dict = {}
        for ni in snapshot.list():
            m = ni.metrics
            if m is None or not m.slice_id or m.num_hosts <= 1:
                continue
            gw = slice_grid(m)
            if gw is None:
                continue
            grid, wrap = gw
            entry = per.setdefault(m.slice_id, (grid, wrap, set()))
            if entry[0] != grid:
                continue
            if (m.chip_count > 0
                    and len(self.allocator.free_coords(ni)) == m.chip_count):
                entry[2].add(slice_host_coord(m, grid))
        frozen = {sid: (g, w, frozenset(c)) for sid, (g, w, c) in per.items()}
        state.write("frag_geo_hosts", (usage, snapshot, frozen))
        return frozen

    def _geometric_term(self, state: CycleState, node: NodeInfo) -> float:
        snapshot = state.read_or("snapshot")
        if snapshot is None:
            return 0.0
        m = node.metrics
        entry = self._slice_geometry(state, snapshot).get(m.slice_id)
        if entry is None:
            return 0.0
        grid, wrap, free_hosts = entry
        from ..carve import slice_host_coord
        from ...topology.carve import largest_carvable

        coord = slice_host_coord(m, grid)
        if coord not in free_hosts:
            return 0.0  # already dented: packing here is the GOOD move
        before = largest_carvable(grid, free_hosts, wrap=wrap)
        after = largest_carvable(grid, free_hosts - {coord}, wrap=wrap)
        return -100.0 if after < before else 0.0

    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        spec: WorkloadSpec = state.read(SPEC_KEY)
        m = node.metrics
        if m is None:
            return 0.0, Status.success()
        total = 0.0
        if spec.chips == 1:
            free = len(self.allocator.free_coords(node))
            if free == 2:
                total -= 100.0
        if (self.carver is not None and m.slice_id and m.num_hosts > 1
                and not spec.is_gang):
            total += self._geometric_term(state, node)
        return total, Status.success()

    def score_batch(self, state: CycleState, pod, table, rows):
        if self.carver is not None:
            # geometric term needs per-slice whole-host sets — this
            # plugin alone takes the scalar loop (None routes only it)
            return None
        spec: WorkloadSpec = state.read(SPEC_KEY)
        if spec.chips != 1:
            return np.zeros(len(rows), dtype=np.float64)
        return np.where(table.valid[rows] & (table.free_count[rows] == 2),
                        -100.0, 0.0)

    def normalize(self, state: CycleState, pod, scores: dict[str, float]) -> None:
        return None  # absolute semantics, like the topology scorer
