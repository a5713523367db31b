"""Heterogeneity model: workload-class throughput ratios across
accelerator generations, and the score plugin they drive.

Gavel's core observation (PAPERS.md, arXiv:2008.09213) is that the
throughput RATIO between accelerator generations is workload-dependent —
a memory-bound embedding job gains little from a faster MXU while a
compute-bound transformer gains a lot — so "a chip is a chip" scoring
leaves throughput on the table exactly in the mixed fleets this
scheduler targets. The model here is Gavel's throughput matrix reduced
to placement time:

    ratio(workload class, generation) -> relative throughput

with three sources, in precedence order: per-class operator overrides
(`workloadClasses` config), the generation catalog's compute proxy
(clock x MXU count, normalised to v4 = 1.0), and 1.0 for anything
unknown (no data never steers a ranking — the same rule the duty-cycle
scorer follows).

The OBJECTIVE (config `policyObjective`) shapes how ratios become score
weights, Gavel/Tesserae's pluggable-policy idea at single-placement
granularity:

- ``makespan``: score by normalised throughput r/r_best — every job
  leans toward its fastest generation, maximising aggregate throughput.
- ``avg-jct``: the same affinity, additionally boosted for SMALL jobs
  (x (1 + 1/chips)): when a fast chip is contended, the shortest
  queue-clearing job wins it — the placement-time shadow of
  shortest-job-first, which minimises average JCT.
- ``finish-time-fairness``: the affinity scaled by the tenant's DRF
  deficit (x (1 + (fair - share)/fair when below fair share)): tenants
  running behind their entitlement get first claim on the fast
  generations, pulling their finish times back toward the fair rate.
"""

from __future__ import annotations

from ..framework import CycleState, NodeInfo, NO_BATCH, ScorePlugin, Status
from ..columnar import HAVE_NUMPY, np
from ...topology.generations import GENERATIONS
from ...utils.labels import WorkloadSpec, tenant_of

OBJECTIVES = ("makespan", "avg-jct", "finish-time-fairness")

# generation key used for nodes that report no TPU generation: GPU nodes
# score under the "gpu" class row; nodes with no telemetry identity at
# all fall back to the neutral ratio
GPU_KEY = "gpu"
_UNKNOWN = "unknown"


def throughput_class(spec: WorkloadSpec) -> str:
    """The workload class a spec scores under: the declared scv/class
    label when present, else a coarse spec-derived class (gpu / gang /
    multi / single) so classless fleets still get sane defaults. Pure
    function of the spec — every spec-keyed memo covers it."""
    if spec.workload_class is not None:
        return spec.workload_class
    if spec.accelerator == "gpu":
        return "gpu"
    if spec.is_gang:
        return "gang"
    return "multi" if spec.chips > 1 else "single"


def generation_key(metrics) -> str:
    """The generation axis of the throughput matrix for one node:
    tpu_generation when reported, else the accelerator kind ("gpu"),
    else unknown (neutral)."""
    if metrics is None:
        return _UNKNOWN
    return metrics.tpu_generation or metrics.accelerator or _UNKNOWN


def _catalog_ratios() -> dict[str, float]:
    """Default per-generation ratios from the catalog's compute proxy
    (clock x MXUs), normalised to v4 = 1.0. A proxy, not a measurement —
    operators with profiled workloads override per class in config."""
    v4 = GENERATIONS["v4"]
    base = float(v4.clock_mhz * v4.mxus)
    return {name: (g.clock_mhz * g.mxus) / base
            for name, g in GENERATIONS.items()}


class ThroughputModel:
    """ratio(class, generation) with operator overrides over catalog
    defaults. `classes` maps workload class -> {generation: ratio}
    (the config `workloadClasses` block, already plain floats)."""

    def __init__(self, classes: dict[str, dict[str, float]] | None = None):
        self._defaults = _catalog_ratios()
        self._classes: dict[str, dict[str, float]] = {
            str(c): {str(g): float(r) for g, r in (gens or {}).items()}
            for c, gens in (classes or {}).items()}
        self._best: dict[str, float] = {}

    def ratio(self, wclass: str, gen: str) -> float:
        """Relative throughput of `wclass` on `gen`; 1.0 when neither
        the class row nor the catalog knows the generation (no data
        never steers)."""
        row = self._classes.get(wclass)
        if row is not None:
            r = row.get(gen)
            if r is not None:
                return r
            # a class row that names ANY generation is authoritative for
            # its workload: generations it omits score the catalog proxy
        return self._defaults.get(gen, 1.0)

    def best(self, wclass: str) -> float:
        """The class's best ratio over every KNOWN generation (override
        row keys + catalog) — the r_best that normalises scores to
        "fraction of this job's peak throughput". Memoised per class;
        the model is immutable after construction."""
        hit = self._best.get(wclass)
        if hit is None:
            known = set(self._defaults)
            row = self._classes.get(wclass)
            if row:
                known |= set(row)
            hit = max((self.ratio(wclass, g) for g in known), default=1.0)
            hit = max(hit, 1e-9)
            self._best[wclass] = hit
        return hit


class HeterogeneityScore(ScorePlugin):
    """Score nodes by the pod's class-vs-generation throughput ratio,
    shaped by the configured objective (module docstring).

    ABSOLUTE semantics (normalize_kind identity), like the topology and
    fragmentation scorers: the term is already on a bounded 0..100*k
    scale and must only TIP choices between otherwise-comparable nodes —
    min-max would amplify a 2% throughput difference to the full 0-100
    swing and stomp the capacity signals."""

    name = "heterogeneity-score"
    normalize_kind = "identity"
    # telemetry-blackout degraded mode does NOT drop this scorer: the
    # generation of a node is inventory, not a live quality number —
    # last-known generation is exactly as true during a blackout.

    def __init__(self, model: ThroughputModel, objective: str,
                 weight: int = 4, policy=None) -> None:
        if objective not in OBJECTIVES:
            raise ValueError(
                f"policyObjective must be one of {OBJECTIVES}, "
                f"got {objective!r}")
        self.model = model
        self.objective = objective
        self.weight = weight
        self.policy = policy  # PolicyEngine: DRF shares for the fairness objective
        # score-memo contract (core's score section): for the static
        # objectives the raw score is a pure function of the node's
        # generation (inside the node serial) and the pod's spec — clean
        # nodes' scores may be replayed verbatim. finish-time-fairness
        # folds in live tenant shares, which move with every bind the
        # version vector attributes to OTHER nodes, so it must not
        # declare — those cycles score fully, every time.
        if objective != "finish-time-fairness":
            self.score_inputs = "node"

    def equivalence_key(self, pod):
        """Batch-cycle contract: the static objectives read only the
        spec (class + chips) and node state — classmates (same spec by
        construction) are interchangeable. finish-time-fairness scores
        move with the tenant's live share, which OUR OWN batch commits
        shift mid-batch — never batch those pods."""
        if self.objective == "finish-time-fairness":
            return NO_BATCH
        return ()

    # ------------------------------------------------------------- scoring
    def _factor(self, spec: WorkloadSpec, pod) -> float:
        """The objective's pod-level multiplier (node-independent, so it
        distributes over the per-node ratio — computed once per cycle
        via the state memo in score/score_batch)."""
        if self.objective == "avg-jct":
            return 1.0 + 1.0 / max(spec.chips, 1)
        if self.objective == "finish-time-fairness" and self.policy is not None:
            book = self.policy.book
            if book is not None:
                tenant = tenant_of(pod)
                fair = self.policy.fair_share(tenant)
                share = book.dominant_share(tenant)
                if fair > 0.0 and share < fair:
                    return 1.0 + (fair - share) / fair
        return 1.0

    _FKEY = "hetero_factor"

    def _cycle_factor(self, state: CycleState, spec, pod) -> float:
        f = state.read_or(self._FKEY)
        if f is None:
            f = self._factor(spec, pod)
            state.write(self._FKEY, f)
        return f

    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        spec: WorkloadSpec = state.read("workload_spec")
        wclass = throughput_class(spec)
        r = self.model.ratio(wclass, generation_key(node.metrics))
        f = self._cycle_factor(state, spec, pod)
        # EDIT IN LOCKSTEP with score_batch: same expression, same
        # operation order, so the vectorized form agrees bit-for-bit
        return 100.0 * r / self.model.best(wclass) * f, Status.success()

    def score_batch(self, state: CycleState, pod, table, rows):
        """Columnar form: one ratio lookup per interned generation id,
        broadcast through the gen/accel columns. Written op-for-op like
        the scalar path (elementwise IEEE ops in the same order), so
        floats agree bit-for-bit — pinned by tests/test_policy.py."""
        if not HAVE_NUMPY:
            return None
        spec: WorkloadSpec = state.read("workload_spec")
        wclass = throughput_class(spec)
        interned = table.intern_table()
        # per-intern-id ratio vector (a handful of strings cluster-wide);
        # ids are dense [0, len) by construction of the intern table
        vec = np.ones(len(interned) + 1, dtype=np.float64)
        for s, i in interned.items():
            vec[i] = self.model.ratio(wclass, s)
        empty = table.intern_of("")
        gen = table.gen[rows]
        accel = table.accel[rows]
        # a node reporting no tpu_generation scores under its
        # accelerator kind, exactly generation_key's fallback
        ids = np.where(gen == empty, accel, gen) if empty >= 0 else gen
        # no-telemetry rows carry the -2 sentinel in BOTH columns; a
        # profile without the telemetry filter can legally rank such a
        # node, and a negative index would silently read some OTHER
        # interned string's ratio — route it to the pad slot, whose
        # value is the scalar path's neutral 1.0 (generation_key(None))
        ids = np.where(ids >= 0, ids, len(interned))
        r = vec[ids]
        f = self._cycle_factor(state, spec, pod)
        return 100.0 * r / self.model.best(wclass) * f

    def native_score_args(self, state: CycleState, pod, table):
        """Fused-kernel capability hook: the kernel knows the telemetry
        and fragmentation folds only — adding a kind means an ABI bump,
        and the mixed-cycle contract already keeps placements bit-exact
        (kernel-born raws fold with this plugin's Python raws in profile
        order, core._fold_scores). Deliberate None."""
        return None

    def normalize(self, state: CycleState, pod, scores) -> None:
        return None  # absolute semantics (class docstring)
