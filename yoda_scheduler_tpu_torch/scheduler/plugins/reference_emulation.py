"""Reference-semantics plugin set, used as the benchmark baseline.

Re-creates the *intended* scheduling behaviour of the reference
(pkg/yoda: filter predicates over live telemetry only, max-normalised
weighted scoring) WITHOUT this framework's TPU-native improvements, so
`bench.py` can compare like for like on the same engine:

- no allocation awareness: chips/memory claimed by bound-but-running pods
  are invisible until telemetry catches up (the reference trusts only the
  live SCV numbers; chip count checks against the node's TOTAL CardNumber,
  reference pkg/yoda/filter/filter.go:13 — never decremented)
- no topology, no gang admission, no staleness gate, no preemption
- scoring keeps the reference's integer arithmetic and its clock-divided-
  by-MaxBandwidth defect (algorithm.go:60) — baseline behaviour includes
  baseline bugs
- to be fair to the reference's deployment reality (a sniffer DaemonSet
  updating the CR within its poll interval), the emulation binder
  decrements telemetry free-HBM immediately on bind.
"""

from __future__ import annotations

from ..config import SchedulerConfig
from ..framework import CycleState, FilterPlugin, NodeInfo, ScorePlugin, Status, min_max_normalize
from ...utils.labels import WorkloadSpec, spec_for
from .prescore import MAX_KEY, SPEC_KEY, MaxValue


class RefFilter(FilterPlugin):
    """Count/memory/clock predicates exactly as the reference applies them
    (filter.go:11-58), minus every TPU-native addition."""

    name = "ref-filter"

    def filter(self, state: CycleState, pod, node: NodeInfo) -> Status:
        spec: WorkloadSpec = state.read(SPEC_KEY)
        m = node.metrics
        if m is None:
            return Status.unschedulable(f"{node.name}: scv is not exist")
        # nodeSelector stand-in, NOT a reference plugin capability: on a
        # mixed cluster a reference deployment pins GPU jobs to GPU nodes
        # with ordinary k8s nodeSelectors (upstream NodeAffinity runs before
        # the yoda plugin). Without this the baseline scatters TPU jobs onto
        # GPU nodes and the bin-pack comparison measures mis-placement, not
        # packing quality.
        if spec.accelerator is not None and m.accelerator != spec.accelerator:
            return Status.unschedulable(f"{node.name}: nodeSelector mismatch")
        if (spec.tpu_generation is not None
                and m.tpu_generation != spec.tpu_generation):
            # same stand-in rationale: a reference deployment pins TPU
            # generations with ordinary nodeSelectors, not plugin logic
            return Status.unschedulable(f"{node.name}: nodeSelector mismatch")
        if m.chip_count < max(spec.chips, 1):
            return Status.unschedulable(f"{node.name}: not enough cards")
        # device-plugin resource stand-in, NOT a reference plugin capability:
        # real reference deployments request cards through the device-plugin
        # resource, and the DEFAULT NodeResourcesFit plugin (running
        # alongside yoda in the same framework) prevents handing the same
        # device out twice. Without this the baseline thrashes forever
        # re-offering claimed cards whose telemetry still shows free HBM —
        # a deployment artifact, not the scheduling behaviour under test.
        if m.chip_count - len(node.assigned_coords()) < max(spec.chips, 1):
            return Status.unschedulable(f"{node.name}: devices exhausted")
        fits_mem = sum(
            1 for c in m.chips
            if c.healthy and c.hbm_free_mb >= spec.min_free_mb
        )
        if fits_mem < spec.chips:
            return Status.unschedulable(f"{node.name}: memory")
        fits_clock = sum(
            1 for c in m.chips
            if c.healthy and c.clock_mhz >= spec.min_clock_mhz
        )
        if fits_clock < spec.chips:
            return Status.unschedulable(f"{node.name}: clock")
        return Status.success()


class RefMaxCollection:
    """PreScore collecting reference maxima (collection.go:30-57) over ALL
    chips that fit the request, without free-coordinate awareness."""

    name = "ref-max-collection"

    def pre_score(self, state: CycleState, pod, feasible) -> Status:
        spec: WorkloadSpec = state.read(SPEC_KEY)
        mv = MaxValue()
        for node in feasible:
            m = node.metrics
            if m is None:
                continue
            for c in m.chips:
                if (c.healthy and c.hbm_free_mb >= spec.min_free_mb
                        and c.clock_mhz >= spec.min_clock_mhz):
                    mv.bandwidth = max(mv.bandwidth, c.ici_bandwidth_gbps)
                    mv.clock = max(mv.clock, c.clock_mhz)
                    mv.core = max(mv.core, c.core_count)
                    mv.free_memory = max(mv.free_memory, c.hbm_free_mb)
                    mv.power = max(mv.power, c.power_w)
                    mv.total_memory = max(mv.total_memory, c.hbm_total_mb)
        state.write(MAX_KEY, mv)
        return Status.success()


class RefScore(ScorePlugin):
    """Reference scoring math with its integer truncation and the clock/
    MaxBandwidth bug preserved (algorithm.go:28-87)."""

    name = "ref-score"
    weight = 1

    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        spec: WorkloadSpec = state.read(SPEC_KEY)
        mv: MaxValue = state.read_or(MAX_KEY)
        m = node.metrics
        if mv is None or m is None:
            return 0.0, Status.error("no Max in cycle state")
        basic = 0
        for c in m.chips:
            if (c.healthy and c.hbm_free_mb >= spec.min_free_mb
                    and c.clock_mhz >= spec.min_clock_mhz):
                basic += (
                    c.ici_bandwidth_gbps * 100 // mv.bandwidth       # w=1
                    + c.clock_mhz * 100 // mv.bandwidth              # the bug
                    + c.core_count * 100 // mv.core                  # w=1
                    + c.power_w * 100 // mv.power                    # w=1
                    + (c.hbm_free_mb * 100 // mv.free_memory) * 2    # w=2
                    + c.hbm_total_mb * 100 // mv.total_memory        # w=1
                )
        # allocate: label-claimed headroom, per-chip label treated as the
        # node total exactly as the reference does (algorithm.go:76-80)
        claimed = 0
        for p in node.pods:
            try:
                claimed += spec_for(p).min_free_mb
            except Exception:
                pass
        total = m.hbm_total_sum
        allocate = 0 if (total == 0 or claimed > total) else (
            (total - claimed) * 100 // total * 3)
        actual = 0 if total == 0 else m.hbm_free_sum * 100 // total * 2
        return float(basic + allocate + actual), Status.success()

    def normalize(self, state: CycleState, pod, scores: dict[str, float]) -> None:
        min_max_normalize(scores)


class OvercommitError(RuntimeError):
    """The naive device-plugin emulation found no free chips at bind time."""


class TelemetryDecrementingCluster:
    """Wraps a FakeCluster: on bind, immediately debits the node's live
    telemetry (the ideal-sniffer assumption that favours the baseline), and
    assigns concrete chips the way a topology-blind device plugin would —
    any free qualifying coords, arbitrary order, no contiguity. The
    reference never chooses chips (SURVEY §2.2: that was the GPU device
    plugin's job), so without this the baseline's bin-pack utilisation
    measures 0 by construction instead of measuring its placement quality.

    Overcommit honesty: when the reference's
    allocation-blind filter picks a node whose chips are actually all
    claimed, the real-world outcome is a device-plugin admission failure
    and a pod retry — NOT a successful placement. The emulation therefore
    raises OvercommitError (the engine's bind-failure path requeues the
    pod with backoff) and counts it, instead of crediting the baseline
    with a latency win for a pod that got no chips."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.overcommitted_binds = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _naive_chips(self, pod, node):
        """Free qualifying coords, or "overcommit" when the node has fewer
        than requested (distinct from None = not assessable)."""
        m = self._inner.telemetry.get(node)
        if m is None:
            return None
        try:
            spec = spec_for(pod)
        except Exception:
            return None
        used = set()
        for p in self._inner.pods_on(node):
            used |= p.assigned_chips()
        free = sorted(
            c.coords for c in m.chips
            if c.healthy and c.coords not in used
            and c.hbm_free_mb >= spec.min_free_mb)
        if len(free) < spec.chips:
            return "overcommit"  # reference has no allocation view
        return free[:spec.chips]

    def bind(self, pod, node, assigned_chips=None):
        if assigned_chips is None:
            assigned_chips = self._naive_chips(pod, node)
            if assigned_chips == "overcommit":
                self.overcommitted_binds += 1
                raise OvercommitError(
                    f"{node}: all chips claimed; device plugin rejects")
        self._inner.bind(pod, node, assigned_chips)
        m = self._inner.telemetry.get(node)
        if m is None:
            return
        try:
            spec = spec_for(pod)
        except Exception:
            return
        # debit the chips that were ACTUALLY assigned — debiting different
        # chips than the device plugin handed out would desynchronise the
        # HBM view from the coordinate view and manufacture phantom
        # overcommits the real reference never caused
        taken = set(assigned_chips or ())
        need = spec.chips
        for c in sorted(m.chips,
                        key=lambda c: (c.coords not in taken, -c.hbm_free_mb)):
            if need == 0:
                break
            if c.healthy and (c.coords in taken
                              or c.hbm_free_mb >= spec.min_free_mb):
                c.hbm_free_mb = max(
                    0, c.hbm_free_mb - max(spec.min_free_mb, c.hbm_total_mb // max(m.chip_count, 1)))
                need -= 1
        self._inner.telemetry.put(m)


class RefSort:
    """The reference's queue order exactly: strict ``scv/priority`` only
    (sort.go:8-18) — none of PrioritySort's most-constrained-first
    tie-break. FIFO on ties is kept as engine glue (the comparator must be
    a strict weak order; upstream's queue masked that for the reference)."""

    name = "ref-priority-sort"

    def less(self, a, b) -> bool:
        from .sort import pod_priority

        pa, pb = pod_priority(a), pod_priority(b)
        if pa != pb:
            return pa > pb
        return a.enqueued < b.enqueued

    def key(self, info):
        from .sort import pod_priority

        return (-pod_priority(info), info.enqueued)


def reference_profile(config: SchedulerConfig):
    """A Profile wired with only reference-equivalent capability."""
    from ..core import Profile

    return Profile(
        queue_sort=RefSort(),
        filter=[RefFilter()],
        pre_score=[RefMaxCollection()],
        score=[RefScore()],
    )
