"""Workload label contract and strict parsing.

The reference's user contract is pod labels ``scv/memory``, ``scv/number``,
``scv/clock``, ``scv/priority`` (reference readme.md:27-69); we keep that
exact surface (so a reference user can switch without rewriting manifests)
and extend it with the TPU namespace:

- ``tpu/accelerator``: "tpu" | "gpu" — mixed-cluster partitioning (BASELINE
  config #5); absent = any accelerator that satisfies the resource labels.
- ``tpu/topology``: requested ICI block, e.g. "2x2" — topology-aware packing.
- ``tpu/gang-name`` + ``tpu/gang-size``: multi-host gang (one worker pod per
  host of a pod slice; all-or-nothing admission via the Permit plugin).

Parsing is strict: the reference silently coerced malformed or negative
values to 0 via Atoi-error-swallowing and uint wraparound (reference
pkg/yoda/filter/filter.go:60-86 — SURVEY §3.3 flags this as a hazard). Here a
malformed label raises LabelError, which the filter surfaces as an
Unschedulable status naming the bad label instead of quietly scheduling the
pod as if it had asked for nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

from .memo import memo

MEMORY_LABEL = "scv/memory"       # min free HBM per chip, MB
NUMBER_LABEL = "scv/number"       # chips requested on the node
CLOCK_LABEL = "scv/clock"         # min chip clock, MHz (>= semantics, see below)
PRIORITY_LABEL = "scv/priority"   # queue priority, higher first

ACCELERATOR_LABEL = "tpu/accelerator"
GENERATION_LABEL = "tpu/generation"  # pin a TPU generation ("v4", "v5e", ...)
TOPOLOGY_LABEL = "tpu/topology"
GANG_NAME_LABEL = "tpu/gang-name"
GANG_SIZE_LABEL = "tpu/gang-size"
# elastic gangs (scheduler/elastic/): minimum viable replica count — a
# gang labeled with it may ADMIT at min members when the full size does
# not fit, then grow toward tpu/gang-size as chips free. 0/absent keeps
# the classic all-or-nothing admission. Only meaningful on gang pods and
# only when the elasticGangs knob is on.
GANG_MIN_LABEL = "tpu/gang-min"
# deadline/SLO-aware admission (scheduler/elastic/): seconds after the
# gang's first member arrives by which the job must be RUNNING. Drives
# the start-now-at-min vs wait-for-full decision off the policy engine's
# throughput model (ElasticGangs.deadline_pressed). 0/absent = no
# deadline pressure (start at min only when the full size provably
# cannot fit).
DEADLINE_LABEL = "scv/deadline-seconds"

# Harvest capacity class (scheduler/capacity/): a pod labeled
# ``scv/harvest: "1"`` soaks otherwise-idle chips and is EVICTED FOR
# FREE — outside every disruption protection (preemption budgets, the
# PDB ledger, victim-priority ordering) and first out the door when the
# capacity provisioner drains a node for scale-down. Riding the
# WorkloadSpec keeps every spec-keyed surface (class memos, batch keys)
# sound: a harvest pod and its non-harvest twin never share a class.
HARVEST_LABEL = "scv/harvest"

# SLO serving class (scheduler/elastic/sloguard.py). A pod
# labeled ``scv/serving: "1"`` carries latency-sensitive user traffic:
# its e2e scheduling latency is measured against ``scv/slo-ms`` by the
# burn-rate monitor, it is exempt from workload-tier rate limiting and
# queue-depth backpressure, and under SLO pressure the guard shrinks
# elastic training gangs toward tpu/gang-min to make room. Riding the
# WorkloadSpec keeps every spec-keyed surface (class memos, batch keys)
# sound: a serving pod and its batch twin never share a class. A
# scheduling input only when the sloServing knob is on.
SERVING_LABEL = "scv/serving"
# per-request scheduling-latency SLO in milliseconds; requires
# scv/serving (an SLO without the serving class would never be
# monitored — strict parsing rejects the silent no-op).
SLO_MS_LABEL = "scv/slo-ms"

# Policy-engine labels (scheduler/policy/). The workload CLASS names the
# job's throughput profile across accelerator generations (Gavel's
# job-type axis, arXiv:2008.09213) — it rides the WorkloadSpec so every
# spec-keyed surface (class memos, batch keys, per-spec maxima memo)
# distinguishes classes automatically. The TENANT names the quota/DRF
# accounting unit; absent, the pod's namespace is the tenant (it is part
# of the memo/batch keys already).
WORKLOAD_CLASS_LABEL = "scv/class"
TENANT_LABEL = "scv/tenant"


class LabelError(ValueError):
    """A workload label is present but malformed."""

    def __init__(self, label: str, value: str, why: str = "must be a non-negative integer"):
        self.label = label
        super().__init__(f"label {label}={value!r}: {why}")


def _parse_uint(labels: dict[str, str], key: str, default: int) -> int:
    raw = labels.get(key)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise LabelError(key, raw) from None
    if v < 0:
        raise LabelError(key, raw)
    return v


def _parse_int(labels: dict[str, str], key: str, default: int) -> int:
    raw = labels.get(key)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise LabelError(key, raw, "must be an integer") from None


@dataclass(frozen=True, eq=True)
class WorkloadSpec:
    """The parsed resource request of one pod.

    Semantics notes vs. the reference:
    - ``chips`` defaults to 1 when ``scv/number`` is absent, matching
      PodFitsNumber's default (reference pkg/yoda/filter/filter.go:15).
    - ``min_clock_mhz`` uses >= ("at least this fast"), resolving the
      reference's filter-vs-score inconsistency (== at filter.go:57 but >= at
      collection.go:46 / algorithm.go:48) in favour of the README's stated
      intent ("high-performance GPU", readme.md:55-63).
    """

    chips: int = 1
    min_free_mb: int = 0
    min_clock_mhz: int = 0
    priority: int = 0
    accelerator: str | None = None   # None = any
    tpu_generation: str | None = None  # None = any generation
    topology: str | None = None      # e.g. "2x2"
    gang_name: str | None = None
    gang_size: int = 0
    # elastic-gang minimum (tpu/gang-min): 0 = classic all-or-nothing.
    # A scheduling input only when the elasticGangs knob is on; riding
    # the spec keeps every spec-keyed surface (class memos, batch keys)
    # sound — two gangs differing only in min never share a class.
    gang_min: int = 0
    # start-deadline seconds (scv/deadline-seconds): 0 = none
    deadline_s: int = 0
    # harvest capacity class (scv/harvest): evicted for free — outside
    # preemption budgets and the PDB ledger, first victim of scale-down
    # drains. False/absent = ordinary pod.
    harvest: bool = False
    # SLO serving class (scv/serving): latency-sensitive user traffic —
    # exempt from workload-tier rate limiting/backpressure, measured by
    # the burn-rate monitor, protected by the serving-headroom quota
    # level. False/absent = batch/training.
    serving: bool = False
    # scheduling-latency SLO, ms (scv/slo-ms): 0 = unmonitored. Only
    # valid together with scv/serving.
    slo_ms: int = 0
    # declared throughput-profile class (scv/class); None = classless —
    # the heterogeneity model then falls back to a coarse spec-derived
    # class. A scheduling input ONLY when the policy engine is enabled;
    # carrying it on the spec keeps the class memos and batch keys sound
    # (two pods differing only in class never share a spec).
    workload_class: str | None = None

    # Whether the pod opted into accelerator scheduling at all: a pod with no
    # scv/* labels still defaults to 1 chip (reference behaviour — any pod
    # routed to the yoda scheduler wants an accelerator node).
    @classmethod
    def from_labels(cls, labels: dict[str, str]) -> "WorkloadSpec":
        gang_size = _parse_uint(labels, GANG_SIZE_LABEL, 0)
        gang_name = labels.get(GANG_NAME_LABEL)
        if gang_name is not None and gang_size <= 0:
            raise LabelError(GANG_SIZE_LABEL, labels.get(GANG_SIZE_LABEL, ""),
                             "gang pods must set a positive tpu/gang-size")
        gang_min = _parse_uint(labels, GANG_MIN_LABEL, 0)
        if gang_min:
            if gang_name is None:
                raise LabelError(GANG_MIN_LABEL, labels[GANG_MIN_LABEL],
                                 "tpu/gang-min requires tpu/gang-name")
            if gang_min > gang_size:
                raise LabelError(GANG_MIN_LABEL, labels[GANG_MIN_LABEL],
                                 f"must be <= tpu/gang-size ({gang_size})")
        accel = labels.get(ACCELERATOR_LABEL)
        if accel is not None and accel not in ("tpu", "gpu"):
            raise LabelError(ACCELERATOR_LABEL, accel, 'must be "tpu" or "gpu"')
        gen = labels.get(GENERATION_LABEL)
        if gen is not None:
            from ..topology.generations import GENERATIONS  # validate eagerly

            if gen not in GENERATIONS:
                raise LabelError(GENERATION_LABEL, gen,
                                 f"must be one of {sorted(GENERATIONS)}")
        topo = labels.get(TOPOLOGY_LABEL)
        if topo is not None:
            from ..topology.torus import parse_topology  # validate eagerly

            try:
                parse_topology(topo)
            except ValueError:
                raise LabelError(TOPOLOGY_LABEL, topo, "must look like '2x2x1'") from None
        wclass = labels.get(WORKLOAD_CLASS_LABEL)
        if wclass is not None and not wclass:
            raise LabelError(WORKLOAD_CLASS_LABEL, wclass,
                             "must be a non-empty class name")
        harvest_raw = labels.get(HARVEST_LABEL)
        harvest = False
        if harvest_raw is not None:
            if harvest_raw in ("1", "true", "True"):
                harvest = True
            elif harvest_raw not in ("0", "false", "False"):
                raise LabelError(HARVEST_LABEL, harvest_raw,
                                 'must be "1"/"true" or "0"/"false"')
        serving_raw = labels.get(SERVING_LABEL)
        serving = False
        if serving_raw is not None:
            if serving_raw in ("1", "true", "True"):
                serving = True
            elif serving_raw not in ("0", "false", "False"):
                raise LabelError(SERVING_LABEL, serving_raw,
                                 'must be "1"/"true" or "0"/"false"')
        slo_ms = _parse_uint(labels, SLO_MS_LABEL, 0)
        if slo_ms and not serving:
            raise LabelError(SLO_MS_LABEL, labels[SLO_MS_LABEL],
                             "scv/slo-ms requires scv/serving")
        if serving and harvest:
            raise LabelError(SERVING_LABEL, serving_raw or "",
                             "a pod cannot be both serving and harvest")
        return cls(
            chips=_parse_uint(labels, NUMBER_LABEL, 1),
            min_free_mb=_parse_uint(labels, MEMORY_LABEL, 0),
            min_clock_mhz=_parse_uint(labels, CLOCK_LABEL, 0),
            priority=_parse_int(labels, PRIORITY_LABEL, 0),
            accelerator=accel,
            tpu_generation=gen,
            topology=topo,
            gang_name=gang_name,
            gang_size=gang_size,
            gang_min=gang_min,
            deadline_s=_parse_uint(labels, DEADLINE_LABEL, 0),
            harvest=harvest,
            serving=serving,
            slo_ms=slo_ms,
            workload_class=wclass,
        )

    @property
    def is_gang(self) -> bool:
        return self.gang_name is not None

    def __hash__(self) -> int:
        # cached: specs key the filter-verdict and unschedulable-class
        # caches, so they are hashed once per (pod, node) on the hot path;
        # frozen dataclasses rebuild the field tuple on every hash call
        h = self.__dict__.get("_hash_memo")
        if h is None:
            h = hash((self.chips, self.min_free_mb, self.min_clock_mhz,
                      self.priority, self.accelerator, self.tpu_generation,
                      self.topology, self.gang_name, self.gang_size,
                      self.gang_min, self.deadline_s, self.harvest,
                      self.serving, self.slo_ms, self.workload_class))
            object.__setattr__(self, "_hash_memo", h)
        return h


# NOTE: spec_for() builds its memo key from exactly this label set —
# keep the two in sync
_SPEC_LABELS = (
    NUMBER_LABEL, MEMORY_LABEL, CLOCK_LABEL, PRIORITY_LABEL,
    ACCELERATOR_LABEL, GENERATION_LABEL, TOPOLOGY_LABEL,
    GANG_NAME_LABEL, GANG_SIZE_LABEL, GANG_MIN_LABEL, DEADLINE_LABEL,
    HARVEST_LABEL, SERVING_LABEL, SLO_MS_LABEL, WORKLOAD_CLASS_LABEL,
)
_SPEC_LABEL_SET = frozenset(_SPEC_LABELS)

# the complete public label surface (spec inputs + the bind-time chip
# assignment the scheduler itself publishes) — `cli validate` flags any
# other scv/* or tpu/* label as a probable typo
from .pod import ASSIGNED_CHIPS_LABEL as _ASSIGNED  # no cycle: pod imports only .memo

KNOWN_LABELS = frozenset(_SPEC_LABELS) | {_ASSIGNED, TENANT_LABEL}


def workload_class(pod) -> str:
    """Coarse pod classification for per-class latency metrics (the bench
    decomposes p50 by these). Not a scheduling input."""
    try:
        spec = spec_for(pod)
    except LabelError:
        return "malformed"
    if spec.serving:
        return "serving"
    if spec.is_gang:
        return "gang"
    if spec.topology is not None:
        return "topology"
    if spec.accelerator == "gpu":
        return "gpu"
    if spec.chips > 1:
        return "tpu-multi"
    if ACCELERATOR_LABEL in pod.labels or NUMBER_LABEL in pod.labels:
        return "tpu-single"
    return "unlabeled"


def is_harvest(pod) -> bool:
    """Whether the pod belongs to the harvest capacity class (evicted
    for free — see HARVEST_LABEL). Malformed labels read as non-harvest:
    a pod that cannot declare its class never gets the weaker
    protections removed by accident."""
    try:
        return spec_for(pod).harvest
    except LabelError:
        return False


def is_serving(pod) -> bool:
    """Whether the pod belongs to the SLO serving class (see
    SERVING_LABEL). Malformed labels read as non-serving: a pod that
    cannot declare its class never acquires the stronger admission
    fastpath by accident."""
    try:
        return spec_for(pod).serving
    except LabelError:
        return False


def tenant_of(pod) -> str:
    """The pod's quota/DRF accounting unit (scheduler/policy/): the
    scv/tenant label when present, else the namespace. Both inputs are
    already inside the engine's memo/batch keys (namespace directly,
    the label via plugin equivalence contributions), so tenancy can
    never alias across a memo class."""
    return pod.labels.get(TENANT_LABEL) or pod.namespace


_SPEC_INTERN: dict[WorkloadSpec, WorkloadSpec] = {}


def _intern_spec(spec: WorkloadSpec) -> WorkloadSpec:
    """One canonical object per spec VALUE: pods sharing a label class then
    share the spec object, so dict lookups in the spec-keyed caches
    short-circuit on identity instead of comparing nine fields."""
    got = _SPEC_INTERN.get(spec)
    if got is not None:
        return got
    if len(_SPEC_INTERN) > 4096:  # churn guard; classes are few in practice
        _SPEC_INTERN.clear()
    _SPEC_INTERN[spec] = spec
    return spec


def spec_for(pod) -> WorkloadSpec:
    """Parse-once spec cache for a pod-like object (anything with ``labels``).

    Keyed by the values of the labels the spec reads, so in-place label
    mutation (bind-time chip assignment, eviction cleanup) can never serve a
    stale spec. The scheduler walks every bound pod's spec on every cycle
    (allocation accounting), so parse cost is hot-path cost. Raises LabelError
    exactly like ``WorkloadSpec.from_labels``; errors are not cached (a
    malformed pod fails its cycle permanently anyway)."""
    labels = pod.labels
    # key = the present spec-label ITEMS, one filtered walk of the (few)
    # labels instead of twelve .get calls. Coverage is exact: any
    # spec-label add/remove/change moves the key, while non-spec labels
    # (the bind-time chip assignment, app labels) never force a reparse.
    key = tuple(kv for kv in labels.items() if kv[0] in _SPEC_LABEL_SET)
    hit = pod.__dict__.get("_spec_cache")
    if hit is not None and hit[0] == key:
        return hit[1]
    spec = _intern_spec(WorkloadSpec.from_labels(labels))
    pod.__dict__["_spec_cache"] = (key, spec)
    return spec
