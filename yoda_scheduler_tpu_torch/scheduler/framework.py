"""Scheduling-framework extension points, re-implemented natively.

The reference does not implement a scheduling engine — it embeds upstream
kube-scheduler as a library and registers one plugin implementing 5 of its
extension points (reference pkg/yoda/scheduler.go:28-32 asserts QueueSort/
Filter/PostFilter/Score/ScoreExtensions). Building TPU-native and
standalone, we re-create the extension-point architecture itself so the
framework runs against any cluster backend (in-memory fake, or a real
API server via k8s/client.py):

    QueueSort -> PreFilter -> Filter -> [PostFilter on failure] ->
    PreScore -> Score -> NormalizeScore -> Reserve -> Permit -> Bind

Two deliberate departures from the reference, per SURVEY.md §3.2:
- PreScore exists and is where per-cycle aggregation happens. The reference
  abused PostFilter (a preemption hook in its pinned k8s v1.20) to collect
  cluster maxima, which silently never ran before Score on modern control
  planes; here PostFilter is what it should be — the failure/preemption hook.
- Permit exists, enabling all-or-nothing gang admission for multi-host
  pod-slice jobs (no counterpart in the reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any

from itertools import count as _count

from ..telemetry.schema import TpuNodeMetrics
from ..utils.pod import Pod

_NODE_INFO_SERIAL = _count(1)


class Code(IntEnum):
    SUCCESS = 0
    UNSCHEDULABLE = 1   # this node/pod combination cannot work; try others / retry later
    ERROR = 2           # internal problem; abort the cycle
    WAIT = 3            # Permit: park the pod, a co-scheduling decision is pending
    SKIP = 4            # plugin has nothing to say for this pod


@dataclass
class Status:
    code: Code = Code.SUCCESS
    message: str = ""

    @classmethod
    def success(cls) -> "Status":
        # shared singleton: success statuses are created per (pod, node)
        # on the hot path and nobody mutates them
        return _SUCCESS

    @classmethod
    def unschedulable(cls, message: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, message)

    @classmethod
    def error(cls, message: str) -> "Status":
        return cls(Code.ERROR, message)

    @classmethod
    def wait(cls, message: str = "") -> "Status":
        return cls(Code.WAIT, message)

    @classmethod
    def skip(cls) -> "Status":
        return cls(Code.SKIP)

    @property
    def ok(self) -> bool:
        return self.code == Code.SUCCESS

    def __bool__(self) -> bool:  # guard against truthiness misuse
        raise TypeError("use status.ok / status.code, not truthiness")


_SUCCESS = Status(Code.SUCCESS)


class CycleState:
    """Per-scheduling-cycle scratch space shared between plugins.

    The reference used framework.CycleState with manual Lock/Write/Unlock
    (reference pkg/yoda/collection/collection.go:53-55) because upstream
    runs Filter/Score over nodes in parallel goroutines. Here a cycle runs
    single-threaded under the engine's cycle lock, and single dict ops are
    atomic under the GIL — so the state is a plain dict (read/write are the
    hot path: several accesses per (pod, node) filter/score call)."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(f"cycle state has no key {key!r}")
        return self._data[key]

    def read_or(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._data = dict(self._data)
        return c


@dataclass
class NodeInfo:
    """A node as seen by one scheduling cycle: telemetry + pods bound there.

    The reference obtained these separately — telemetry from its CRD cache
    (scheduler.go:80,118) and pods from the framework's snapshot lister
    (scheduler.go:111); here the Snapshot carries both coherently."""

    name: str
    metrics: TpuNodeMetrics | None
    pods: list[Pod] = field(default_factory=list)
    # Node-object metadata.labels and spec.taints (upstream NodeAffinity /
    # TaintToleration contract — plugins/admission.py). The reference got
    # these checks from the kube-scheduler it embedded; telemetry CRs don't
    # carry them, the Node objects do.
    labels: dict[str, str] = field(default_factory=dict)
    taints: tuple = ()
    # status.allocatable as (cpu millicores, memory bytes); None = the
    # node reports no allocatable, i.e. no cpu/mem constraint (in-memory
    # fakes and accelerator-only deployments)
    allocatable: tuple | None = None
    # Node spec.unschedulable (kubectl cordon) — upstream's
    # NodeUnschedulable plugin, which the reference inherited from the
    # embedded kube-scheduler; honored in plugins/admission.py with the
    # standard toleration escape hatch
    unschedulable: bool = False
    # process-unique identity for version-keyed caches (id() can be reused
    # after GC; the serial never is). A NodeInfo is immutable once built, so
    # serial equality == same telemetry + same bound-pod set.
    serial: int = field(default_factory=lambda: next(_NODE_INFO_SERIAL),
                        repr=False, compare=False)
    # per-instance memos — a NodeInfo is built for one coherent view of the
    # node and may be reused across cycles while that view is unchanged
    _claimed_chips: int | None = field(default=None, repr=False, compare=False)
    _claimed_hbm: int | None = field(default=None, repr=False, compare=False)
    _assigned: set | None = field(default=None, repr=False, compare=False)
    _req_cpu_mem: tuple | None = field(default=None, repr=False, compare=False)
    _host_ports: tuple | None = field(default=None, repr=False, compare=False)

    def claimed_chips(self) -> int:
        """Chips already claimed by bound pods' labels (allocation view)."""
        if self._claimed_chips is None:
            from ..utils.labels import LabelError, spec_for

            total = 0
            for p in self.pods:
                try:
                    total += spec_for(p).chips
                except LabelError:
                    continue  # malformed bound pod: it never passed our filter
            self._claimed_chips = total
        return self._claimed_chips

    def claimed_hbm_mb(self) -> int:
        """HBM claimed by bound pods (per-chip request × chips), label view."""
        if self._claimed_hbm is None:
            from ..utils.labels import LabelError, spec_for

            total = 0
            for p in self.pods:
                try:
                    spec = spec_for(p)
                except LabelError:
                    continue
                total += spec.min_free_mb * spec.chips
            self._claimed_hbm = total
        return self._claimed_hbm

    def requested_cpu_mem(self) -> tuple[int, int]:
        """(cpu millicores, memory bytes) requested by bound pods —
        NodeResourcesFit accounting. Terminating pods COUNT: they hold
        their resources until deletion, exactly as their chips stay
        assigned (the preemptor waiting on them holds a nomination, and
        the engine's victims-draining guard covers the window). Memoized
        per NodeInfo."""
        if self._req_cpu_mem is None:
            cpu = mem = 0
            for p in self.pods:
                cpu += p.cpu_millis
                mem += p.memory_bytes
            self._req_cpu_mem = (cpu, mem)
        return self._req_cpu_mem

    def used_host_ports(self) -> tuple:
        """(hostPort, protocol, hostIP) triples bound pods hold — upstream
        NodePorts accounting. Terminating pods count, like cpu/mem above:
        the port stays bound until the pod is gone. Memoized per NodeInfo."""
        if self._host_ports is None:
            out = []
            for p in self.pods:
                out.extend(p.host_ports)
            self._host_ports = tuple(out)
        return self._host_ports

    def assigned_coords(self) -> set[tuple[int, int, int]]:
        """ICI coords claimed by bound pods (from bind-time chip assignment)."""
        if self._assigned is None:
            out: set[tuple[int, int, int]] = set()
            for p in self.pods:
                out |= p.assigned_chips()
            self._assigned = out
        return self._assigned


class Snapshot:
    """Immutable-ish view of cluster + telemetry taken at cycle start."""

    def __init__(self, node_infos: dict[str, NodeInfo],
                 budgets: tuple = (),
                 namespaces: dict[str, dict] | None = None) -> None:
        self._node_infos = node_infos
        # PodDisruptionBudgets in force this cycle (utils/pdb.py model);
        # preemption consults them when ranking victim plans. A budget
        # change bumps the cluster's membership version, so incremental
        # snapshots never carry stale budgets.
        self.budgets = budgets
        # namespace -> metadata.labels, for podAffinityTerm
        # namespaceSelector resolution; None (no namespace source) makes
        # namespace_labels return None and selectors match conservatively
        # nothing (admission._pod_term_selects). Namespace label changes
        # bump the cluster membership version like budget changes do.
        self._namespaces = namespaces
        # lazily-computed cluster facts used for plugin relevance gating
        # (core.py builds the per-cycle active-plugin lists from them);
        # incremental snapshots inherit the value from their parent when
        # the dirty set cannot have changed it
        self._any_taints: bool | None = None
        self._any_pod_anti: bool | None = None
        self._any_alloc: bool | None = None
        self._any_pref_pod: bool | None = None
        self._any_unsched: bool | None = None
        # list() result, computed once: the cycle walks the node list
        # several times (filter order, pre-score, preemption) and a fresh
        # 1000-element list per call was measurable at scale. Snapshots
        # are replaced (not mutated) after construction, so the cache
        # never goes stale within one snapshot's lifetime.
        self._list: "list[NodeInfo] | None" = None

    def get(self, name: str) -> NodeInfo | None:
        return self._node_infos.get(name)

    def namespace_labels(self, ns: str) -> dict | None:
        """metadata.labels of a namespace; {} for a known-labelless
        namespace, None when this snapshot has no namespace source at
        all (selectors then match nothing — conservative)."""
        if self._namespaces is None:
            return None
        return self._namespaces.get(ns, {})

    def list(self) -> list[NodeInfo]:
        if self._list is None:
            self._list = list(self._node_infos.values())
        return self._list

    def any_taints(self) -> bool:
        """True when at least one node carries a taint. On an untainted
        cluster (the common case) the admission plugin drops out of the
        per-(pod, node) filter/score hot loops entirely."""
        if self._any_taints is None:
            self._any_taints = any(
                ni.taints for ni in self._node_infos.values())
        return self._any_taints

    def any_unschedulable(self) -> bool:
        """True when at least one node is cordoned (spec.unschedulable) —
        gates the admission cordon check out of the hot loops on the
        common fully-schedulable cluster, like any_taints."""
        if self._any_unsched is None:
            self._any_unsched = any(
                ni.unschedulable for ni in self._node_infos.values())
        return self._any_unsched

    def any_allocatable(self) -> bool:
        """True when any node reports status.allocatable — without one,
        NodeResourcesFit has nothing to constrain and pods with ordinary
        container requests stay out of the admission hot loops."""
        if self._any_alloc is None:
            self._any_alloc = any(
                ni.allocatable is not None
                for ni in self._node_infos.values())
        return self._any_alloc

    def any_preferred_pod_affinity(self) -> bool:
        """True when any bound pod carries preferred inter-pod terms —
        their symmetric scoring makes them relevant to every incoming
        pod (gates the admission score hook like any_taints)."""
        if self._any_pref_pod is None:
            self._any_pref_pod = any(
                p.preferred_pod_affinity
                for ni in self._node_infos.values() for p in ni.pods)
        return self._any_pref_pod

    def any_pod_anti_affinity(self) -> bool:
        """True when any bound pod carries required podAntiAffinity — the
        symmetry rule makes such a pod relevant to EVERY incoming pod, so
        this gates the inter-pod checks the same way any_taints gates the
        taint checks."""
        if self._any_pod_anti is None:
            self._any_pod_anti = any(
                p.pod_anti_affinity
                for ni in self._node_infos.values() for p in ni.pods)
        return self._any_pod_anti

    def __len__(self) -> int:
        return len(self._node_infos)


@dataclass
class QueuedPodInfo:
    """Queue entry (reference framework.QueuedPodInfo analogue)."""

    pod: Pod
    enqueued: float = field(default_factory=time.time)
    attempts: int = 0
    last_failure: str = ""
    not_before: float = 0.0  # backoff gate
    # plugins whose rejection made the pod unschedulable this attempt —
    # the queue's event index routes cluster events to exactly these
    # plugins' queueing hints (upstream QueuedPodInfo.UnschedulablePlugins)
    rejected_by: tuple = ()
    # when the pod entered backoff (backoff-wait histogram input)
    backoff_started: float = 0.0
    # cycles this pod CRASHED (a plugin raised; distinct from `attempts`,
    # which counts orderly unschedulable verdicts) — the engine
    # quarantines the pod past SchedulerConfig.quarantine_threshold
    crashes: int = 0
    # consecutive server-rejected bind CONFLICTS (409 node-claim races in
    # a scheduler fleet). Conflict retries are attempt-free and
    # backoff-free — the loser of an optimistic race did nothing wrong —
    # but a pathological streak falls back to the ordinary backoff path
    # (core._bind_conflict)
    conflicts: int = 0
    # ---- e2e latency decomposition (observability). The queue and the
    # engine partition each pod's enqueue->bind interval on the injectable
    # clock: time sitting in the active queue or backoff (t_queue,
    # accumulated at pop), completed non-binding cycle time (t_cycle,
    # accumulated at requeue), and the final cycle's compute/commit split
    # (cycle_started/commit_started stamps) — observed into the e2e_*
    # histograms when the pod binds (core._bind). Plain float adds per
    # transition; never a span allocation. Sentinel is -1.0, NOT 0.0:
    # chaos/fuzz rigs run FakeClock from t=0, where 0.0 is a legitimate
    # stamp.
    last_queued_at: float = -1.0
    t_queue: float = 0.0
    t_cycle: float = 0.0
    cycle_started: float = -1.0
    commit_started: float = -1.0
    # start of the queue stint the last pop consumed (last_queued_at is
    # reset at pop; span recording needs the start after the fact)
    stint_started: float = -1.0


# --------------------------------------------------------------------------
# Cluster events + queueing hints (upstream EventsToRegister/QueueingHint
# analogue). A plugin that rejects pods declares which cluster events could
# make such a pod schedulable again; the queue then wakes a parked pod the
# moment a matching event arrives instead of letting it sleep out its
# backoff, and leaves it sleeping on non-matching events (no thundering
# herd of re-filtering).
# --------------------------------------------------------------------------
POD_BOUND = "PodBound"                        # a pod bound somewhere
POD_DELETED = "PodDeleted"                    # a bound pod left (evict/delete)
# intake signal, not a capacity event: a new unbound pod appeared in the
# watch cache. Wakes a sleeping serve loop so intake runs NOW instead of
# at the next poll tick; never routed through queueing hints (a pending
# pod's arrival cannot cure anyone's rejection)
POD_PENDING_ARRIVED = "PodPendingArrived"
NODE_ADDED = "NodeAdded"                      # node joined the cluster
NODE_TELEMETRY_UPDATED = "NodeTelemetryUpdated"  # telemetry CR changed
NODE_SPEC_CHANGED = "NodeSpecChanged"         # labels/taints/cordon edited
GANG_MEMBER_ARRIVED = "GangMemberArrived"     # a gang member (re)submitted

# hint verdicts
QUEUE = "QUEUE"   # the event can help: move the pod to the active queue
SKIP = "SKIP"     # the event cannot help: leave the pod in backoff


@dataclass(frozen=True)
class ClusterEvent:
    """One cluster state change, as published to the queue's event index.
    `node` is the node the event touched (when attributable); telemetry
    events carry the old and new metrics so hints can judge whether the
    change could free capacity (upstream hints receive old/new objects
    the same way). `origin` names the pending pod whose own rollback
    produced the event (reservation/permit unwind): that pod must NOT be
    woken by it — the "freed" capacity is its own, and self-waking would
    bypass its backoff in a park/timeout/repark livelock."""

    kind: str
    node: str | None = None
    gang: str | None = None
    old: Any = None
    new: Any = None
    origin: str | None = None


class EnqueueExtensions:
    """Mixin for plugins that reject pods: declare the cluster events a
    rejected pod should wake on, plus a per-(event, pod) hint. A rejecting
    plugin that does NOT implement this is treated conservatively — any
    event wakes its pods (upstream's behaviour for hint-less plugins)."""

    def events_to_register(self) -> tuple:
        """Event kinds that could make a pod this plugin rejected
        schedulable. Empty = no event can (pods wait out their backoff)."""
        return ()

    def queueing_hint(self, event: ClusterEvent, pod: Pod) -> str:
        """QUEUE to activate the pod now, SKIP to leave it in backoff."""
        return QUEUE


# --------------------------------------------------------------------------
# Plugin interfaces. A plugin implements any subset; the profile wires them in.
# --------------------------------------------------------------------------
# CycleState key a PreFilter plugin may write: a frozenset of node names
# that are the ONLY possible feasible nodes for this pod. The engine then
# skips the filter chain for every other node. Narrowing must be SOUND —
# a superset of feasibility under predicates no later phase (including
# preemption) can relax; gang slice membership / chosen-slice / plan
# quotas qualify because evictions change none of them.
CANDIDATE_NODES_KEY = "candidate_nodes"


# Sentinel a plugin's equivalence_key returns to declare "pods like this
# are NOT interchangeable under my verdicts" — the engine then never
# extends the queue head to a batch containing such a pod.
NO_BATCH = object()


class Plugin:
    name: str = "plugin"

    def equivalence_key(self, pod: Pod):
        """Scheduling-equivalence contribution (upstream equivalence-cache
        analogue, batch scheduling cycles): a hashable description of every
        POD-SPECIFIC input this plugin's behaviour depends on beyond the
        parsed WorkloadSpec and live cluster state. Two pods whose specs
        and every plugin's equivalence keys agree are interchangeable for
        one scheduling pass — the engine may pop them as one batch and
        share the filter/score work.

        Returning a key is a CONTRACT, not a hint: it asserts that for
        such a pod this plugin's Filter/Score verdicts are a pure function
        of (key, spec, cluster state), and that its PreFilter/Permit hooks
        are no-ops. Return framework.NO_BATCH for pods that carry state
        the key cannot capture (gang membership, inter-pod terms, exact
        topology shapes). The conservative DEFAULT is NO_BATCH — a plugin
        that never audited itself for interchangeability must not silently
        vouch for it, so profiles containing un-audited plugins simply
        never batch."""
        return NO_BATCH


class QueueSortPlugin(Plugin):
    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        raise NotImplementedError


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod: Pod, snapshot: Snapshot) -> Status:
        raise NotImplementedError


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        raise NotImplementedError

    def filter_batch(self, state: CycleState, pod: Pod, table, rows=None):
        """Vectorized capability hook (columnar data plane): return a
        boolean mask over `table` (scheduler/columnar.py) — the whole
        table when `rows` is None, else aligned with the given row-index
        array — with one verdict per node, True exactly where `filter`
        would return SUCCESS. Return None when this plugin/pod
        combination cannot be expressed over the columns (gang state,
        contiguous-block search, nominated holds, inter-pod terms): the
        WHOLE pod then takes the per-node scalar path, which stays the
        ground truth (parity pinned by tests/test_columnar.py). The
        subset form serves the class-memo repair paths, which re-filter
        only dirty nodes."""
        return None

    def native_filter_args(self, state: CycleState, pod: Pod, table):
        """Native-data-plane capability hook (scheduler/nativeplane.py):
        return the fused kernel's predicate parameters for this pod — a
        dict of YodaPlaneReq fields (native/fusedplane.cc) — or None
        when this plugin/pod combination cannot be expressed there. A
        single None sends the WHOLE pod down the numpy-columnar (then
        scalar) fallback chain; the kernel's verdicts must be
        bit-identical to `filter`'s booleans for the pods it accepts
        (parity pinned by tests/test_native_plane.py)."""
        return None


class PostFilterPlugin(Plugin):
    """Runs when no node passed Filter — the preemption hook (what PostFilter
    actually is in the modern framework, unlike the reference's use)."""

    def post_filter(self, state: CycleState, pod: Pod, snapshot: Snapshot,
                    failures: dict[str, str]) -> tuple[str | None, list[Pod], Status]:
        """Return (nominated_node or None, victims to evict, status). The
        engine performs the evictions generically."""
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(self, state: CycleState, pod: Pod, feasible: list[NodeInfo]) -> Status:
        raise NotImplementedError

    # Batch-commit capability hook. None = this plugin cannot update its
    # pre_score outputs incrementally, so the engine never arms the batch
    # commit loop for profiles containing it (each classmate then runs
    # the ordinary per-pod cycle). Implementations take
    # (state, pod, node_info, names) -> bool: one classmate just bound on
    # `node_info` (freshly rebuilt post-bind); `names` is the repaired
    # candidate name frozenset; bring this plugin's pre_score outputs in
    # `state` (and its own memos) to the cycle's new `cycle_versions`, or
    # return False when an exact update is impossible (the engine then
    # falls back to per-pod cycles for the rest of the batch). MUST leave
    # everything exactly as a fresh pre_score call at the new version
    # vector would — the batched-vs-per-pod parity fuzz pins this. See
    # plugins/prescore.py and plugins/topology.py for the two
    # implementations.
    pre_score_update = None

    # Native-data-plane capability hook. None = the fused kernel cannot
    # stand in for this plugin's pre_score, so the engine runs pre_score
    # normally even on native cycles. The one implementation
    # (MaxCollection.native_install) takes (state, spec, vers, names,
    # contribs, mv6) — the kernel's per-candidate qualifying maxima and
    # MaxValue fold — and must leave cycle state and its own memos
    # exactly as a fresh pre_score call would.
    native_install = None


class ScorePlugin(Plugin):
    weight: int = 1
    # Declared shape of `normalize` so the engine can fuse normalization
    # into the weighted sum without the per-cycle dict copy (and replay it
    # vectorized in the batch commit loop):
    #   "identity" — normalize leaves scores untouched (the base default,
    #                and plugins whose scores are already absolute);
    #   "minmax"   — normalize is exactly min_max_normalize(scores) with
    #                the default [0, 100] bounds;
    #   None       — undeclared: the engine calls `normalize` on a dict
    #                copy, the pre-existing generic path (a plugin that
    #                does not override `normalize` at all is detected as
    #                identity without a declaration).
    # The fused paths are written op-for-op like the declared shape, so
    # floats agree bit-for-bit (parity-fuzzed in tests/test_batch.py).
    normalize_kind: str | None = None

    def score(self, state: CycleState, pod: Pod, node: NodeInfo) -> tuple[float, Status]:
        raise NotImplementedError

    def score_batch(self, state: CycleState, pod: Pod, table, rows):
        """Vectorized capability hook (columnar data plane): return a
        float array of RAW scores aligned with `rows` (row indices into
        `table`, one per feasible candidate) — bit-identical to calling
        `score` per node — or None to keep the scalar loop. Normalize and
        the weighted sum still run on the full raw vector either way."""
        return None

    def native_score_args(self, state: CycleState, pod: Pod, table):
        """Native-data-plane capability hook: return the fused kernel's
        scoring parameters ({"kind": ..., weights...} — see
        scheduler/nativeplane.py) or None to keep this plugin's scores
        on the Python path (the engine folds kernel-born and
        Python-born raw vectors in profile order, so a mixed cycle
        stays bit-identical). Kernel raw terms must match `score`
        bit-for-bit for the pods this hook accepts."""
        return None

    def normalize(self, state: CycleState, pod: Pod, scores: dict[str, float]) -> None:
        """Optional ScoreExtensions.NormalizeScore analogue; mutate in place."""
        return None


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod: Pod, node: str) -> Status:
        raise NotImplementedError

    def unreserve(self, state: CycleState, pod: Pod, node: str) -> None:
        raise NotImplementedError


class PermitPlugin(Plugin):
    def permit(self, state: CycleState, pod: Pod, node: str) -> tuple[Status, float]:
        """Return (status, timeout_s). WAIT parks the pod up to timeout_s."""
        raise NotImplementedError


class BindPlugin(Plugin):
    def bind(self, state: CycleState, pod: Pod, node: str) -> Status:
        raise NotImplementedError


def min_max_normalize(scores: dict[str, float], lo: float = 0.0, hi: float = 100.0) -> None:
    """The reference's NormalizeScore rescales raw sums to [0,100] via
    min-max (reference pkg/yoda/scheduler.go:132-157, including a `lowest--`
    divide-by-zero guard). Same math, standard guard.

    EDIT IN LOCKSTEP: plugins declaring ``normalize_kind = "minmax"``
    promise exactly this arithmetic with the default bounds, and two
    fused replicas depend on it bit-for-bit — the scalar fold in
    core.Scheduler._fold_scores and the vectorized fold in
    core.Scheduler._commit_batch. Changing the ops here without mirroring
    both silently diverges batched vs per-pod placements on score ties
    (the parity fuzz in tests/test_batch.py is the tripwire)."""
    if not scores:
        return
    lowest = min(scores.values())
    highest = max(scores.values())
    span = highest - lowest
    for k, v in scores.items():
        scores[k] = hi if span == 0 else lo + (v - lowest) * (hi - lo) / span
