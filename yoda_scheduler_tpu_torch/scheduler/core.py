"""The scheduling engine: queue -> cycle -> bind, with gang parking.

This is the native replacement for the upstream kube-scheduler machinery the
reference borrowed wholesale (its scheduleOne loop, queue, binding cycle;
reference pkg/register/register.go:10-12 embeds it as a library). One
scheduler instance owns:

- a SchedulingQueue ordered by the QueueSort plugin, with 1s->10s backoff
  (reference deploy/yoda-scheduler.yaml:19-20)
- the scheduling cycle across extension points (framework.py)
- a waiting-pod parking lot for Permit WAIT verdicts (gang admission)
- structured cycle traces + Prometheus-style metrics (utils/obs.py)

kube-scheduler parity details implemented natively:
- only pods whose spec.schedulerName matches the profile are scheduled
- percentageOfNodesToScore: Filter stops early once enough feasible nodes
  are found, starting from a rotating offset (the adaptive formula for the
  0/default case, reference deploy/yoda-scheduler.yaml:18 inherits it)
- score ties break randomly (seeded)
- PostFilter (preemption) runs only when no node is feasible, mirroring the
  modern framework role the reference misused (SURVEY §3.2).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque

from .cluster import FakeCluster
from .columnar import ColumnarTable, HAVE_NUMPY, np
from .config import SchedulerConfig
from .framework import (
    BindPlugin,
    CANDIDATE_NODES_KEY,
    ClusterEvent,
    Code,
    CycleState,
    FilterPlugin,
    GANG_MEMBER_ARRIVED,
    NO_BATCH,
    NODE_TELEMETRY_UPDATED,
    NodeInfo,
    POD_DELETED,
    POD_PENDING_ARRIVED,
    PermitPlugin,
    PostFilterPlugin,
    PreFilterPlugin,
    PreScorePlugin,
    QUEUE,
    QueuedPodInfo,
    QueueSortPlugin,
    ReservePlugin,
    ScorePlugin,
    Snapshot,
    Status,
)

# sentinel distinguishing "no cached batch key yet" from a cached None
_BKEY_MISS = object()
from .queue import DRFShardedQueue, SchedulingQueue
from .plugins import (
    ChipAllocator,
    FragmentationScore,
    GangCoordinator,
    GangPermit,
    MaxCollection,
    NodeAdmission,
    PriorityPreemption,
    PrioritySort,
    TelemetryFilter,
    TelemetryScore,
    TopologyScore,
)
from .plugins.prescore import MAX_KEY
from .plugins.topology import SLICE_USE_KEY
from ..utils.labels import (
    GANG_NAME_LABEL, LabelError, is_harvest, spec_for, tenant_of,
    workload_class)
from ..utils.obs import (
    CycleTrace, FlightRecorder, Metrics, SpanRing, TraceLog, span_sampled)
from ..utils.pod import ASSIGNED_CHIPS_LABEL, Pod, PodPhase, format_assigned_chips

# distinguishes "caller supplied no metrics" from "telemetry is None"
_UNSET = object()

# cached single-label tuples for the per-cycle labeled counters (the
# values come from small fixed vocabularies — outcomes, planes, plugin
# names — so the cache stays tiny while saving a dict build + sort per
# scheduling cycle)
_LABEL1_CACHE: dict = {}

_EMPTY_SET: frozenset = frozenset()


def _numpy_fold(smat, kind_flags, weights, n):
    """The ONE numpy definition of the normalize+weighted-sum fold:
    op-for-op `Scheduler._fold_scores` (and the C kernel's
    yoda_batch_fold) — minmax lo/hi, span == 0 -> flat 100.0, else
    0.0 + (v - lo) * 100.0 / span, accumulated totals + w * v per
    scorer in order. The batch-commit loop and the per-cycle fold both
    fall back to THIS when the native kernel is absent, so the three
    implementations cannot drift apart one call site at a time. Returns
    the totals array."""
    totals = np.zeros(n, dtype=np.float64)
    for k in range(smat.shape[0]):
        arr = smat[k, :n]
        if kind_flags[k]:
            lowest = arr.min()
            span = arr.max() - lowest
            if span == 0:
                arr = np.full(n, 100.0)
            else:
                arr = 0.0 + (arr - lowest) * 100.0 / span
        totals = totals + float(weights[k]) * arr
    return totals


def _label1(key: str, value: str) -> tuple:
    hit = _LABEL1_CACHE.get((key, value))
    if hit is None:
        if len(_LABEL1_CACHE) > 4096:
            _LABEL1_CACHE.clear()
        hit = ((key, value),)
        _LABEL1_CACHE[(key, value)] = hit
    return hit


class Clock:
    """Injectable time source so tests/benches control backoff and timeouts."""

    def time(self) -> float:
        return time.time()

    def sleep(self, s: float) -> None:
        time.sleep(s)


class FakeClock(Clock):
    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def time(self) -> float:
        return self._now

    def sleep(self, s: float) -> None:
        self._now += s

    def advance(self, s: float) -> None:
        self._now += s


class HybridClock(Clock):
    """Real elapsed compute time + virtual sleeps. Benchmarks use this so
    measured latencies include genuine scheduling-cycle cost and queue wait,
    while backoff/permit sleeps advance time instantly instead of stalling
    the harness for real seconds."""

    def __init__(self) -> None:
        self._t0 = time.time()
        self._p0 = time.perf_counter()
        self._virtual = 0.0

    def time(self) -> float:
        return self._t0 + (time.perf_counter() - self._p0) + self._virtual

    def sleep(self, s: float) -> None:
        self._virtual += s


class Profile:
    """A wired plugin set (the KubeSchedulerConfiguration profile analogue)."""

    def __init__(
        self,
        queue_sort: QueueSortPlugin,
        pre_filter: list[PreFilterPlugin] | None = None,
        filter: list[FilterPlugin] | None = None,
        post_filter: list[PostFilterPlugin] | None = None,
        pre_score: list[PreScorePlugin] | None = None,
        score: list[ScorePlugin] | None = None,
        reserve: list[ReservePlugin] | None = None,
        permit: list[PermitPlugin] | None = None,
        bind: BindPlugin | None = None,
    ) -> None:
        self.queue_sort = queue_sort
        self.pre_filter = pre_filter or []
        self.filter = filter or []
        self.post_filter = post_filter or []
        self.pre_score = pre_score or []
        self.score = score or []
        self.reserve = reserve or []
        self.permit = permit or []
        self.bind = bind
        # policy engine (scheduler/policy/): set by default_profile /
        # registry.build_profile when policyObjective / DRF knobs enable
        # it; None = the pre-policy engine, placements bit-identical.
        # The Scheduler attaches its cluster/metrics/flight at init.
        self.policy = None
        # elastic-gang controller (scheduler/elastic/): set when the
        # elasticGangs knob is on; None = classic all-or-nothing gang
        # admission, placements bit-identical.
        self.elastic = None


def _headroom_gate(policy):
    from .policy.headroom import ServingHeadroomGate

    return ServingHeadroomGate(policy)


def default_profile(config: SchedulerConfig,
                    allocator: ChipAllocator | None = None,
                    gangs: GangCoordinator | None = None,
                    ) -> tuple[Profile, ChipAllocator, GangPermit]:
    """The yoda-tpu plugin set: telemetry filter/score (reference capability)
    + topology scorer, chip allocator, gang permit, priority preemption.

    `allocator`/`gangs` may be shared instances: co-hosted profiles
    (multi.py) must see each other's pending reservations or they would
    double-book chips between Reserve and Bind."""
    allocator = allocator or ChipAllocator()
    gangs = gangs or GangCoordinator()
    # elastic gangs (scheduler/elastic/): built only when the knob asks —
    # the off default constructs the EXACT pre-elastic plugin set, so
    # placements stay bit-identical (tests/test_elastic.py)
    elastic = None
    if config.elastic_gangs:
        from .elastic import ElasticGangs

        elastic = ElasticGangs(config)
    # geometric torus placement (scheduler/carve.py): built only when the
    # knob asks — the off default constructs the EXACT pre-torus plugin
    # set, so placements stay bit-identical (tests/test_torus_carve.py)
    carver = None
    if config.torus_placement:
        from .carve import TorusCarver

        carver = TorusCarver(allocator)
    gang_permit = GangPermit(gangs, timeout_s=config.gang_timeout_s,
                             allocator=allocator, elastic=elastic,
                             carver=carver)
    topo = TopologyScore(allocator, weight=config.topology_weight)
    admission = NodeAdmission(allocator)
    # policy engine (scheduler/policy/): built only when a knob asks for
    # it — the unset default constructs the EXACT pre-policy plugin set,
    # so placements stay bit-identical (pinned by tests/test_policy.py)
    policy = None
    # serving headroom rides the policy engine's DRF book:
    # reserving capacity for scv/serving forces the engine on even with
    # no objective/tenants configured
    headroom_on = (config.slo_serving
                   and config.serving_headroom_pct > 0.0)
    policy_enabled = (config.policy_objective or config.drf_fairness
                      or config.tenant_quotas or headroom_on)
    if policy_enabled:
        from .policy import (HeterogeneityScore, PolicyEngine,
                             TenantFairnessSort, TenantQuotaGate)

        policy = PolicyEngine(config)
    hetero = ([HeterogeneityScore(policy.model, config.policy_objective,
                                  weight=config.heterogeneity_weight,
                                  policy=policy)]
              if policy is not None and config.policy_objective
              and config.heterogeneity_weight > 0 else [])
    drf_on = policy is not None and (config.drf_fairness
                                     or config.tenant_quotas)
    profile = Profile(
        queue_sort=(TenantFairnessSort(policy) if drf_on
                    else PrioritySort()),
        # quota gate first (one node-independent check per cycle, before
        # gang planning pays anything); the serving-headroom gate sits
        # beside it — the quota level above every tenant; GangPermit.
        # pre_filter computes multi-slice plans for gangs no single
        # slice can host
        pre_filter=([TenantQuotaGate(policy)] if drf_on else [])
        + ([_headroom_gate(policy)] if headroom_on else [])
        + [gang_permit],
        # admission first: nodeSelector/taint rejections are cheap and spare
        # the telemetry filter's capacity math on excluded nodes
        filter=[admission,
                TelemetryFilter(allocator, gangs, config.telemetry_max_age_s)],
        post_filter=[PriorityPreemption(allocator, gangs)] if config.preemption else [],
        # TopologyScore is both a PreScore (slice-usage map) and a Score plugin
        pre_score=[MaxCollection(allocator)] + ([topo] if config.topology_weight > 0 else []),
        score=[
            TelemetryScore(allocator, config.weights, weight=1),
            *([topo] if config.topology_weight > 0 else []),
            *([FragmentationScore(allocator,
                                  weight=config.fragmentation_weight,
                                  carver=carver)]
              if config.fragmentation_weight > 0 else []),
            *hetero,
            admission,
        ],
        reserve=[allocator, gang_permit],
        permit=[gang_permit],
    )
    profile.policy = policy
    if elastic is not None:
        # the deadline decision reads the policy engine's throughput
        # model when one exists (built just above)
        elastic.policy = policy
    profile.elastic = elastic
    return profile, allocator, gang_permit


class _WaitingPod:
    def __init__(self, info: QueuedPodInfo, node: str, deadline: float) -> None:
        self.info = info
        self.node = node
        self.deadline = deadline


class _BatchCtx:
    """Carry-over from an equivalence-class batch's FIRST (ordinary)
    scheduling cycle into the incremental commit loop (_commit_batch):
    the candidate list in ranking order, every scorer's raw score dict
    (copies — the cycle's own memo entries must not alias them), and the
    prescore outputs the loop maintains per member."""

    __slots__ = ("armed", "state", "spec", "memo_key", "want",
                 "scorers", "candidates", "raws", "names_set", "vers",
                 "usage", "mv_t", "chosen")

    def __init__(self) -> None:
        self.armed = False

    def arm(self, **kw) -> None:
        self.armed = True
        for k, v in kw.items():
            setattr(self, k, v)


class _NativeCycle:
    """One fused native scan's outputs, reshaped for the engine: the
    candidate NodeInfos in scan order, the per-plugin raw score dicts
    (kernel-born for native scorers), the MaxValue fold + per-candidate
    contributions for MaxCollection.native_install, and — when EVERY
    active scorer was native — the fused normalize+weighted totals."""

    __slots__ = ("feasible", "names_set", "checked", "mv6", "contribs",
                 "raws", "totals", "scorers")


# _native_scan verdict: the kernel ran and found ZERO feasible rows —
# final (the numpy mask would agree), so the engine skips the numpy
# attempt and hands the pod to the scalar scan for its diagnostics
_NATIVE_EMPTY = object()

# fence_provider verdict: the replica owned the target node's shard when
# the cycle started, but the lease has since expired or been reassigned —
# the commit is aborted cleanly (reservation unwound, attempt-free
# retry) instead of burning a doomed RPC the authority would fence-reject
FENCE_LOST = object()


class Scheduler:
    def __init__(
        self,
        cluster: FakeCluster,
        config: SchedulerConfig | None = None,
        profile: Profile | None = None,
        clock: Clock | None = None,
        cycle_lock: "threading.RLock | None" = None,
    ) -> None:
        self.cluster = cluster
        self.config = config or SchedulerConfig()
        if profile is None:
            profile, allocator, gang_permit = default_profile(self.config)
            self.allocator: ChipAllocator | None = allocator
            self.gang_permit: GangPermit | None = gang_permit
        else:
            self.allocator = next(
                (p for p in profile.reserve if isinstance(p, ChipAllocator)), None
            )
            self.gang_permit = next(
                (p for p in profile.permit if isinstance(p, GangPermit)), None
            )
        self.profile = profile
        self.clock = clock or Clock()
        self.metrics = Metrics()
        # torus carver observability: the carver is built inside the
        # profile (no Metrics exists yet there) — hand it ours
        _carver = getattr(self.gang_permit, "carver", None)
        if _carver is not None:
            _carver.metrics = self.metrics
        qkw = dict(
            initial_backoff_s=self.config.pod_initial_backoff_s,
            max_backoff_s=self.config.pod_max_backoff_s,
            key=getattr(profile.queue_sort, "key", None),
            metrics=self.metrics,
            hinted_backoff_s=self.config.pod_hinted_backoff_s,
        )
        if getattr(profile.queue_sort, "sharded_drf", False) \
                and getattr(profile, "policy", None) is not None:
            # DRF fairness: per-tenant sharded priority bands with
            # exact-at-pop shares off the live book (queue.py docstring)
            # — the sort plugin supplies the band inputs, the queue does
            # the tenant selection
            from .plugins.sort import pod_priority

            self.queue: SchedulingQueue = DRFShardedQueue(
                profile.queue_sort.less, policy=profile.policy,
                tenant_fn=tenant_of, priority_fn=pod_priority,
                subkey_fn=profile.queue_sort.subkey, **qkw)
        else:
            self.queue = SchedulingQueue(profile.queue_sort.less, **qkw)
        # churn plane half (a): drain the notify inbox in batched slices
        # (queue._drain_batch) instead of one on_event walk per event
        self._churn = bool(config.churn_plane)
        self.queue.batch_drain = self._churn
        # event-driven requeue: register every plugin's EnqueueExtensions
        # (queueing hints) with the queue's event index, plus the engine's
        # own hint for pods waiting on preemption victims to drain
        seen_plugins: set[str] = set()
        for plugins in (profile.pre_filter, profile.filter,
                        profile.post_filter, profile.pre_score,
                        profile.score, profile.reserve, profile.permit):
            for p in plugins:
                if p.name not in seen_plugins:
                    seen_plugins.add(p.name)
                    self.queue.register_plugin(p)
        self.queue.register_hint("victim-drain", (POD_DELETED,),
                                 lambda ev, pod: QUEUE)
        # elastic gangs (scheduler/elastic/): growth members — members of
        # a gang already admitted at >= tpu/gang-min — park under this
        # distinct hint class and wake when capacity frees (a departing
        # pod, a joining node), the same machinery as victim-drain
        self.elastic = getattr(profile, "elastic", None)
        # gang -> (version vector, bound count): growth members re-check
        # their gang's cluster-truth size on EVERY failed cycle, and the
        # O(cluster) pod walk must not be paid per wake — the vector
        # covers binds/unbinds, so a hit is exact
        self._gang_count_memo: dict[str, tuple] = {}
        if self.elastic is not None:
            from .elastic import ELASTIC_GROW_HINT
            from .framework import NODE_ADDED, NODE_TELEMETRY_UPDATED

            # NODE_TELEMETRY_UPDATED rides along because chips also free
            # by RECOVERING (the same event classic gang-permit and the
            # telemetry filter register for): without it a growth member
            # parked behind unhealthy chips waits out its full hinted
            # backoff instead of waking when the slice heals
            self.queue.register_hint(
                ELASTIC_GROW_HINT,
                (POD_DELETED, NODE_ADDED, NODE_TELEMETRY_UPDATED),
                lambda ev, pod: QUEUE)
        # batch scheduling cycles: every distinct plugin (queue sort and
        # binder included) contributes to the scheduling-equivalence key;
        # one NO_BATCH vote makes a pod per-pod-only (framework.Plugin.
        # equivalence_key). The per-key queue index is only built when the
        # knob enables batching at all.
        self._eq_plugins: list = []
        seen_ids: set[int] = set()
        for p in ([profile.queue_sort]
                  + ([profile.bind] if profile.bind is not None else [])):
            if id(p) not in seen_ids:
                seen_ids.add(id(p))
                self._eq_plugins.append(p)
        for plugins in (profile.pre_filter, profile.filter,
                        profile.post_filter, profile.pre_score,
                        profile.score, profile.reserve, profile.permit):
            for p in plugins:
                if id(p) not in seen_ids:
                    seen_ids.add(id(p))
                    self._eq_plugins.append(p)
        # class-level batch-key cache (see _compute_batch_key)
        self._bkey_class_cache: dict = {}
        if self.config.batch_max_pods > 1:
            self.queue.set_batch_key_fn(self._batch_key)
        # cluster events land in the queue's inbox from ANY thread
        # (reflector, binder, test driver); the next pop() routes them
        # through the queueing hints on the engine thread. `wake` lets a
        # serve loop sleep until an event or submission arrives instead
        # of polling.
        self.wake = threading.Event()
        # Intra-replica parallel heads (scheduler/heads.py). head_filter
        # is the queue-segregation predicate: pop/peek skip entries it
        # claims for another head. route_events=False on worker heads
        # keeps N heads from funneling every cluster event into the ONE
        # shared queue N times (memos self-invalidate off the version
        # vector at cycle time, so workers need no event routing — only
        # the wake). Both stay inert (None/True) on a classic engine.
        self.head_filter = None
        self.route_events = True
        # bounded per-head dispatch window: generalizes the one-deep
        # scan prefetch so wire commit overlaps cycle compute beyond
        # depth 1 without letting a slow wire build an unbounded pile of
        # in-flight binds per head. 0 = classic unbounded dispatch.
        self._dispatch_sem = (
            threading.BoundedSemaphore(self.config.head_dispatch_depth)
            if self.config.head_dispatch_depth > 0 else None)
        sub = getattr(cluster, "subscribe", None)
        if sub is not None:
            sub(self.notify_event)
        wc = getattr(cluster.telemetry, "watch_changes", None)
        if wc is not None:
            wc(self._on_telemetry_change)
        self.waiting: dict[str, _WaitingPod] = {}
        self.failed: dict[str, str] = {}  # pod.key -> permanent failure reason
        # pods permanently failed by cycle-level crash containment (a
        # plugin RAISED quarantine_threshold times for them) — a subset
        # of `failed`, kept separately so operators can tell poison pods
        # from ordinary unschedulability. Bounded like doomed_gangs.
        self.quarantined: dict[str, str] = {}
        # apiserver circuit breaker (self-healing): consecutive bind wire
        # failures open it, parking scheduling until the cooldown passes;
        # a post-cooldown probe bind closes it on success. All breaker
        # state is engine-thread-only; binder threads report outcomes in
        # ARRIVAL ORDER through the _bind_results deque, so a success is
        # folded before/after the failures exactly as it happened on the
        # wire (a bare boolean could not order a stale pre-storm success
        # against newer failures, or vice versa).
        self._breaker_failures = 0
        self._breaker_until = 0.0
        self._breaker_cooldown = self.config.breaker_cooldown_s
        # telemetry-blackout degraded mode: previous cycle's regime, so a
        # flip can clear the class memos (staleness verdicts change
        # without any version bump — exactly the invalidation the version
        # vectors cannot see)
        self._degraded = False
        # _commit_batch's current member, for crash attribution when a
        # plugin raises inside the batch commit loop
        self._batch_cursor: QueuedPodInfo | None = None
        # churn-plane fast cycle (config.churn_plane): the resume state a
        # clean fully-bound batch commit leaves behind — (ctx, last bound
        # node, exit version vector). The next same-class batch re-enters
        # _commit_batch directly off it when every guard holds
        # (schedule_batch), skipping the ordinary head cycle.
        self._fast_resume: tuple | None = None
        # poison-vs-systemic discriminator for quarantine: a crash is
        # SYSTEMIC when, since the last crash, no cycle completed
        # cleanly AND the last crash was a DIFFERENT pod — i.e. the
        # engine is crashing across the board (corrupt snapshot input, a
        # bug in shared engine code), in which case permanently failing
        # pods would convert an engine-wide fault into mass data loss.
        # A pod re-crashing its OWN cycles (even back-to-back, with no
        # neighbours left to interleave) stays poison and quarantines.
        self._ok_since_crash = True
        self._last_crash_key: str | None = None
        self.traces = TraceLog()
        # lifecycle span tracing (utils/obs.py): every 1-in-trace_sampling
        # pod gets the full queued/cycle/bind_wire span tree, recorded on
        # THIS engine's clock into a bounded ring and exported as
        # Chrome/Perfetto trace-event JSON (/traces/export, bench.py
        # --trace-out). Appends are GIL-atomic tuple pushes; unsampled
        # pods pay one memoized dict lookup per cycle.
        self.spans = SpanRing()
        # black-box flight recorder: structured engine events (breaker
        # transitions, degraded flips, quarantines, fence aborts, conflict
        # fallbacks) in a bounded ring, auto-dumped to disk when a trip
        # kind fires and a dump dir is configured
        self.flight = FlightRecorder(
            clock=self.clock, dump_dir=self.config.flight_dump_dir or None)
        # policy engine (scheduler/policy/): built plugin-side by
        # default_profile / registry.build_profile; the engine hands it
        # the live surfaces its DRF book and starvation watch read.
        # None (the default) keeps every policy hook out of the cycle.
        self.policy = getattr(profile, "policy", None)
        if self.policy is not None:
            self.policy.attach(self.cluster, self.metrics, self.flight,
                               self.clock)
        # workload-tier admission (scheduler/workload.py): one decision
        # per Workload against the DRF book / quotas / live capacity;
        # pods materialize lazily on admission. None (the default knob)
        # keeps the pod-at-a-time intake bit-identical.
        self.workloads = None
        if self.config.workload_admission:
            from .workload import WorkloadAdmission

            self.workloads = WorkloadAdmission(self)
        if self.elastic is not None:
            self.elastic.attach(self.metrics, self.clock)
        self.rng = random.Random(self.config.rng_seed)
        self._filter_start = 0  # rotating offset for percentageOfNodesToScore
        # node -> ((telemetry generation, pods version), NodeInfo) — see
        # snapshot() for the cross-cycle reuse contract
        self._ni_cache: dict[str, tuple[tuple, NodeInfo]] = {}
        self._known_nodes: set[str] = set()
        # incremental-snapshot state: (Snapshot, cluster gver, telemetry
        # ver, nodes membership ver) from the previous cycle
        self._snap: tuple[Snapshot, int, int, int] | None = None
        # unschedulable-CLASS memo: spec -> (cluster versions, reason). A
        # pod whose identical-spec classmate just failed, with NOTHING
        # changed since (no bind/evict/telemetry/reservation/nomination/
        # membership event), fails in O(1) instead of rescanning every
        # node — the native analogue of upstream kube-scheduler parking
        # unschedulable pods until a relevant cluster event.
        self._unsched_memo: dict = {}
        # feasible-CLASS memo: memo_key -> (cluster versions, feasible
        # node names). The success-path twin of _unsched_memo: a
        # classmate's feasible list is repaired from the change logs
        # (only dirty nodes re-filtered; staleness re-verified per node)
        # instead of rebuilt by a full cluster scan. Gated to per-node-
        # predicate pods only — see the feas_ok gate in
        # _schedule_one_locked and _repair_feasible for the soundness
        # envelope.
        self._feas_memo: dict = {}
        # per-cycle dirty-set memo for _changes_since_vers: in steady
        # state every class memo (feasible, unschedulable, score, slice
        # usage) stores the SAME previous version vector, so one cycle
        # asks for the same (cvers -> now) delta several times — each a
        # walk of three change logs under the cluster lock. Keyed by
        # (cvers, current vector) so a mid-cycle version bump (a Reserve
        # write, a concurrent reflector apply) self-invalidates; cleared
        # each cycle. Returned sets are shared — callers must not mutate.
        self._csv_memo: dict = {}
        # score-CLASS memo: memo_key -> (cluster versions, MaxValue
        # tuple, slice-usage map, scorer names, {plugin: {node: raw}}).
        # Classmate cycles rescore only dirty nodes; see the score
        # section of _schedule_one_locked for the soundness envelope.
        self._score_memo: dict = {}
        # async-bind wire outcomes in ARRIVAL order, appended by binder
        # threads and drained by run_one on the engine thread (the queue
        # is engine-thread-only; deque.append/popleft are GIL-atomic).
        # Entries: None = a wire success (breaker signal only);
        # (info, node, err) = a failure needing recovery.
        self._bind_results: deque = deque()
        # gang -> reason: a member permanently failed during assembly, so
        # the gang can never reach its size with the current incarnations.
        # Parked peers are failed at doom time; peers sitting in backoff
        # fail fast at their next cycle (the park->timeout->requeue loop
        # counts no attempts, so without this they never resolve).
        # ENGINE-THREAD-ONLY dict: submit() (any thread) records revivals
        # in the GIL-atomic deque below and run_one drains it, so a fresh
        # incarnation of the failed member makes the gang viable again
        # without cross-thread mutation of the dict.
        self.doomed_gangs: dict[str, str] = {}
        self._gang_revivals: deque = deque()
        # elastic-gang retirement inbox: POD_DELETED
        # events carrying a gang label land here from any thread; the
        # engine thread drains them in run_one and retires a _growing
        # record whose gang has ZERO bound members left in cluster truth
        # — an externally-deleted mid-growth gang would otherwise
        # survive until backstop eviction and miscount grow/admission
        # metrics when the name is reused.
        self._elastic_retires: deque = deque()
        # columnar data plane (scheduler/columnar.py): parallel-array twin
        # of the object snapshot, maintained from the same change logs.
        # None when numpy is unavailable, the knob is off, or there is no
        # allocator to source free sets from — every consumer then takes
        # the scalar path (its ground truth) unconditionally.
        self._columnar: ColumnarTable | None = (
            ColumnarTable(self.allocator,
                          shards=self.config.columnar_shards)
            if HAVE_NUMPY and self.config.columnar
            and self.allocator is not None else None)
        if self._columnar is not None and self._columnar.shards:
            # sharded membership rebuilds need the change-log delta
            # WITHOUT the membership-version gate _changes_since_vers
            # enforces (that gate exists exactly because per-name logs
            # can't describe joins — the sharded rebuild handles joins
            # itself and only needs the surviving rows' dirt)
            self._columnar.membership_dirty_fn = self._membership_dirty
        if self._columnar is not None:
            # cycle-phase attribution: table sync stamps its wall time
            # into cycle_event_apply_ms (the row-refresh half of event
            # application; the queue-drain half stamps the same series)
            self._columnar.metrics = self.metrics
        # native data plane (scheduler/nativeplane.py): the fused C++
        # kernel running the memo-miss full scan in one GIL-releasing
        # call. Requires the columnar table (it consumes those arrays
        # zero-copy); a missing/stale/unbuildable .so degrades silently
        # to the numpy path — the gauge records which plane is live.
        self._native = None
        # incremental-commit kernels (nativeplane.IncrementalKernels):
        # the batch-commit fold and the post-bind columnar row refresh
        # as single C calls — the "post-bind repair path stops paying
        # numpy per-op overhead" half of the native plane. Gated on the
        # same knob; an older .so degrades just these back to numpy.
        self._incremental = None
        # (tag, FusedResult) from the overlapped scan prefetch, awaiting
        # consume-time validation against the live version vector
        self._prefetched: tuple | None = None
        if self._columnar is not None and self.config.native_plane:
            try:
                from .nativeplane import FusedPlane, IncrementalKernels

                self._native = FusedPlane.load()
                self._incremental = IncrementalKernels.load()
            except Exception:  # pragma: no cover - defensive: a broken
                self._native = None  # ctypes env must not kill the engine
                self._incremental = None
        # native COMMIT plane (nativeplane.CommitKernels, nativeCommit
        # knob): the per-candidate topology packing/blend as one
        # GIL-releasing call, plus the incremental fold/refresh kernels
        # even when the fused scan plane is off — the two knobs compose
        # independently, and each degrades alone on a stale .so.
        self._commitk = None
        if self._columnar is not None and self.config.native_commit:
            try:
                from .nativeplane import CommitKernels, IncrementalKernels

                self._commitk = CommitKernels.load()
                if self._incremental is None:
                    self._incremental = IncrementalKernels.load()
            except Exception:  # pragma: no cover - defensive, as above
                self._commitk = None
        if self._columnar is not None and self._incremental is not None:
            self._columnar.native_refresh = self._incremental
        # churn plane, columnar half: multi-row dirt applied as one
        # batched delta-vector pass, through the eventplane kernel when
        # the .so carries it (a stale .so degrades just this plane to
        # the numpy scatter; knob off keeps the per-row ground truth)
        self._eventk = None
        if self._columnar is not None and self._churn:
            self._columnar.batch_events = True
            try:
                from .nativeplane import EventKernels

                self._eventk = EventKernels.load()
            except Exception:  # pragma: no cover - defensive, as above
                self._eventk = None
            self._columnar.event_kernels = self._eventk
        self.metrics.set_gauge("native_plane_active",
                               1.0 if self._native is not None else 0.0)
        self.metrics.set_gauge("native_commit_active",
                               1.0 if self._commitk is not None else 0.0)
        self.metrics.set_gauge("churn_plane_active",
                               1.0 if self._churn else 0.0)
        self.metrics.set_gauge("event_plane_native",
                               1.0 if self._eventk is not None else 0.0)
        if self.config.native_commit:
            # arm plugins carrying a commit-plane batch form (today:
            # TopologyScore). Armed even when the .so lacks the kernels —
            # the pure-Python half (in-place contribution patch, array
            # usage map) stands on its own.
            for p in list(self.profile.score) + list(self.profile.pre_score):
                hook = getattr(p, "enable_commit_plane", None)
                if hook is not None:
                    hook(self._commitk)
        if self._churn:
            # churn-plane plugin arming (today: TopologyScore's
            # copy-on-write slice-usage views) — pure-Python data-plane
            # amortization, observationally identical outputs
            for p in list(self.profile.score) + list(self.profile.pre_score):
                hook = getattr(p, "enable_churn_plane", None)
                if hook is not None:
                    hook()
        # shared across co-hosted profiles (multi.py) to serialize cycles;
        # private (uncontended) when this engine runs alone
        self.cycle_lock = cycle_lock or threading.RLock()
        # preemption victims re-enter scheduling through this callable.
        # MultiProfileScheduler points it at its schedulerName-routing
        # submit so a victim owned by profile B evicted by profile A's
        # engine lands back in B's queue, not A's; standalone engines
        # default to their own submit (which rejects foreign names).
        self.victim_router = None
        # active defragmentation controller (scheduler/elastic/defrag.py):
        # a closed migration loop on THIS engine's injectable clock,
        # gated per pass on the breaker/degraded interlock and — in a
        # fleet — on shard-0 ownership (FleetCoordinator wires
        # owner_check). None when the knob is off.
        self.defrag = None
        if self.config.defrag_interval_s > 0 and self.allocator is not None:
            from .elastic import DefragController

            self.defrag = DefragController(
                self, self.config.defrag_interval_s,
                max_migrations=self.config.max_migrations_per_pass,
                cooldown_s=self.config.defrag_cooldown_s)
        # closed-loop capacity provisioner (scheduler/capacity/): a
        # control loop on THIS engine's injectable clock scaling node
        # pools up off the pending backlog's recorded shapes and down by
        # drain-and-release — ticked BEFORE the breaker gate (scale-up
        # continues through apiserver storms; its scale-down half gates
        # itself on the breaker/degraded interlocks). None when the
        # knob is off (placements bit-identical). The provider attaches
        # post-construction (attach_provider) — until then every pass
        # no-ops.
        self.provisioner = None
        if self.config.provisioner_interval_s > 0:
            from .capacity import CapacityProvisioner

            self.provisioner = CapacityProvisioner(
                self, self.config.provisioner_interval_s)
        # SLO-guarded colocated serving: the burn-rate
        # monitor measures every serving bind against its scv/slo-ms
        # budget; the guard degrades training toward gang-min under
        # pressure and gives the surplus back in the valleys. Both None
        # when the knob is off — the monitor observes nothing, the
        # cycle carries no SLO hook, placements bit-identical.
        self.slo = None
        self.sloguard = None
        if self.config.slo_serving:
            from ..utils.obs import SloMonitor
            from .elastic import SloGuard

            self.slo = SloMonitor(
                self.metrics, flight=self.flight,
                target_pct=self.config.slo_target_pct,
                burn_threshold=self.config.slo_burn_threshold,
                fast_window_s=self.config.slo_fast_window_s,
                slow_window_s=self.config.slo_slow_window_s)
            if self.config.slo_guard_interval_s > 0:
                self.sloguard = SloGuard(
                    self, self.slo, self.config.slo_guard_interval_s,
                    shrink_budget=self.config.slo_shrink_budget,
                    hysteresis_s=self.config.slo_hysteresis_s)
        # shard-lease fencing (scheduler/fleet.py): when set, called as
        # fence_provider(pod, node) right before every bind dispatch.
        # Returns a fencing token to carry on the bind (owned shard), None
        # for an unfenced optimistic bind (node outside the replica's
        # shards), or FENCE_LOST — the lease vanished mid-cycle — which
        # aborts the commit cleanly through the unwind path. None (the
        # default) skips fencing entirely: standalone engines are the
        # fleet of one.
        self.fence_provider = None

    # ----------------------------------------------------------------- intake
    def submit(self, pod: Pod) -> bool:
        """Accept a pod if it targets this scheduler (spec.schedulerName
        routing, as in kube-scheduler)."""
        if pod.scheduler_name != self.config.scheduler_name:
            return False
        gang = pod.labels.get(GANG_NAME_LABEL)
        if gang:
            # a (re)submitted member can complete the gang again; the
            # engine thread applies the revival (run_one drains this) —
            # and parked siblings in backoff wake on the arrival event
            self._gang_revivals.append(gang)
            self.notify_event(ClusterEvent(GANG_MEMBER_ARRIVED, gang=gang))
        self.queue.add(pod, now=self.clock.time())
        self.metrics.inc("pods_submitted_total")
        self.wake.set()
        return True

    def submit_workload(self, w) -> bool:
        """Accept a Workload into the admission tier (workloadAdmission
        knob on; scheduler/workload.py). Parked cost is O(1) — pods
        exist only after the workload admits."""
        if self.workloads is None \
                or w.scheduler_name != self.config.scheduler_name:
            return False
        self.workloads.submit(w)
        self.metrics.inc("workloads_inbox_total")
        self.wake.set()
        return True

    def withdraw_workload(self, key: str,
                          reason: str = "withdrawn") -> bool:
        """Withdraw a workload by key (external CR deletion, operator
        action): parked ones unpark, admitted ones retire their quota
        claim and materialized members in one pass."""
        if self.workloads is None:
            return False
        self.workloads.withdraw(key, reason)
        self.wake.set()
        return True

    def notify_event(self, event: ClusterEvent) -> None:
        """Accept a cluster event from any thread; the queue routes it
        through its queueing hints at the next pop on the engine thread.
        Intake signals (PodPendingArrived) only wake the serve loop — a
        pending pod's arrival cannot cure a parked pod's rejection, so it
        never enters the hint path."""
        if event.kind != POD_PENDING_ARRIVED and self.route_events:
            self.queue.notify(event)
        if (self.elastic is not None and event.kind == POD_DELETED
                and event.gang):
            # a gang member left the cluster: the engine thread checks
            # whether the whole gang is gone and retires its elastic
            # bookkeeping (run_one drains this deque)
            self._elastic_retires.append(event.gang)
        # churn plane: coalesce redundant wake signals — safe because
        # every serve loop clears the flag BEFORE its next run_one, and
        # run_one drains the inbox this event was appended to above
        if self._churn and self.wake.is_set():
            return
        self.wake.set()

    def _on_telemetry_change(self, node: str, old, new) -> None:
        self.notify_event(ClusterEvent(NODE_TELEMETRY_UPDATED, node=node,
                                       old=old, new=new))

    def tracks(self, pod_key: str) -> bool:
        """Is this pod currently in our hands (queued, backing off, or parked
        at Permit)? Used by the serve loop to avoid duplicate submission."""
        return pod_key in self.waiting or self.queue.contains(pod_key)

    def _num_feasible_to_find(self, num_nodes: int) -> int:
        """kube-scheduler's numFeasibleNodesToFind: all nodes below 100; above
        that, percentageOfNodesToScore (adaptive when 0) with a floor of 100.

        The adaptive default additionally caps candidates at 100 (the
        floor): upstream's formula still scores 42% of a 1000-node
        cluster, and past ~100 candidates the min-max-normalised ranking
        is already saturated. Measured on the 1000-node/5000-pod scale
        bench: cap=150 p50 6585ms vs cap=100 p50 2270ms with
        IDENTICAL placement quality (bound 4046 vs 4060, both runs end
        with zero free chips — capacity-limited, not choice-limited);
        the earlier 150 cap still paid 1.6x the p50 of an explicit
        pct=10 at BENCH_r04's scale. An explicit
        percentage is honoured as given — the cap applies only when the
        operator left the choice to the scheduler."""
        if num_nodes < 100:
            return num_nodes
        pct = self.config.percentage_of_nodes_to_score
        if not pct:
            # min(max(n*adaptive_pct//100, 100), 100) is identically 100
            # whatever the formula yields — the floor and the cap meet.
            # (The formula itself is BELOW 100 for n up to ~204 and above
            # it past that; the constant is the cap + floor, not the
            # formula saturating.)
            return 100
        if pct >= 100:
            return num_nodes
        return max(num_nodes * pct // 100, 100)

    def _sampled(self, pod: Pod) -> bool:
        """Is this pod in the 1-in-trace_sampling span-traced set?
        Memoized on the pod (the decision is a pure function of the key,
        so retries and fleet replicas agree)."""
        s = pod.__dict__.get("_span_sampled")
        if s is None:
            s = span_sampled(pod.key, self.config.trace_sampling)
            pod.__dict__["_span_sampled"] = s
        return s

    @staticmethod
    def _memo_key_of(pod: Pod, spec) -> tuple:
        """Scheduling-CLASS key for the unschedulable/feasible/score memos.
        Every input is fixed at pod creation (labels/selectors are
        immutable while the pod is pending), so retries reuse the key
        built on the first attempt — the tuple/frozenset build was
        measurable across a 5000-pod burst's retry cycles."""
        memo_key = pod.__dict__.get("_memo_key")
        if memo_key is None:
            if (pod.node_selector or pod.tolerations or pod.node_affinity
                    or pod.pod_affinity or pod.pod_anti_affinity
                    or pod.topology_spread or pod.cpu_millis
                    or pod.memory_bytes):
                memo_key = (spec, frozenset(pod.node_selector.items()),
                            tuple((t.get("key", ""),
                                   t.get("operator", "Equal"),
                                   t.get("value", ""), t.get("effect", ""))
                                  for t in pod.tolerations),
                            pod.node_affinity, pod.pod_affinity,
                            pod.pod_anti_affinity, pod.topology_spread,
                            pod.cpu_millis, pod.memory_bytes, pod.namespace)
            else:
                # namespace is part of even the plain class: a bound pod's
                # anti-affinity (symmetry rule) can repel pods of one
                # namespace and not another with identical labels
                memo_key = (spec, pod.namespace)
            pod.__dict__["_memo_key"] = memo_key
        return memo_key

    # ------------------------------------------------------ batch cycles
    def _batch_key(self, pod: Pod):
        """Scheduling-equivalence key for batch cycles (None = this pod
        always takes the per-pod cycle). Two pods with equal keys are
        interchangeable for one scheduling pass: same memo class (resource
        shape, selectors, tolerations, namespace, priority — all inside
        the WorkloadSpec/memo key) and identical per-plugin equivalence
        contributions. Gang members, exact-topology requests, and pods
        with inter-pod terms / spread / hostPorts never batch — their
        cycles carry state outside the key. Memoised per pod: every input
        is fixed at creation, like the memo key."""
        got = pod.__dict__.get("_batch_key", _BKEY_MISS)
        if got is not _BKEY_MISS:
            return got
        key = self._compute_batch_key(pod)
        pod.__dict__["_batch_key"] = key
        return key

    def _compute_batch_key(self, pod: Pod):
        try:
            spec = spec_for(pod)
        except LabelError:
            return None
        if spec.is_gang or spec.topology is not None:
            return None
        if (pod.pod_affinity or pod.pod_anti_affinity
                or pod.topology_spread or pod.host_ports):
            return None
        memo_key = self._memo_key_of(pod, spec)
        # class-level key cache: every equivalence contribution is a
        # function of the pod's scheduling CLASS (the framework audit —
        # "two pods with equal keys are interchangeable" — is exactly
        # what makes them class-determined). The memo key carries the
        # class (spec, selectors, tolerations, affinities, resources,
        # namespace); tenancy rides along explicitly because the DRF
        # sort keys on the scv/tenant label, which the memo key omits.
        # A 25k-pod burst of four classes was paying 25k full plugin
        # walks for four distinct answers.
        cls_key = (memo_key, pod.labels.get("scv/tenant"))
        hit = self._bkey_class_cache.get(cls_key)
        if hit is not None:
            return hit
        parts = []
        for p in self._eq_plugins:
            eq = getattr(p, "equivalence_key", None)
            # duck-typed plugins without the Plugin base (reference
            # emulation) never audited interchangeability: NO_BATCH
            k = eq(pod) if eq is not None else NO_BATCH
            if k is NO_BATCH:
                return None
            if k != ():
                parts.append((getattr(p, "name", type(p).__name__), k))
        out = (memo_key, tuple(parts))
        if len(self._bkey_class_cache) > 4096:
            self._bkey_class_cache.clear()
        self._bkey_class_cache[cls_key] = out
        return out

    def _cluster_versions(self) -> tuple | None:
        """Version vector over everything a filter verdict can depend on:
        bound pods, telemetry, node membership, reservations+nominations.
        None when the backend doesn't expose the counters."""
        pg = getattr(self.cluster, "pods_global_version", None)
        if pg is None:
            return None
        return (pg,
                self.cluster.telemetry.resource_version,
                getattr(self.cluster, "nodes_version", 0),
                self.allocator.version if self.allocator is not None else 0)

    def _changes_since_vers(self, cvers):
        """Node names changed since version vector `cvers` (the
        _cluster_versions tuple): (current vector, dirty set | None).
        None when membership changed, a log was trimmed, or the allocator
        recorded a change whose node set is unknowable ("*") — callers
        must rebuild from scratch. Exposed to plugins through the cycle
        state as ``changes_since_fn`` so per-cycle aggregations (slice
        usage, feasible lists) can repair instead of rescanning."""
        vers, dirty, _ = self._changes_since_directed(cvers)
        return vers, dirty

    def _changes_since_directed(self, cvers):
        """(current vector, dirty | None, grew | None): like
        _changes_since_vers plus the GREW subset — names with at least
        one capacity-releasing (or direction-unknown) change. A name only
        in dirty was touched exclusively by binds/claims, which within
        the memo path's per-node-predicate envelope cannot flip it
        infeasible -> feasible (changelog docstring). Backends without
        direction support contribute their whole dirty set to grew
        (conservative)."""
        vers = self._cluster_versions()
        if vers is None or cvers is None or vers[2] != cvers[2]:
            return vers, None, None
        key = (cvers, vers)
        hit = self._csv_memo.get(key)
        if hit is not None:
            return vers, hit[0], hit[1]
        csince = getattr(self.cluster, "changes_since", None)
        tsince = getattr(self.cluster.telemetry, "changes_since", None)
        if csince is None or tsince is None or self.allocator is None:
            return vers, None, None
        # per-log short-circuit: an unchanged version counter means an
        # empty delta — skip the locked log walk (the commit loop asks
        # after every bind, when typically only two of the three logs
        # moved; the counter reads are GIL-atomic ints)
        if vers[0] == cvers[0]:
            pdirty = pgrew = _EMPTY_SET
        else:
            cdir = getattr(self.cluster, "changes_since_directed", None)
            if cdir is not None:
                _, pdirty, pgrew = cdir(cvers[0])
            else:
                _, pdirty = csince(cvers[0])
                pgrew = pdirty
        if vers[1] == cvers[1]:
            tdirty = _EMPTY_SET
        else:
            _, tdirty = tsince(cvers[1])
        if vers[3] == cvers[3]:
            adirty = agrew = _EMPTY_SET
        else:
            _, adirty, agrew = self.allocator.changes_since_directed(
                cvers[3])
        if (pdirty is None or tdirty is None or adirty is None
                or "*" in adirty):
            dirty = grew = None
        else:
            dirty = pdirty | tdirty | adirty
            # telemetry updates are direction-unknown: all grew
            grew = pgrew | tdirty | agrew
        self._csv_memo[key] = (dirty, grew)
        return vers, dirty, grew

    def _membership_dirty(self, cvers):
        """Dirty node names since `cvers` IGNORING membership movement —
        the sharded columnar rebuild's input (columnar.py): a surviving
        row absent from this set is provably unchanged and block-copies.
        None when any log was trimmed or the allocator recorded an
        unattributable change (the caller then rebuilds in full)."""
        if cvers is None or self.allocator is None:
            return None
        csince = getattr(self.cluster, "changes_since", None)
        tsince = getattr(self.cluster.telemetry, "changes_since", None)
        if csince is None or tsince is None:
            return None
        _, pdirty = csince(cvers[0])
        _, tdirty = tsince(cvers[1])
        _, adirty, _ = self.allocator.changes_since_directed(cvers[3])
        if pdirty is None or tdirty is None or adirty is None \
                or "*" in adirty:
            return None
        return pdirty | tdirty | adirty

    @staticmethod
    def _feas_entry(vers, feasible):
        """Feasible-class memo record: (version vector, NodeInfo tuple,
        name frozenset, name -> position index). The set and index let
        _repair_feasible patch the cached list in O(|dirty|) instead of
        walking every entry."""
        names = tuple(n.name for n in feasible)
        return (vers, tuple(feasible), frozenset(names),
                {n: i for i, n in enumerate(names)})

    def _repair_feasible(self, hit, vers, now, state, pod, snapshot,
                         filters, want):
        """Rebuild a classmate's feasible list by re-filtering ONLY the
        nodes the change logs attribute a change to since the list was
        built. Returns None (caller falls back to the full scan) when:

        - node membership changed (per-name logs can't describe joins),
        - any change log was trimmed past the cached version,
        - the allocator log carries "*" (a gang slice entitlement touched
          an unknowable node set),
        - the repaired list is empty (the preemption path needs real
          per-node verdicts, which only the full scan records).

        Staleness is the one verdict input that moves with TIME rather
        than with any version counter (a node whose sniffer died changes
        no log), so it is re-verified here for every unchanged node — an
        O(1) comparison, unlike the full predicate chain. The re-check
        applies only when an active filter advertises `time_dependent`
        (TelemetryFilter does): a profile with no staleness gate
        (reference emulation) must get repaired lists its own full scan
        would produce, not ours.

        Unchanged nodes the original early-exit scan never checked stay
        unchecked — the class keeps scoring the same candidate set until
        one of its nodes changes, which the rotating full-scan start then
        re-diversifies."""
        cvers, cached, cached_names, cached_index = hit
        _, dirty, grew = self._changes_since_directed(cvers)
        if dirty is None:
            return None
        max_age = self.config.telemetry_max_age_s
        # degraded (blackout) mode waives the staleness gate wholesale,
        # so repaired lists must not re-impose it per node
        check_stale = (not state.read_or("degraded")
                       and any(getattr(p, "time_dependent", False)
                               for p in filters))
        if check_stale:
            # O(1) short-circuit: when even the OLDEST stored heartbeat is
            # fresh, no node can be stale — skip the per-name re-checks
            # (the floor is conservative; see TelemetryStore.heartbeat_floor)
            floor_fn = getattr(self.cluster.telemetry, "heartbeat_floor",
                               None)
            if floor_fn is not None:
                floor = floor_fn()
                if floor is not None and (now - floor) <= max_age:
                    check_stale = False
        # the memo holds NodeInfo objects, not names: when `dirty` is
        # attributable every unchanged node's cached info is content-valid
        # (membership changes force dirty=None above), so the common path
        # touches no snapshot lookup at all — only dirty names re-resolve.
        # The hot path (no staleness gate) copies the cached list and
        # deletes the few dirty positions via the stored index — walking
        # all `want` entries per cycle was a measurable slice of
        # bind-cycle cost in the 1000-node drain. Dirty nodes that still
        # pass re-enter at the END (same as the original walk), which the
        # score tie-break order depends on — an in-place variant measured
        # 34 fewer binds at the 1000-node tier.
        if not check_stale:
            repaired = list(cached)
            bad = dirty & cached_names
            if bad:
                for i in sorted((cached_index[n] for n in bad),
                                reverse=True):
                    del repaired[i]  # re-checked below, appended if ok
            # gap-fill candidates: the whole dirty set. Restricting to
            # GREW-dirtied nodes here is tempting but wrong-in-effect:
            # a cached list below `want` means the original early-exit
            # scan never checked some nodes, and a shrink-dirtied
            # UNCHECKED node may be feasible all along — skipping it
            # measurably shrank exploration (53 fewer binds at the
            # 1000-node tier). _repair_unsched CAN restrict to grew:
            # there the failing scan verified every node infeasible.
            fill = dirty
        else:
            repaired = []
            for node in cached:
                if node.name in dirty:
                    continue  # re-checked below so ordering is stable-ish
                if (node.metrics is None
                        or node.metrics.stale(now=now, max_age_s=max_age)):
                    continue
                repaired.append(node)
            fill = dirty
        # dirty-node verdicts: via the columnar table's subset masks when
        # every active filter vectorizes for this pod (the same booleans
        # the scalar chain yields — repair never reads the messages), the
        # per-node plugin chain otherwise. Thresholded: for a couple of
        # bind-dirtied names the scalar chain beats the table's sync +
        # gather overhead; the mask pays off on the big dirty sets event
        # storms and diverse-class drains produce.
        fill_names = sorted(fill)
        verdicts = (self._columnar_subset_ok(state, pod, snapshot, vers,
                                             filters, fill_names)
                    if len(fill_names) >= 6 and self._columnar is not None
                    else None)
        for name in fill_names:
            if len(repaired) >= want:
                # identical to filtering everything then truncating
                # [:want]: any further passer would land past `want` and
                # be cut — so don't pay its predicate chain at all (the
                # dirty set holds every OTHER class's latest bound nodes
                # too, and re-filtering them was most of repair cost)
                break
            node = snapshot.get(name)
            if node is None:
                continue
            if verdicts is not None:
                if verdicts.get(name):
                    repaired.append(node)
                continue
            st = Status.success()
            for p in filters:
                st = p.filter(state, pod, node)
                if not st.ok:
                    break
            if st.ok:
                repaired.append(node)
            elif st.code == Code.ERROR:
                return None  # surface errors via the full scan
        if not repaired:
            return None
        return repaired[:want]

    def _repair_unsched(self, hit, state, pod, snapshot, filters, trace):
        """The failure-path twin of _repair_feasible: bridge a classmate's
        no-feasible-node verdict to the current version vector by
        re-filtering ONLY the dirty nodes. A failing scan checked EVERY
        node, and under the feas_ok gate no predicate flips
        infeasible->feasible without a recorded change (staleness only
        moves the other way), so clean nodes stay infeasible by
        construction. Returns None when the change logs cannot attribute
        the delta (caller runs the full scan), else
        (passing NodeInfos, extra rejector plugin names, dirty names).

        Only GREW-dirtied nodes are re-filtered: a node touched solely by
        binds/claims cannot have become feasible under the envelope above.
        The returned dirty set stays FULL — the caller's restricted
        preemption re-plan needs shrink-dirtied nodes too (a fresh
        lower-priority bind is exactly what creates a victim)."""
        _, dirty, grew = self._changes_since_directed(hit[0])
        if dirty is None:
            return None
        passing = []
        rejectors: set[str] = set()
        for name in sorted(grew):
            node = snapshot.get(name)
            if node is None:
                continue
            st = Status.success()
            rej = None
            for p in filters:
                st = p.filter(state, pod, node)
                if not st.ok:
                    rej = p.name
                    break
            trace.filter_verdicts[name] = "ok" if st.ok else st.message
            if st.code == Code.ERROR:
                return None  # surface errors via the full scan
            if st.ok:
                passing.append(node)
            elif rej is not None:
                rejectors.add(rej)
        return passing, rejectors, dirty

    def _columnar_subset_ok(self, state, pod, snapshot, vers, filters,
                            names):
        """Combined filter verdicts for a SUBSET of nodes via the
        columnar table's row-aligned masks: {name: bool}, or None when
        the table can't serve this pod (unversioned backend, a
        non-vectorizable plugin, names outside the table). Serves the
        class-memo repair paths, whose gap-fill re-filters a handful of
        dirty nodes per cycle — the verdicts are the same booleans the
        scalar chain would produce (parity-fuzzed), minus the message
        strings the repair paths never read."""
        table = self._columnar
        if table is None or vers is None:
            return None
        if not table.sync(snapshot, vers, self._changes_since_vers):
            return None
        idx = table.index
        rows = []
        known = []
        for n in names:
            i = idx.get(n)
            if i is not None:
                rows.append(i)
                known.append(n)
        if not rows:
            return {}
        rows = np.asarray(rows, dtype=np.int64)
        ok = None
        for p in filters:
            fb = getattr(p, "filter_batch", None)
            bm = fb(state, pod, table, rows) if fb is not None else None
            if bm is None:
                return None
            ok = bm if ok is None else (ok & bm)
        if ok is None:
            return dict.fromkeys(known, True)
        return dict(zip(known, ok.tolist()))

    def _columnar_filter(self, state, pod, filters, snapshot, vers, nodes,
                         want, trace):
        """Vectorized full-scan filter: every active plugin contributes a
        boolean row mask (filter_batch), the masks AND together, and the
        rotating-offset early-stop scan is replayed over the combined
        mask by index — the SAME candidates, in the same order, as the
        per-node scalar scan would produce. Returns the feasible list, or
        None when any plugin/pod can't vectorize OR no node passed: the
        zero-pass case falls back to the scalar scan untouched (it owns
        the per-node failure diagnostics the preemption planner and the
        unschedulable-class memo need), with _filter_start deliberately
        left unadvanced so the fallback scan starts where this one did."""
        table = self._columnar
        if not table.sync(snapshot, vers, self._changes_since_vers):
            return None
        if len(table) != len(nodes):
            return None
        allmask = None
        for p in filters:
            fb = getattr(p, "filter_batch", None)
            bm = fb(state, pod, table) if fb is not None else None
            if bm is None:
                return None
            allmask = bm if allmask is None else (allmask & bm)
        if allmask is None:  # no active filters: everything passes
            allmask = table.new_true()
        n = len(nodes)
        start = self._filter_start % n
        order = (np.arange(n) if not start else
                 np.concatenate((np.arange(start, n), np.arange(start))))
        pass_pos = np.flatnonzero(allmask[order])
        if pass_pos.size == 0:
            return None
        if pass_pos.size >= want:
            checked = int(pass_pos[want - 1]) + 1
            sel = order[pass_pos[:want]]
        else:
            checked = n
            sel = order[pass_pos]
        self._filter_start = (start + checked) % n
        feasible = [nodes[i] for i in sel.tolist()]
        for ni in feasible:
            trace.filter_verdicts[ni.name] = "ok"
        self.metrics.inc("columnar_filter_cycles_total")
        return feasible

    # ----------------------------------------------------------- native plane
    def _native_args(self, state, pod, spec, filters, snapshot, vers,
                     nodes, want, degraded):
        """Assemble one fused-kernel request from the plugins' native
        capability hooks. Returns (req, sel_by_class, tel_plugin,
        frag_plugin, scorers, all_native), or None when any active
        filter vetoes — the pod then takes the numpy columnar path.
        Shared by the in-cycle scan and the prefetch dispatcher, so a
        consumed prefetch is built from EXACTLY the args the cycle
        would have built (version-vector equality pins the rest)."""
        table = self._columnar
        if not table.sync(snapshot, vers, self._changes_since_vers):
            return None
        if len(table) != len(nodes):
            return None
        now = state.read_or("now")
        req = {
            "degraded": 1 if degraded else 0,
            "now": float(now if now is not None else time.time()),
            "chips": int(spec.chips),
            "min_free_mb": int(spec.min_free_mb),
            "min_clock_mhz": int(spec.min_clock_mhz),
            "start": self._filter_start % len(nodes),
            "want": int(want),
        }
        sel = None
        for p in filters:
            hook = getattr(p, "native_filter_args", None)
            a = hook(state, pod, table) if hook is not None else None
            if a is None:
                return None
            s = a.pop("sel_by_class", None)
            if s is not None:
                sel = s
            req.update(a)
        scorers = self._gated_scorers(pod, snapshot, degraded)
        # kernel telemetry scoring divides by the kernel's own MaxValue
        # fold, which stands in for MaxCollection's pre_score — a
        # profile without a native_install-capable prescore plugin keeps
        # telemetry scoring on the Python path (whatever writes MAX_KEY
        # there owns the maxima)
        has_installer = any(
            getattr(p, "native_install", None) is not None
            for p in self.profile.pre_score)
        tel_p = frag_p = None
        for p in scorers:
            hook = getattr(p, "native_score_args", None)
            a = hook(state, pod, table) if hook is not None else None
            if a is None:
                continue  # Python-fold scorer (topology, admission)
            kind = a.pop("kind", None)
            if kind == "telemetry" and tel_p is None and has_installer:
                tel_p = p
                req.update(a)
                req["tel_score"] = 1
            elif kind == "fragmentation" and frag_p is None:
                frag_p = p
                req.update(a)
                req["frag_score"] = 1
        # the kernel's fused normalize+weighted sum folds tel then frag;
        # it may stand in for _fold_scores only when the gated scorer
        # set is exactly those plugins IN THAT ORDER (float addition is
        # order-sensitive; mixed cycles fold in Python instead)
        native = [p for p in (tel_p, frag_p) if p is not None]
        req["compute_totals"] = 1 if scorers == native else 0
        return req, sel, tel_p, frag_p, scorers, scorers == native

    def _native_scan(self, state, pod, spec, filters, snapshot, vers,
                     nodes, want, degraded):
        """One fused native cycle: consume a validated prefetch or run
        the kernel inline. Returns a _NativeCycle, _NATIVE_EMPTY (zero
        feasible — final), or None (veto/failure: numpy path next)."""
        args = self._native_args(state, pod, spec, filters, snapshot,
                                 vers, nodes, want, degraded)
        if args is None:
            self.metrics.inc("native_fallbacks_total")
            return None
        req, sel, tel_p, frag_p, scorers, all_native = args
        res = None
        pf = self._prefetched
        if pf is not None:
            tag, pres = pf
            self._prefetched = None
            # consume-time validation: same pod object, same version
            # vector (⇒ same snapshot, table, spec-derived args), same
            # scan window and regime, and no heartbeat aged past the
            # staleness gate since dispatch. ANYTHING else → discard and
            # count, exactly like the batch-conflict fallback.
            if (pres is not None and tag[0] is pod and tag[1] == vers
                    and tag[2] == req["start"] and tag[3] == want
                    and tag[4] == bool(degraded) and tag[5] == len(nodes)
                    and self._prefetch_fresh(req)):
                res = pres
                self.metrics.inc("prefetch_hits_total")
            else:
                self.metrics.inc("prefetch_stale_total")
        if res is None:
            res = self._native.run(self._columnar, req, sel_by_class=sel)
        if res is None:
            self.metrics.inc("native_fallbacks_total")
            return None
        self.metrics.inc("native_scans_total")
        if res.found == 0:
            return _NATIVE_EMPTY
        feasible = [nodes[i] for i in res.rows]
        names = [ni.name for ni in feasible]
        nc = _NativeCycle()
        nc.feasible = feasible
        nc.names_set = frozenset(names)
        nc.checked = res.checked
        nc.mv6 = res.mv6
        nc.contribs = {
            name: (tuple(res.contrib[k]) if res.qcount[k] else None)
            for k, name in enumerate(names)}
        raws = {}
        if tel_p is not None:
            raws[tel_p.name] = dict(zip(names, res.tel))
        if frag_p is not None:
            raws[frag_p.name] = dict(zip(names, res.frag))
        nc.raws = raws
        nc.totals = dict(zip(names, res.totals)) if all_native else None
        nc.scorers = scorers
        return nc

    def _prefetch_fresh(self, req: dict) -> bool:
        """May a prefetched mask stand in for a fresh scan, staleness-
        wise? Age only grows, so a node stale at DISPATCH is still stale
        now — the one divergence is a node whose heartbeat aged past the
        gate BETWEEN dispatch and consume. When even the oldest stored
        heartbeat is fresh at consume time, no such node exists."""
        if not req.get("tel_filter") or req.get("degraded"):
            return True
        floor_fn = getattr(self.cluster.telemetry, "heartbeat_floor", None)
        if floor_fn is None:
            return False
        floor = floor_fn()
        return floor is None or (req["now"] - floor) <= req["max_age"]

    def _dispatch_prefetch(self) -> None:
        """Overlapped scan prefetch (run_one, after each cycle): while
        the finished cycle's bind is still on the wire — and reflector
        threads ingest — the worker runs the NEXT queue head's memo-miss
        fused scan against the snapshot version just produced. The scan
        releases the GIL, so this costs the engine thread nothing but
        the dispatch bookkeeping; _native_scan validates the result by
        version vector at consume time. Only memo-MISS heads are worth
        prefetching: a class with a live feasible/unschedulable memo
        entry repairs in O(dirty) anyway."""
        plane = self._native
        if plane.inflight:
            return
        if self._prefetched is not None:
            # the cycle that just finished never reached the consume
            # point (memo hit, veto, gang/nominated pod, different head):
            # the banked result's tag can no longer match a future cycle
            # once this cycle moved the version vector — discard it now
            # so its buffers unpin and prefetching resumes, and count it
            # like any other stale result
            self._prefetched = None
            self.metrics.inc("prefetch_stale_total")
        now = self.clock.time()
        if now < self._breaker_until:
            return
        info = self.queue.peek(now, exclude=self.head_filter)
        if info is None:
            return
        pod = info.pod
        try:
            spec = spec_for(pod)
        except LabelError:
            return
        if spec.is_gang:
            return
        if self.allocator is not None \
                and self.allocator.nomination_of(pod.key) is not None:
            return
        memo_key = self._memo_key_of(pod, spec)
        if memo_key in self._feas_memo or memo_key in self._unsched_memo:
            return
        vers = self._cluster_versions()
        if vers is None:
            return
        snapshot = self.snapshot()
        nodes = snapshot.list()
        if not nodes:
            return
        degraded = self._detect_degraded(now)
        state = CycleState()
        state.write("now", now)
        state.write("workload_spec", spec)
        state.write("snapshot", snapshot)
        state.write("cycle_versions", vers)
        if degraded:
            state.write("degraded", True)
        filters = [p for p in self.profile.filter
                   if getattr(p, "relevant", None) is None
                   or p.relevant(pod, snapshot)]
        want = self._num_feasible_to_find(len(nodes))
        args = self._native_args(state, pod, spec, filters, snapshot,
                                 vers, nodes, want, degraded)
        if args is None:
            return
        req, sel = args[0], args[1]
        tag = (pod, vers, req["start"], want, bool(degraded), len(nodes))
        plane.prefetch_submit(tag, self._columnar, req, sel_by_class=sel)
        self.metrics.inc("prefetch_dispatched_total")

    # --------------------------------------------------------------- snapshot
    def snapshot(self) -> Snapshot:
        """Per-cycle view. Incremental: backends exposing change logs
        (changes_since on the cluster and telemetry store, plus a node
        membership version) let a cycle rebuild ONLY the nodes that
        changed since the previous cycle — a bind touches one node, so at
        1000 nodes the per-cycle cost is O(dirty), not O(cluster). Node
        membership changes or an out-of-range log fall back to the full
        walk, which itself reuses per-node NodeInfos via _ni_cache."""
        cluster = self.cluster
        csince = getattr(cluster, "changes_since", None)
        tsince = getattr(cluster.telemetry, "changes_since", None)
        nver = getattr(cluster, "nodes_version", None)
        if csince is not None and tsince is not None and self._snap is not None:
            snap, pv0, tv0, nv0 = self._snap
            if nver == nv0:  # membership unchanged
                pv, pdirty = csince(pv0)
                tv, tdirty = tsince(tv0)
                if pdirty is not None and tdirty is not None:
                    dirty = pdirty | tdirty
                    if not dirty:
                        self._snap = (snap, pv, tv, nv0)
                        return snap
                    # SHARED dict, mutated in place: the superseded
                    # snapshot is never read for pre-mutation content
                    # after this cycle starts (memo_ok's `prev` checks run
                    # before snapshot()), and copying 1000 entries per
                    # cycle was a measurable slice of the drain at scale.
                    # The fresh Snapshot wrapper still gets its own
                    # identity + lazily-recomputed list()/flags.
                    infos = snap._node_infos
                    pods_version = getattr(cluster, "pods_version", None)
                    # pre-mutation fact needed below: did any dirty node
                    # flip unschedulable True -> False? Must be captured
                    # BEFORE infos[name] is overwritten (the dict is
                    # shared, so reading it after would see the NEW info)
                    uncordoned = False
                    if snap._any_unsched:
                        uncordoned = any(
                            n in infos and infos[n].unschedulable
                            for n in dirty)
                    for name in dirty:
                        if name not in infos:
                            continue  # telemetry for a non-member node
                        ni = self._make_node_info(name)
                        infos[name] = ni
                        if pods_version is not None:
                            key = (getattr(ni.metrics, "generation", None),
                                   pods_version(name))
                            self._ni_cache[name] = (key, ni)
                    # membership version unchanged here, so budgets and
                    # namespace labels are too
                    fresh = Snapshot(infos, budgets=snap.budgets,
                                     namespaces=snap._namespaces)
                    # carry the any-taints / any-anti-affinity facts: only
                    # dirty nodes can have introduced one (a removal leaves
                    # the conservative True, costing nothing but the
                    # skipped optimization)
                    if snap._any_taints is not None:
                        fresh._any_taints = snap._any_taints or any(
                            infos[n].taints for n in dirty if n in infos)
                    if snap._any_pod_anti is not None:
                        fresh._any_pod_anti = snap._any_pod_anti or any(
                            p.pod_anti_affinity
                            for n in dirty if n in infos
                            for p in infos[n].pods)
                    if snap._any_alloc is not None:
                        fresh._any_alloc = snap._any_alloc or any(
                            infos[n].allocatable is not None
                            for n in dirty if n in infos)
                    if snap._any_pref_pod is not None:
                        fresh._any_pref_pod = snap._any_pref_pod or any(
                            p.preferred_pod_affinity
                            for n in dirty if n in infos
                            for p in infos[n].pods)
                    if snap._any_unsched is not None:
                        if uncordoned:
                            # a dirty node WAS unschedulable before this
                            # rebuild (captured pre-mutation above): it
                            # may just have been uncordoned — recompute
                            # exactly (an uncordon of the LAST cordoned
                            # node must drop the admission filter out of
                            # the hot path, not pin it there until the
                            # next full snapshot). O(nodes), but only on
                            # cycles that touched a cordoned node. This
                            # is what makes NodeSpecChanged requeue hints
                            # worth taking: the woken pod's retry runs
                            # against the cheap path again.
                            fresh._any_unsched = any(
                                ni.unschedulable for ni in infos.values())
                        else:
                            fresh._any_unsched = snap._any_unsched or any(
                                infos[n].unschedulable
                                for n in dirty if n in infos)
                    self._snap = (fresh, pv, tv, nv0)
                    return fresh
        return self._full_snapshot()

    def _snapshot_one_dirty(self, name: str, prev_vers, vers
                            ) -> "Snapshot | None":
        """Commit-loop snapshot: the caller has PROVEN — change-log
        attribution against `prev_vers` — that `name` is the only node
        changed since the cached snapshot and membership is unchanged.
        Rebuild that one NodeInfo and re-wrap: exactly what snapshot()
        would produce with dirty == {name}, minus its re-walk of the
        change logs the caller already performed. None = the cached
        snapshot isn't at `prev_vers` (caller uses the generic path)."""
        if self._snap is None or prev_vers is None:
            return None
        snap, pv0, tv0, nv0 = self._snap
        if (pv0 != prev_vers[0] or tv0 != prev_vers[1]
                or nv0 != prev_vers[2] or nv0 != vers[2]):
            return None
        infos = snap._node_infos
        old = infos.get(name)
        if old is None:
            return None
        uncordoned = bool(snap._any_unsched) and old.unschedulable
        ni = self._make_node_info(name)
        infos[name] = ni
        pods_version = getattr(self.cluster, "pods_version", None)
        if pods_version is not None:
            self._ni_cache[name] = (
                (getattr(ni.metrics, "generation", None),
                 pods_version(name)), ni)
        fresh = Snapshot(infos, budgets=snap.budgets,
                         namespaces=snap._namespaces)
        # flag carries: the generic path's any(...) over dirty, unrolled
        # for the single node (it reads the post-rebuild info, as here)
        if snap._any_taints is not None:
            fresh._any_taints = snap._any_taints or bool(ni.taints)
        if snap._any_pod_anti is not None:
            fresh._any_pod_anti = snap._any_pod_anti or any(
                p.pod_anti_affinity for p in ni.pods)
        if snap._any_alloc is not None:
            fresh._any_alloc = (snap._any_alloc
                                or ni.allocatable is not None)
        if snap._any_pref_pod is not None:
            fresh._any_pref_pod = snap._any_pref_pod or any(
                p.preferred_pod_affinity for p in ni.pods)
        if snap._any_unsched is not None:
            if uncordoned:
                fresh._any_unsched = any(
                    x.unschedulable for x in infos.values())
            else:
                fresh._any_unsched = snap._any_unsched or ni.unschedulable
        self._snap = (fresh, vers[0], vers[1], nv0)
        return fresh

    def _make_node_info(self, name: str, metrics=_UNSET) -> NodeInfo:
        """One coherent NodeInfo: telemetry + bound pods + node-object meta
        (labels/taints for the admission plugin; backends without node
        metadata — plain fakes — yield empty meta). Callers that already
        fetched the node's telemetry (cache-key computation) pass it in to
        avoid a second store lookup per node."""
        cluster = self.cluster
        meta_fn = getattr(cluster, "node_meta", None)
        labels, taints = meta_fn(name) if meta_fn is not None else ({}, ())
        alloc_fn = getattr(cluster, "node_allocatable", None)
        unsched_fn = getattr(cluster, "node_unschedulable", None)
        if metrics is _UNSET:
            metrics = cluster.telemetry.get(name)
        return NodeInfo(name=name, metrics=metrics,
                        pods=cluster.pods_on(name), labels=labels,
                        taints=taints,
                        allocatable=alloc_fn(name)
                        if alloc_fn is not None else None,
                        unschedulable=bool(unsched_fn(name))
                        if unsched_fn is not None else False)

    def _full_snapshot(self) -> Snapshot:
        cluster = self.cluster
        # sample the version vector BEFORE reading any node data: a
        # concurrent mutation during the walk then just re-flags its node
        # dirty next cycle. Sampling after would absorb the event — the
        # stored version covers a change the snapshot never saw, and
        # changes_since would never report it again.
        csince = getattr(cluster, "changes_since", None)
        tsince = getattr(cluster.telemetry, "changes_since", None)
        pre = None
        if csince is not None and tsince is not None:
            pre = (csince(1 << 62)[0], tsince(1 << 62)[0],
                   getattr(cluster, "nodes_version", 0))
        pods_version = getattr(cluster, "pods_version", None)
        infos: dict[str, NodeInfo] = {}
        names = cluster.node_names()
        for name in names:
            metrics = cluster.telemetry.get(name)
            if pods_version is not None:
                key = (getattr(metrics, "generation", None), pods_version(name))
                cached = self._ni_cache.get(name)
                if cached is not None and cached[0] == key:
                    infos[name] = cached[1]
                    continue
                ni = self._make_node_info(name, metrics)
                self._ni_cache[name] = (key, ni)
            else:
                ni = self._make_node_info(name, metrics)
            infos[name] = ni
        # prune per-node caches for departed nodes on EVERY backend — the
        # allocator's free-set cache fills from free_coords() regardless of
        # whether this backend supports NodeInfo reuse
        gone = self._known_nodes - set(infos)
        if gone:
            for n in gone:
                self._ni_cache.pop(n, None)
            if self.allocator is not None:
                self.allocator.forget_nodes(gone)
            # plugin-local per-node caches (filter verdicts, score terms)
            # prune through the same hook
            for plugins in (self.profile.filter, self.profile.pre_score,
                            self.profile.score):
                for p in plugins:
                    forget = getattr(p, "forget_nodes", None)
                    if forget is not None:
                        forget(gone)
        self._known_nodes = set(infos)
        budgets_fn = getattr(cluster, "disruption_budgets", None)
        ns_fn = getattr(cluster, "namespace_labels_map", None)
        snap = Snapshot(infos,
                        budgets=budgets_fn() if budgets_fn is not None else (),
                        namespaces=ns_fn() if ns_fn is not None else None)
        if pre is not None:
            self._snap = (snap, pre[0], pre[1], pre[2])
        return snap

    # ------------------------------------------------------------- the cycle
    def schedule_one(self, info: QueuedPodInfo) -> str:
        """One pod's cycle. Serialized via cycle_lock: a cycle snapshots the
        cluster, then reserves/binds against that snapshot — a concurrent
        bind from a co-hosted profile's engine between the two would
        double-book chips (upstream kube-scheduler likewise runs ONE
        scheduleOne loop across all profiles)."""
        with self.cycle_lock:
            try:
                return self._schedule_one_locked(info)
            except Exception as e:
                # cycle-level exception containment: a raising plugin
                # fails the POD, never the engine thread
                return self._contain_crash(info, e)

    def schedule_batch(self, infos: list[QueuedPodInfo]) -> str:
        """One shared scheduling cycle over an equivalence-class batch
        (queue.pop_batch). The FIRST pod runs the ordinary per-pod cycle —
        full semantics, and it arms the commit context only when that
        cycle stayed inside the class-memo soundness envelope. On a bound
        outcome the remaining classmates commit greedily against its
        candidate ranking with incremental claim/score/maxima updates
        (_commit_batch); every member the incremental path cannot place
        EXACTLY as a per-pod cycle would — a concurrent event moved the
        version vector, candidates exhausted, the cluster maxima shifted —
        falls back to the ordinary per-pod cycle inline, right here, so
        no pod is ever lost or reordered behind the rest of the queue.

        Churn-plane fast cycle (config.churn_plane): when the PREVIOUS
        same-class batch's commit ran clean end to end, its context is
        still armed (_fast_resume) — this batch re-enters the commit
        loop directly (_fast_cycle), skipping the ordinary head cycle,
        and only falls back here on a guard miss or mid-batch conflict.
        With the knob on, single-pod batches also run through this body
        (not schedule_one) so their cycles arm and consume the context
        too — at equilibrium the queue often drains one pod at a time."""
        if len(infos) == 1 and not self._churn:
            return self.schedule_one(infos[0])
        with self.cycle_lock:
            if self._fast_resume is not None:
                done = self._fast_cycle(infos)
                if done:
                    if done == len(infos):
                        return "bound"
                    infos = infos[done:]
            ctx = _BatchCtx()
            try:
                first = self._schedule_one_locked(infos[0], batch_ctx=ctx)
            except Exception as e:
                first = self._contain_crash(infos[0], e)
            rest = infos[1:]
            done = 0
            if first == "bound" and ctx.armed:
                if rest:
                    self.metrics.inc("batch_cycles_total")
                self._batch_cursor = None
                try:
                    done = self._commit_batch(ctx, rest)
                except Exception as e:
                    # attribute the crash to the member the commit loop
                    # was processing (every earlier member completed);
                    # the rest fall back to per-pod cycles below
                    cur = self._batch_cursor
                    if cur is not None and cur in rest:
                        done = rest.index(cur) + 1
                        self._contain_crash(cur, e)
                    else:
                        done = 0
                        self.metrics.inc("cycle_crashes_total")
                finally:
                    self._batch_cursor = None
            leftover = rest[done:]
            # unschedulable-class batch fast path: when the head's cycle
            # just recorded (or reconfirmed) the class's no-feasible-node
            # verdict, its batchmates — same equivalence class, so same
            # memo key — would each pay a full per-pod cycle only to hit
            # that same memo at the same version vector. Fail them off
            # the memo directly (attempts, backoff, traces, and metrics
            # exactly as the per-pod memo-hit path would), under the same
            # soundness envelope the memo itself requires; any member the
            # fast path can't prove eligible falls through to the
            # ordinary per-pod cycle below.
            fast_ok = (first in ("unschedulable", "failed")
                       and not ctx.armed and leftover
                       and self.defrag is None
                       and (self.allocator is None
                            or not self.allocator.has_holds()))
            if fast_ok:
                prev = self._snap[0] if self._snap is not None else None
                fast_ok = prev is None or not prev.any_pod_anti_affinity()
            for i, info in enumerate(leftover):
                # breaker gate FIRST: a storm that opened the circuit
                # mid-batch parks the rest attempt-free — the memo fast
                # path must not burn their attempts while the server is
                # down (run_one's gate would have held them)
                if self.clock.time() < self._breaker_until:
                    # the circuit breaker opened mid-batch (a storm is
                    # failing every bind): park the remaining members
                    # back on the active queue with no attempt burned —
                    # run_one's gate holds them until the cooldown
                    now_park = self.clock.time()
                    for parked in leftover[i:]:
                        # now= closes the batch-cycle stint and opens a
                        # fresh queue-wait one, so the breaker-cooldown
                        # wait lands in e2e_queue_wait_ms like any park
                        self.queue.requeue_immediate(parked, now=now_park)
                    break
                if fast_ok and self._batch_fast_fail(info):
                    continue
                try:
                    self._schedule_one_locked(info)
                except Exception as e:
                    self._contain_crash(info, e)
            return first

    def _fast_cycle(self, infos: list[QueuedPodInfo]) -> int:
        """Churn-plane fast cycle: consume the resume state a clean,
        fully-bound batch commit left behind (_fast_resume) and run this
        batch straight through the incremental commit loop, skipping the
        ordinary head cycle. The entry guards re-establish everything a
        head cycle re-derives OUTSIDE the version vector — regime, holds,
        nominations, policy gates, the pod's equivalence class; the
        attribution check inside _commit_batch proves everything inside
        it (foreign dirt of any kind falls back). Returns how many
        members were handled; 0 = nothing consumed (guard miss or
        first-member conflict), the caller runs the ordinary cycle."""
        ctx, r_node, r_vers = self._fast_resume
        self._fast_resume = None
        now = self.clock.time()
        reason = None
        p0 = infos[0].pod
        if p0.phase == PodPhase.BOUND and p0.node:
            reason = "foreign_bound"  # the full cycle owns the drop
        elif self._degraded or self._detect_degraded(now):
            reason = "degraded"  # regime (or a pending flip): full
            # cycles own the memo clears and the staleness waivers
        elif self.defrag is not None:
            reason = "defrag"  # pins land between cycles, outside vers
        elif self.allocator is not None and (
                self.allocator.has_holds()
                or self.allocator.nomination_of(p0.key) is not None):
            reason = "holds"  # per-pod holds break class equivalence
        elif getattr(self.profile, "policy", None) is not None:
            reason = "policy"  # fairness gates re-read live shares
        else:
            try:
                spec = spec_for(p0)
            except LabelError:
                reason = "spec"
            else:
                if spec.is_gang:
                    reason = "gang"
                elif self._memo_key_of(p0, spec) != ctx.memo_key:
                    reason = "class_moved"
        if reason is None:
            # attribution pre-check, the same test _commit_batch applies
            # per member — run it BEFORE paying the commit loop's matrix
            # setup, because at equilibrium a completion between batches
            # is the COMMON miss (foreign dirt) and the ordinary cycle
            # is about to take a fresh snapshot anyway
            vers, dirty, _grew = self._changes_since_directed(r_vers)
            if vers is None or dirty is None or not dirty <= {r_node}:
                conflicted = True
                if dirty is not None and vers is not None:
                    snap_infos = (self._snap[0]._node_infos
                                  if self._snap is not None else None)
                    if snap_infos is not None:
                        conflicted = any(n != r_node and n in snap_infos
                                         for n in dirty)
                if conflicted:
                    reason = "foreign_dirt"
        if reason is not None:
            self.metrics.inc("fast_cycle_guard_misses_total")
            self.flight.record("fast_cycle_guard_miss", pod=p0.key,
                               reason=reason)
            return 0
        self.metrics.inc("fast_cycles_total")
        self._batch_cursor = None
        try:
            done = self._commit_batch(ctx, infos, prev_node=r_node,
                                      prev_vers=r_vers)
        except Exception as e:
            # same crash attribution as schedule_batch's commit call
            cur = self._batch_cursor
            if cur is not None and cur in infos:
                done = infos.index(cur) + 1
                self._contain_crash(cur, e)
            else:
                done = 0
                self.metrics.inc("cycle_crashes_total")
        finally:
            self._batch_cursor = None
        if done < len(infos):
            self.metrics.inc("fast_cycle_fallbacks_total")
        return done

    def _batch_fast_fail(self, info: QueuedPodInfo) -> bool:
        """Fail one batchmate off the unschedulable-class memo without a
        per-pod cycle — bit-identical to the memo-hit path in
        _schedule_one_locked (same attempts bookkeeping, trace shape,
        metrics, and requeue/backoff), legal only when THIS pod's memo
        entry sits exactly at the live version vector. False = not
        provably eligible; the caller runs the ordinary cycle."""
        pod = info.pod
        if pod.phase == PodPhase.BOUND and pod.node:
            return False  # foreign-bound: the full cycle owns the drop
        now = self.clock.time()
        degraded = self._detect_degraded(now)
        if degraded != self._degraded:
            return False  # regime flip: the full cycle owns the clears
        if degraded:
            # a fast-failed batchmate is a real scheduling cycle run
            # under the blackout regime: the counter must see it, or a
            # batched degraded drain undercounts by (batch-1)/batch
            self.metrics.inc("degraded_cycles_total")
        try:
            spec = spec_for(pod)
        except LabelError:
            return False
        if spec.is_gang:
            return False
        vers = self._cluster_versions()
        if vers is None:
            return False
        hit = self._unsched_memo.get(self._memo_key_of(pod, spec))
        if hit is None or hit[0] != vers:
            return False
        if info.cycle_started >= 0.0:
            info.t_cycle += max(now - info.cycle_started, 0.0)
        info.cycle_started = now
        trace = CycleTrace(pod=pod.key, started=now)
        trace.plane = "memo"
        self.metrics.inc("unsched_memo_hits_total")
        self._unschedulable(info, trace, hit[1], rejected_by=hit[2])
        return True

    def _commit_batch(self, ctx: _BatchCtx, infos: list[QueuedPodInfo],
                      prev_node: str | None = None,
                      prev_vers=None) -> int:
        """Greedy batch commit: place each classmate against the shared
        candidate ranking, updating ONLY what the previous bind touched —
        the bound node's row (NodeInfo rebuild + re-filter + re-score),
        its slice's usage entry, and the maxima fold — then re-rank with
        one vectorized normalize+sum over the raw vectors. Every update
        replicates the corresponding per-pod repair path op-for-op (the
        parity fuzz in tests/test_batch.py pins placements identical), so
        a batched drain and a per-pod drain of the same trace bind the
        same pods to the same chips. Returns how many infos were fully
        handled; the caller runs per-pod cycles for the rest.

        Churn-plane fast cycle: `prev_node`/`prev_vers` resume a PRIOR
        batch's fully-consumed commit context across the cycle boundary
        (schedule_batch guards the entry), so an equilibrium drain of one
        equivalence class pays ONE ordinary head cycle and then commits
        every later batch through this loop. The attribution check below
        is the safety net either way: any dirt not on the previously
        bound node sends the caller back to the ordinary cycle."""
        state = ctx.state
        spec = ctx.spec
        candidates = ctx.candidates
        raws = ctx.raws
        scorers = ctx.scorers
        want = ctx.want
        max_age = self.config.telemetry_max_age_s
        floor_fn = getattr(self.cluster.telemetry, "heartbeat_floor", None)
        table = self._columnar
        # exit-time memo state: the class memos must end up EXACTLY where
        # the equivalent per-pod chain would leave them, or the next
        # classmate's repair produces a differently-ordered candidate
        # list and the tie-break diverges. The feasible entry tracks the
        # latest COMPLETED repair (per-pod stores it at repair time); the
        # score entry tracks the latest completed rescore (per-pod stores
        # it after scoring) — a bail between the two stores the mixed
        # state the per-pod chain would also be in at that point.
        if prev_node is None:
            prev_node = ctx.chosen
            prev_cycle_vers = ctx.vers
            mem_feas = (ctx.vers, list(candidates))
            mem_score = (ctx.vers, ctx.mv_t, ctx.usage)
        else:
            # resumed continuation: the memos already sit at the previous
            # commit's exit vector — re-seed the exit state from THERE,
            # not from the head cycle's long-stale vector
            prev_cycle_vers = prev_vers
            mem_feas = (prev_vers, list(candidates))
            mem_score = (prev_vers, ctx.mv_t,
                         state.read_or(SLICE_USE_KEY) or {})
        raws_ok = True  # False only when a rescore ERROR left raws torn
        handled = 0
        kinds = [(p, raws[p.name],
                  getattr(p, "score_inputs", None) == "node+slice_usage",
                  self._normalize_kind(p), getattr(p, "weight", 1))
                 for p in scorers]
        # per-scorer raw scores as one preallocated row-major matrix in
        # candidate order, maintained in LOCKSTEP with `candidates` (the
        # dicts in `raws` stay the score-memo's exit format): the
        # per-member normalize+weighted-sum fold then runs over array
        # views — one fused native call (IncrementalKernels.batch_fold)
        # or a handful of numpy ops — instead of rebuilding an array
        # from dict lookups per scorer per member. Capacity +1: a member
        # removes the bound node and re-appends at most one row.
        n_sc = len(kinds)
        cap = len(candidates) + 1
        smat = np.empty((n_sc, cap), dtype=np.float64)
        for k, (_p, raw, _c, _k, _w) in enumerate(kinds):
            smat[k, :len(candidates)] = [raw[ni.name] for ni in candidates]
        fold_kinds = np.asarray(
            [1 if t[3] == "minmax" else 0 for t in kinds], dtype=np.int64)
        fold_w = np.asarray([float(t[4]) for t in kinds],
                            dtype=np.float64)
        totals_buf = np.empty(cap, dtype=np.float64)
        ties_buf = np.empty(cap, dtype=np.int64)
        nk = self._incremental
        fold_fn = nk.fold_fn if nk is not None else None
        # buffer pointers captured once — the per-member call passes
        # plain ints (a ctypes cast per call would cost more than the
        # numpy ops the fused fold removes)
        p_smat, p_kinds = smat.ctypes.data, fold_kinds.ctypes.data
        p_w, p_tot, p_ties = (fold_w.ctypes.data, totals_buf.ctypes.data,
                              ties_buf.ctypes.data)
        stride = smat.shape[1]
        # candidate NAME set maintained in lockstep with the list: the
        # per-member frozenset then builds off this set instead of
        # re-walking 100 NodeInfo.name attributes
        cand_names = {ni.name for ni in candidates}
        completed = True  # False once any member falls off the loop
        # churn plane: per-member counter bumps are batched into one inc
        # per call ("metrics sampled, not stamped") — totals identical,
        # minus two locked dict updates per member
        defer = self._churn
        n_hits = n_binds = 0
        for info in infos:
            self._batch_cursor = info  # crash attribution (schedule_batch)
            completed = False  # back True only when this member BINDS
            pod = info.pod
            now = self.clock.time()
            # conflict detection by ATTRIBUTION, not by version equality:
            # the previous bind legitimately moved the vector, so the
            # batch may continue only when every change since the previous
            # member's cycle is on the node that bind touched. Anything
            # else — a reflector apply, a telemetry publish, a cordon, an
            # async-bind rollback, even one landing DURING our own bind
            # call — sends the rest of the batch to per-pod cycles and
            # their fresh snapshots.
            vers, dirty, _grew = self._changes_since_directed(
                prev_cycle_vers)
            conflicted = (vers is None or dirty is None
                          or not dirty <= {prev_node})
            if conflicted and dirty is not None and vers is not None:
                # NON-MEMBER dirt cannot conflict: a dirty name outside
                # this engine's snapshot membership (a sharded-reflection
                # replica's foreign pools, telemetry for unknown nodes)
                # is exactly what snapshot()/sync() skip — no candidate,
                # score, or prescore input can depend on it. Membership
                # CHANGES can't hide here: they move vers[2], which the
                # attribution above already turned into dirty=None.
                snap_infos = (self._snap[0]._node_infos
                              if self._snap is not None else None)
                if snap_infos is not None:
                    conflicted = any(n != prev_node and n in snap_infos
                                     for n in dirty)
            if conflicted:
                self.metrics.inc("batch_conflict_fallbacks_total")
                self.flight.record("batch_conflict_fallback",
                                   pod=pod.key, prev_node=prev_node)
                break
            self._csv_memo.clear()
            state.write("now", now)
            # incremental: attribution above proved dirty == {prev_node},
            # so patch the cached snapshot directly (generic fallback
            # when the cache isn't exactly at the previous vector)
            snapshot = self._snapshot_one_dirty(prev_node,
                                                prev_cycle_vers, vers)
            if snapshot is None:
                snapshot = self.snapshot()
            state.write("snapshot", snapshot)
            state.write("cycle_versions", vers)
            if snapshot.any_pod_anti_affinity():
                break  # memo envelope broke: full per-pod cycles own it
            new_prev = snapshot.get(prev_node)
            if new_prev is None:
                break
            # per-member relevance re-gate, exactly the per-pod cycle's:
            # an absorbed change on the bound node itself (a cordon
            # landing inside our bind window attributes to prev_node) can
            # flip a snapshot fact and pull a filter back into play
            filters = [p for p in self.profile.filter
                       if getattr(p, "relevant", None) is None
                       or p.relevant(pod, snapshot)]
            if any(getattr(p, "time_dependent", False) for p in filters) \
                    and not state.read_or("degraded"):
                # (degraded mode waives staleness entirely, so the
                # aged-out-heartbeat bail below would only thrash)
                floor = floor_fn() if floor_fn is not None else None
                if floor is None or (now - floor) > max_age:
                    # some heartbeat may have aged out mid-batch: only the
                    # per-pod repair path re-verifies staleness per node
                    self.metrics.inc("batch_conflict_fallbacks_total")
                    break
            if table is not None and not self._churn:
                # keep the columnar twin hot: one in-place row refresh
                # from the rebuilt NodeInfo instead of a changes_since
                # walk at the next sync. Sound because the attribution
                # check above proved every change since the previous
                # cycle's vector is on prev_node — and new_prev reflects
                # ALL of them, not just our bind (a telemetry publish or
                # cordon absorbed into the bind window refills correctly).
                # The free_coords/claimed_hbm work is memoized on
                # new_prev, so the re-filter below reuses it.
                # Churn plane: SKIP the per-member refresh — the loop
                # never reads the table, and letting the dirt accumulate
                # means the next ordinary cycle's sync applies the whole
                # batch in one eventplane call (_sync_batched) instead of
                # a _fill_row here per member. Same final table bytes:
                # refresh_row is a declared shortcut, never a source of
                # truth (its own docstring).
                table.refresh_row(prev_node, new_prev, prev_cycle_vers,
                                  vers)
            # ---- candidate list: exactly _repair_feasible for a single
            # dirty node — drop the bound node, re-filter it against its
            # rebuilt info, passing nodes re-enter at the END (score
            # tie-break order depends on this)
            for i, ni in enumerate(candidates):
                if ni.name == prev_node:
                    del candidates[i]
                    cand_names.discard(prev_node)
                    lc = len(candidates)
                    if i < lc:  # keep the score matrix in lockstep
                        smat[:, i:lc] = smat[:, i + 1:lc + 1]
                    break
            appended = False
            if len(candidates) < want:
                st = Status.success()
                for p in filters:
                    st = p.filter(state, pod, new_prev)
                    if not st.ok:
                        break
                if st.code == Code.ERROR:
                    break
                if st.ok:
                    candidates.append(new_prev)
                    cand_names.add(prev_node)
                    appended = True
            if not candidates:
                # the class ran out of known candidates: the per-pod full
                # scan (and its unschedulable/preemption bookkeeping) owns
                # this — identical to repair returning an empty list (the
                # feasible memo stays at the last COMPLETED repair, just
                # as a failed per-pod repair leaves it)
                break
            # repair completed: per-pod refreshes the feasible entry at
            # exactly this point, so the exit state does too
            mem_feas = (vers, list(candidates))
            names = frozenset(cand_names)
            # ---- prescore outputs: each plugin updates its own memo +
            # cycle-state contribution exactly (MaxCollection maxima,
            # TopologyScore slice usage)
            prev_usage = state.read_or(SLICE_USE_KEY) or {}
            ok = True
            for p in self.profile.pre_score:
                if not p.pre_score_update(state, pod, new_prev, names):
                    ok = False
                    break
            if not ok:
                break
            usage = state.read_or(SLICE_USE_KEY) or {}
            mvv = state.read_or(MAX_KEY)
            mv_t = (mvv.bandwidth, mvv.clock, mvv.core, mvv.free_memory,
                    mvv.power, mvv.total_memory) if mvv is not None else None
            if mv_t != ctx.mv_t:
                # the cluster maxima moved (the bound node held the unique
                # max-attribute chip): every maxima-normalised raw score is
                # stale, which is exactly the score-memo miss the per-pod
                # cycle full-rescoring handles
                break
            sid = (new_prev.metrics.slice_id
                   if new_prev.metrics is not None else None)
            slice_moved = bool(sid) and usage.get(sid) != prev_usage.get(sid)
            # ---- re-score only what changed: the bound node (if it
            # re-entered) for every scorer, plus its slice-mates for
            # slice-coupled scorers — the score-memo replay rule
            # candidates needing a fresh score are KNOWN: the re-appended
            # bound node (its raw entry was just popped) and — for
            # slice-coupled scorers when its slice's usage moved — that
            # slice's other members. Scoring exactly those (instead of
            # scanning every candidate per scorer for a membership check)
            # computes the same values the scan would.
            appended_idx = len(candidates) - 1 if appended else None
            mates = None
            if slice_moved and any(t[2] for t in kinds):
                mates = [(idx, node) for idx, node in enumerate(candidates)
                         if idx != appended_idx
                         and node.metrics is not None
                         and node.metrics.slice_id == sid]
            for k, (p, raw, coupled, _kind, _w) in enumerate(kinds):
                raw.pop(prev_node, None)
                row = smat[k]
                if appended_idx is not None:
                    node = candidates[appended_idx]
                    s, st = p.score(state, pod, node)
                    if st.code == Code.ERROR:
                        ok = False
                        break
                    raw[node.name] = s
                    row[appended_idx] = s
                if coupled and mates:
                    for idx, node in mates:
                        s, st = p.score(state, pod, node)
                        if st.code == Code.ERROR:
                            ok = False
                            break
                        raw[node.name] = s
                        row[idx] = s
                    if not ok:
                        break
            if not ok:
                raws_ok = False  # mid-rescore ERROR: raws are torn
                break
            # ---- normalize + weighted sum + tie set, op-for-op the
            # scalar fold: one fused native call when the incremental
            # kernel is loaded, the elementwise numpy twin otherwise
            # (both perform the same IEEE double ops in the same order,
            # so the tie set — and the seeded tie-break — are identical)
            n = len(candidates)
            n_ties = (fold_fn(p_smat, n_sc, stride, p_kinds, p_w, n,
                              p_tot, p_ties)
                      if fold_fn is not None else -1)
            if n_ties > 0:
                best_nodes = [candidates[int(ties_buf[j])].name
                              for j in range(n_ties)]
            else:
                totals = _numpy_fold(smat, fold_kinds, fold_w, n)
                best = totals.max()
                best_nodes = [candidates[i].name
                              for i in np.flatnonzero(totals == best)]
            chosen = self.rng.choice(best_nodes)
            # selection complete: candidates/raws/usage are the exact
            # per-pod repair state for THIS member's version vector. The
            # batch commit IS the feasible-class repair path, fused — the
            # counter keeps meaning "classmate placed off the class memo
            # instead of a fresh scan" for dashboards and tests alike.
            if defer:
                n_hits += 1
            else:
                self.metrics.inc("feas_memo_hits_total")
            mem_score = (vers, mv_t, usage)
            prev_cycle_vers = vers
            # ---- Reserve -> (Permit) -> Bind, the ordinary sub-steps
            trace = CycleTrace(pod=pod.key, started=now)
            # batch commit IS the class-memo repair path; plane-attribute
            # member cycles the same way (cycle_plane_total{plane="memo"})
            trace.plane = "memo"
            info.commit_started = self.clock.time()  # e2e: commit opens
            reserved: list[ReservePlugin] = []
            st = Status.success()
            for p in self.profile.reserve:
                try:
                    st = p.reserve(state, pod, chosen)
                except Exception:
                    # crash surfaces through schedule_batch's containment
                    self._unwind_reserved(reserved, state, pod, chosen)
                    raise
                if not st.ok:
                    for r in reversed(reserved):
                        r.unreserve(state, pod, chosen)
                    break
                reserved.append(p)
            if not st.ok:
                # a racing claim emptied the chosen node between score and
                # reserve: per-pod handling for this member, fresh cycles
                # for the rest
                self._unschedulable(info, trace, f"reserve: {st.message}",
                                    rejected_by=(p.name,))
                self.metrics.inc("batch_conflict_fallbacks_total")
                handled += 1
                break
            # Permit: the equivalence contract (framework.equivalence_key)
            # guarantees permit plugins are no-ops for batchable pods, but
            # call them anyway — a WAIT/deny here is a contract breach we
            # surface through the ordinary rollback, not silently
            permit_ok = True
            for p in self.profile.permit:
                try:
                    pst, _timeout = p.permit(state, pod, chosen)
                except Exception:
                    self._unwind_reserved(reserved, state, pod, chosen)
                    raise
                if not pst.ok:
                    for r in reversed(reserved):
                        r.unreserve(state, pod, chosen)
                    self._unschedulable(info, trace,
                                        f"permit: {pst.message}",
                                        rejected_by=(p.name,))
                    handled += 1
                    permit_ok = False
                    break
            if not permit_ok:
                break
            if not self._bind(info, chosen, trace):
                # _bind rolled back and requeued; remaining members need
                # the fresh snapshot a per-pod cycle takes
                self.metrics.inc("batch_conflict_fallbacks_total")
                handled += 1
                break
            if defer:
                n_binds += 1
            else:
                self.metrics.inc("batched_binds_total")
            handled += 1
            prev_node = chosen
            completed = True
        if n_hits:
            self.metrics.inc("feas_memo_hits_total", n_hits)
        if n_binds:
            self.metrics.inc("batched_binds_total", n_binds)
        # churn-plane fast cycle: a commit loop that ran CLEAN end to end
        # (every member bound — or no members at all, the single-pod
        # head) leaves its context armed for the next same-class batch;
        # schedule_batch re-guards at consume time and the attribution
        # check above re-proves soundness against whatever happened in
        # between. Any fall-off means the ordinary cycle owns the class
        # again until a fresh commit re-arms.
        self._fast_resume = ((ctx, prev_node, prev_cycle_vers)
                             if self._churn and completed and raws_ok
                             else None)
        # exit-time memo refresh (see mem_feas/mem_score above): the next
        # classmate — batched, or the per-pod fallback the caller runs for
        # the rest of this batch — must see the memos the equivalent
        # per-pod chain would have produced, with the same list ORDER
        # (tie-breaks ride on it). A torn raw dict (mid-rescore ERROR)
        # drops the score entry instead; values-exactness makes a fresh
        # rescore produce identical floats anyway.
        if len(self._feas_memo) > 256:
            self._feas_memo.clear()
        self._feas_memo[ctx.memo_key] = self._feas_entry(*mem_feas)
        if raws_ok:
            if len(self._score_memo) > 256:
                self._score_memo.clear()
            self._score_memo[ctx.memo_key] = (mem_score[0], mem_score[1],
                                              mem_score[2], ctx.names_set,
                                              raws)
        else:
            self._score_memo.pop(ctx.memo_key, None)
        return handled

    def _detect_degraded(self, now: float) -> bool:
        """Telemetry-blackout verdict for one cycle (side-effect-free;
        the regime-flip bookkeeping stays in _schedule_one_locked). Also
        used by the prefetch dispatcher, whose scan must run under the
        same regime the consuming cycle will detect."""
        if not self.config.degraded_mode:
            return False
        ceil_fn = getattr(self.cluster.telemetry, "heartbeat_ceiling", None)
        if ceil_fn is None:
            return False
        ceil = ceil_fn()
        return (ceil is not None
                and (now - ceil) > self.config.telemetry_max_age_s)

    def _gated_scorers(self, pod, snapshot, degraded: bool) -> list:
        """The cycle's effective scorer set: degraded mode drops
        telemetry-dependent scorers, relevance gates drop plugins that
        cannot move this pod's ranking. One definition — the scoring
        section and the native scan must agree or their folds diverge."""
        scorers = []
        for p in self.profile.score:
            if degraded and getattr(p, "telemetry_dependent", False):
                # blackout degraded mode: stale quality numbers would
                # rank nodes on noise — capacity/topology scorers carry
                # the placement until the feed recovers
                continue
            gate = getattr(p, "score_relevant", None)
            if gate is None:
                gate = getattr(p, "relevant", None)
            if gate is None or gate(pod, snapshot):
                scorers.append(p)
        return scorers

    def _schedule_one_locked(self, info: QueuedPodInfo,
                             batch_ctx: "_BatchCtx | None" = None) -> str:
        # churn-plane fast cycle: any ordinary cycle invalidates the
        # carried commit context — it may bind, repair memos, or mutate
        # the score dicts the context aliases. A batch that re-arms does
        # so at _commit_batch exit, AFTER this clear.
        self._fast_resume = None
        if self._native is not None and self._native.inflight:
            # thread-safety contract (nativeplane.py): the table must be
            # quiescent before this cycle's first sync — wait for the
            # in-flight prefetch scan (sub-ms) and bank its result for
            # the consume-time validation in _native_scan
            got = self._native.prefetch_wait()
            if got is not None:
                self._prefetched = got
        pod = info.pod
        now = self.clock.time()
        # e2e decomposition: open the compute phase. A batch member
        # falling back to this per-pod cycle arrives with the stint
        # run_one opened at the shared pop still live — fold that
        # pop-to-fallback wait into t_cycle first (it IS batch cycle
        # time), or the interval would vanish from the breakdown
        if info.cycle_started >= 0.0:
            info.t_cycle += max(now - info.cycle_started, 0.0)
        info.cycle_started = now
        trace = CycleTrace(pod=pod.key, started=now)
        # lifecycle spans: sampled pods stamp each extension point (one
        # clock read per phase); everyone else pays one memoized lookup
        rec = self.spans if self._sampled(pod) else None
        if pod.phase == PodPhase.BOUND and pod.node:
            # a foreign fleet replica bound this pod after it entered our
            # queue (shared-state optimistic scheduling — free-for-all
            # poaching or a split-brain window queued it twice): drop the
            # entry off cluster truth instead of burning a full cycle
            # that would end in the authority's 409
            if self.allocator is not None:
                self.allocator.unnominate(pod.key)
            self.metrics.inc("foreign_bind_skips_total")
            self._finish(trace, "foreign-bound", node=pod.node,
                         reason="already bound by a foreign replica")
            return "foreign-bound"
        state = CycleState()
        state.write("now", now)
        self._csv_memo.clear()  # per-cycle dirty-set cache

        try:
            spec = spec_for(pod)
        except LabelError as e:
            # malformed request: permanent failure, not silent 0-coercion
            pod.phase = PodPhase.FAILED
            self.failed[pod.key] = str(e)
            self.metrics.inc("pods_failed_total")
            self._finish(trace, "failed", reason=str(e))
            return "failed"
        doom = self.doomed_gangs.get(spec.gang_name) if spec.is_gang else None
        if doom is not None:
            # a peer permanently failed while this member sat in backoff:
            # assembly can never finish, fail fast instead of re-parking
            self._fail_permanently(info, doom, trace=trace)
            return "failed"
        state.write("workload_spec", spec)

        # serving-pressure growth hold (SloGuard): while the guard is
        # pressed OR shrunk capacity is still owed back, elastic GROWTH
        # members (gang already running at >= tpu/gang-min) park instead
        # of re-absorbing the chips the shrink pass just freed for
        # serving. The give-back publishes a POD_DELETED wake through
        # the elastic-grow hint class, releasing them in the valley.
        if (self.sloguard is not None and self.elastic is not None
                and spec.is_gang and spec.gang_min > 0
                and self.sloguard.holding(now)
                and spec.gang_name not in self.doomed_gangs
                and self._bound_members_of(spec.gang_name)
                >= spec.gang_min):
            from .elastic import ELASTIC_GROW_HINT

            self.metrics.inc("serving_growth_holds_total")
            return self._unschedulable(
                info, trace,
                f"gang {spec.gang_name}: growth held while serving "
                "pressure holds the freed chips",
                rejected_by=(ELASTIC_GROW_HINT,), gang_doom=False)

        # telemetry-blackout degraded mode: when even the NEWEST stored
        # heartbeat is past the staleness gate, the whole feed is dark —
        # one node's dead sniffer never trips this — and the engine keeps
        # scheduling off last-known capacity (TelemetryFilter waives its
        # staleness gate, telemetry-dependent scorers drop out) instead
        # of marking every node stale-infeasible. Detected per cycle; a
        # regime flip clears the class memos, because staleness verdicts
        # change with TIME and no version vector records the transition.
        degraded = self._detect_degraded(now)
        if degraded != self._degraded:
            self._degraded = degraded
            self._unsched_memo.clear()
            self._feas_memo.clear()
            self._score_memo.clear()
            self.metrics.set_gauge("degraded", 1.0 if degraded else 0.0)
            self.metrics.inc("degraded_transitions_total")
            self.flight.record("degraded_mode", active=degraded)
        if degraded:
            state.write("degraded", True)
            self.metrics.inc("degraded_cycles_total")

        # unschedulable-class fast path (see _unsched_memo). Gang pods and
        # nominated preemptors carry state outside the version vector.
        # Admission inputs (nodeSelector/tolerations) are part of the class:
        # two pods with identical labels but different tolerations must not
        # share a verdict. The common no-admission case keys on the interned
        # spec alone (a tuple never equals a WorkloadSpec, so no collision).
        # the symmetry rule makes verdicts depend on ARBITRARY pod labels
        # (a bound pod's anti-affinity selector can distinguish pods with
        # identical WorkloadSpecs), so the class memo is unsound while any
        # bound pod carries anti-affinity. The previous cycle's snapshot
        # answers that cheaply; if an anti-affinity pod binds later, the
        # version vector already invalidates every memo entry.
        prev = self._snap[0] if self._snap is not None else None
        memo_ok = (not spec.is_gang
                   and (prev is None or not prev.any_pod_anti_affinity())
                   and (self.allocator is None
                        or self.allocator.nomination_of(pod.key) is None))
        memo_key = self._memo_key_of(pod, spec)
        vers = self._cluster_versions()
        if memo_ok and vers is not None:
            hit = self._unsched_memo.get(memo_key)
            if hit is not None and hit[0] == vers:
                self.metrics.inc("unsched_memo_hits_total")
                trace.plane = "memo"
                return self._unschedulable(info, trace, hit[1],
                                           rejected_by=hit[2])

        snapshot = self.snapshot()
        state.write("snapshot", snapshot)
        state.write("changes_since_fn", self._changes_since_vers)
        # the version vector sampled BEFORE the snapshot was built:
        # plugin memos must store THIS vector, never a live re-sample —
        # an event landing between snapshot build and a later sample
        # would be absorbed (the memo's version covers it while its data
        # predates it), and changes_since would never report it again
        state.write("cycle_versions", vers)

        # PreFilter
        for p in self.profile.pre_filter:
            st = p.pre_filter(state, pod, snapshot)
            if st.code == Code.UNSCHEDULABLE:
                return self._unschedulable(info, trace, st.message,
                                           rejected_by=(p.name,))
            if st.code == Code.ERROR:
                return self._cycle_error(info, trace, st.message)

        # migration-plan pin (scheduler/elastic/defrag.py): a defrag
        # victim's FIRST re-placement cycle considers ONLY its planned
        # destination — the dry-run proved it fits there, and unpinned
        # re-scoring would bounce it straight back into the hole the
        # migration just opened. One-shot: a failed pinned cycle (the
        # destination was taken meanwhile) leaves later retries
        # unrestricted. Never overrides gang narrowing (victims are
        # never gang members).
        if (self.defrag is not None
                and state.read_or(CANDIDATE_NODES_KEY) is None):
            pin = self.defrag.take_pin(pod.key)
            if pin is not None:
                state.write(CANDIDATE_NODES_KEY, frozenset((pin,)))
                # class memos are unsound under candidate narrowing: the
                # pinned one-node scan must neither be STORED class-wide
                # (a classmate would inherit a single-node feasible list
                # or an O(1) "no feasible node" verdict while the cluster
                # has capacity) nor SKIPPED via a feasible-memo hit (the
                # class list ignores the pin). Gang narrowing never hits
                # this because is_gang already cleared memo_ok; the pin
                # is the only narrowing a memo-eligible pod can carry.
                # (On FakeCluster the victim is also allocator-nominated,
                # which clears memo_ok anyway — this gate is what keeps
                # the real-apiserver path sound, where eviction destroys
                # the incarnation and no nomination is placed.)
                memo_ok = False

        # Filter with early-stop (percentageOfNodesToScore)
        nodes = snapshot.list()
        want = self._num_feasible_to_find(len(nodes))
        # a nominated preemptor evaluates its nominated node FIRST (upstream
        # behavior): its verdict is then always known, so _unschedulable can
        # release the hold the moment the node stops being feasible
        nom = (self.allocator.nomination_of(pod.key)
               if self.allocator is not None else None)
        # per-cycle relevance gating: plugins exposing `relevant(pod,
        # snapshot)` drop out of the per-node loops when they cannot affect
        # this pod (e.g. admission on an untainted cluster) — the gate runs
        # once per cycle, not once per node
        filters = [p for p in self.profile.filter
                   if getattr(p, "relevant", None) is None
                   or p.relevant(pod, snapshot)]

        # per-class incremental feasible list: classmates dominate bursts,
        # and a bind dirties ONE node — repair the previous classmate's
        # feasible list from the change logs instead of re-filtering the
        # whole cluster. STRICTER gate than _unsched_memo: the memo there
        # requires exact version equality, while repair bridges versions
        # re-filtering only dirty nodes — sound ONLY for per-node
        # predicates. Domain-scoped constraints (topologySpread skew,
        # required pod (anti-)affinity incl. the symmetry rule) flip
        # verdicts of UNCHANGED same-domain nodes on a bind, so any such
        # pod — or any bound anti-affinity pod, checked on the CURRENT
        # snapshot, not memo_ok's previous one — takes the full scan.
        feas_ok = (memo_ok and nom is None and vers is not None
                   and not pod.topology_spread
                   and not pod.pod_affinity and not pod.pod_anti_affinity
                   and not snapshot.any_pod_anti_affinity())
        feasible: list[NodeInfo] | None = None
        rejectors: set[str] = set()
        t_filter0 = now  # span stamp: filter phase effectively starts here
        if feas_ok:
            hit = self._feas_memo.get(memo_key)
            if hit is not None:
                feasible = self._repair_feasible(
                    hit, vers, now, state, pod, snapshot, filters, want)
                if feasible is not None:
                    trace.plane = "memo"
                    self.metrics.inc("feas_memo_hits_total")
                    # refresh versions + infos so the next classmate's
                    # dirty set stays small
                    self._feas_memo[memo_key] = self._feas_entry(
                        vers, feasible)

        if feasible is None and feas_ok:
            # unschedulable-class REPAIR: the classmate's "no feasible
            # node" verdict was recorded under an older version vector. A
            # failing scan checked EVERY node, and no predicate under the
            # feas_ok gate flips infeasible->feasible without a recorded
            # change, so only the DIRTY nodes can have become feasible —
            # re-filter just those instead of rescanning the cluster (the
            # retry storms this replaces were the old backoff wall's
            # main compute cost: each one a full scan plus a preemption
            # re-plan).
            hit = self._unsched_memo.get(memo_key)
            if hit is not None and hit[0] != vers:
                rep = self._repair_unsched(hit, state, pod, snapshot,
                                           filters, trace)
                if rep is not None:
                    trace.plane = "memo"
                    passing, extra_rej, dirty = rep
                    if passing:
                        self.metrics.inc("unsched_memo_repairs_total")
                        feasible = passing[:want]
                        # the class is schedulable again: retire the
                        # unschedulable entry and seed the feasible memo
                        # so the next classmate repairs from here
                        del self._unsched_memo[memo_key]
                        self._feas_memo[memo_key] = self._feas_entry(
                            vers, feasible)
                    else:
                        combined = hit[2] | extra_rej
                        self._unsched_memo[memo_key] = (vers, hit[1],
                                                        combined)
                        self.metrics.inc("unsched_memo_repairs_total")
                        # preemption could have become viable only on a
                        # dirty node (e.g. a fresh lower-priority bind):
                        # run the planner restricted to those. Falls back
                        # to the full scan when a post-filter plugin can't
                        # restrict or PDB accounting couples the verdicts
                        # cluster-wide.
                        if self.profile.post_filter:
                            if snapshot.budgets or not all(
                                    getattr(p, "supports_restricted", False)
                                    for p in self.profile.post_filter):
                                feasible = None  # full scan decides
                            else:
                                out = self._run_post_filter(
                                    info, trace, state, pod, spec,
                                    snapshot, now, only_nodes=dirty)
                                if out is not None:
                                    return out
                                return self._unschedulable(
                                    info, trace, hit[1],
                                    rejected_by=tuple(combined))
                        else:
                            return self._unschedulable(
                                info, trace, hit[1],
                                rejected_by=tuple(combined))

        # native fused scan: when every active filter AND prescore can be
        # expressed in the fused kernel, the memo-miss full scan — filter
        # mask, rotating early-stop top-k, MaxValue fold, native scorers'
        # raw terms — collapses into ONE GIL-releasing C call over the
        # columnar arrays (scheduler/nativeplane.py). Same gates as the
        # numpy path below; any veto falls through to numpy columnar,
        # then scalar — the fallback chain is scalar <- numpy <- native,
        # each layer the ground truth of the one above.
        nat: "_NativeCycle | None" = None
        native_empty = False
        if (feasible is None and self._native is not None
                and vers is not None and nom is None and not spec.is_gang
                and nodes and state.read_or(CANDIDATE_NODES_KEY) is None):
            out = self._native_scan(state, pod, spec, filters, snapshot,
                                    vers, nodes, want, degraded)
            if out is _NATIVE_EMPTY:
                # zero feasible rows, verdict-final (the numpy mask would
                # agree bit-for-bit): skip the redundant numpy scan; the
                # scalar loop below owns the per-node failure diagnostics
                # and _filter_start deliberately stays unadvanced
                native_empty = True
                trace.plane = "native"
            elif out is not None:
                nat = out
                trace.plane = "native"
                feasible = nat.feasible
                for ni in feasible:
                    trace.filter_verdicts[ni.name] = "ok"
                self._filter_start = (self._filter_start % len(nodes)
                                      + nat.checked) % len(nodes)
                if feas_ok:
                    if len(self._feas_memo) > 256:
                        self._feas_memo.clear()
                    self._feas_memo[memo_key] = self._feas_entry(
                        vers, feasible)

        # columnar full scan: when every active filter can express this
        # pod's predicates over the node table, the whole cluster is
        # evaluated in a handful of numpy calls instead of a per-(pod,
        # node) Python loop. Gated to pods whose cycle carries no state
        # the columns can't see (nomination ordering, PreFilter candidate
        # narrowing, gang membership); zero-pass and every bail-out fall
        # through to the scalar scan below, which remains ground truth.
        if (feasible is None and not native_empty
                and self._columnar is not None
                and vers is not None and nom is None and not spec.is_gang
                and nodes and state.read_or(CANDIDATE_NODES_KEY) is None):
            feasible = self._columnar_filter(state, pod, filters, snapshot,
                                            vers, nodes, want, trace)
            if feasible is not None:
                trace.plane = "numpy"
            if feas_ok and feasible:
                if len(self._feas_memo) > 256:
                    self._feas_memo.clear()
                self._feas_memo[memo_key] = self._feas_entry(vers, feasible)

        if feasible is None:
            trace.plane = "native" if native_empty else "scalar"
            # bounded diagnostics after a kernel-final empty verdict: the
            # scalar scan's only remaining outputs are the failure REASON
            # (sorted per-node messages, truncated at ~500 chars) and the
            # REJECTORS set. The rejectors come exactly from the columnar
            # masks (first-failing plugin per row, one vectorized pass);
            # the reason needs only the alphabetically-first nodes up to
            # the truncation budget — nodes are already in sorted order,
            # so scanning a prefix builds the identical string a full
            # walk would. A full FAILING scan advances the rotation by
            # len(nodes) ≡ 0 (mod n), so the bounded scan advances by 0
            # too. At 50k nodes this turns an O(cluster) Python walk per
            # no-fit class into O(truncation).
            diag_budget = None
            if native_empty:
                rej = self._columnar_rejectors(state, pod, filters)
                if rej is not None:
                    rejectors |= rej
                    diag_budget = 1000
            if diag_budget is not None:
                order = range(len(nodes))
            else:
                order = [(self._filter_start + i) % len(nodes)
                         for i in range(len(nodes))]
                if nom is not None:
                    ni = next((i for i in order
                               if nodes[i].name == nom[0]), None)
                    if ni is not None:
                        order.remove(ni)
                        order.insert(0, ni)
            # sound candidate narrowing from PreFilter (gang slice
            # membership / chosen slice / plan quotas): nodes outside the
            # set are provably infeasible under predicates preemption
            # cannot relax, so the filter chain is skipped for them
            cand = state.read_or(CANDIDATE_NODES_KEY)
            feasible = []
            checked = 0
            diag_size = 0
            for i in order:
                node = nodes[i]
                if cand is not None and node.name not in cand:
                    continue
                checked += 1
                st = Status.success()
                rej = None
                for p in filters:
                    st = p.filter(state, pod, node)
                    if not st.ok:
                        rej = p.name
                        break
                trace.filter_verdicts[node.name] = ("ok" if st.ok
                                                    else st.message)
                if st.code == Code.ERROR:
                    return self._cycle_error(info, trace, st.message)
                if st.ok:
                    feasible.append(node)
                    if len(feasible) >= want:
                        break
                elif rej is not None:
                    rejectors.add(rej)
                if diag_budget is not None and not st.ok:
                    diag_size += len(node.name) + len(st.message) + 2
                    if diag_size > diag_budget:
                        break
            if diag_budget is None:
                self._filter_start = ((self._filter_start + checked)
                                      % max(len(nodes), 1))
            if feas_ok and feasible:
                if len(self._feas_memo) > 256:
                    self._feas_memo.clear()
                self._feas_memo[memo_key] = self._feas_entry(vers, feasible)

        if rec is not None:
            rec.record("cycle.filter", pod.key, t_filter0, self.clock.time(),
                       {"plane": trace.plane or "scalar",
                        "feasible": len(feasible) if feasible else 0,
                        "want": want})
        if not feasible:
            # a nominated preemptor whose victims are still in graceful
            # termination is just waiting for capacity it is already
            # entitled to — don't plan a second preemption round (`nom`
            # from the filter-ordering step above; the cycle lock means it
            # cannot have changed since)
            if nom is not None and any(
                    p.terminating for p in self.cluster.pods_on(nom[0])):
                return self._unschedulable(
                    info, trace,
                    f"waiting for victims on {nom[0]} to terminate",
                    rejected_by=("victim-drain",))
            # same for a gang holding a slice-level entitlement: while its
            # victims drain anywhere on the nominated slice, wait
            if spec.is_gang and self.allocator is not None:
                gnom = self.allocator.gang_nomination_of(spec.gang_name)
                if gnom is not None and any(
                        p.terminating
                        for ni in snapshot.list()
                        if ni.metrics is not None
                        and ni.metrics.slice_id == gnom[0]
                        for p in ni.pods):
                    return self._unschedulable(
                        info, trace,
                        f"waiting for victims on slice {gnom[0]} to "
                        "terminate", rejected_by=("victim-drain",))
            # elastic GROWTH members (gang already admitted at >= min in
            # cluster truth) park event-driven instead of preempting:
            # growth rides capacity as it frees — the defrag controller
            # and ordinary departures publish the POD_DELETED wakes —
            # and never evicts anyone to grow an already-running job
            out = self._elastic_growth_park(info, spec, trace)
            if out is not None:
                return out
            # PostFilter: preemption — the plugin plans, the engine evicts
            out = self._run_post_filter(info, trace, state, pod, spec,
                                        snapshot, now)
            if out is not None:
                return out
            # elastic admit-at-min: preemption could not cure this gang
            # member either — if enough members are already placed
            # (parked at Permit + bound), start the gang NOW at reduced
            # size instead of letting the whole assembly time out
            out = self._elastic_admit_at_min(info, spec, trace)
            if out is not None:
                return out
            # build the diagnostic bounded: at 1000 nodes a full join of
            # every failure verdict costs more than the whole cycle
            parts: list[str] = []
            size = 0
            for n, v in sorted(trace.filter_verdicts.items()):
                if v == "ok":
                    continue
                parts.append(f"{n}: {v}")
                size += len(parts[-1])
                if size > 500:
                    parts.append("...")
                    break
            reason = "no feasible node: " + "; ".join(parts)[:500]
            if memo_ok and vers is not None:
                # classmates fail in O(1) until any cluster event; the
                # rejecting-plugin set rides along so their queueing hints
                # apply to O(1) failures too
                if len(self._unsched_memo) > 256:
                    self._unsched_memo.clear()
                self._unsched_memo[memo_key] = (vers, reason,
                                                frozenset(rejectors))
            return self._unschedulable(info, trace, reason,
                                       rejected_by=tuple(rejectors))

        t_score0 = self.clock.time() if rec is not None else 0.0
        # PreScore. When the candidate set came off the feasible-class
        # memo, hand prescore plugins its name frozenset so they can key
        # their own incremental folds on set identity (MaxCollection
        # re-folds only touched components when the set is unchanged).
        if feas_ok:
            fent = self._feas_memo.get(memo_key)
            if (fent is not None and fent[0] == vers
                    and len(fent[1]) == len(feasible)):
                state.write("feasible_names", fent[2])
        for p in self.profile.pre_score:
            if nat is not None:
                inst = getattr(p, "native_install", None)
                if inst is not None:
                    # the fused kernel already folded this plugin's
                    # output (MaxValue + per-candidate contributions):
                    # install it exactly where pre_score would leave it
                    inst(state, spec, vers, nat.names_set, nat.contribs,
                         nat.mv6)
                    continue
            st = p.pre_score(state, pod, feasible)
            if st.code == Code.ERROR:
                return self._cycle_error(info, trace, st.message)

        # Score + per-plugin normalize + weighted sum (relevance-gated
        # like the filter loop; a plugin may declare a separate
        # score_relevant when its scoring inputs are narrower than its
        # filtering inputs)
        totals: dict[str, float] = {n.name: 0.0 for n in feasible}
        scorers = (nat.scorers if nat is not None
                   else self._gated_scorers(pod, snapshot, degraded))

        # SCORE-class memo: a classmate's raw per-plugin scores are
        # verbatim repeats for every node the change logs call clean —
        # rescore ONLY dirty nodes (the score twin of _repair_feasible).
        # Sound only for plugins that DECLARE their per-node inputs via
        # `score_inputs`: "node" (node serial + allocator pending version
        # + the pod's label class + the cycle maxima) or
        # "node+slice_usage" (additionally the node's slice-usage entry).
        # Any other scorer, a maxima change, or a scorer-set change falls
        # back to full scoring. Normalize/weighted-sum always re-run on
        # the full raw vector (min-max is a whole-set operation).
        mvv = state.read_or(MAX_KEY)
        mv_t = (mvv.bandwidth, mvv.clock, mvv.core, mvv.free_memory,
                mvv.power, mvv.total_memory) if mvv is not None else None
        usage = state.read_or(SLICE_USE_KEY) or {}
        names_set = tuple(p.name for p in scorers)
        repairable = feas_ok and all(
            getattr(p, "score_inputs", None) in ("node", "node+slice_usage")
            for p in scorers)
        dirty_s = None
        hit = self._score_memo.get(memo_key) if repairable else None
        if hit is not None and hit[1] == mv_t and hit[3] == names_set:
            _, dirty_s = self._changes_since_vers(hit[0])
        cached_usage = hit[2] if hit is not None else {}
        if scorers:
            # equilibrium memo-churn gauge: how often steady-state
            # arrivals land on a replayable score memo vs forcing a full
            # rescore (bench.run_serve_steady folds these into a rate)
            self.metrics.inc("score_memo_hits_total" if dirty_s is not None
                             else "score_memo_misses_total")
        # columnar batch scoring: on memo-MISS cycles (first of a class,
        # maxima moved, candidate set changed) plugins exposing
        # score_batch evaluate ALL candidates in one array expression
        # (normalize then becomes one broadcast over the raw vector).
        # When the score-class memo replay is available it stays
        # preferred — replaying ~want cached floats beats recomputing
        # them, vectorized or not; plugins without a batch form
        # (topology sub-block search, admission preferences) keep the
        # scalar loop either way.
        # candidate row-index array, resolved lazily on the first
        # memo-miss cycle that can use batch scoring (sync is idempotent
        # per version vector — the repair path usually already paid it)
        col_rows = None
        # under the commit plane, batch scoring also arms on fused-native
        # cycles: the fused kernel carries no topology term, so on a nat
        # memo-miss TopologyScore would otherwise scalar-loop over every
        # candidate — exactly the per-pod Python the plane removes (the
        # sync below is a version-vector no-op there; the nat scan paid it)
        if ((nat is None or self._commitk is not None) and dirty_s is None
                and self._columnar is not None
                and vers is not None and scorers):
            if self._columnar.sync(snapshot, vers, self._changes_since_vers):
                col_rows = self._columnar.rows_for(feasible)
        raws: dict[str, dict[str, float]] = {}
        # per-plugin folds are DEFERRED: when every plugin declares its
        # normalize shape, the whole stack folds in one fused pass over
        # the candidate matrix (_fold_all_scores) — op-for-op the same
        # floats as folding each plugin in turn, minus a Python loop
        # over ~want candidates per scorer per cycle
        fold_jobs: list = []
        for p in scorers:
            if nat is not None:
                nraw = nat.raws.get(p.name)
                if nraw is not None:
                    # raw terms straight from the fused kernel; the fold
                    # stays in profile order so mixed native/Python
                    # cycles accumulate bit-identically. When EVERY
                    # scorer was native the kernel also fused
                    # normalize+sum (nat.totals, applied below).
                    raws[p.name] = nraw
                    if nat.totals is None:
                        fold_jobs.append((p, nraw))
                    continue
            raw: dict[str, float] = {}
            if col_rows is not None:
                sb = getattr(p, "score_batch", None)
                arr = sb(state, pod, self._columnar, col_rows) \
                    if sb is not None else None
                if arr is not None:
                    for i, node in enumerate(feasible):
                        raw[node.name] = float(arr[i])
                    self.metrics.inc("columnar_score_batches_total")
                    raws[p.name] = raw
                    fold_jobs.append((p, raw))
                    continue
            cached = hit[4].get(p.name, {}) if dirty_s is not None else {}
            slice_coupled = (getattr(p, "score_inputs", None)
                             == "node+slice_usage")
            for node in feasible:
                name = node.name
                if dirty_s is not None and name not in dirty_s:
                    m = node.metrics
                    sid = m.slice_id if m is not None else None
                    if (not (slice_coupled and sid
                             and usage.get(sid) != cached_usage.get(sid))
                            and name in cached):
                        raw[name] = cached[name]
                        continue
                s, st = p.score(state, pod, node)
                if st.code == Code.ERROR:
                    return self._cycle_error(info, trace, st.message)
                raw[name] = s
            raws[p.name] = raw
            fold_jobs.append((p, raw))
        if nat is not None and nat.totals is not None:
            totals = nat.totals
        else:
            self._fold_all_scores(state, pod, fold_jobs, feasible, totals)
        if repairable and vers is not None:
            if len(self._score_memo) > 256:
                self._score_memo.clear()
            self._score_memo[memo_key] = (vers, mv_t, usage, names_set,
                                          raws)
        trace.scores = totals

        best_score = max(totals.values())
        best_nodes = [n for n, s in totals.items() if s == best_score]
        chosen = self.rng.choice(best_nodes)
        if rec is not None:
            rec.record("cycle.score", pod.key, t_score0, self.clock.time(),
                       {"scorers": [p.name for p in scorers],
                        "chosen": chosen})

        # arm the batch commit loop (schedule_batch): classmates popped
        # with this pod may commit against this cycle's candidate ranking
        # via incremental updates — but ONLY when the whole cycle ran
        # inside the class-memo soundness envelope (feas_ok + declared
        # score inputs, i.e. `repairable`) and every normalize/prescore
        # step has an exact incremental form. Anything else leaves the
        # context un-armed and the classmates take per-pod cycles.
        if (batch_ctx is not None and repairable and vers is not None
                and HAVE_NUMPY
                and all(getattr(p, "pre_score_update", None) is not None
                        for p in self.profile.pre_score)
                and all(self._normalize_kind(p) in ("identity", "minmax")
                        for p in scorers)):
            batch_ctx.arm(
                state=state, spec=spec, memo_key=memo_key, want=want,
                scorers=scorers,
                candidates=list(feasible),
                raws={pn: dict(r) for pn, r in raws.items()},
                names_set=names_set, vers=vers, usage=usage, mv_t=mv_t,
                chosen=chosen)

        # Reserve
        info.commit_started = self.clock.time()  # e2e: commit phase opens
        reserved: list[ReservePlugin] = []
        for p in self.profile.reserve:
            try:
                st = p.reserve(state, pod, chosen)
            except Exception:
                # a RAISING reserve plugin must not leak the partial
                # reservation chain; the engine's containment then
                # quarantine-tracks the crash
                self._unwind_reserved(reserved, state, pod, chosen)
                raise
            if not st.ok:
                for r in reversed(reserved):
                    r.unreserve(state, pod, chosen)
                return self._unschedulable(info, trace,
                                           f"reserve: {st.message}",
                                           rejected_by=(p.name,))
            reserved.append(p)
        if rec is not None:
            rec.record("cycle.reserve", pod.key, info.commit_started,
                       self.clock.time(), {"node": chosen})

        # Permit
        t_permit0 = self.clock.time() if rec is not None else 0.0
        for p in self.profile.permit:
            try:
                st, timeout = p.permit(state, pod, chosen)
            except Exception:
                self._unwind_reserved(reserved, state, pod, chosen)
                raise
            if st.code == Code.WAIT:
                self.waiting[pod.key] = _WaitingPod(info, chosen, now + timeout)
                self.metrics.inc("pods_waiting_total")
                self._finish(trace, "waiting", node=chosen, reason=st.message)
                return "waiting"
            if not st.ok:
                for r in reversed(reserved):
                    r.unreserve(state, pod, chosen)
                return self._unschedulable(info, trace,
                                           f"permit: {st.message}",
                                           rejected_by=(p.name,))
        if rec is not None and self.profile.permit:
            rec.record("cycle.permit", pod.key, t_permit0,
                       self.clock.time(), {"node": chosen})

        # Bind this pod, then any gang peers its admission released
        if not self._bind(info, chosen, trace):
            # anchor bind failed: the gang (if any) must not half-bind —
            # reject the waiting peers now instead of letting them park
            # until the Permit deadline with reservations held
            if self.gang_permit is not None:
                gang = self.gang_permit.gang_of(pod)
                if gang:
                    self._fail_gang(gang)
            return "bind-error"
        if self.gang_permit is not None:
            peers_ok = True
            for peer_key in self.gang_permit.peers_to_approve(pod):
                if not self._bind_waiting_peer(peer_key):
                    peers_ok = False
            if spec.is_gang and self.allocator is not None and peers_ok:
                # gang FULLY bound: its slice entitlement (if it preempted
                # its way in) is consumed. A failed peer bind keeps the
                # hold — the straggler needs its refill window protected
                # until it re-binds (the entitlement expiry bounds the
                # worst case).
                self.allocator.unnominate_gang(spec.gang_name)
        return "bound"

    # ------------------------------------------------------------ sub-steps
    @staticmethod
    def _unwind_reserved(reserved, state, pod, node) -> None:
        """Best-effort rollback of a partial reservation chain after a
        RAISING reserve/permit plugin, with REAL cycle state (gang plan
        decrements need the snapshot + chosen node — _contain_crash's
        bare backstop sweep cannot reconstruct them). Swallows unreserve
        errors: the original crash must reach the engine's containment,
        not be masked by a secondary failure. Shared by the per-pod and
        batch-commit reserve/permit loops so the unwind contract has one
        definition."""
        for r in reversed(reserved):
            try:
                r.unreserve(state, pod, node)
            except Exception:
                pass

    @staticmethod
    def _normalize_kind(p) -> str | None:
        """Resolve a score plugin's declared normalize shape
        (framework.ScorePlugin.normalize_kind); a plugin that never
        overrode `normalize` is identity without declaring it."""
        kind = getattr(p, "normalize_kind", None)
        if kind is not None:
            return kind
        if type(p).normalize is ScorePlugin.normalize:
            return "identity"
        return None

    def _fold_scores(self, state, pod, p, raw, totals) -> None:
        """Normalize + weighted-sum one plugin's raw scores into totals.
        Plugins with a declared normalize shape get the normalization
        FUSED into the accumulation — op-for-op the same floats as
        normalize-then-sum, minus the per-cycle dict copy and second dict
        walk (the score-replay allocations were a measured slice of the
        1000-node drain's ~170 us/bind floor). Undeclared shapes keep the
        generic copy-then-normalize path unchanged."""
        w = getattr(p, "weight", 1)
        kind = self._normalize_kind(p)
        if kind == "identity":
            for name, s in raw.items():
                totals[name] += w * s
            return
        if kind == "minmax" and raw:
            # exactly framework.min_max_normalize(lo=0, hi=100) followed
            # by `totals[name] += w * s`, with the temporary dict elided
            vals = raw.values()
            lowest = min(vals)
            highest = max(vals)
            span = highest - lowest
            if span == 0:
                for name in raw:
                    totals[name] += w * 100.0
            else:
                for name, s in raw.items():
                    totals[name] += w * (0.0 + (s - lowest) * 100.0 / span)
            return
        nraw = dict(raw)  # normalize mutates: keep the memo's copy raw
        p.normalize(state, pod, nraw)
        for name, s in nraw.items():
            totals[name] += w * s

    def _columnar_rejectors(self, state, pod, filters) -> "set[str] | None":
        """First-failing-plugin attribution for a kernel-final EMPTY
        verdict, from the columnar masks: plugin p rejects a row iff the
        row survived every earlier filter and fails p's mask — exactly
        the scalar chain's early-exit attribution, one vectorized pass
        per plugin. None when any filter can't vectorize (the caller
        walks the scalar chain instead). The table already sits at the
        cycle's version (the native scan synced it)."""
        table = self._columnar
        if table is None:
            return None
        alive = None
        out: set[str] = set()
        for p in filters:
            fb = getattr(p, "filter_batch", None)
            bm = fb(state, pod, table) if fb is not None else None
            if bm is None:
                return None
            rejected = ~bm if alive is None else (alive & ~bm)
            if rejected.any():
                out.add(p.name)
            alive = bm if alive is None else (alive & bm)
        return out

    def _fold_all_scores(self, state, pod, jobs, feasible, totals) -> None:
        """Fold every deferred (plugin, raw) pair into `totals`. When
        every plugin declares a vectorizable normalize shape and the
        candidate set is big enough to matter, ONE pass over the raw
        matrix — the fused native fold (IncrementalKernels.batch_fold)
        or its numpy twin — replaces the per-plugin per-candidate Python
        loops; both perform exactly _fold_scores' IEEE ops in the same
        order, so every total is bit-identical (the batch parity fuzz
        pins the same fold in _commit_batch). Undeclared shapes and
        small sets keep the per-plugin dict fold."""
        n = len(feasible)
        if (HAVE_NUMPY and n >= 16 and jobs
                and all(self._normalize_kind(p) in ("identity", "minmax")
                        for p, _ in jobs)):
            names = [ni.name for ni in feasible]
            smat = np.empty((len(jobs), n), dtype=np.float64)
            for k, (_p, raw) in enumerate(jobs):
                smat[k] = [raw[nm] for nm in names]
            kinds = np.asarray(
                [1 if self._normalize_kind(p) == "minmax" else 0
                 for p, _ in jobs], dtype=np.int64)
            ws = np.asarray([float(getattr(p, "weight", 1))
                             for p, _ in jobs], dtype=np.float64)
            nk = self._incremental
            tot = np.empty(n, dtype=np.float64)
            if nk is not None:
                ties = np.empty(n, dtype=np.int64)
                got = nk.batch_fold(smat, kinds, ws, n, tot, ties)
            else:
                got = -1
            if got <= 0:  # no kernel (or malformed): the numpy twin
                tot = _numpy_fold(smat, kinds, ws, n)
            for nm, v in zip(names, tot.tolist()):
                totals[nm] = v
            return
        for p, raw in jobs:
            self._fold_scores(state, pod, p, raw, totals)

    def _run_post_filter(self, info: QueuedPodInfo, trace: CycleTrace,
                         state: CycleState, pod: Pod, spec, snapshot,
                         now: float, only_nodes: set | None = None
                         ) -> str | None:
        """PostFilter (preemption): the plugin plans, the engine evicts.
        Returns "preempting" when a plan was executed, None when no plugin
        produced one. `only_nodes` restricts planning to the named nodes
        (the unschedulable-class repair path: only dirty nodes can have
        become curable) — callers pass it only when every post-filter
        plugin advertises `supports_restricted`."""
        if self.policy is not None and self.policy.quotas:
            # per-tenant preemption budgets: hand the planner a victim
            # predicate so budget-exhausted tenants' pods drop out of
            # the candidate pools and plans route AROUND them (the
            # whole-plan admits() below stays the exact backstop)
            budgets = self.policy.budgets
            state.write("victim_budget_ok",
                        lambda v: budgets.has_budget(tenant_of(v), now))
        if self.elastic is not None:
            # elastic shrink-to-min: surplus members of bound elastic
            # gangs join the victim pools (preempt._make_shrink_ok) —
            # the cheaper alternative to untouchable gangs, still under
            # the PDB ledger and the tenant budgets above
            state.write("elastic_shrinkable", True)
        for p in self.profile.post_filter:
            if only_nodes is not None:
                nominated, victims, st = p.post_filter(
                    state, pod, snapshot, trace.filter_verdicts,
                    only_nodes=only_nodes)
            else:
                nominated, victims, st = p.post_filter(
                    state, pod, snapshot, trace.filter_verdicts)
            if st.ok and nominated is not None:
                # harvest-class victims (scv/harvest) are evicted for
                # FREE: they never pass through the budget gate below,
                # never charge a tenant's rolling budget, and count
                # harvest_evictions_total{reason} instead of the
                # per-tenant victim attribution — the planner already
                # kept them out of the PDB ledger
                budgeted = [v for v in victims if not is_harvest(v)]
                # per-tenant preemption budgets (scheduler/policy/): a
                # plan that would overdraw ANY victim tenant's rolling
                # budget is refused whole — the preemptor stays
                # unschedulable until budgets refill or capacity frees.
                # Gated BEFORE any eviction, so a budget can never be
                # half charged; the PDB ledger already ranked plans
                # below the budget layer, so both protections hold.
                if (self.policy is not None
                        and not self.policy.budgets.admits(budgeted, now)):
                    # admits() counted the denial per budget level
                    # (preemptions_budget_denied_total{tenant})
                    self.flight.record(
                        "preemption_budget_denied", pod=pod.key,
                        victims=len(victims))
                    continue
                # on a real API server evict() is a DELETE: the victim's
                # controller recreates it as a new incarnation which the
                # serve loop submits — requeueing the dead object locally
                # would race it (same contract as Descheduler.run_once)
                local = getattr(self.cluster, "supports_local_requeue", False)
                if self.policy is not None:
                    self.policy.budgets.charge(budgeted, now)
                for victim in victims:
                    victim_harvest = is_harvest(victim)
                    self.cluster.evict(victim)
                    self.metrics.inc("pods_evicted_total")
                    if victim_harvest:
                        self.metrics.inc("harvest_evictions_total",
                                         labels={"reason": "preemption"})
                    if self.elastic is not None:
                        try:
                            vspec = spec_for(victim)
                        except LabelError:
                            vspec = None
                        if (vspec is not None and vspec.is_gang
                                and vspec.gang_min > 0):
                            # shrink-to-min: the donor gang drops one
                            # member (never below min — the planner's
                            # surplus accounting guarantees it) and its
                            # re-placed member will re-grow it
                            self.elastic.on_member_evicted(
                                vspec, reason="preemption")
                    if self.policy is not None and not victim_harvest:
                        # per-tenant disruption attribution: who LOST a
                        # pod to preemption. A DISTINCT family from the
                        # flat plan counter below — mixing victim-count
                        # labels into preemptions_total would make
                        # sum() over that family read plans + victims.
                        # Harvest victims counted above instead: the
                        # harvested tenant did not "lose" protected work
                        self.metrics.inc("preemption_victims_total",
                                         labels={"tenant": tenant_of(victim)})
                    if local:
                        router = self.victim_router or self.submit
                        if not router(victim):
                            self.metrics.inc("preempt_victims_unrouted_total")
                if self.allocator is not None:
                    # hold the freed capacity until the preemptor binds
                    # or fails — otherwise requeued victims (or co-hosted
                    # profiles) refill the hole and the preemptor
                    # livelocks. A gang holds its whole SLICE (per-host
                    # chips, bounded by an expiry so an abandoned gang
                    # can't block the slice forever).
                    if spec.is_gang:
                        ni = snapshot.get(nominated)
                        slice_id = (ni.metrics.slice_id
                                    if ni is not None and ni.metrics
                                    else "")
                        self.allocator.nominate_gang(
                            spec.gang_name, slice_id, spec.chips,
                            spec.priority,
                            expires_at=now + 2 * self.config.gang_timeout_s,
                            cpu_millis=pod.cpu_millis,
                            memory_bytes=pod.memory_bytes)
                    else:
                        self.allocator.nominate(
                            pod.key, nominated, spec.chips, spec.priority,
                            cpu_millis=pod.cpu_millis,
                            memory_bytes=pod.memory_bytes,
                            host_ports=pod.host_ports)
                self.metrics.inc("preemptions_total")
                # budget-violating preemptions are legal (best-effort,
                # upstream semantics) but operators need to SEE them
                viol = state.read_or("preempt_pdb_violations", 0)
                if viol:
                    self.metrics.inc("preempt_pdb_violations_total", viol)
                info.last_failure = f"preempting on {nominated}"
                self.queue.requeue_immediate(info, now=self.clock.time())
                self._finish(trace, "preempting", reason=info.last_failure)
                return "preempting"
        return None

    def _bind(self, info: QueuedPodInfo, node: str, trace: CycleTrace) -> bool:
        """Bind through the configured binder. On failure (API outage
        outlasting the client's retry budget, pod deleted, bound elsewhere)
        the reservation is rolled back and the pod requeued with backoff —
        an escaped exception here used to strand the pod Pending forever.

        Backends exposing bind_async (the real-API KubeCluster) get
        upstream kube-scheduler's binding-cycle model: the cache is
        updated optimistically and the POST runs on a binder worker while
        this engine moves to the next pod; a terminal wire failure rolls
        the cache back (freeing the chips — allocation accounting follows
        the cache) and re-enters the pod through _async_bind_failed."""
        pod = info.pod
        rec = self.spans if self._sampled(pod) else None
        entry = self.allocator.assignment_of(pod) if self.allocator is not None else None
        coords = entry[1] if entry is not None else None
        dispatched_async = False
        fence = None
        if self.fence_provider is not None:
            fence = self.fence_provider(pod, node)
            if fence is FENCE_LOST:
                # shard lease lost between cycle start and commit: abort
                # cleanly through the unwind path — reservation released,
                # capacity event for parked pods, attempt-free retry (the
                # pod did nothing wrong; the next cycle re-places it,
                # possibly unfenced on a shard we no longer prefer)
                if self.allocator is not None:
                    self.allocator.unreserve(CycleState(), pod, node)
                    self.notify_event(ClusterEvent(POD_DELETED, node=node,
                                                   origin=pod.key))
                self.metrics.inc("lease_lost_aborts_total")
                self.flight.record("fence_abort", pod=pod.key, node=node)
                self.queue.requeue_immediate(info, now=self.clock.time())
                self._finish(trace, "lease-lost", node=node,
                             reason="shard lease lost mid-cycle")
                return False
        fence_kw = {} if fence is None else {"fence": fence}
        t_wire0 = self.clock.time()
        try:
            if self.profile.bind is not None:
                self.profile.bind.bind(CycleState(), pod, node)
            else:
                bind_async = getattr(self.cluster, "bind_async", None)
                # GANG members always bind synchronously: the anchor-fail
                # _fail_gang rollback, the peers_ok gate, and the slice
                # entitlement release below all read _bind's return value
                # — dispatch-time success would neuter the all-or-nothing
                # invariants (a half-bound gang with its entitlement
                # released). Singles get the async binding cycle.
                is_gang_member = (self.gang_permit is not None
                                  and self.gang_permit.gang_of(pod))
                if (bind_async is not None and self.config.async_binding
                        and not is_gang_member):
                    # pass coords through: real-API backends publish them
                    # as the chip-assignment annotation so the claim
                    # survives a scheduler restart. The preemptor's
                    # NOMINATION is consumed only on wire success (the
                    # entitlement must survive a transient bind failure,
                    # same as the sync failure path below); the callbacks
                    # touch only thread-safe state — queue recovery is
                    # marshalled back onto the engine thread via
                    # _bind_results (the queue itself is engine-thread
                    # only).
                    dispatched_async = True
                    on_fail = (lambda p, n, e, _info=info:
                               self._bind_results.append((_info, n, e)))
                    on_success = self._async_bind_succeeded
                    sem = self._dispatch_sem
                    if sem is not None:
                        # bounded dispatch window: block until a slot
                        # frees (wire completion releases it). Release
                        # exactly once per dispatch — through whichever
                        # callback fires, or on a SYNCHRONOUS dispatch
                        # exception (pipelined backends raise 409s
                        # through dispatch itself, before any callback).
                        sem.acquire()
                        released = [False]

                        def _rel():
                            if not released[0]:
                                released[0] = True
                                sem.release()

                        on_fail = (lambda p, n, e, _info=info,
                                   _inner=on_fail:
                                   (_rel(), _inner(p, n, e)) and None)
                        on_success = (lambda p, n, _inner=on_success:
                                      (_rel(), _inner(p, n)) and None)
                        try:
                            bind_async(pod, node, coords, on_fail=on_fail,
                                       on_success=on_success, **fence_kw)
                        except Exception:
                            _rel()
                            raise
                    else:
                        bind_async(pod, node, coords, on_fail=on_fail,
                                   on_success=on_success, **fence_kw)
                else:
                    self.cluster.bind(pod, node, coords, **fence_kw)
        except Exception as e:
            # lost-response recovery (satellite of the chaos work): before
            # rolling back, ask the cluster whether the bind actually
            # LANDED — a failure after the server applied the mutation
            # (fake fault -1, KubeClient AmbiguousRequestError whose
            # confirm GET also failed) must be ADOPTED, not replayed:
            # requeueing a bound pod is the duplicate-bind window.
            bound_to = None
            bn = getattr(self.cluster, "bound_node_of", None)
            if bn is not None:
                try:
                    bound_to = bn(pod.key)
                except Exception:
                    bound_to = None
            if self._is_authority_conflict(e):
                # server-returned conflict — the apiserver's 409 or a
                # bind-authority webhook denial: a FOREIGN replica's
                # commit beat ours (optimistic shared-state scheduling),
                # never a wire failure, never the breaker. Checked BEFORE the
                # adoption branch: a 409 means our POST was REJECTED, so
                # even bound_to == node is someone else's same-key win on
                # the same node (our own landed-but-409-on-replay case is
                # resolved inside KubeClient.bind and never raises) —
                # adopting it through the ambiguous tail would overwrite
                # the winner's chip assignment with our coords.
                return self._bind_conflict(info, node, trace, e, bound_to)
            if bound_to != node:
                self._breaker_failure(e)
                if self.allocator is not None:
                    # release the pending reservation; keep any nomination (a
                    # preemptor's entitlement survives a transient bind failure)
                    self.allocator.unreserve(CycleState(), pod, node)
                    # freed reservation = capacity event for OTHER parked pods
                    self.notify_event(ClusterEvent(POD_DELETED, node=node,
                                                   origin=pod.key))
                self.metrics.inc("bind_errors_total")
                self._unschedulable(info, trace, f"bind failed: {e}",
                                    outcome="bind-error")
                return False
            # the cluster shows OUR bind: the wire failed, the mutation
            # did not — fall through to the ordinary success tail
            self.metrics.inc("ambiguous_bind_recoveries_total")
            self._breaker_success()
        else:
            if not dispatched_async:
                # a synchronous wire success is the breaker's probe signal
                # (async successes report in order via _bind_results)
                self._breaker_success()
        # wire phase closes here: for sync backends this is the real bind
        # RTT (retries and confirm GETs included); for async dispatch it
        # is the dispatch cost — the binder-measured RTT lands in the
        # cluster's bind_wire_ms histogram instead
        wire_end = self.clock.time()
        wire_s = max(wire_end - t_wire0, 0.0)
        if rec is not None:
            rec.record("bind_wire", pod.key, t_wire0, wire_end,
                       {"node": node, "dispatched_async": dispatched_async})
        if self.allocator is not None:
            if not dispatched_async:
                # reservation + entitlement consumed in one lock round
                # (async dispatch defers unnominate to wire success)
                self.allocator.finish_bind(pod)
            else:
                self.allocator.complete(pod)  # reservation consumed
        if coords is not None and not dispatched_async:
            # publish the chip assignment on the pod regardless of binder,
            # so allocation accounting sees it next cycle (bind_async set
            # it itself at dispatch — re-setting here would race the
            # binder rollback's label pop on a fast failure)
            pod.labels[ASSIGNED_CHIPS_LABEL] = format_assigned_chips(coords)
        now_b = self.clock.time()
        e2e_ms = (now_b - info.enqueued) * 1e3
        self.metrics.observe("schedule_latency_ms", e2e_ms)
        # per-class decomposition (gang / multi-chip / gpu / unlabeled ...):
        # aggregate p50 hides class-level regressions behind class mix
        cls = workload_class(pod)
        cname = _LABEL1_CACHE.get(("_lat_cls", cls))
        if cname is None:
            cname = "schedule_latency_ms_class_" + cls
            _LABEL1_CACHE[("_lat_cls", cls)] = cname
        self.metrics.observe(cname, e2e_ms)
        if self.slo is not None:
            # serving-SLO feed: every scv/serving bind's enqueue->bind
            # latency scores against its scv/slo-ms target — the burn-
            # rate monitor's only input signal (starvation is caught
            # separately by the guard's parked-serving check)
            try:
                sspec = spec_for(pod)
            except LabelError:
                sspec = None
            if sspec is not None and sspec.serving and sspec.slo_ms > 0:
                self.slo.observe(e2e_ms, sspec.slo_ms, now_b)
        # e2e latency decomposition: the queue/engine stamps partition this
        # pod's enqueue->bind interval into queue-wait (active + backoff),
        # cycle compute (every attempt's pre-commit work), commit
        # (reserve/permit/bookkeeping) and wire — bench.e2e_breakdown
        # reads these histograms, and their p50s must cover >=95% of the
        # measured e2e p50 (the CI fence)
        if info.commit_started >= 0.0 and info.cycle_started >= 0.0:
            compute_s = info.t_cycle + max(
                info.commit_started - info.cycle_started, 0.0)
            commit_s = max(now_b - info.commit_started - wire_s, 0.0)
            self.metrics.observe("e2e_queue_wait_ms", info.t_queue * 1e3)
            self.metrics.observe("e2e_cycle_compute_ms", compute_s * 1e3)
            self.metrics.observe("e2e_commit_ms", commit_s * 1e3)
            self.metrics.observe("e2e_wire_ms", wire_s * 1e3)
        self.metrics.inc("pods_scheduled_total")
        if self.policy is not None:
            # fold the bind into the DRF book (one dirty node off the
            # change log), retire any gang in-flight claim, and
            # republish per-tenant shares/breaches
            self.policy.on_bind(pod)
            self.policy.resolved(pod.key)
        if self.elastic is not None:
            # elastic-gang bookkeeping: a bind into a gang admitted below
            # desired size is a GROW (gang_grow_total); reaching desired
            # retires the growing record. Gang members always bind
            # synchronously, so this is wire-proven, never dispatch-time.
            try:
                bspec = spec_for(pod)
            except LabelError:
                bspec = None
            if bspec is not None and bspec.is_gang and bspec.gang_min > 0:
                self.elastic.on_member_bound(
                    self.cluster, bspec,
                    n_bound=self._bound_members_of(bspec.gang_name))
        if not dispatched_async:
            # Scheduled is posted on WIRE success only (upstream posts it
            # after the binding subresource lands): sync binds and adopted
            # ambiguous binds are proven here; async dispatches post from
            # _async_bind_succeeded, so a terminal wire failure never
            # leaves a false Scheduled trail behind a Pending pod
            self._post_scheduled_event(pod, node)
        self._finish(trace, "bound", node=node)
        return True

    def _post_scheduled_event(self, pod, node: str) -> None:
        post = getattr(self.cluster, "post_event", None)
        if post is not None:
            try:
                post(pod, "Scheduled",
                     f"Successfully assigned {pod.key} to {node}")
            except Exception:
                pass  # observability must never fail a bind

    def _bind_conflict(self, info: QueuedPodInfo, node: str,
                       trace: CycleTrace, err: Exception,
                       bound_to: str | None,
                       release_reservation: bool = True) -> bool:
        """A server-returned 409 rejected our optimistic commit — the
        scheduler-fleet conflict path. Two shapes:

        - FOREIGN-BIND conflict (`bound_to` names another node, or the
          pod reads BOUND): another replica won the pod. Drop our queue
          entry off cluster truth — requeueing would loop 409 forever.
        - NODE-CLAIM conflict (pod still unbound): a foreign bind landed
          on our chosen node between snapshot and commit, so our rows
          were stale. The foreign bind already bumped the change log —
          the next cycle's snapshot repair re-filters exactly the dirty
          rows — so retry locally, attempt-free (the pod did nothing
          wrong). A pathological conflict streak falls back to the
          ordinary backoff path so a livelock can't hot-spin the engine.

        Either way the server ANSWERED: a 409 is proof of a live
        apiserver, so it feeds the breaker's success side, never its
        failure count. Shared by the sync bind path and the async drain
        (`release_reservation=False` there: the reservation was already
        consumed at dispatch and the binder rolled its cache back)."""
        pod = info.pod
        self.metrics.inc("bind_conflicts_total")
        self.flight.record(
            "bind_conflict", pod=pod.key, node=node,
            resolution=("foreign-bind"
                        if bound_to is not None
                        or pod.phase == PodPhase.BOUND else "node-claim"))
        self._breaker_success()
        if release_reservation and self.allocator is not None:
            self.allocator.unreserve(CycleState(), pod, node)
            # the freed reservation is a capacity event for parked pods
            self.notify_event(ClusterEvent(POD_DELETED, node=node,
                                           origin=pod.key))
        if bound_to is not None or pod.phase == PodPhase.BOUND:
            if self.allocator is not None:
                self.allocator.unnominate(pod.key)
            if bound_to is not None and pod.node != bound_to:
                # our copy disagrees with cluster truth (stale Pending on
                # a wire backend, or a hypothetical optimistic write to
                # the losing node): adopt the winner's node. The chip
                # annotation is the winner's to publish — ours was never
                # set on the sync path, and the async binder rolled its
                # optimistic label back before reporting.
                pod.node = bound_to
                pod.phase = PodPhase.BOUND
            self.metrics.inc("foreign_bind_conflicts_total")
            self._finish(trace, "foreign-bound", node=pod.node,
                         reason=str(err))
            return False
        info.conflicts += 1
        if info.conflicts >= 8:
            # losing 8 straight optimistic races means the cluster is
            # pathologically contended (or our view persistently stale):
            # back off like an ordinary unschedulable pod instead of
            # spinning attempt-free retries
            info.conflicts = 0
            self._unschedulable(info, trace, f"bind conflict: {err}",
                                outcome="bind-conflict")
            return False
        self.metrics.inc("bind_conflict_retries_total")
        self.queue.requeue_immediate(info, now=self.clock.time())
        self._finish(trace, "bind-conflict", node=node, reason=str(err))
        return False

    def _async_bind_succeeded(self, pod, node) -> None:
        """on_success callback for dispatched binds, run on a BINDER
        thread: consume the preemptor entitlement (wire success is when
        the nomination is provably spent) and record the wire-healthy
        signal IN ORDER with any failures — the engine folds the deque
        sequentially, so a success only resets the breaker streak for
        failures that actually preceded it (the breaker counters
        themselves stay engine-thread-only)."""
        if self.allocator is not None:
            self.allocator.unnominate(pod.key)
        self._post_scheduled_event(pod, node)  # wire-proven, like the sync path
        self._bind_results.append(None)

    @staticmethod
    def _is_authority_conflict(e: Exception) -> bool:
        """A server-side REJECTION of our commit: the apiserver's own
        409, or a pods/binding admission-webhook denial — which a real
        apiserver surfaces with the WEBHOOK's status code (ours sets
        409; third-party authorities commonly 400/403). Either way the
        authority ANSWERED and refused, so the verdict takes the
        conflict path (foreign-bind adopt / attempt-free local retry),
        never the breaker and never the bind-error backoff. The denial
        shape itself has ONE definition (k8s.client.is_webhook_denial —
        imported lazily: this is the error path, and core must not
        import the k8s package at module load)."""
        if getattr(e, "status", None) == 409:
            return True
        from ..k8s.client import is_webhook_denial

        return is_webhook_denial(e)

    @staticmethod
    def _is_wire_failure(e: Exception) -> bool:
        """Only WIRE-class bind failures feed the breaker: connection
        drops, timeouts, and transport errors surfaced with status 0
        (k8s ApiError wrapping an ambiguous/connection failure). A
        server-RETURNED status (409 conflict, 404 pod gone) is proof the
        apiserver is alive — counting those would park scheduling on a
        healthy-but-contended cluster."""
        status = getattr(e, "status", None)
        if status is not None:
            return status == 0
        return isinstance(e, (ConnectionError, TimeoutError, OSError))

    def _breaker_failure(self, e: Exception) -> None:
        """One more consecutive bind WIRE failure (engine thread only;
        non-wire errors are ignored — see _is_wire_failure). At the
        threshold the breaker OPENS: run_one parks scheduling until the
        cooldown passes, so an apiserver error storm stops burning every
        queued pod's attempts/backoff against a dead server. Re-opening
        after a failed post-cooldown probe doubles the cooldown
        (capped), the classic half-open escalation."""
        if self.config.breaker_threshold <= 0:
            return
        if not self._is_wire_failure(e):
            return
        self._breaker_failures += 1
        if self._breaker_failures < self.config.breaker_threshold:
            return
        now = self.clock.time()
        if now >= self._breaker_until:
            self._breaker_until = now + self._breaker_cooldown
            self._breaker_cooldown = min(
                self._breaker_cooldown * 2,
                8 * self.config.breaker_cooldown_s)
            self.metrics.inc("breaker_opens_total")
            self.metrics.set_gauge("breaker_open", 1.0)
            # trip kind: auto-dumps the flight ring when a dump dir is
            # configured — the black box lands on disk WHILE the storm is
            # live, not after someone asks
            self.flight.record("breaker_open",
                               failures=self._breaker_failures,
                               cooldown_s=self._breaker_until - now,
                               error=f"{type(e).__name__}: {e}")

    def _breaker_success(self) -> None:
        """A bind reached the server: reset the failure streak and close
        an open breaker (engine thread only)."""
        if not self._breaker_failures and not self._breaker_until:
            return
        was_open = self._breaker_until > 0.0
        self._breaker_failures = 0
        self._breaker_until = 0.0
        self._breaker_cooldown = self.config.breaker_cooldown_s
        self.metrics.set_gauge("breaker_open", 0.0)
        if was_open:
            self.metrics.inc("breaker_closes_total")
            self.flight.record("breaker_close")

    def _drain_bind_failures(self) -> None:
        """Fold async wire outcomes and recover pods whose dispatched
        binds never reached the server. Binder workers only APPEND to
        the thread-safe _bind_results deque; the requeue itself runs
        HERE, on the engine thread (the SchedulingQueue has no internal
        lock — a binder-thread mutation would race pop()'s backoff flush
        and could drop the entry). Success markers are interleaved in
        arrival order, so the breaker streak resets exactly when the
        wire actually recovered — a stale pre-storm success cannot wipe
        newer failures, and a post-storm success closes an open breaker."""
        while True:
            try:
                item = self._bind_results.popleft()
            except IndexError:
                return
            if item is None:
                self._breaker_success()  # wire success, in sequence
                continue
            info, node, err = item
            pod = info.pod
            if self.tracks(pod.key):
                # the serve loop's intake raced the rollback and already
                # resubmitted the reverted pod: a second queue entry
                # would double-bind
                continue
            # lost-response adoption, the async twin of _bind's: when the
            # cluster ALREADY shows this pod bound to the reported node,
            # the POST landed and only the response died — the
            # dispatch-time optimistic accounting is correct as it
            # stands, so consume the nomination and move on instead of
            # requeueing a bound pod into a duplicate-bind loop
            bound_to = None
            bn = getattr(self.cluster, "bound_node_of", None)
            if bn is not None:
                try:
                    bound_to = bn(pod.key)
                except Exception:
                    bound_to = None
                if bound_to == node \
                        and not self._is_authority_conflict(err):
                    # ambiguous wire failure whose POST actually landed
                    # (a 409 is NOT this: the server REJECTED our POST,
                    # so a same-node bound_to is a foreign same-key win
                    # — conflict-resolved below, winner's chips intact)
                    if self.allocator is not None:
                        self.allocator.unnominate(pod.key)
                    self.metrics.inc("ambiguous_bind_recoveries_total")
                    self._post_scheduled_event(pod, node)  # landed after all
                    self._breaker_success()
                    continue
            if self._is_authority_conflict(err):
                # conflict, the async flavour: the binder already rolled
                # its cache (and our optimistic chip label) back before
                # reporting, and the dispatch-time reservation was
                # consumed — so only the pod's fields (shared-object
                # backends that never applied) and the queue need
                # attention before sharing the sync resolution logic.
                # The label is deliberately NOT popped in the foreign
                # case: on shared-object backends it is the WINNER's.
                # The dispatch-time success tail already counted this pod
                # in pods_scheduled_total/latency; record the correction
                # so per-replica bind shares can be computed exactly
                # (counters are monotonic — never decremented)
                self.metrics.inc("async_bind_conflict_corrections_total")
                trace = CycleTrace(pod=pod.key, started=self.clock.time())
                if bound_to is None:
                    if pod.node == node:
                        pod.phase = PodPhase.PENDING
                        pod.node = None
                        pod.labels.pop(ASSIGNED_CHIPS_LABEL, None)
                    self.notify_event(ClusterEvent(POD_DELETED, node=node,
                                                   origin=pod.key))
                self._bind_conflict(info, node, trace, err, bound_to,
                                    release_reservation=False)
                continue
            self._breaker_failure(err)
            pod.phase = PodPhase.PENDING
            pod.node = None
            pod.labels.pop(ASSIGNED_CHIPS_LABEL, None)
            self.metrics.inc("bind_errors_total")
            # the cache rollback freed the optimistically-claimed chips:
            # a capacity event for OTHER parked pods (the backend's own
            # DELETED event never fires — the bind never landed)
            self.notify_event(ClusterEvent(POD_DELETED, node=node,
                                           origin=pod.key))
            trace = CycleTrace(pod=pod.key, started=self.clock.time())
            # the dispatch-time success was already counted in
            # pods_scheduled_total/latency; the error counter plus the
            # bind-error trace record the correction
            self._unschedulable(info, trace, f"async bind failed: {err}",
                                outcome="bind-error")

    def _unschedulable(self, info: QueuedPodInfo, trace: CycleTrace, reason: str,
                       outcome: str = "unschedulable",
                       rejected_by: tuple = (),
                       gang_doom: bool = True) -> str:
        info.last_failure = reason
        # any orderly non-conflict outcome breaks a 409 streak: the
        # conflict counter means CONSECUTIVE optimistic-race losses, not
        # lifetime losses (see _bind_conflict's fallback)
        info.conflicts = 0
        # operator-facing trail (kubectl describe pod): backends with a
        # wire (KubeCluster) POST a FailedScheduling Event carrying the
        # same reason the cycle trace records — deduplicated and queued
        # off-thread there, a no-op on in-memory fakes
        post = getattr(self.cluster, "post_event", None)
        if post is not None:
            try:
                post(info.pod, "FailedScheduling", reason, type_="Warning")
            except Exception:
                pass  # observability must never fail the cycle
        if self.allocator is not None and self.allocator.has_pod_nominations():
            nom = self.allocator.nomination_of(info.pod.key)
            if (nom is not None and trace.filter_verdicts.get(nom[0]) != "ok"
                    and not any(p.terminating
                                for p in self.cluster.pods_on(nom[0]))):
                # the nominated node no longer fits this pod (chips went
                # unhealthy, telemetry stale, node gone): release the hold so
                # it doesn't block the node's capacity forever — upstream
                # clears nominatedNodeName the same way. While victims are
                # still draining (terminating pods present) the node is
                # EXPECTED to fail the filter, so the hold survives — this
                # is the whole point of nominatedNodeName semantics.
                self.allocator.unnominate(info.pod.key)
        if self.config.max_attempts and info.attempts + 1 >= self.config.max_attempts:
            if gang_doom:
                self._doom_gang_of(info, reason)
            # elastic growth members (gang_doom=False) fail ALONE: the
            # gang keeps running at its reduced size — permanently
            # failing a grow attempt must not tear the whole job down
            self._fail_permanently(info, reason, trace=trace)
            return "failed"
        for pname in rejected_by:
            # per-plugin rejection attribution (labeled metric): which
            # plugin is gating the pending backlog, by name
            self.metrics.inc("filter_rejections_total",
                             labels=_label1("plugin", pname))
        now = self.clock.time()
        if self.policy is not None:
            # starvation watch: a pod still unbound past the configured
            # threshold trips the flight recorder + per-tenant counter
            self.policy.note_wait(info.pod, now - info.enqueued)
        self.queue.requeue_backoff(info, now=now,
                                   rejected_by=tuple(rejected_by))
        self.metrics.inc("pods_unschedulable_total")
        self._finish(trace, outcome, reason=reason)
        return outcome

    def _doom_gang_of(self, info: QueuedPodInfo, reason: str) -> None:
        """A permanently-failed member dooms its gang: the remaining
        members can never reach gang-size with the current incarnations,
        so give the slice entitlement back and fail the peers too —
        parked ones NOW, backoff ones at their next cycle (their
        park->timeout->requeue loop counts no attempts, so they would
        otherwise never resolve). Shared by the max-attempts branch and
        crash quarantine; no-op for non-gang pods."""
        try:
            spec = spec_for(info.pod)
        except LabelError:
            return
        if not spec.is_gang:
            return
        if self.allocator is not None:
            self.allocator.unnominate_gang(spec.gang_name)
        doom = (f"gang {spec.gang_name}: member {info.pod.key} "
                f"permanently failed: {reason}")
        self.doomed_gangs[spec.gang_name] = doom
        while len(self.doomed_gangs) > 1024:
            # never-resubmitted doomed gangs would otherwise accumulate
            # forever; oldest doom evicts first (a revived-then-stale
            # entry only costs the evicted gang's members one extra
            # park/timeout round)
            self.doomed_gangs.pop(next(iter(self.doomed_gangs)))
        self._doom_parked_members(spec.gang_name, doom)

    def _contain_crash(self, info: QueuedPodInfo, e: Exception) -> str:
        """Cycle-level exception containment: a plugin RAISED somewhere in
        this pod's cycle. The engine thread survives unconditionally —
        the pod pays: its (possibly partial) reservation is defensively
        rolled back, the crash is counted, and the pod requeues with
        backoff until quarantine_threshold crashes mark it poison and
        fail it permanently (one malformed pod must not monopolise the
        engine with crash-requeue loops forever)."""
        pod = info.pod
        state = CycleState()
        try:
            state.write("workload_spec", spec_for(pod))
        except LabelError:
            pass
        # did the crashed cycle leave a pending reservation? (the in-loop
        # unwinds in the reserve/permit paths normally clear it with real
        # state; this backstop covers raise sites between them)
        entry = (self.allocator.assignment_of(pod)
                 if self.allocator is not None else None)
        for p in reversed(self.profile.reserve):
            # idempotent sweep: unreserve keys on the pod and tolerates
            # never-reserved pods, so crashes before Reserve cost nothing
            try:
                p.unreserve(state, pod, "")
            except Exception:
                pass
        if entry is not None:
            # the sweep freed reserved chips: a capacity event for OTHER
            # hint-parked pods, exactly like the bind-failure rollback
            # (origin keeps the crashed pod off its own event)
            self.notify_event(ClusterEvent(POD_DELETED, node=entry[0],
                                           origin=pod.key))
        info.crashes += 1
        self.metrics.inc("cycle_crashes_total")
        self.flight.record("cycle_crash", pod=pod.key,
                           error=f"{type(e).__name__}: {e}",
                           crashes=info.crashes)
        trace = CycleTrace(pod=pod.key, started=self.clock.time())
        reason = f"cycle crash: {type(e).__name__}: {e}"
        thresh = self.config.quarantine_threshold
        # quarantine only POISON pods; see __init__'s discriminator — an
        # engine-wide fault crashing pod after pod must not permanently
        # fail the whole pending workload
        systemic = (not self._ok_since_crash
                    and self._last_crash_key is not None
                    and self._last_crash_key != pod.key)
        self._ok_since_crash = False
        self._last_crash_key = pod.key
        if thresh and info.crashes >= thresh and not systemic:
            reason = (f"quarantined after {info.crashes} crashing cycles "
                      f"({type(e).__name__}: {e})")
            self.quarantined[pod.key] = reason
            while len(self.quarantined) > 1024:
                self.quarantined.pop(next(iter(self.quarantined)))
            self.metrics.inc("pods_quarantined_total")
            self.flight.record("quarantine", pod=pod.key, reason=reason)
            self._doom_gang_of(info, reason)
            self._fail_permanently(info, reason, trace=trace)
            return "quarantined"
        self.queue.requeue_backoff(info, now=self.clock.time())
        self._finish(trace, "crash", reason=reason)
        return "crash"

    def _cycle_error(self, info: QueuedPodInfo, trace: CycleTrace, reason: str) -> str:
        self.queue.requeue_backoff(info, now=self.clock.time())
        self.metrics.inc("cycle_errors_total")
        self._finish(trace, "error", reason=reason)
        return "error"

    def _finish(self, trace: CycleTrace, outcome: str, node: str | None = None,
                reason: str = "") -> None:
        now = self.clock.time()
        trace.finish(outcome, node=node, reason=reason, now=now)
        self.traces.add(trace)
        self.metrics.inc("scheduling_outcomes_total",
                         labels=_label1("outcome", outcome))
        if trace.plane:
            self.metrics.inc("cycle_plane_total",
                             labels=_label1("plane", trace.plane))
        if self._sampled_key(trace.pod):
            attrs = {"outcome": outcome}
            if trace.plane:
                attrs["plane"] = trace.plane
            if node:
                attrs["node"] = node
            if reason:
                attrs["reason"] = reason[:200]
            self.spans.record("cycle", trace.pod, trace.started, now, attrs)

    def _sampled_key(self, key: str) -> bool:
        """Span-sampling verdict from a bare pod key (call sites without
        the pod object — crash/failure traces)."""
        return span_sampled(key, self.config.trace_sampling)

    # -------------------------------------------------------- waiting / gangs
    def check_waiting(self) -> None:
        """Reject gangs whose Permit deadline passed; roll everything back."""
        now = self.clock.time()
        expired_gangs: set[str] = set()
        for key, w in list(self.waiting.items()):
            if w.deadline <= now:
                gang = self.gang_permit.gang_of(w.info.pod) if self.gang_permit else None
                if gang:
                    expired_gangs.add(gang)
                else:
                    self._rollback_waiting(key)
        for gang in expired_gangs:
            self.metrics.inc("gang_timeouts_total")
            self._fail_gang(gang)

    def _fail_gang(self, gang: str) -> None:
        """Tear a gang down: reject its parked members (reservations roll
        back, pods requeue with backoff) and release any slice entitlement
        it won by preemption. The policy engine's in-flight tenant quota
        claim — recorded when the quota gate ADMITTED the gang — is
        retired here too: a failed assembly holds no capacity, so leaving
        the claim to its TTL would gate same-tenant work against
        headroom nobody is using."""
        for key in self.gang_permit.fail_gang(gang):
            self._rollback_waiting(key)
        if self.allocator is not None:
            self.allocator.unnominate_gang(gang)
        if self.policy is not None:
            self.policy.gang_failed(gang)
        if self.elastic is not None:
            self.elastic.reset(gang)

    # ------------------------------------------------------- elastic gangs
    def _drain_elastic_retires(self) -> None:
        """Retire elastic bookkeeping for gangs whose members were
        deleted externally: a POD_DELETED carrying a
        gang label queued the gang here; if cluster truth now shows ZERO
        bound members, the gang is gone (or restarting from scratch) and
        its _growing/_first_seen/_pending_admission records must not
        survive to miscount grows and admissions when the name is
        reused. A SHRINK eviction never trips this — the gang keeps
        >= min members bound, so the count stays positive."""
        elastic = self.elastic
        seen: set[str] = set()
        while self._elastic_retires:
            try:
                gang = self._elastic_retires.popleft()
            except IndexError:
                break
            if gang in seen or elastic is None:
                continue
            seen.add(gang)
            if (gang in elastic._growing
                    or gang in elastic._first_seen
                    or gang in elastic._pending_admission) \
                    and self._bound_members_of(gang) == 0:
                elastic.reset(gang)
                self.metrics.inc("gang_elastic_retired_total")
                self.flight.record("elastic_gang_retired", gang=gang)

    def _bound_members_of(self, gang: str) -> int:
        """Cluster-truth bound member count, memoised on the version
        vector: growth members ask on every failed cycle, and between
        cluster changes the answer cannot move. Miss (or no versioned
        backend) falls through to the full pod walk."""
        from .elastic import bound_member_count

        vers = self._cluster_versions()
        if vers is None:
            return bound_member_count(self.cluster, gang)
        hit = self._gang_count_memo.get(gang)
        if hit is not None and hit[0] == vers:
            return hit[1]
        n = bound_member_count(self.cluster, gang)
        if len(self._gang_count_memo) > 4096:
            self._gang_count_memo.clear()  # churn backstop
        self._gang_count_memo[gang] = (vers, n)
        return n

    def _elastic_growth_park(self, info: QueuedPodInfo, spec,
                             trace: CycleTrace) -> str | None:
        """A gang member found no capacity, but its gang ALREADY runs at
        >= tpu/gang-min in cluster truth: it is a GROWTH member. Park it
        under the elastic-grow hint class (woken by POD_DELETED /
        NODE_ADDED) with the gang-doom path disarmed — a growth member
        exhausting max_attempts fails alone; the reduced-size gang keeps
        running. Returns the outcome, or None when not applicable."""
        if (self.elastic is None or not spec.is_gang
                or spec.gang_min <= 0
                or spec.gang_name in self.doomed_gangs):
            return None
        if self._bound_members_of(spec.gang_name) < spec.gang_min:
            return None
        from .elastic import ELASTIC_GROW_HINT

        return self._unschedulable(
            info, trace,
            f"gang {spec.gang_name}: running at reduced size, waiting "
            "for chips to grow", rejected_by=(ELASTIC_GROW_HINT,),
            gang_doom=False)

    def _bind_waiting_peer(self, peer_key: str) -> bool:
        """Bind a gang member parked at Permit off its held reservation —
        the peer-approve contract, shared by gang completion and elastic
        admit-at-min so the two paths cannot diverge. True unless the
        peer existed and its bind failed (a failed bind requeues the
        member through _bind's ordinary failure path)."""
        w = self.waiting.pop(peer_key, None)
        if w is None:
            return True
        return self._bind(w.info, w.node,
                          CycleTrace(pod=peer_key, started=w.info.enqueued))

    def _elastic_admit_at_min(self, info: QueuedPodInfo, spec,
                              trace: CycleTrace) -> str | None:
        """A gang member found no capacity and preemption produced no
        plan. If the gang has >= tpu/gang-min members placed (parked at
        Permit + bound), admit it AT THE CURRENT SIZE: bind the parked
        members now — their reservations are consumed, exactly the
        peer-approve path — and park THIS member (and, next cycles, any
        other unplaced member) for growth. Returns the outcome, or None
        when not applicable (the caller then takes the ordinary
        unschedulable path, assembly keeps waiting for full size)."""
        if (self.elastic is None or not spec.is_gang
                or spec.gang_min <= 0 or self.gang_permit is None
                or spec.gang_name in self.doomed_gangs):
            return None
        gang = spec.gang_name
        waiting = [k for k in self.gang_permit.gangs.waiting_members(gang)
                   if k in self.waiting]
        n_bound = self._bound_members_of(gang)
        if not waiting or n_bound + len(waiting) < spec.gang_min:
            return None
        # record the admission FIRST: the members binding right now are
        # the floor, not growth (on_member_bound decrements the initial
        # allowance before counting grows)
        self.elastic.note_admitted_at_min(gang, initial=len(waiting),
                                          reason="no-fit")
        for peer_key in self.gang_permit.fail_gang(gang):
            self._bind_waiting_peer(peer_key)
        # a peer bind can fail at the wire (outage): _bind requeued it
        # with backoff, but the gang must not stand "admitted" below min.
        # Withdraw the elastic record — the requeued members re-enter
        # CLASSIC assembly (permit counts cluster-truth bound members
        # toward completeness), so nothing is lost, and no below-min gang
        # is ever left running under an admitted-at-min banner.
        if self._bound_members_of(gang) < spec.gang_min:
            self.elastic.reset(gang)
            self.flight.record("elastic_admit_aborted", gang=gang,
                               reason="peer bind failed below min")
            return self._unschedulable(
                info, trace,
                f"gang {gang}: admit-at-min aborted (peer bind failed)",
                gang_doom=False)
        from .elastic import ELASTIC_GROW_HINT

        return self._unschedulable(
            info, trace,
            f"gang {gang}: admitted at min ({spec.gang_min}/"
            f"{spec.gang_size}), waiting for chips to grow",
            rejected_by=(ELASTIC_GROW_HINT,), gang_doom=False)

    def _doom_parked_members(self, gang: str, reason: str) -> None:
        """Permanently fail the gang's parked members (doomed-gang path:
        a peer exhausted its attempts, so assembly can never finish).
        Bound members are untouched — members only bind after the gang
        completed, at which point no assembly failure can occur."""
        if self.gang_permit is None:
            return
        for key in self.gang_permit.fail_gang(gang):
            w = self.waiting.pop(key, None)
            if w is None:
                continue
            self._unreserve_waiting(w)
            self._fail_permanently(w.info, reason)
        if self.policy is not None:
            # the doomed gang's in-flight tenant quota claim dies with it
            self.policy.gang_failed(gang)
        if self.elastic is not None:
            self.elastic.reset(gang)

    def _fail_permanently(self, info: QueuedPodInfo, reason: str,
                          trace: CycleTrace | None = None) -> None:
        """Terminal failure bookkeeping, shared by the max-attempts branch,
        the doomed-gang fail-fast, and parked-member dooming."""
        info.pod.phase = PodPhase.FAILED
        self.failed[info.pod.key] = reason
        if self.allocator is not None:
            self.allocator.unnominate(info.pod.key)
        if self.policy is not None:
            # drop the pod from the starvation-watch dedup set: a pod
            # that tripped and then failed terminally must not pin the
            # set toward its clear-all backstop (which would re-trip
            # still-starving pods)
            self.policy.resolved(info.pod.key)
        self.metrics.inc("pods_failed_total")
        if trace is None:
            trace = CycleTrace(pod=info.pod.key, started=self.clock.time())
        self._finish(trace, "failed", reason=reason)

    def _unreserve_waiting(self, w: _WaitingPod) -> None:
        state = CycleState()
        try:
            state.write("workload_spec", spec_for(w.info.pod))
        except LabelError:
            pass
        for p in reversed(self.profile.reserve):
            p.unreserve(state, w.info.pod, w.node)
        # the rollback returned reserved chips to the free pool — to a
        # parked capacity-starved pod that is indistinguishable from a
        # pod leaving the node, so publish it as one (no cluster backend
        # sees allocator-only changes, hence no event would fire). origin
        # keeps the rolled-back pod itself from riding its own event out
        # of backoff (park -> timeout -> self-wake livelock)
        self.notify_event(ClusterEvent(POD_DELETED, node=w.node,
                                       origin=w.info.pod.key))

    def _rollback_waiting(self, key: str) -> None:
        w = self.waiting.pop(key, None)
        if w is None:
            return
        self._unreserve_waiting(w)
        # a gang member rolled back at Permit (assembly timeout) is parked
        # on the gang plugin: a sibling's (re)arrival — or freed capacity —
        # is what can complete assembly next time, so route those events
        # to its queueing hints instead of leaving only the blind timer
        rejected_by = ()
        if self.gang_permit is not None \
                and self.gang_permit.gang_of(w.info.pod):
            rejected_by = (self.gang_permit.name,)
        self.queue.requeue_backoff(w.info, now=self.clock.time(),
                                   rejected_by=rejected_by)

    def forget(self, pod_key: str) -> None:
        """The pod vanished from the cluster (external DELETE while queued
        or parked at Permit): drop every trace so its reservation and
        nomination hold don't leak. A parked gang member takes its whole
        gang down — the gang can never complete without it, and its key
        left in the coordinator's waiting set would otherwise let a
        re-formed gang 'complete' with a phantom member."""
        w = self.waiting.pop(pod_key, None)
        if w is not None:
            self._unreserve_waiting(w)
            gang = self.gang_permit.gang_of(w.info.pod) if self.gang_permit else None
            if gang:
                self._fail_gang(gang)  # surviving peers requeue
                self.doomed_gangs.pop(gang, None)  # gone = not doomed
        for q in self.queue.remove(pod_key):
            # a QUEUED gang member (e.g. mid-preemption, before parking)
            # also takes its gang's state and slice entitlement with it
            gang = self.gang_permit.gang_of(q.pod) if self.gang_permit else None
            if gang:
                self._fail_gang(gang)
                self.doomed_gangs.pop(gang, None)
        if self.allocator is not None:
            self.allocator.unnominate(pod_key)
        if self.policy is not None:
            self.policy.resolved(pod_key)  # starvation-watch dedup set
        self.failed.pop(pod_key, None)
        self.quarantined.pop(pod_key, None)

    def reconcile(self, pods) -> tuple[int, int]:
        """Restart reconciliation: rebuild assumed/in-flight bind state
        from CLUSTER truth after a scheduler crash. For each candidate
        pod (the previous incarnation's workload, as recovered from the
        apiserver or the test driver): binding present in the cluster =>
        ADOPT it — the chip-assignment annotation rode the Binding, so
        allocation accounting follows from cluster state alone; absent =>
        the pod never made it past the wire (a crash between Reserve and
        Bind left only engine-local state, which died with the engine) —
        scrub any stale assignment annotation and REQUEUE it. No pod is
        lost, none is double-bound. Returns (adopted, requeued)."""
        adopted = requeued = 0
        bn = getattr(self.cluster, "bound_node_of", None)
        for pod in pods:
            if self.tracks(pod.key) or pod.key in self.failed:
                continue
            node = bn(pod.key) if bn is not None else None
            if node is not None:
                pod.node = node
                pod.phase = PodPhase.BOUND
                adopted += 1
                self.metrics.inc("reconcile_adopted_total")
                continue
            pod.node = None
            pod.phase = PodPhase.PENDING
            pod.labels.pop(ASSIGNED_CHIPS_LABEL, None)
            if self.submit(pod):
                requeued += 1
                self.metrics.inc("reconcile_requeued_total")
        if adopted or requeued:
            # no-op passes stay out of the black box: multi-profile and
            # paginated reconciles route per-pod through here
            self.flight.record("reconcile", adopted=adopted,
                               requeued=requeued)
        return adopted, requeued

    # -------------------------------------------------------------- main loop
    def run_one(self) -> str | None:
        """One scheduling cycle: expire parked gangs, pop the next ready
        pod, schedule it. Returns the cycle outcome, or None when nothing
        is ready (queue empty, everyone backing off, or parked at Permit) —
        callers decide how to wait (next_wake_at)."""
        if self.waiting:
            self.check_waiting()
        if self._bind_results:
            self._drain_bind_failures()
        while self._gang_revivals:  # recorded by submit() on any thread
            try:
                self.doomed_gangs.pop(self._gang_revivals.popleft(), None)
            except IndexError:
                break
        if self._elastic_retires:
            self._drain_elastic_retires()
        if self.provisioner is not None:
            # capacity tick BEFORE the breaker gate: an apiserver storm
            # must not stop scale-up (pending work still needs homes
            # when the wire heals); the pass's scale-down half checks
            # the breaker/degraded interlocks itself. Contained like
            # the defrag tick — a controller crash never takes the
            # scheduling loop down.
            try:
                self.provisioner.maybe_run(self.clock.time())
            except Exception:
                self.metrics.inc("provisioner_errors_total")
        if self.clock.time() < self._breaker_until:
            # circuit open (apiserver error storm): park scheduling — the
            # queue keeps its order and nobody's attempts burn; resumes
            # cleanly when the cooldown passes (next_wake_at floors the
            # queue wake at the breaker deadline)
            self.metrics.inc("breaker_parked_cycles_total")
            return None
        if self.defrag is not None:
            # active defragmentation tick (engine thread, injectable
            # clock): run a migration pass when due — behind the breaker
            # gate above, so an open circuit never migrates, and guarded
            # inside against degraded mode / fleet ownership / no demand
            try:
                self.defrag.maybe_run(self.clock.time())
            except Exception:
                # the controller is best-effort: a planning crash must
                # not take the scheduling loop down with it
                self.metrics.inc("defrag_errors_total")
        if self.workloads is not None:
            # workload-tier admission pass (engine thread): at most
            # admissionBurst O(1) decisions, contained like the defrag
            # tick — an admission crash must not take the loop down
            try:
                self.workloads.tick(self.clock.time())
            except Exception:
                self.metrics.inc("workload_admission_errors_total")
        if self.sloguard is not None:
            # SLO guard tick (engine thread): evaluate burn-rate
            # pressure and shrink/give-back when due — behind the
            # breaker gate (its evictions ride the bind wire's health)
            # and contained like every controller tick
            try:
                self.sloguard.maybe_run(self.clock.time())
            except Exception:
                self.metrics.inc("slo_guard_errors_total")
        maxp = self.config.batch_max_pods
        if maxp > 1:
            if self.allocator is None or self.allocator.has_holds():
                # nominated preemptors / gang-slice entitlements make
                # filter verdicts depend on per-pod holds the equivalence
                # key cannot see: per-pod cycles until the holds drain
                maxp = 1
        if maxp > 1:
            infos = self.queue.pop_batch(now=self.clock.time(),
                                         max_pods=maxp,
                                         exclude=self.head_filter)
            if not infos:
                return None
            self.metrics.observe("batch_size", len(infos))
            started = self.clock.time()
            for i in infos:
                self._record_queued_span(i, started)
                # batch members' compute phase opens at the shared pop:
                # time spent waiting for earlier members IS batch cycle
                # time (the head's _schedule_one_locked restamps itself)
                i.cycle_started = started
            outcome = self.schedule_batch(infos)
        else:
            info = self.queue.pop(now=self.clock.time(),
                                  exclude=self.head_filter)
            if info is None:
                return None
            started = self.clock.time()
            self._record_queued_span(info, started)
            outcome = self.schedule_one(info)
        if outcome not in ("crash", "quarantined"):
            # a cycle completed without crashing: the next crash is a
            # per-pod (poison) signal again, not a systemic one
            self._ok_since_crash = True
        self.metrics.observe("cycle_latency_ms",
                             (self.clock.time() - started) * 1e3)
        if self._native is not None and self.config.native_prefetch:
            # best-effort, and CONTAINED like the cycle itself: a raising
            # capability hook here runs outside the per-pod crash
            # containment, and the completed cycle's real outcome must
            # not be replaced by an escaping dispatch error
            try:
                self._dispatch_prefetch()
            except Exception:
                self.metrics.inc("prefetch_dispatch_errors_total")
        return outcome

    def _record_queued_span(self, info: QueuedPodInfo, now: float) -> None:
        """One `queued` lifecycle span per queue stint (sampled pods):
        intake wait for the first pop, a backoff segment (with the parking
        plugins) for every retry stint."""
        if info.stint_started < 0.0 or not self._sampled(info.pod):
            return
        attrs: dict = {"segment": "backoff" if info.attempts else "intake",
                       "attempts": info.attempts}
        if info.rejected_by:
            attrs["parked_by"] = list(info.rejected_by)
        self.spans.record("queued", info.pod.key, info.stint_started, now,
                          attrs)

    def next_wake_at(self) -> float | None:
        """Earliest future instant at which run_one could make progress:
        the nearest gang-permit deadline or backoff expiry — or now, when
        undrained cluster events could activate a parked pod (the queue's
        next_ready_at reads 0.0 while its inbox is non-empty). None =
        idle."""
        wakes = []
        if self.waiting:
            wakes.append(min(w.deadline for w in self.waiting.values()))
        nxt = self.queue.next_ready_at()
        if nxt is not None:
            # an open circuit breaker defers queue work (but never permit
            # deadlines — check_waiting still runs while parked)
            wakes.append(max(nxt, self._breaker_until))
        if self.defrag is not None:
            # the defrag pass is a wake source only while pods are
            # PENDING (its demand gate): a due pass may free exactly the
            # chips a parked pod needs, and without this wake a
            # run_until_idle drain would sleep past it. With nothing
            # pending the controller would no-op, so idle stays idle.
            # The gate is maybe_run's own (DefragController.demanded —
            # fleet-wide when wired, so a shard-0 owner with an empty
            # local queue still wakes for passes other replicas need).
            # Floored at the breaker deadline like the queue wake above:
            # run_one returns at the breaker gate BEFORE the defrag tick,
            # so a due next_at would otherwise spin the wait loop.
            if self.defrag.demanded():
                wakes.append(max(self.defrag.next_at, self._breaker_until))
        if self.workloads is not None:
            nx = self.workloads.next_ready_at(self.clock.time())
            if nx is not None:
                # a due admission pass runs inside run_one, which parks
                # at the breaker gate first — floor like the queue wake
                wakes.append(max(nx, self._breaker_until))
        if self.provisioner is not None and self.provisioner.busy():
            # NOT floored at the breaker: the capacity tick runs before
            # the breaker gate in run_one (scale-up continues degraded)
            wakes.append(self.provisioner.next_at)
        if self.sloguard is not None and self.sloguard.demanded():
            # the guard is a wake source while pressure is live, shrunk
            # capacity awaits give-back, or burn windows must close —
            # floored at the breaker like the defrag wake (the tick
            # runs behind the gate)
            wakes.append(max(self.sloguard.next_at, self._breaker_until))
        return min(wakes) if wakes else None

    def run_until_idle(self, max_cycles: int = 100_000) -> int:
        """Drive cycles until no pending work remains (tests/bench harness).
        Returns the number of cycles executed."""
        cycles = 0
        while cycles < max_cycles:
            if self.run_one() is not None:
                cycles += 1
                continue
            wake = self.next_wake_at()
            if wake is None:
                break  # fully idle
            self.clock.sleep(max(wake - self.clock.time(), 0.01))
            cycles += 1
        return cycles

    # ------------------------------------------------------------- reporting
    def bin_pack_utilization(self) -> float:
        """% of healthy TPU chips claimed by bound pods, over TPU nodes that
        could host work — the BASELINE bin-pack metric."""
        total = 0
        used = 0
        for name in self.cluster.node_names():
            m = self.cluster.telemetry.get(name)
            if m is None or m.accelerator != "tpu":
                continue
            healthy = m.healthy_coords()
            total += len(healthy)
            ni = NodeInfo(name=name, metrics=m, pods=self.cluster.pods_on(name))
            used += len(ni.assigned_coords() & healthy)
        return 100.0 * used / total if total else 0.0
