"""Scheduler configuration (the KubeSchedulerConfiguration analogue).

The reference's score weights are compile-time constants (reference
pkg/yoda/score/algorithm.go:16-26) and its profile knobs live in a ConfigMap
(deploy/yoda-scheduler.yaml:7-31: percentageOfNodesToScore, pod backoff
1->10s, plugin enablement/weights). SURVEY.md §5 calls for making the
weights configurable; this module is that plugin-args surface, loadable from
the same YAML shape (see deploy/yoda-tpu-scheduler.yaml).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace


def _batch_default() -> int:
    """Default for batch scheduling cycles (core.schedule_batch).
    YODA_BATCH=0 — or any non-integer string ("off", "false", …) —
    restores the strict per-pod cycle end-to-end (CI runs tier-1 under
    both); a positive integer overrides the batch size ceiling; unset
    keeps the built-in 32."""
    raw = os.environ.get("YODA_BATCH", "")
    if not raw:
        return 32
    try:
        return max(int(raw), 1)
    except ValueError:
        # any non-integer string ("off", "no", a typo) disables: an
        # operator setting the variable at all is steering the knob, and
        # silently batching at full size would defeat their per-pod repro
        return 1


def _columnar_default() -> bool:
    """Opt-out knob for the columnar data plane (scheduler/columnar.py).
    YODA_COLUMNAR=0 restores the per-node scalar path end-to-end — CI
    runs the tier-1 suite under both values."""
    return os.environ.get("YODA_COLUMNAR", "1").lower() not in (
        "0", "false", "off")


def _columnar_shards_default() -> int:
    """Pool sharding for the columnar table (scheduler/columnar.py):
    node pools hash into this many shards, making membership rebuilds,
    qualifying-chip memo invalidation, and change-log row repair
    O(shard) instead of O(cluster). 0 (the default) keeps the unsharded
    table bit-for-bit; env YODA_COLUMNAR_SHARDS overrides."""
    raw = os.environ.get("YODA_COLUMNAR_SHARDS", "")
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _bind_pipeline_default() -> int:
    """Windowed bind-wire pipelining (k8s/client.py): binder workers
    drain up to this many queued binds per pass and put them on ONE
    persistent connection back-to-back (HTTP/1.1 pipelining), reading
    the responses in order — conflicts resolve through the existing
    409/adopt protocol, in submission order. 0 (default) keeps the
    one-POST-per-worker wire; env YODA_BIND_PIPELINE overrides."""
    raw = os.environ.get("YODA_BIND_PIPELINE", "")
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _native_plane_default() -> bool:
    """Opt-out knob for the native data plane (scheduler/nativeplane.py).
    YODA_NATIVE_PLANE=0 restores the numpy columnar path end-to-end —
    CI runs the tier-1 suite under both values."""
    return os.environ.get("YODA_NATIVE_PLANE", "1").lower() not in (
        "0", "false", "off")


def _native_prefetch_default() -> bool:
    return os.environ.get("YODA_NATIVE_PREFETCH", "1").lower() not in (
        "0", "false", "off")


def _native_commit_default() -> bool:
    """Opt-in knob for the native COMMIT plane (scheduler/nativeplane.py
    CommitKernels): topology packing scored in one GIL-releasing call,
    the batch-commit candidate-removal shift fused with the score fold,
    and the slice-usage patch carried on columnar arrays instead of
    per-member dict copies. Default OFF; YODA_NATIVE_COMMIT=1 enables —
    placements are bit-identical either way (parity fuzz in
    tests/test_native_commit.py; CI runs tier-1 under both values)."""
    return os.environ.get("YODA_NATIVE_COMMIT", "0").lower() in (
        "1", "true", "on")


def _churn_plane_default() -> bool:
    """Opt-in knob for the CHURN plane: batched event application (the
    watch/notify inbox drained into per-kind delta vectors applied in
    one pass per cycle — columnar row refreshes through one native
    eventplane call, one vectorized queue-hint walk, one amortized
    memo/unbind fold) plus the guarded fast-cycle path that carries a
    batch's commit context across cycle boundaries when the class memo
    is still exact. Default OFF; YODA_CHURN_PLANE=1 enables —
    placements are bit-identical either way (parity fuzz in
    tests/test_churn_plane.py; CI runs a knob-off tier-1 leg)."""
    return os.environ.get("YODA_CHURN_PLANE", "0").lower() in (
        "1", "true", "on")


def _fleet_procs_default() -> int:
    """Process-fleet width (scheduler/fleet.py ProcessFleet): run this
    many scheduler PROCESSES against the wire apiserver, nothing shared
    but the authority (each process = one fleet replica with a global
    index: sharded reflection, per-shard leases, fenced binds, 409
    adoption). 0/1 (default, or env YODA_FLEET_PROCS unset) keeps the
    in-process topology."""
    raw = os.environ.get("YODA_FLEET_PROCS", "")
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _gil_switch_default() -> float:
    """Serve-path GIL switch interval in milliseconds (cli.cmd_serve used
    to hardcode 1ms). YODA_GIL_SWITCH_MS overrides; 0 leaves the
    interpreter default (5ms) untouched."""
    raw = os.environ.get("YODA_GIL_SWITCH_MS", "")
    if not raw:
        return 1.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return 1.0


def _trace_sampling_default() -> int:
    """Default pod sampling rate for lifecycle span tracing (utils/obs.py
    SpanRing): spans are recorded for 1-in-N pods (deterministic by pod
    key, so a sampled pod's tree is complete across fleet replicas).
    YODA_TRACE_SAMPLING=0 disables tracing, =1 traces every pod; the CI
    instrumentation-overhead fence pins <3% p50 regression at this
    default."""
    raw = os.environ.get("YODA_TRACE_SAMPLING", "")
    if not raw:
        return 8
    try:
        return max(int(raw), 0)
    except ValueError:
        return 8


def _fleet_default() -> int:
    """Default replica count for the scheduler fleet (scheduler/fleet.py).
    YODA_FLEET=<n> runs n engine replicas against the same apiserver,
    each committing binds optimistically; unset/1/non-integer keeps the
    classic single engine (whose placements stay bit-identical)."""
    raw = os.environ.get("YODA_FLEET", "")
    if not raw:
        return 1
    try:
        return max(int(raw), 1)
    except ValueError:
        return 1


def _schedule_heads_default() -> int:
    """Default head count for intra-replica parallel scheduling
    (scheduler/heads.py). YODA_SCHEDULE_HEADS=<n> runs n scheduling
    heads inside ONE engine process, each pulling from the shared queue
    and committing optimistically; unset/1/non-integer keeps the classic
    single loop (whose placements stay bit-identical)."""
    raw = os.environ.get("YODA_SCHEDULE_HEADS", "")
    if not raw:
        return 1
    try:
        return max(int(raw), 1)
    except ValueError:
        return 1


def _head_dispatch_depth_default() -> int:
    """Default per-head async-bind dispatch window. YODA_HEAD_DISPATCH
    =<n> caps each head at n in-flight dispatched binds; unset/0 keeps
    the classic unbounded dispatch."""
    raw = os.environ.get("YODA_HEAD_DISPATCH", "")
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def _policy_objective_default() -> str:
    """Default objective for the policy engine's heterogeneity scorer
    (scheduler/policy/). Unset = the policy engine stays OUT of the
    profile and placements are bit-identical to the pre-policy default
    (the CI parity leg pins this). YODA_POLICY_OBJECTIVE overrides."""
    return _valid_policy_objective(
        os.environ.get("YODA_POLICY_OBJECTIVE", ""))


def _valid_policy_objective(objective: str) -> str:
    """Reject unknown policyObjective values at config-load time — a
    typo silently disabling the whole policy engine would corrupt
    exactly the placement comparison the operator asked for (same
    posture as _valid_fleet_mode)."""
    if objective not in ("", "makespan", "avg-jct", "finish-time-fairness"):
        raise ValueError(
            "policyObjective must be '', 'makespan', 'avg-jct' or "
            f"'finish-time-fairness', got {objective!r}")
    return objective


def _elastic_default() -> bool:
    """Elastic gangs (scheduler/elastic/): gangs labeled tpu/gang-min may
    admit at min replicas and grow toward desired as chips free, and
    bound elastic gangs become shrink-to-min preemption donors. Default
    OFF; YODA_ELASTIC=1 enables (CI runs a tier-1 leg with it spelled-out
    off, the same parity discipline as the policy engine)."""
    return os.environ.get("YODA_ELASTIC", "0").lower() in ("1", "true", "on")


def _torus_default() -> bool:
    """Geometric torus placement (topology/carve.py + scheduler/carve.py):
    multi-host slices become wrapped host-grid tori and gang demand is
    carved as contiguous axis-aligned blocks scored by ICI bisection
    bandwidth, with geometric fragmentation scoring, torus-reassembly
    defrag, and shape-conserving slice scale-down riding the same knob.
    Default OFF; YODA_TORUS=1 enables (CI runs a tier-1 leg with it
    spelled-out off — placements are bit-identical when unset, the same
    parity discipline as the policy engine)."""
    return os.environ.get("YODA_TORUS", "0").lower() in ("1", "true", "on")


def _workload_admission_default() -> bool:
    """Workload-tier admission (scheduler/workload.py): one Workload
    object describes N gang members x M replicas; admission runs ONCE
    per workload against the DRF book / hierarchical quotas / live
    capacity, and pods materialize into the scheduling queue lazily
    only after their workload admits — a parked workload costs O(1)
    memory, never O(pods). Default OFF; YODA_WORKLOAD_ADMISSION=1
    enables (CI runs a tier-1 leg with it spelled-out off, the same
    parity discipline as the policy engine)."""
    return os.environ.get("YODA_WORKLOAD_ADMISSION", "0").lower() in (
        "1", "true", "on")


def _slo_default() -> bool:
    """SLO-guarded colocated serving (scheduler/elastic/sloguard.py):
    scv/serving pods get burn-rate-monitored scheduling latency, flash
    crowds shrink elastic training gangs toward tpu/gang-min (the elastic-gang
    predicate, not just harvest eviction), admission reserves serving
    headroom as a DRF quota level, and a hysteresis'd give-back returns
    surplus to training in valleys. Default OFF; YODA_SLO=1 enables (CI
    runs a tier-1 leg with it spelled-out off — placements are
    bit-identical when unset, the same parity discipline as the policy
    engine)."""
    return os.environ.get("YODA_SLO", "0").lower() in ("1", "true", "on")


def _drf_default() -> bool:
    """DRF fairness layer (tenant-fairness queue ordering + quota gate
    + preemption budgets): default OFF; YODA_DRF=1 enables."""
    return os.environ.get("YODA_DRF", "0").lower() in ("1", "true", "on")


def _freeze_tenants(tenants) -> tuple:
    """Normalise a config `tenants:` mapping ({name: {quota: 0.5,
    preemptionBudget: 3}}) into the frozen ((name, quota, budget), ...)
    tuple the dataclass carries. Accepts the frozen form unchanged."""
    if not tenants:
        return ()
    if isinstance(tenants, dict):
        out = []
        for name, body in sorted(tenants.items()):
            body = body or {}
            out.append((str(name), float(body.get("quota", 0.0)),
                        int(body.get("preemptionBudget", -1))))
        return tuple(out)
    return tuple((str(n), float(q), int(b)) for n, q, b in tenants)


def _freeze_classes(classes) -> tuple:
    """Normalise a `workloadClasses:` mapping ({class: {v4: 1.0,
    v5e: 1.9}}) into ((class, ((gen, ratio), ...)), ...)."""
    if not classes:
        return ()
    if isinstance(classes, dict):
        return tuple(
            (str(c), tuple(sorted((str(g), float(r))
                                  for g, r in (gens or {}).items())))
            for c, gens in sorted(classes.items()))
    return tuple((str(c), tuple((str(g), float(r)) for g, r in gens))
                 for c, gens in classes)


def _freeze_pool_bounds(bounds) -> tuple:
    """Normalise a config `poolBounds:` mapping ({pool: {min: 1,
    max: 16}}) into the frozen ((pool, min, max), ...) tuple the
    dataclass carries. Accepts the frozen form unchanged."""
    if not bounds:
        return ()
    if isinstance(bounds, dict):
        out = []
        for name, body in sorted(bounds.items()):
            body = body or {}
            lo = int(body.get("min", 0))
            hi = int(body.get("max", 64))
            if lo < 0 or hi < lo:
                raise ValueError(
                    f"poolBounds[{name!r}]: need 0 <= min <= max, "
                    f"got min={lo} max={hi}")
            out.append((str(name), lo, hi))
        return tuple(out)
    return tuple((str(n), int(lo), int(hi)) for n, lo, hi in bounds)


def _valid_fleet_mode(mode: str) -> str:
    """Reject unknown fleetMode values at config-load time: the sharded/
    free-for-all A/B is the whole point of the knob, and a typo
    ("free_for_all", "FreeForAll") silently falling back to sharded
    would corrupt exactly the comparison the operator asked for."""
    if mode not in ("sharded", "free-for-all"):
        raise ValueError(
            f"fleetMode must be 'sharded' or 'free-for-all', got {mode!r}")
    return mode


@dataclass(frozen=True)
class ScoreWeights:
    """Per-attribute weights for the telemetry score.

    Defaults match the reference exactly (algorithm.go:16-26):
    bandwidth/clock/core/power/total_memory=1, free_memory=2, actual=2,
    allocate=3 — so default behaviour is reference behaviour."""

    bandwidth: int = 1
    clock: int = 1
    core: int = 1
    power: int = 1
    free_memory: int = 2
    total_memory: int = 1
    actual: int = 2
    allocate: int = 3
    # Default OFF (reference parity): PENALISE nodes whose qualifying
    # chips report a high measured MXU duty cycle — live utilisation the
    # reference's clock-as-performance proxy cannot see (telemetry/
    # schema.py Chip.duty_cycle_pct). Nodes reporting no duty (GPU nodes;
    # the first-party sniffer, which cannot measure duty through JAX's
    # public API) contribute zero — no data means no penalty, never a
    # bonus, so mixed fleets aren't steered toward unmeasured capacity.
    duty_cycle: int = 0


@dataclass(frozen=True)
class SchedulerConfig:
    scheduler_name: str = "yoda-scheduler"
    # 0 = adaptive, the k8s default the reference inherits
    # (deploy/yoda-scheduler.yaml:18)
    percentage_of_nodes_to_score: int = 0
    # pod retry backoff, reference deploy/yoda-scheduler.yaml:19-20
    pod_initial_backoff_s: float = 1.0
    pod_max_backoff_s: float = 10.0
    # timer safety net for pods whose EVERY rejecting plugin has queueing
    # hints registered: such pods are woken by matching cluster events, so
    # the blind-retry timer MAY stretch to this (upstream kube-scheduler's
    # podMaxInUnschedulablePodsDuration analogue, there 5min). Opt-in: any
    # value <= pod_max_backoff_s (the default) disables the stretch and
    # every pod keeps the classic 1s->10s cadence — event wakes still fire
    # either way, the stretch only trades doomed-retry compute for a
    # longer worst case when an event channel is missing.
    pod_hinted_backoff_s: float = 0.0
    weights: ScoreWeights = field(default_factory=ScoreWeights)
    # telemetry older than this is treated as unschedulable (no reference
    # equivalent — its cache served arbitrarily stale data)
    telemetry_max_age_s: float = 60.0
    # gang admission: how long Permit parks a pod awaiting its peers
    gang_timeout_s: float = 30.0
    # enable priority preemption when no node fits (modern PostFilter role)
    preemption: bool = True
    # topology-aware scoring weight (new TPU capability; 0 disables).
    # must outweigh the telemetry score's emptier-node preference (all three
    # emptiness signals are anti-packing and min-max normalisation amplifies
    # them to 0-100): with identical chips, packing decides placement so
    # contiguous blocks survive for tpu/topology requests; with heterogeneous
    # chips the quality signals still move the needle
    topology_weight: int = 6
    # give up on a pod after this many unschedulable attempts (0 = retry
    # forever, the kube-scheduler posture; benches set a finite cap)
    max_attempts: int = 0
    rng_seed: int = 0
    # periodic slice-defragmentation pass (scheduler/deschedule.py);
    # 0 disables. Victim protection + budget use the descheduler defaults.
    deschedule_interval_s: float = 0.0
    # ---- elastic gangs + active defragmentation (scheduler/elastic/) ----
    # elastic gangs: tpu/gang-min admission-at-min + event-driven growth
    # + shrink-to-min preemption donors. OFF by default — with the knob
    # off (or on but no tpu/gang-min labels in the workload) placements
    # are bit-identical to the classic engine (tests/test_elastic.py
    # TestElasticOffParity + the CI elastic-disabled tier-1 leg).
    elastic_gangs: bool = field(default_factory=_elastic_default)
    # active defragmentation controller (scheduler/elastic/defrag.py): a
    # closed loop on the ENGINE thread's injectable clock driving
    # deschedule.py's slice-conservation/compaction strategies through
    # the victim-drain path — at most maxMigrationsPerPass evictions per
    # pass, per-pod cooldowns, and a hard interlock (never migrates
    # while the bind breaker is open or degraded mode is active; in a
    # fleet, only the shard-0 owner's replica runs it). 0 disables.
    defrag_interval_s: float = 0.0
    max_migrations_per_pass: int = 4
    # per-pod migration cooldown: a pod the defrag loop moved is immune
    # for this long (the chaos matrix pins "no pod migrated more than
    # once per cooldown window")
    defrag_cooldown_s: float = 300.0
    # columnar data plane: evaluate the vectorizable filter predicates and
    # score terms over the whole node table in one numpy call per cycle
    # (scheduler/columnar.py). The scalar per-node path remains wired in
    # as the fallback (non-vectorizable plugins/pods) and ground truth;
    # False — or env YODA_COLUMNAR=0 — restores it end-to-end.
    columnar: bool = field(default_factory=_columnar_default)
    # pool-sharded columnar table (scheduler/columnar.py pool_of): node
    # pools hash into this many shards; membership rebuilds block-copy
    # untouched pools, and the qualifying-chip memo invalidates (and
    # repairs) per shard instead of per cluster. 0 (default, or env
    # YODA_COLUMNAR_SHARDS unset) keeps the unsharded table — placements
    # are bit-identical either way (tests/test_columnar.py shard fuzz).
    columnar_shards: int = field(default_factory=_columnar_shards_default)
    # native data plane: run the memo-miss full filter+score scan as ONE
    # GIL-releasing call into the fused C++ kernel (native/fusedplane.cc
    # via scheduler/nativeplane.py), consuming the columnar table's
    # arrays zero-copy. Requires the columnar plane; a missing or stale
    # libyodaplace.so degrades silently (native_plane_active gauge 0).
    # False — or env YODA_NATIVE_PLANE=0 — restores the numpy columnar
    # path exactly (fallback chain: native -> numpy columnar -> scalar).
    native_plane: bool = field(default_factory=_native_plane_default)
    # overlapped scan prefetch: while a pod commits/binds, a worker
    # thread runs the NEXT queue head's memo-miss fused scan against the
    # current snapshot version, validated at consume time by the
    # change-log version vector (stale -> discarded and counted). Only
    # meaningful with the native plane active.
    native_prefetch: bool = field(default_factory=_native_prefetch_default)
    # native COMMIT plane (scheduler/nativeplane.py CommitKernels over
    # native/commitplane.cc): the per-pod Python left on the hot path
    # after the fused scan — topology packing/blend per candidate, the
    # batch-commit candidate-removal shift + score fold, the per-member
    # slice-usage patch — runs as GIL-releasing C calls (arrays in,
    # arrays out, op-for-op the scalar arithmetic). Off (default, or
    # env YODA_NATIVE_COMMIT unset): the Python/numpy paths run
    # end-to-end, bit-identical placements (the CI parity leg).
    native_commit: bool = field(default_factory=_native_commit_default)
    # churn plane: batched event application + the fast-cycle
    # commit continuation. The engine drains its event inbox once per
    # cycle into per-kind batches (columnar rows refreshed by one
    # native/eventplane.cc call, queue hints evaluated over the whole
    # batch, memo invalidation folded once), and a fully-consumed batch
    # commit leaves its context armed so the NEXT same-class cycle can
    # skip the ordinary head cycle when every guard holds (no degraded
    # flip, no foreign dirt, no gang/policy/defrag involvement). Off
    # (default, or env YODA_CHURN_PLANE unset): per-event scalar
    # application and strict per-batch head cycles — bit-identical
    # placements (tests/test_churn_plane.py parity fuzz).
    churn_plane: bool = field(default_factory=_churn_plane_default)
    # fragmentation-aware packing weight (plugins/score.py
    # FragmentationScore): steer 1-chip pods away from nodes whose free
    # set is down to its LAST pair, so 2-chip jobs keep finding pairs
    # deep into a drain. 0 disables.
    fragmentation_weight: int = 1
    # geometric torus placement (scheduler/carve.py TorusCarver): carve
    # gang demand as contiguous axis-aligned host blocks on each slice's
    # wrapped host grid, scored by ICI bisection bandwidth; multi-slice
    # gangs get one carve per slice; FragmentationScore, the defrag
    # controller, and slice scale-down all turn geometry-aware. OFF by
    # default — with the knob off placements are bit-identical to the
    # classic engine (tests/test_torus_carve.py knob-off parity + the CI
    # torus-disabled tier-1 leg).
    torus_placement: bool = field(default_factory=_torus_default)
    # batch scheduling cycles: extend the queue head to up to this many
    # pods sharing one scheduling equivalence class and place them with
    # ONE shared filter+score pass plus an incremental greedy commit
    # (core.schedule_batch). 1 disables (strict per-pod cycles, the
    # upstream scheduleOne cadence); env YODA_BATCH=0 forces 1. Gang,
    # topology, affinity, nominated, and hold-affected pods always take
    # the per-pod cycle regardless of this knob.
    batch_max_pods: int = field(default_factory=_batch_default)
    # windowed in-flight bind pipelining (k8s/client.py): binder workers
    # batch up to this many queued binds onto one persistent connection
    # back-to-back, resolving responses (409s included) in order; Event
    # posting batches through the same path. 0 (default, or env
    # YODA_BIND_PIPELINE unset) keeps one POST per worker round-trip —
    # placements are identical either way (the wire only reorders
    # latency, never outcomes; parity pinned in tests/test_k8s.py).
    bind_pipeline_window: int = field(default_factory=_bind_pipeline_default)
    # dispatch the bind POST on a binder worker (upstream kube-scheduler's
    # binding-cycle goroutine) when the cluster backend supports it
    # (KubeCluster.bind_async); the in-memory FakeCluster always binds
    # synchronously. Wire failures roll back and requeue with backoff.
    async_binding: bool = True
    # telemetry-blackout degraded mode: when the NEWEST stored heartbeat
    # is older than telemetry_max_age_s (the whole feed is dark, not one
    # node's sniffer), keep scheduling off last-known capacity — the
    # staleness gate is waived and telemetry-dependent scorers drop out —
    # instead of marking every node stale-infeasible and binding nothing.
    # Cycles run this way increment degraded_cycles_total and flip the
    # `degraded` gauge; recovery is automatic when fresh telemetry lands.
    degraded_mode: bool = True
    # cycle-level exception containment: a plugin RAISING (not returning
    # ERROR) fails the pod's cycle, never the engine thread. After this
    # many crashing cycles the pod is quarantined (permanently failed,
    # pods_quarantined_total) so one poison pod cannot monopolise the
    # engine with crash-requeue loops. 0 = never quarantine (crashes
    # keep requeueing with backoff forever).
    quarantine_threshold: int = 5
    # apiserver circuit breaker: after this many CONSECUTIVE bind wire
    # failures, park scheduling for breaker_cooldown_s (doubling per
    # re-open, capped at 8x) instead of burning every queued pod's
    # attempts against a dead server; a post-cooldown probe bind closes
    # the breaker on success. 0 disables.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    # scheduler fleet (scheduler/fleet.py): run this many engine replicas
    # against the same apiserver, each scheduling from its own snapshot
    # and committing binds OPTIMISTICALLY — the authority rejects
    # conflicting commits with a 409 the engine resolves (foreign-bind
    # drop / local retry). 1 (or env YODA_FLEET unset) keeps the classic
    # single engine, bit-identical placements included.
    fleet_replicas: int = field(default_factory=_fleet_default)
    # process fleet (scheduler/fleet.py ProcessFleet): run this many
    # scheduler PROCESSES against the wire apiserver — each child is a
    # full fleet replica with a GLOBAL index (identity, rng seed,
    # preferred shards, gang routing all span the process fleet), its
    # own sharded reflection and per-shard fenced leases, nothing
    # shared but the authority. The parent supervises lifecycle
    # (crash-restart re-enters through Scheduler.reconcile) and
    # aggregates the per-process /metrics endpoints by scrape. 0/1
    # keeps in-process topologies (fleetReplicas / scheduleHeads).
    fleet_processes: int = field(default_factory=_fleet_procs_default)
    # global index of THIS process within the process fleet (stamped by
    # ProcessFleet on its children; -1 = not a process-fleet member).
    # Drives the fleet coordinator's replica_base so identities, seeds
    # and preferred shards are fleet-global, not per-process.
    fleet_proc_index: int = -1
    # serve-path GIL switch interval in ms (sys.setswitchinterval at
    # cmd_serve startup): 1ms keeps watch-ingest p99 low when Python
    # threads contend; matters less as scans/commits release the GIL
    # (nativePlane/nativeCommit). 0 leaves the interpreter default.
    gil_switch_interval_ms: float = field(default_factory=_gil_switch_default)
    # intra-replica parallel scheduling (scheduler/heads.py): run this
    # many scheduling HEADS inside one engine process, all pulling from
    # the SAME scheduling queue (multi-head pop, no double-consume) and
    # committing optimistically against the shared authority — a losing
    # head's 409 resolves through the fleet's existing foreign-bind /
    # node-claim machinery, attempt-free, entirely in-process. Each head
    # keeps its own allocator/memos/columnar table (single-writer row
    # refresh per head; the native plane's GIL-releasing scans are what
    # actually parallelize). 1 (or env YODA_SCHEDULE_HEADS unset) keeps
    # the classic loop, bit-identical placements included. Composes
    # with fleet_replicas: each replica runs its own head set.
    schedule_heads: int = field(default_factory=_schedule_heads_default)
    # bounded per-head dispatch queue: at most this many async binds
    # in flight per head before the head's next dispatch blocks (the
    # generalization of the one-deep scan prefetch — wire commit
    # overlaps cycle compute up to this depth, and one head can never
    # fill the shared wire window and starve its siblings). 0 (default,
    # or env YODA_HEAD_DISPATCH unset) = unbounded, classic behaviour.
    head_dispatch_depth: int = field(
        default_factory=_head_dispatch_depth_default)
    # shard leases: node pools hash into this many shards, each backed by
    # a lease (yoda-shard-<i>); a replica schedules its owned shards
    # preferentially and carries a fencing token on binds into them.
    # 0 = one shard per replica.
    shard_leases: int = 0
    # sharded reflection (scheduler/fleet.py ShardedOwnedView +
    # k8s/client.py KubeCluster owned-pool filtering): each fleet
    # replica ingests and maintains scheduling state ONLY for the node
    # pools its shard leases cover — membership, change events, snapshot
    # and columnar rows for foreign shards never enter the replica —
    # with watch ownership handed over alongside the lease on rebalance.
    # Off (default): every replica keeps the full-cluster view and may
    # place onto foreign shards optimistically (bit-identical to the
    # pre-knob fleet). On: a replica can only place within its owned
    # pools, the trade that makes its ingest O(own shards).
    reflector_sharding: bool = False
    # "sharded" (leases + shard-affinity scoring + fencing) or
    # "free-for-all" (every replica pulls from the shared intake with no
    # node preference — the A/B baseline with the higher conflict rate)
    fleet_mode: str = "sharded"
    # dynamic shard rebalancing (scheduler/fleet.py): replicas heartbeat
    # `yoda-replica-<idx>` leases, and a replica holding a foreign shard
    # (crash takeover) hands it back — at this cadence — once the
    # preferred owner's heartbeat is live again, so a recovered replica
    # gets its shards re-leased instead of ownership staying sticky with
    # whoever survived the crash. Also arms the orphan guard (a shard
    # whose preferrer died before ever leasing it is claimed after one
    # lease duration). 0 disables: sticky takeover.
    shard_rebalance_s: float = 5.0
    # bind-authority admission webhook (k8s/webhook.py): the port the
    # `yoda-tpu webhook` server listens on (deploy/bind-authority-
    # webhook.yaml wires the Service + ValidatingWebhookConfiguration to
    # it). 0 = not serving a webhook from this process.
    webhook_port: int = 0
    # webhook self-degradation posture when its claim index goes stale
    # (watch feed dead past webhook_stale_after_s): False (default)
    # fail-CLOSED — deny binds with a retryable 503 until the feed
    # recovers (safety over availability, the recommended setting);
    # True fail-OPEN — allow everything, counted and flight-recorded
    # (availability over safety: under a concurrent scheduler partition
    # this is exactly the double-booking window, see ARCHITECTURE.md).
    webhook_fail_open: bool = False
    webhook_stale_after_s: float = 30.0
    # ---- policy engine (scheduler/policy/) ----
    # heterogeneity-aware placement objective: "" (off, the default —
    # profile and placements bit-identical to pre-policy), "makespan",
    # "avg-jct", or "finish-time-fairness". Selecting one adds the
    # HeterogeneityScore plugin: per-workload-class throughput ratios
    # across accelerator generations (Gavel) weight the ranking.
    policy_objective: str = field(default_factory=_policy_objective_default)
    # HeterogeneityScore weight (absolute 0..100*k term, like topology)
    heterogeneity_weight: int = 4
    # per-class throughput overrides: ((class, ((gen, ratio), ...)), ...)
    # — config `workloadClasses: {train: {v4: 1.0, v5e: 1.9}}`. Classes
    # come from the scv/class pod label (spec-derived fallback); absent
    # entries use the generation catalog's compute proxy.
    workload_classes: tuple = ()
    # multi-tenant DRF fairness layer: tenant-fairness queue ordering +
    # quota admission gate + per-tenant preemption budgets. Tenancy =
    # scv/tenant label, falling back to the pod namespace.
    drf_fairness: bool = field(default_factory=_drf_default)
    # hierarchical tenant quotas: ((tenant, dominant-share cap,
    # preemption budget), ...) — config `tenants: {acme: {quota: 0.5,
    # preemptionBudget: 3}, "acme/ml": {quota: 0.25}}`. quota 0 = no
    # cap; budget -1 = unlimited, else max victims the tenant may LOSE
    # to preemption per rolling window.
    tenant_quotas: tuple = ()
    preemption_budget_window_s: float = 60.0
    # starvation watch: a pod still unbound after this many seconds
    # trips the flight recorder (tenant_starvation) and the per-tenant
    # counter. 0 disables.
    starvation_after_s: float = 300.0
    # ---- workload-tier admission (scheduler/workload.py) ----
    # Workload admission above the pod queue: Workloads park in O(1)
    # until one admission decision (DRF book + hierarchical quotas +
    # live capacity) materializes their pods into the queue. OFF by
    # default — placements and queue behaviour bit-identical to the
    # pod-at-a-time intake (tests/test_workload.py parity + the CI
    # admission job's knob-off tier-1 leg).
    workload_admission: bool = field(
        default_factory=_workload_admission_default)
    # rate-limited intake: at most this many workload ADMISSIONS per
    # second (token bucket, admission_burst deep). 0 = unlimited.
    # Excess pressure parks workloads with a Backpressure condition
    # instead of flooding the pod queue.
    admission_rate_per_s: float = 0.0
    # token-bucket depth AND the per-tick admission exam cap: one
    # scheduling cycle never spends more than this many admission
    # decisions, keeping the admission tier O(1)-per-cycle whatever the
    # parked backlog depth.
    admission_burst: int = 64
    # backpressure threshold: no workload admits while the engine holds
    # at least this many pending pods (queued + backoff) — the knob
    # that bounds materialized-pod memory at million-pod backlogs.
    # 0 = unlimited.
    max_materialized_pods: int = 0
    # ---- closed-loop capacity (scheduler/capacity/) ----
    # node-provisioner control loop: scale node pools up per accelerator
    # shape off the pending backlog's recorded unschedulability, scale
    # down by drain-and-consolidate (harvest pods first) and release
    # only empty, cooldown-expired nodes. 0 (the default) never
    # constructs the loop — placements bit-identical (tests/
    # test_capacity.py parity + the CI capacity job's knob-off tier-1
    # leg, the defrag/workload-tier discipline).
    provisioner_interval_s: float = 0.0
    # per-pool fleet-size bounds: ((pool, min, max), ...) — config
    # `poolBounds: {v4-pool: {min: 1, max: 16}}`. Pools without an
    # entry use the template's own bounds (default 0..64). The
    # provisioner never releases below min and never requests past max.
    pool_bounds: tuple = ()
    # a node must sit EMPTY this long before scale-down may release it
    # (and no release at all within one hysteresis window of the pool's
    # last scale-up — flapping demand must never oscillate the fleet)
    scale_down_cooldown_s: float = 300.0
    provisioner_hysteresis_s: float = 60.0
    # provider-failure exponential backoff (stockouts, quota denials,
    # written-off requests): initial doubling to the max, seeded jitter;
    # breakerThreshold consecutive failures open the pool's circuit
    # breaker for provisioner_backoff_max_s
    provisioner_backoff_s: float = 5.0
    provisioner_backoff_max_s: float = 60.0
    # an in-flight capacity request unanswered past this is WRITTEN OFF
    # (failure-path backoff applies); a node that arrives later anyway
    # is adopted through membership reconciliation, never leaked
    provision_timeout_s: float = 120.0
    # ---- SLO-guarded colocated serving (scheduler/elastic/sloguard.py,
    # utils/obs.py SloMonitor, scheduler/policy/headroom.py) ----
    # master knob: OFF (the default) constructs none of it — no monitor,
    # no guard, no headroom gate, placements bit-identical
    # (tests/test_slo.py parity + the CI slo job's YODA_SLO=0 tier-1
    # leg, the elastic/torus discipline).
    slo_serving: bool = field(default_factory=_slo_default)
    # reserved serving headroom as a fraction of cluster chips: the
    # non-serving aggregate (training + harvest) may never occupy more
    # than (1 - pct) of capacity, expressed as a quota level ABOVE every
    # tenant in the DRF hierarchy. 0 (default) reserves nothing.
    serving_headroom_pct: float = 0.0
    # SLO objective: the fraction of serving binds that must land inside
    # their scv/slo-ms budget. Burn rate = violation-fraction /
    # (1 - target); 100x burn means every request is violating.
    slo_target_pct: float = 99.0
    # multi-window burn-rate trip (the Google SRE workbook discipline):
    # pressure asserts only when BOTH the fast and slow windows burn
    # above threshold — fast-only is noise, slow-only is stale history.
    slo_burn_threshold: float = 2.0
    slo_fast_window_s: float = 30.0
    slo_slow_window_s: float = 300.0
    # guard cadence on the engine clock (0 never ticks the guard even
    # when sloServing is on — monitor-only mode)
    slo_guard_interval_s: float = 1.0
    # max elastic-gang members shrunk per guard pass: degradation is
    # gradual by construction, one budgeted bite per interval
    slo_shrink_budget: int = 4
    # two-direction hysteresis (the provisioner's discipline): no
    # shrink within this window of the last give-back and no give-back
    # within it of the last shrink OR while pressure persists — flapping
    # traffic must never oscillate training gang sizes.
    slo_hysteresis_s: float = 30.0
    # lifecycle span tracing (utils/obs.py SpanRing): record the full
    # queued/cycle/bind_wire/watch_confirm span tree for 1-in-N pods
    # (deterministic by pod key). 0 disables, 1 traces every pod; env
    # YODA_TRACE_SAMPLING overrides. Per-pod e2e phase accounting (the
    # e2e_breakdown histograms) is always on — it is a handful of float
    # adds per bind, not a span.
    trace_sampling: int = field(default_factory=_trace_sampling_default)
    # black-box flight recorder: directory auto-dumps land in when the
    # breaker opens or a chaos invariant trips ("" = in-memory ring only;
    # env YODA_FLIGHT_DIR overrides an empty value)
    flight_dump_dir: str = ""

    def with_(self, **kw) -> "SchedulerConfig":
        return replace(self, **kw)

    @classmethod
    def from_profile(cls, profile: dict) -> "SchedulerConfig":
        """Build from a KubeSchedulerConfiguration-style profile dict (the
        shape shipped in deploy/yoda-tpu-scheduler.yaml)."""
        args = {}
        for p in profile.get("pluginConfig", []):
            if p.get("name") == "yoda-tpu":
                args = p.get("args", {})
        w = args.get("scoreWeights", {})
        weights = ScoreWeights(**{k: int(v) for k, v in w.items()}) if w else ScoreWeights()
        defaults = cls()  # single source of truth for absent args
        return cls(
            scheduler_name=profile.get("schedulerName", defaults.scheduler_name),
            percentage_of_nodes_to_score=int(profile.get(
                "percentageOfNodesToScore", defaults.percentage_of_nodes_to_score)),
            weights=weights,
            telemetry_max_age_s=float(args.get(
                "telemetryMaxAgeSeconds", defaults.telemetry_max_age_s)),
            gang_timeout_s=float(args.get("gangTimeoutSeconds", defaults.gang_timeout_s)),
            preemption=bool(args.get("preemption", defaults.preemption)),
            topology_weight=int(args.get("topologyWeight", defaults.topology_weight)),
            deschedule_interval_s=float(args.get(
                "descheduleIntervalSeconds", defaults.deschedule_interval_s)),
            elastic_gangs=bool(args.get(
                "elasticGangs", defaults.elastic_gangs)),
            defrag_interval_s=float(args.get(
                "defragIntervalSeconds", defaults.defrag_interval_s)),
            max_migrations_per_pass=max(int(args.get(
                "maxMigrationsPerPass",
                defaults.max_migrations_per_pass)), 1),
            defrag_cooldown_s=float(args.get(
                "defragCooldownSeconds", defaults.defrag_cooldown_s)),
            async_binding=bool(args.get("asyncBinding",
                                        defaults.async_binding)),
            bind_pipeline_window=max(int(args.get(
                "bindPipelineWindow", defaults.bind_pipeline_window)), 0),
            pod_hinted_backoff_s=float(args.get(
                "podHintedBackoffSeconds", defaults.pod_hinted_backoff_s)),
            columnar=bool(args.get("columnar", defaults.columnar)),
            columnar_shards=max(int(args.get(
                "columnarShards", defaults.columnar_shards)), 0),
            native_plane=bool(args.get("nativePlane",
                                       defaults.native_plane)),
            native_prefetch=bool(args.get("nativePrefetch",
                                          defaults.native_prefetch)),
            native_commit=bool(args.get("nativeCommit",
                                        defaults.native_commit)),
            churn_plane=bool(args.get("churnPlane",
                                      defaults.churn_plane)),
            fragmentation_weight=int(args.get(
                "fragmentationWeight", defaults.fragmentation_weight)),
            torus_placement=bool(args.get(
                "torusPlacement", defaults.torus_placement)),
            batch_max_pods=max(int(args.get(
                "batchMaxPods", defaults.batch_max_pods)), 1),
            degraded_mode=bool(args.get("degradedMode",
                                        defaults.degraded_mode)),
            quarantine_threshold=int(args.get(
                "quarantineThreshold", defaults.quarantine_threshold)),
            breaker_threshold=int(args.get(
                "breakerThreshold", defaults.breaker_threshold)),
            breaker_cooldown_s=float(args.get(
                "breakerCooldownSeconds", defaults.breaker_cooldown_s)),
            fleet_replicas=max(int(args.get(
                "fleetReplicas", defaults.fleet_replicas)), 1),
            fleet_processes=max(int(args.get(
                "fleetProcesses", defaults.fleet_processes)), 0),
            fleet_proc_index=int(args.get(
                "fleetProcIndex", defaults.fleet_proc_index)),
            gil_switch_interval_ms=max(float(args.get(
                "gilSwitchIntervalMs",
                defaults.gil_switch_interval_ms)), 0.0),
            schedule_heads=max(int(args.get(
                "scheduleHeads", defaults.schedule_heads)), 1),
            head_dispatch_depth=max(int(args.get(
                "headDispatchDepth", defaults.head_dispatch_depth)), 0),
            shard_leases=max(int(args.get(
                "shardLeases", defaults.shard_leases)), 0),
            fleet_mode=_valid_fleet_mode(str(args.get(
                "fleetMode", defaults.fleet_mode))),
            reflector_sharding=bool(args.get(
                "reflectorSharding", defaults.reflector_sharding)),
            shard_rebalance_s=float(args.get(
                "shardRebalanceSeconds", defaults.shard_rebalance_s)),
            webhook_port=int(args.get(
                "webhookPort", defaults.webhook_port)),
            webhook_fail_open=bool(args.get(
                "failOpen", defaults.webhook_fail_open)),
            webhook_stale_after_s=float(args.get(
                "webhookStaleAfterSeconds",
                defaults.webhook_stale_after_s)),
            policy_objective=_valid_policy_objective(str(args.get(
                "policyObjective", defaults.policy_objective))),
            heterogeneity_weight=int(args.get(
                "heterogeneityWeight", defaults.heterogeneity_weight)),
            workload_classes=_freeze_classes(args.get(
                "workloadClasses", defaults.workload_classes)),
            drf_fairness=bool(args.get(
                "drfFairness", defaults.drf_fairness)),
            tenant_quotas=_freeze_tenants(args.get(
                "tenants", defaults.tenant_quotas)),
            preemption_budget_window_s=float(args.get(
                "preemptionBudgetWindowSeconds",
                defaults.preemption_budget_window_s)),
            starvation_after_s=float(args.get(
                "starvationAfterSeconds", defaults.starvation_after_s)),
            workload_admission=bool(args.get(
                "workloadAdmission", defaults.workload_admission)),
            admission_rate_per_s=float(args.get(
                "admissionRatePerSecond", defaults.admission_rate_per_s)),
            admission_burst=max(int(args.get(
                "admissionBurst", defaults.admission_burst)), 1),
            max_materialized_pods=max(int(args.get(
                "maxMaterializedPods", defaults.max_materialized_pods)), 0),
            provisioner_interval_s=float(args.get(
                "provisionerIntervalSeconds",
                defaults.provisioner_interval_s)),
            pool_bounds=_freeze_pool_bounds(args.get(
                "poolBounds", defaults.pool_bounds)),
            scale_down_cooldown_s=float(args.get(
                "scaleDownCooldownSeconds",
                defaults.scale_down_cooldown_s)),
            provisioner_hysteresis_s=float(args.get(
                "provisionerHysteresisSeconds",
                defaults.provisioner_hysteresis_s)),
            provisioner_backoff_s=float(args.get(
                "provisionerBackoffSeconds",
                defaults.provisioner_backoff_s)),
            provisioner_backoff_max_s=float(args.get(
                "provisionerBackoffMaxSeconds",
                defaults.provisioner_backoff_max_s)),
            provision_timeout_s=float(args.get(
                "provisionTimeoutSeconds", defaults.provision_timeout_s)),
            slo_serving=bool(args.get(
                "sloServing", defaults.slo_serving)),
            serving_headroom_pct=min(max(float(args.get(
                "servingHeadroomPct",
                defaults.serving_headroom_pct)), 0.0), 0.9),
            slo_target_pct=min(max(float(args.get(
                "sloTargetPct", defaults.slo_target_pct)), 0.0), 100.0),
            slo_burn_threshold=max(float(args.get(
                "sloBurnThreshold", defaults.slo_burn_threshold)), 0.0),
            slo_fast_window_s=max(float(args.get(
                "sloFastWindowSeconds",
                defaults.slo_fast_window_s)), 1.0),
            slo_slow_window_s=max(float(args.get(
                "sloSlowWindowSeconds",
                defaults.slo_slow_window_s)), 1.0),
            slo_guard_interval_s=max(float(args.get(
                "sloGuardIntervalSeconds",
                defaults.slo_guard_interval_s)), 0.0),
            slo_shrink_budget=max(int(args.get(
                "sloShrinkBudget", defaults.slo_shrink_budget)), 1),
            slo_hysteresis_s=max(float(args.get(
                "sloHysteresisSeconds", defaults.slo_hysteresis_s)), 0.0),
            trace_sampling=max(int(args.get(
                "traceSampling", defaults.trace_sampling)), 0),
            flight_dump_dir=str(args.get(
                "flightDumpDir", defaults.flight_dump_dir)),
        )


# Note: upstream kube-scheduler's adaptive percentageOfNodesToScore
# formula (max(5, 50 - num_nodes/125), capped at 100) used to live here,
# but under the engine's 100-candidate floor and cap it is identically
# 100 for every cluster size, so the engine inlines the constant —
# see Engine._num_feasible_to_find (core.py) for the derivation and the
# measured justification.
