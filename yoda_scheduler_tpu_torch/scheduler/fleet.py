"""Scheduler fleet: N engine replicas, one cluster, optimistic commits.

The serve path tops out at what ONE engine thread can push through its
cycle loop. This module runs ``fleet_replicas`` full engines (own queue,
allocator, memos — everything engine-local) against the SAME cluster
backend, in the Omega shared-state style: every replica schedules from
its own snapshot and commits binds OPTIMISTICALLY. Nothing coordinates
the hot path; correctness comes from the AUTHORITY:

- the apiserver (tests/fake_apiserver.py) and FakeCluster both reject a
  bind whose target pod is already bound, whose chip/HBM claim would
  oversubscribe the node, or whose fencing token is stale — a 409 the
  committer resolves as a *foreign-bind conflict* (drop the pod, another
  replica won it) or a *node-claim conflict* (retry locally off the
  freshly-invalidated rows; the foreign bind already bumped the change
  log, so the ordinary snapshot repair re-filters exactly the dirty
  nodes). Server-returned 409s never trip the bind circuit breaker.
  NOTE a vanilla kube apiserver natively enforces only the pod-level
  half (binding 409s an already-assigned pod); the chip/fence checks
  must be ported as an admission webhook for production fleets —
  ARCHITECTURE.md "Authority scope, honestly".

Two placement regimes, the A/B the bench measures:

- **sharded** (default): node pools hash into ``shard_leases`` shards,
  each backed by a lease. A replica acquires its preferred shards
  (``shard % n == idx``), takes over expired ones (crash recovery),
  scores its owned shards' nodes up (ShardScore), and carries each
  shard's fencing epoch on binds into it — so replicas mostly place on
  disjoint node pools and conflicts stay rare, while lease loss mid-bind
  aborts the commit cleanly through the reservation unwind path.
- **free-for-all**: round-robin intake, no node preference, no fencing —
  every replica may take any pod, and only the optimistic 409s keep the
  invariants. Higher conflict rate, zero coordination; the baseline.

``fleet_replicas=1`` builds exactly one unmodified engine — placements
stay bit-identical to the classic scheduler (pinned in tests/test_fleet.py).

Driving: ``run_until_idle(rng)`` interleaves replica cycles
deterministically (the chaos fuzz replays failures from a seed alone);
``start(stop)`` runs one thread per replica for the serve/bench path.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from collections import deque

from .cluster import FakeCluster
from .columnar import pool_of, shard_of_pool
from .config import SchedulerConfig
from .core import Clock, FENCE_LOST, Scheduler, default_profile
from .framework import ScorePlugin, Status
from .multi import (_MergedFlightView, _MergedMetricsView, _MergedSpansView,
                    _MergedTracesView)
from .registry import build_profile
# the ONE lease-name prefix: fence tokens are matched by string between
# the engine side (here) and the authority (fake_apiserver / the Lease
# API via ShardLeaseManager) — a drifted copy would 409 every fenced bind
from ..k8s.leaderelect import REPLICA_HB_PREFIX, SHARD_LEASE_PREFIX
from ..utils.labels import GANG_NAME_LABEL, is_serving
from ..utils.pod import Pod

log = logging.getLogger("yoda-tpu.fleet")


def shard_of(name: str, shard_count: int) -> int:
    """Stable node/pod -> shard hash (crc32: identical across processes
    and runs, unlike PYTHONHASHSEED-salted hash())."""
    return zlib.crc32(name.encode()) % max(shard_count, 1)


class LocalLeaseStore:
    """In-memory shard-lease authority on an injectable clock — the same
    semantics the wire path gets from the Lease API + fake apiserver
    (k8s/leaderelect.py ShardLeaseManager): holder identity, float
    durations, a monotonically-increasing transitions epoch bumped on
    every change of holder, and fence validation at bind time
    (FakeCluster.lease_authority). Chaos hooks: revoke() force-expires a
    lease mid-bind-window, steal() reassigns it while the old holder's
    belief — and epoch — go stale (split-brain)."""

    def __init__(self, clock: Clock | None = None) -> None:
        self.clock = clock or Clock()
        self._lock = threading.Lock()
        # name -> [holder | None, epoch, renew_t, duration_s]
        self._leases: dict[str, list] = {}

    def try_acquire(self, name: str, identity: str,
                    duration_s: float) -> int | None:
        """Acquire (absent/expired lease) or refresh (own lease). Returns
        the fencing epoch, or None when another holder is live."""
        with self._lock:
            now = self.clock.time()
            rec = self._leases.get(name)
            if rec is None:
                self._leases[name] = [identity, 1, now, duration_s]
                return 1
            holder, epoch, renew_t, dur = rec
            if holder == identity:
                rec[2], rec[3] = now, duration_s
                return epoch
            if now - renew_t <= dur:
                return None  # live foreign holder
            # takeover of an expired lease: the epoch bump is what makes
            # the previous holder's in-flight fencing tokens rejectable
            self._leases[name] = [identity, epoch + 1, now, duration_s]
            return epoch + 1

    def renew(self, name: str, identity: str, epoch: int) -> bool:
        with self._lock:
            rec = self._leases.get(name)
            if rec is None or rec[0] != identity or rec[1] != epoch:
                return False
            if self.clock.time() - rec[2] > rec[3]:
                return False  # expired: must re-acquire (epoch may move)
            rec[2] = self.clock.time()
            return True

    def holder(self, name: str) -> tuple[str | None, int] | None:
        with self._lock:
            rec = self._leases.get(name)
            return (rec[0], rec[1]) if rec is not None else None

    def revoke(self, name: str) -> None:
        """Chaos: force-expire the lease AND retire its epoch — the
        holder cannot renew its way back; its outstanding fencing tokens
        are stale from this instant."""
        with self._lock:
            rec = self._leases.get(name)
            if rec is not None:
                rec[0] = None
                rec[1] += 1
                rec[2] = float("-inf")

    def release(self, name: str, identity: str, epoch: int) -> bool:
        """Voluntary handoff (dynamic shard rebalancing): the holder
        gives the lease up — holder cleared, epoch bumped (the releaser's
        in-flight fencing tokens die with it), immediately acquirable by
        the next claimant. False when the lease was already someone
        else's (a takeover raced the release; nothing of ours remains)."""
        with self._lock:
            rec = self._leases.get(name)
            if rec is None or rec[0] != identity or rec[1] != epoch:
                return False
            rec[0] = None
            rec[1] += 1
            rec[2] = float("-inf")
            return True

    def live(self, name: str) -> bool:
        """Held by SOMEONE and unexpired — the replica-heartbeat liveness
        read the rebalancer keys handoffs on."""
        with self._lock:
            rec = self._leases.get(name)
            return (rec is not None and rec[0] is not None
                    and self.clock.time() - rec[2] <= rec[3])

    def steal(self, name: str, identity: str,
              duration_s: float = 30.0) -> int:
        """Chaos: reassign the lease to `identity` regardless of expiry —
        the split-brain injection. The old holder still BELIEVES it owns
        the previous epoch; the authority now disagrees."""
        with self._lock:
            rec = self._leases.get(name)
            epoch = (rec[1] + 1) if rec is not None else 1
            self._leases[name] = [identity, epoch, self.clock.time(),
                                  duration_s]
            return epoch

    def validate_fence(self, fence: tuple) -> bool:
        """Authority-side bind-time check: token (name, holder, epoch)
        matches the live lease and the lease has not expired."""
        name, identity, epoch = fence
        with self._lock:
            rec = self._leases.get(name)
            return (rec is not None and rec[0] == identity
                    and rec[1] == epoch
                    and self.clock.time() - rec[2] <= rec[3])


class ShardedOwnedView:
    """Sharded-reflector facade for one fleet replica (the
    ``reflectorSharding`` knob): the replica's engine sees ONLY the node
    pools its shard leases currently cover. Membership reads filter to
    owned shards, cluster events for foreign nodes are dropped before
    they reach the engine's queue, and — because the engine's snapshot,
    columnar table, and memos key off this membership — foreign binds
    land as O(1) skipped names instead of NodeInfo rebuilds. This is
    what makes a replica's ingest O(own shards): measured at 4 replicas
    over the paced wire, the full-cluster view costs ~2.4x the CPU of a
    single replica for the same binds, almost all of it cross-replica
    state maintenance.

    Ownership is LIVE (the replica's shard->epoch map): a lease
    handover moves watch ownership with it — note_ownership_change()
    bumps the facade's membership version so both replicas' engines
    rebuild against the new pool sets, exactly like nodes joining and
    leaving. The trade, documented on the knob: a replica can only
    place within its owned pools (no foreign-shard spill), so pods only
    bind where their owning replica holds capacity.

    Writes (bind/evict) and global-truth reads (bound_node_of — the
    conflict/adoption protocol must see the WHOLE cluster) pass through
    untouched."""

    def __init__(self, cluster, owned: dict, shard_count: int,
                 node_shard=None) -> None:
        self.cluster = cluster
        self.telemetry = cluster.telemetry
        self._owned = owned  # the replica's live shard->epoch map
        self._shard_count = shard_count
        # node -> shard mapping, shared with the fence provider (the
        # two MUST agree or a replica would fence binds onto nodes
        # outside its view); the coordinator passes the pool-granular
        # form under reflectorSharding
        self._node_shard = node_shard or (
            lambda n: shard_of(n, shard_count))
        self._ver_bias = 0
        self._subs: list = []
        sub = getattr(cluster, "subscribe", None)
        if sub is not None:
            sub(self._relay)

    # ------------------------------------------------------------ sharding
    def _owns(self, node: str | None) -> bool:
        return node is None or self._node_shard(node) in self._owned

    def note_ownership_change(self) -> None:
        """Lease acquired/lost/handed over: the view's membership moved.
        Bump the membership version so every engine-side memo keyed on
        it (snapshot, columnar table, unschedulable classes) rebuilds."""
        self._ver_bias += 1

    # ------------------------------------------------------------- reading
    def node_names(self) -> list[str]:
        owned = self._owned
        ns = self._node_shard
        return [n for n in self.cluster.node_names() if ns(n) in owned]

    @property
    def nodes_version(self) -> int:
        # backing membership version + ownership epoch: both monotonic
        return getattr(self.cluster, "nodes_version", 0) + self._ver_bias

    # -------------------------------------------------------------- events
    def subscribe(self, cb) -> None:
        self._subs.append(cb)

    def _relay(self, event) -> None:
        # foreign-node events never reach the engine: their queue-hint
        # routing and memo invalidation work is exactly the per-replica
        # full-cluster ingest this view exists to cut
        if event.node is not None and not self._owns(event.node):
            return
        for cb in list(self._subs):
            cb(event)

    # --------------------------------------------------------- passthrough
    def __getattr__(self, name):
        return getattr(self.cluster, name)


class ShardScore(ScorePlugin):
    """Shard-affinity scoring for a fleet replica: nodes in the replica's
    owned shards score a flat bonus, steering placement onto its node
    pools so concurrent replicas rarely race for the same chips. Pure
    preference — a pod whose only feasible nodes live in foreign shards
    still places there (unfenced, resolved optimistically); the invariants
    never depend on this plugin. The weight must dominate the other
    scorers' normalized 0-100 bands (topology weight 6 is the largest
    default) so the preference actually partitions."""

    name = "shard-affinity"
    normalize_kind = "identity"
    score_inputs = "node"
    telemetry_dependent = False

    def __init__(self, shard_count: int, owned: dict, weight: int = 8) -> None:
        self.shard_count = shard_count
        self._owned = owned  # the replica's live shard->epoch map
        self.weight = weight

    def equivalence_key(self, pod):
        return ()  # node-side only: every pod sees the same bonus map

    def score(self, state, pod, node):
        s = shard_of(node.name, self.shard_count)
        return (100.0 if s in self._owned else 0.0), Status.success()


class _Replica:
    __slots__ = ("idx", "engine", "identity", "owned", "next_renew",
                 "thread", "incarnation", "manager", "inbox",
                 "clock_skew", "next_rebalance", "absent_since", "view",
                 "headset")

    def __init__(self, idx: int, engine: Scheduler, identity: str) -> None:
        self.idx = idx
        self.engine = engine
        self.identity = identity
        self.owned: dict[int, int] = {}  # shard -> fencing epoch
        self.next_renew = 0.0
        self.thread: threading.Thread | None = None
        self.incarnation = 0
        # wire backends only: the replica's ShardLeaseManager over the
        # real Lease API (the apiserver is then the fence authority)
        self.manager = None
        # threaded mode: the SchedulingQueue is engine-thread-only (no
        # internal lock), so cross-thread submit/forget ride this
        # GIL-atomic deque and the replica's own loop applies them —
        # the same marshalling pattern as the engine's _bind_results
        self.inbox: deque = deque()
        # chaos hook (CLOCK_SKEW): offset added to THIS replica's view of
        # the clock for lease upkeep — a slow clock silently misses
        # renewals while the replica keeps binding on stale epochs, the
        # split-brain-by-drift scenario the fencing checks exist for
        self.clock_skew = 0.0
        self.next_rebalance = 0.0
        # shard -> first instant its lease read ABSENT (orphan guard)
        self.absent_since: dict[int, float] = {}
        # reflectorSharding: the replica's owned-pools facade (None when
        # the knob is off) — lease changes bump its membership version
        self.view: ShardedOwnedView | None = None
        # intra-replica parallel scheduling (scheduler/heads.py): None
        # when scheduleHeads <= 1 (the classic one-loop replica)
        self.headset = None

    def memo_reset(self) -> None:
        """Shard ownership changed: drop every head's score-class memo
        (ShardScore reads the owned set by reference, so all heads
        scored against the old set)."""
        if self.headset is not None:
            self.headset.clear_score_memos()
        else:
            self.engine._score_memo.clear()


class FleetCoordinator:
    """N engine replicas over one cluster backend (module docstring).
    API-compatible with MultiProfileScheduler where the serve loop needs
    it (submit/tracks/forget/claims/engines/metrics/traces/wake)."""

    def __init__(self, cluster, config: SchedulerConfig | None = None,
                 replicas: int | None = None, clock: Clock | None = None,
                 mode: str | None = None, shard_count: int | None = None,
                 lease_store: LocalLeaseStore | None = None,
                 enabled: dict | None = None,
                 lease_duration_s: float = 30.0,
                 renew_period_s: float = 0.5,
                 shard_weight: int = 8,
                 validate_fence_locally: bool = True,
                 seed: int = 0,
                 rebalance_s: float | None = None,
                 cluster_wrapper=None,
                 proc_index: int | None = None,
                 proc_incarnation: int = 0) -> None:
        self.cluster = cluster
        self.config = config or SchedulerConfig()
        self.clock = clock or Clock()
        self.n = max(replicas if replicas is not None
                     else self.config.fleet_replicas, 1)
        # process-fleet mode (fleetProcesses): this coordinator IS one
        # replica slot of an N-process fleet — it builds only replica
        # `proc_index` while keeping self.n = the FLEET size, so the
        # preferred-shard math (s % n == idx), identities, and rng seeds
        # come out identical to the threaded fleet's slot. Nothing is
        # shared with sibling processes but the apiserver: leases fence,
        # 409s adjudicate, accepts() partitions intake.
        self.proc_index = (None if proc_index is None or proc_index < 0
                           else proc_index)
        if self.proc_index is not None and self.proc_index >= self.n:
            raise ValueError(
                f"fleetProcIndex {self.proc_index} >= fleet size {self.n}")
        self.mode = mode or self.config.fleet_mode
        if self.mode not in ("sharded", "free-for-all"):
            raise ValueError(f"unknown fleet mode {self.mode!r}")
        self.sharded = self.mode != "free-for-all" and self.n > 1
        self.shard_count = max(shard_count if shard_count is not None
                               else (self.config.shard_leases or self.n), 1)
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.shard_weight = shard_weight
        # True (default): fence_provider re-validates the token against
        # the local store right before commit, catching lease loss as a
        # clean FENCE_LOST abort. False: trust the owned map until the
        # next renew (the wire posture — ShardLeaseManager replicas always
        # do this), so a stale token actually travels to the AUTHORITY and
        # comes back as a 409 — the chaos fuzz runs both regimes.
        self.validate_fence_locally = validate_fence_locally
        self.seed = seed
        self._enabled = enabled
        # dynamic shard rebalancing cadence (config shardRebalanceSeconds,
        # 0 disables): replicas heartbeat `yoda-replica-<idx>` and a
        # takeover holder hands a foreign shard back once its preferred
        # owner's heartbeat is live again — dead-replica shards are
        # RE-LEASED instead of staying sticky with whoever took them over
        self.rebalance_s = (self.config.shard_rebalance_s
                            if rebalance_s is None else rebalance_s)
        # chaos/test hook: per-replica cluster facade factory
        # (wrapper(cluster, idx) -> backend) — NETWORK_PARTITION freezes
        # one replica's watch view while its binds still flow
        self._wrapper = cluster_wrapper
        # lease plumbing depends on where the authority lives:
        # - in-memory backends (FakeCluster family expose lease_authority)
        #   share one LocalLeaseStore, wired in as the bind-time fence
        #   validator;
        # - wire backends (KubeCluster exposes .client) run each replica's
        #   leases through the real Lease API (ShardLeaseManager) and the
        #   APISERVER validates the fence annotation — an engine-side
        #   store would fence against leases the server never saw.
        self._wire_leases = (self.sharded
                             and not hasattr(cluster, "lease_authority")
                             and getattr(cluster, "client", None) is not None)
        self.lease_store = lease_store or LocalLeaseStore(self.clock)
        # node -> shard mapping shared by fencing, shard-affinity, and
        # the sharded-reflection view. Default: full node name (the
        # historical fleet discipline, bit-identical placements). Under
        # reflectorSharding: the node POOL (columnar.pool_of) — slice
        # hosts of one pool land in one shard, so a replica's view keeps
        # whole slices together and multi-host gangs stay placeable.
        if self.sharded and self.config.reflector_sharding:
            self.node_shard = (
                lambda n, k=self.shard_count: shard_of_pool(pool_of(n), k))
        else:
            self.node_shard = (
                lambda n, k=self.shard_count: shard_of(n, k))
        if self.sharded and getattr(cluster, "lease_authority", None) is None \
                and hasattr(cluster, "lease_authority"):
            cluster.lease_authority = self.lease_store
        self.threaded = False
        self.wake = threading.Event()
        self._rr = 0
        # (membership version, sorted shard list) cache for
        # _populated_shards (reflectorSharding routing)
        self._pop_shards: tuple | None = None
        # pod keys submitted through a replica inbox but not yet drained
        # onto its queue: tracks() consults this SET instead of copying
        # every inbox per call (the serve intake calls tracks once per
        # pending pod per pass — O(inboxes) copies there were quadratic
        # during bursts). GIL-atomic add/discard; advisory like tracks()
        # itself — the serve loop's seen-uid map is the duplicate guard.
        self._inflight: set[str] = set()
        # workload-tier admission (scheduler/workload.py): every replica
        # parks the full workload set (O(1) each), but only the ADMISSION
        # OWNER — the shard-0 lease holder, the defrag ownership
        # discipline — materializes; this claim-once registry is the
        # fleet-wide guard that a lease handover mid-admission can never
        # double-materialize a workload, and the registry re-seeds a
        # crashed replica's parked set
        self._wl_lock = threading.Lock()
        # (key, uid) -> None: an insertion-ordered dict doubling as a
        # bounded FIFO set (see _claim_workload)
        self._wl_claimed: dict[tuple, None] = {}
        self._wl_registry: dict[str, object] = {}
        # capacity provisioner (scheduler/capacity/): ONE provider +
        # pool-template set shared by every replica incarnation, so a
        # crash rebuild re-wires identically and the takeover owner's
        # membership reconciliation adopts the dead owner's arrivals
        self._cap_provider = None
        self._cap_pools: tuple = ()
        self.replicas: list[_Replica] = (
            [self._build_replica(self.proc_index,
                                 incarnation=proc_incarnation)]
            if self.proc_index is not None
            else [self._build_replica(i) for i in range(self.n)])
        sub = getattr(cluster, "subscribe", None)
        if sub is not None:
            sub(lambda ev: self.wake.set())

    # -------------------------------------------------------------- building
    def _build_replica(self, idx: int, incarnation: int = 0) -> _Replica:
        # replica 0 runs the configured rng_seed so a fleet of ONE is the
        # classic engine bit-for-bit; higher replicas deterministically
        # diversify their tie-breaks, which spreads free-for-all replicas
        # across equal-score nodes instead of racing for the same one
        cfg = self.config if idx == 0 else self.config.with_(
            rng_seed=self.config.rng_seed + 7919 * idx)
        if self._enabled is None:
            profile, _alloc, _gang = default_profile(cfg)
        else:
            profile = build_profile(cfg, self._enabled)
        identity = f"{cfg.scheduler_name}-{idx}.{incarnation}"
        rep = _Replica(idx, None, identity)
        rep.incarnation = incarnation
        if self.sharded and not self.config.reflector_sharding:
            # shard-affinity scoring steers a full-cluster view toward
            # owned pools; under reflectorSharding every visible node IS
            # owned, so the plugin would add a constant to every
            # candidate (ranking-neutral) while costing a Python score
            # call per candidate and vetoing the fused native fold
            profile.score.append(ShardScore(
                self.shard_count, rep.owned, weight=self.shard_weight))
        backend = (self.cluster if self._wrapper is None
                   else self._wrapper(self.cluster, idx))
        if self.sharded and self.config.reflector_sharding:
            # sharded reflection: this replica ingests only its owned
            # pools (ShardedOwnedView docstring); watch ownership moves
            # with the shard lease via note_ownership_change
            rep.view = ShardedOwnedView(backend, rep.owned,
                                        self.shard_count,
                                        node_shard=self.node_shard)
            backend = rep.view
        engine = Scheduler(backend, cfg, profile=profile,
                           clock=self.clock)
        # replica-distinct pid: a merged /traces/export shows each
        # replica as its own process row in the Perfetto UI
        engine.spans.pid = idx
        engine.victim_router = self.submit
        if engine.defrag is not None:
            # exactly ONE replica runs the defrag loop at a time: N
            # replicas each migrating the same stray pod would multiply
            # churn N-fold and race each other's placements. Sharded
            # fleets key it on shard-0 ownership (lease-backed, so a
            # crashed owner's successor picks the loop up with the
            # shard); free-for-all fleets pin it to replica 0.
            if self.sharded:
                engine.defrag.owner_check = (lambda r=rep: 0 in r.owned)
            elif idx != 0:
                # free-for-all ownership is PINNED to replica 0, so a
                # non-zero replica's controller could never run — drop it
                # outright instead of leaving a permanently-refused loop
                # that wakes every interval and grows the not-owner skip
                # counter forever (sharded replicas keep theirs because
                # the shard-0 lease, and the loop with it, can move)
                engine.defrag = None
            if engine.defrag is not None:
                # demand is FLEET-wide: the pod a migration unblocks
                # usually queues on a different replica than the defrag
                # owner (advisory cross-thread reads, like tracks())
                engine.defrag.demand_check = (
                    lambda: any(len(r.engine.queue) or r.engine.waiting
                                for r in self.replicas))
        if engine.workloads is not None:
            wa = engine.workloads
            if self.sharded:
                # admission follows the shard-0 lease (crash => the
                # takeover replica inherits the tier with the shard)
                wa.owner_check = (lambda r=rep: 0 in r.owned)
            elif idx != 0:
                # free-for-all ownership pinned to replica 0, like
                # defrag — non-owners still PARK (so a future sharded
                # handover needs no state transfer) but never admit
                wa.owner_check = (lambda: False)
            wa.admitted_check = self._claim_workload
            wa.submit_pod = self.submit       # shard-aware gang routing
            wa.forget_pod = self.forget       # withdraw dooms fleet-wide
            wa.tracks_pod = self.tracks       # progress sees every shard
            wa.pending_fn = (
                # backpressure reads FLEET-wide pending (advisory
                # GIL-atomic cross-thread reads, like tracks())
                lambda: sum(r.engine.queue.pending() + len(r.engine.waiting)
                            for r in self.replicas))
        if engine.sloguard is not None:
            # exactly ONE replica runs the SLO-degradation loop's SHRINK
            # side at a time (the defrag/provisioner ownership
            # discipline): two guards shrinking the same gangs would
            # double-evict past the shrink budget and fight each other's
            # hysteresis. Non-owners keep EVALUATING their own monitor
            # each interval (the workload-admission pattern) — serving
            # binds burn on whichever replica owns them, and the owner
            # ORs every peer's local verdict.
            if self.sharded:
                engine.sloguard.owner_check = (lambda r=rep: 0 in r.owned)
            elif idx != 0:
                engine.sloguard.owner_check = (lambda: False)
            engine.sloguard.pressure_check = (
                # peers' LOCAL evaluations only (local_pressed), never
                # their OR'd `pressed` — two guards OR-ing each other's
                # combined state would latch fleet-wide pressure forever
                # (advisory GIL-atomic cross-thread reads, like defrag)
                lambda _eng=engine: any(
                    r.engine is not None and r.engine is not _eng
                    and r.engine.sloguard is not None
                    and r.engine.sloguard.local_pressed
                    for r in self.replicas))
            engine.sloguard.serving_pending_check = (
                # starved serving demand parks on whichever replica
                # owns its shard, not necessarily the guard owner's
                lambda: any(
                    is_serving(i.pod)
                    for r in self.replicas if r.engine is not None
                    for i in r.engine.queue.parked_infos()))
        if engine.provisioner is not None:
            # exactly ONE replica runs the capacity loop at a time —
            # the defrag ownership discipline: sharded fleets key it on
            # the shard-0 lease (crash => takeover inherits the loop and
            # re-adopts the dead owner's arriving nodes by label);
            # free-for-all pins replica 0 and drops the rest outright
            if self.sharded:
                engine.provisioner.owner_check = (lambda r=rep: 0 in r.owned)
            elif idx != 0:
                engine.provisioner = None
            if engine.provisioner is not None:
                # demand is FLEET-wide: the starved shape usually parks
                # on a different replica than the loop's owner
                # (advisory GIL-atomic cross-thread reads, like defrag)
                engine.provisioner.demand_fn = (
                    lambda: [i for r in self.replicas
                             for i in r.engine.queue.parked_infos()])
                self._wire_provisioner(engine)
        if self.sharded:
            if self._wire_leases:
                from ..k8s.leaderelect import ShardLeaseManager

                rep.manager = ShardLeaseManager(
                    self.cluster.client, self.shard_count,
                    identity=identity,
                    preferred={s for s in range(self.shard_count)
                               if s % self.n == idx},
                    lease_duration_s=self.lease_duration_s,
                    clock=self.clock,
                    replica_count=self.n, replica_idx=idx,
                    rebalance=self.rebalance_s > 0)
            engine.fence_provider = self._make_fence_provider(rep)
        rep.engine = engine
        if cfg.schedule_heads > 1:
            # intra-replica parallel heads (scheduler/heads.py): workers
            # share the replica's (possibly wrapped/sharded) backend and
            # fence with the replica's leases. Worker profiles replicate
            # the replica's shape — including ShardScore over the SAME
            # owned dict, so a lease move steers every head at once.
            from .heads import HeadSet

            def _worker_profile(wcfg, alloc, gangs, _rep=rep):
                # alloc/gangs are the REPLICA's shared instances (see
                # heads.py: per-head allocators double-book chips)
                if self._enabled is None:
                    p, _a, _g = default_profile(wcfg, allocator=alloc,
                                                gangs=gangs)
                else:
                    p = build_profile(wcfg, self._enabled,
                                      allocator=alloc, gangs=gangs)
                if self.sharded and not self.config.reflector_sharding:
                    p.score.append(ShardScore(
                        self.shard_count, _rep.owned,
                        weight=self.shard_weight))
                return p

            rep.headset = HeadSet(engine, cfg.schedule_heads,
                                  worker_profile_fn=_worker_profile)
        return rep

    # ------------------------------------------------------ capacity loop
    def set_capacity_provider(self, provider, pools=()) -> None:
        """Attach the (single, shared) capacity provider and pool
        templates to every replica's provisioner — and remember them so
        crash-rebuilt incarnations re-wire identically."""
        self._cap_provider = provider
        self._cap_pools = tuple(pools)
        for rep in self.replicas:
            if rep.engine.provisioner is not None:
                self._wire_provisioner(rep.engine)

    def _wire_provisioner(self, engine) -> None:
        # membership/occupancy reads go to the UNSHARDED cluster: under
        # reflectorSharding the engine's own backend is an owned-pools
        # view that may not even see the managed pools (the
        # bound_node_of global-truth discipline)
        engine.provisioner.truth = self.cluster
        if self._cap_provider is not None:
            engine.provisioner.attach_provider(self._cap_provider)
        for template in self._cap_pools:
            if template.pool not in engine.provisioner.pools:
                engine.provisioner.add_pool(template)

    def _make_fence_provider(self, rep: _Replica):
        def provider(pod, node):
            s = self.node_shard(node)
            epoch = rep.owned.get(s)
            if epoch is None:
                return None  # foreign shard: unfenced optimistic bind
            token = (f"{SHARD_LEASE_PREFIX}{s}", rep.identity, epoch)
            if rep.manager is not None or not self.validate_fence_locally:
                # trust-owned posture: the AUTHORITY validates at commit —
                # a token gone stale since the last renew comes back as
                # an ordinary 409 conflict, same recovery path (wire
                # replicas always run this way; local fleets opt in)
                return token
            if not self.lease_store.validate_fence(token):
                # expired/stolen since the cycle started: ONE clean abort,
                # then the shard leaves `owned` and retries go unfenced
                rep.owned.pop(s, None)
                rep.memo_reset()
                return FENCE_LOST
            return token
        return provider

    # --------------------------------------------------------------- leases
    def _lease_name(self, shard: int) -> str:
        return f"{SHARD_LEASE_PREFIX}{shard}"

    def _hb_name(self, idx: int) -> str:
        return f"{REPLICA_HB_PREFIX}{idx}"

    def _lease_step(self, rep: _Replica, now: float) -> None:
        """One upkeep pass for one replica: renew owned shards (dropping
        the lost), acquire preferred shards, take over expired ones."""
        if rep.manager is not None:
            # wire leases: the manager talks to the real Lease API; sync
            # its owned map into the one ShardScore/fence_provider read
            before = dict(rep.owned)
            rep.manager.step()
            rep.owned.clear()
            rep.owned.update(rep.manager.owned)
            if rep.owned != before:
                rep.memo_reset()
                if rep.view is not None:
                    rep.view.note_ownership_change()
            rep.next_renew = now + self.renew_period_s
            return
        changed = False
        if self.rebalance_s > 0:
            # liveness heartbeat: `yoda-replica-<idx>` says "someone is
            # serving this slot" — the read every OTHER replica's
            # rebalance handoff keys on. Same duration as shard leases,
            # so liveness and ownership expire on the same horizon.
            self.lease_store.try_acquire(self._hb_name(rep.idx),
                                         rep.identity,
                                         self.lease_duration_s)
        for s in list(rep.owned):
            if not self.lease_store.renew(self._lease_name(s),
                                          rep.identity, rep.owned[s]):
                rep.owned.pop(s, None)
                changed = True
        if self.rebalance_s > 0 and now >= rep.next_rebalance:
            rep.next_rebalance = now + self.rebalance_s
            for s in list(rep.owned):
                pref = s % self.n
                if pref == rep.idx:
                    continue
                if self.lease_store.live(self._hb_name(pref)):
                    # the preferred owner is provably alive again: hand
                    # its shard back (release retires our epoch, so any
                    # in-flight fenced commit of ours dies cleanly at
                    # the authority) instead of staying sticky forever
                    if self.lease_store.release(self._lease_name(s),
                                                rep.identity,
                                                rep.owned[s]):
                        rep.owned.pop(s, None)
                        changed = True
                        rep.engine.metrics.inc(
                            "shard_rebalance_releases_total")
                        rep.engine.flight.record(
                            "shard_rebalance", shard=s,
                            released_to=pref, by=rep.identity)
        for s in range(self.shard_count):
            if s in rep.owned:
                continue
            preferred = (s % self.n == rep.idx)
            if not preferred:
                if self.rebalance_s > 0 \
                        and self.lease_store.live(
                            self._hb_name(s % self.n)):
                    # the preferrer is alive: the shard is THEIRS to
                    # (re)take — grabbing it here would instantly undo a
                    # rebalance release (ours or anyone's)
                    rep.absent_since.pop(s, None)
                    continue
                held = self.lease_store.holder(self._lease_name(s))
                if held is None:
                    # absent: leave it to its preferrer — unless the
                    # preferrer provably died before ever creating it
                    # (orphan guard: nobody may own a shard forever-
                    # nobody, or its pods route to a replica that never
                    # fences them)
                    first = rep.absent_since.setdefault(s, now)
                    if self.rebalance_s <= 0 \
                            or now - first <= self.lease_duration_s:
                        continue
                else:
                    rep.absent_since.pop(s, None)
            epoch = self.lease_store.try_acquire(
                self._lease_name(s), rep.identity, self.lease_duration_s)
            if epoch is not None:
                rep.absent_since.pop(s, None)
                was_foreign = epoch > 1
                rep.owned[s] = epoch
                changed = True
                if was_foreign:
                    # epoch 1 = first-ever creation; anything later means
                    # a previous holder's epoch was retired — a takeover
                    # (crash recovery) or a rebalance handoff landing
                    rep.engine.metrics.inc("shard_takeovers_total")
                    rep.engine.flight.record(
                        "shard_takeover", shard=s, epoch=epoch,
                        by=rep.identity, preferred=preferred)
        if changed:
            # shard ownership is a score input outside every version
            # vector: the score-class memo must not replay stale
            # shard-affinity raws
            rep.memo_reset()
            if rep.view is not None:
                # sharded reflection: the watch-ownership handover rides
                # the lease — membership version bump makes the engine
                # rebuild against the new pool set
                rep.view.note_ownership_change()
        rep.next_renew = now + self.renew_period_s

    # --------------------------------------------------------------- intake
    def claims(self, scheduler_name: str) -> bool:
        return scheduler_name == self.config.scheduler_name

    def accepts(self, pod: Pod) -> bool:
        """Process-fleet intake partition: each pod hashes to exactly ONE
        process of the fleet (gang members ride their gang name, the
        _route discipline, so assembly never splits across processes).
        Advisory like tracks() — the authority's pod-level 409 is what
        actually prevents a double bind if two processes ever disagree."""
        if self.proc_index is None:
            return True
        gang = pod.labels.get(GANG_NAME_LABEL)
        if gang:
            # stable index mapping, the _route gang discipline
            return shard_of(gang, self.n) == self.proc_index
        s = shard_of(pod.key, self.shard_count)
        if self.sharded and self.config.reflector_sharding:
            # mirror _route: only shards whose pools hold nodes may own
            # intake — a pod keyed onto a pool-less shard would strand
            # forever on a process whose sharded view has no capacity
            # (pools hash coarsely; a small cluster can land every pool
            # on one shard)
            pop = self._populated_shards()
            if pop:
                s = pop[s % len(pop)]
        return s % self.n == self.proc_index

    def _route(self, pod: Pod) -> _Replica:
        if self.proc_index is not None:
            # this process IS one replica slot; accepts() already
            # partitioned intake, so everything submitted here is ours
            return self.replicas[0]
        # gangs ride their gang name in EVERY mode: gang state (permit
        # parking, slice plans) is engine-local, so members split across
        # replicas would each wait forever for peers the other engine
        # holds — round-robin must never shred a gang
        gang = pod.labels.get(GANG_NAME_LABEL)
        if gang:
            # STABLE index mapping, never live lease ownership: members
            # of one gang arrive over time, and routing by ownership
            # would split the gang permanently across replicas the first
            # time a lease changed hands mid-assembly
            return self.replicas[shard_of(gang, self.n)]
        if not self.sharded:
            self._rr = (self._rr + 1) % self.n
            return self.replicas[self._rr]
        s = shard_of(pod.key, self.shard_count)
        if self.config.reflector_sharding:
            # route only into shards whose pools actually hold nodes: a
            # pod keyed onto a pool-less shard would sit forever on a
            # replica whose sharded view contains no capacity (pools
            # hash coarsely — a small cluster can land every pool on
            # one shard)
            pop = self._populated_shards()
            if pop:
                s = pop[s % len(pop)]
        for rep in self.replicas:
            if s in rep.owned:
                return rep
        return self.replicas[s % self.n]

    def _populated_shards(self) -> list:
        """Sorted shards that own at least one node's pool (sharded
        reflection), cached on the membership version."""
        nv = getattr(self.cluster, "nodes_version", 0)
        hit = self._pop_shards
        if hit is not None and hit[0] == nv:
            return hit[1]
        shards = sorted({self.node_shard(n)
                         for n in self.cluster.node_names()})
        self._pop_shards = (nv, shards)
        return shards

    def submit(self, pod: Pod) -> bool:
        if pod.scheduler_name != self.config.scheduler_name:
            return False
        rep = self._route(pod)
        if self.threaded:
            # the replica's queue is its own thread's property: marshal
            # the submission through its inbox instead of racing pop()
            self._inflight.add(pod.key)
            rep.inbox.append(("submit", pod))
            rep.engine.wake.set()
            self.wake.set()
            return True
        ok = rep.engine.submit(pod)
        if ok:
            self.wake.set()
        return ok

    # ------------------------------------------------------ workload tier
    def _claim_workload(self, w) -> bool:
        """Fleet-wide admission claim-once (WorkloadAdmission
        admitted_check): True for exactly the FIRST replica that reaches
        the admit step — a lease handover mid-admission finds the claim
        taken and adopts instead of re-materializing. Claims are keyed
        by (key, uid): a deleted-then-recreated workload (new uid) is a
        new incarnation and may admit; the registry is FIFO-bounded so
        a churning serve loop cannot grow it forever."""
        token = (w.key, getattr(w, "uid", ""))
        with self._wl_lock:
            if token in self._wl_claimed:
                return False
            self._wl_claimed[token] = None
            while len(self._wl_claimed) > 65536:
                self._wl_claimed.pop(next(iter(self._wl_claimed)))
            return True

    def submit_workload(self, w) -> bool:
        """Park a Workload on EVERY replica (each copy O(1)): whichever
        replica holds the shard-0 lease admits; the others' copies make
        lease handover state-transfer-free. Requires the
        workloadAdmission knob (engines built without the tier refuse)."""
        if w.scheduler_name != self.config.scheduler_name:
            return False
        if self.replicas[0].engine.workloads is None:
            return False
        from .workload import Workload

        with self._wl_lock:
            self._wl_registry[w.key] = w
        ok = False
        for rep in self.replicas:
            # each replica gets its OWN object — conditions/state are
            # engine-thread-mutable and must not race across replicas
            clone = w if self.n == 1 else Workload.from_cr(w.to_cr())
            if self.threaded:
                rep.inbox.append(("submit_workload", clone))
                rep.engine.wake.set()
                ok = True
            else:
                ok = rep.engine.submit_workload(clone) or ok
        if ok:
            self.wake.set()
        return ok

    def withdraw_workload(self, key: str,
                          reason: str = "withdrawn") -> bool:
        """Withdraw fleet-wide: the claim registry blocks any future
        admission, every replica unparks its copy, and the replica that
        admitted dooms the materialized members (engine withdraw)."""
        if self.replicas[0].engine.workloads is None:
            return False
        with self._wl_lock:
            w = self._wl_registry.pop(key, None)
            # block THIS incarnation from any future admission (a
            # recreated CR arrives with a fresh uid and may admit)
            self._wl_claimed[(key, getattr(w, "uid", "")
                              if w is not None else "")] = None
        for rep in self.replicas:
            if self.threaded:
                rep.inbox.append(("withdraw_workload", (key, reason)))
                rep.engine.wake.set()
            else:
                rep.engine.withdraw_workload(key, reason)
        self.wake.set()
        return True

    def workload_of(self, key: str):
        """The most-advanced view of a workload across replicas (tests/
        status readers): a resolved state wins over a parked copy."""
        from .workload import PARKED

        best = None
        for rep in self.replicas:
            wa = rep.engine.workloads
            w = wa.get(key) if wa is not None else None
            if w is None:
                continue
            if best is None or (w.state != PARKED and best.state == PARKED):
                best = w
        return best

    def submit_to(self, idx: int, pod: Pod) -> bool:
        """Chaos hook: queue a pod on a SPECIFIC replica — the split-brain
        injection queues the same pod on two replicas at once."""
        return self.replicas[idx].engine.submit(pod)

    def tracks(self, pod_key: str) -> bool:
        # advisory in threaded mode (GIL-atomic dict/set reads; the
        # serve loop's seen-uid map is the real duplicate guard)
        return (pod_key in self._inflight
                or any(r.engine.tracks(pod_key) for r in self.replicas))

    def forget(self, pod_key: str) -> None:
        for r in self.replicas:
            if self.threaded:
                r.inbox.append(("forget", pod_key))
                r.engine.wake.set()
            else:
                r.engine.forget(pod_key)

    def reconcile(self, pods) -> tuple[int, int]:
        """Fleet-wide restart reconciliation (the serve loop's startup
        pass, fed by the paginated iter_pods read): bound pods are
        adopted from cluster truth, stranded pods are scrubbed and routed
        through the ordinary shard-aware submit. Works on a one-shot
        generator — one pass, per-pod routing."""
        from ..utils.pod import ASSIGNED_CHIPS_LABEL, PodPhase

        adopted = requeued = 0
        bn = getattr(self.cluster, "bound_node_of", None)
        m = self.replicas[0].engine.metrics
        for pod in pods:
            # process fleets reconcile only their OWN partition: every
            # sibling process runs this same pass at startup, and without
            # the accepts() guard each would adopt/requeue the whole
            # cluster's pods onto its one local replica
            if pod.scheduler_name != self.config.scheduler_name \
                    or not self.accepts(pod) or self.tracks(pod.key):
                continue
            node = bn(pod.key) if bn is not None else None
            if node is not None:
                pod.node = node
                pod.phase = PodPhase.BOUND
                adopted += 1
                m.inc("reconcile_adopted_total")
                continue
            pod.node = None
            pod.phase = PodPhase.PENDING
            pod.labels.pop(ASSIGNED_CHIPS_LABEL, None)
            if self.submit(pod):
                requeued += 1
                m.inc("reconcile_requeued_total")
        if adopted or requeued:
            self.replicas[0].engine.flight.record(
                "reconcile", adopted=adopted, requeued=requeued)
        return adopted, requeued

    # -------------------------------------------------------------- driving
    def step(self, rng: random.Random | None = None) -> str | None:
        """Deterministic single-step: lease upkeep for every due replica,
        then one scheduling cycle on the first ready replica in seeded
        rotation. Returns the cycle outcome or None when every replica is
        idle. The chaos fuzz interleaves replicas through this, so a
        seed fully determines the commit order."""
        now = self.clock.time()
        if self.sharded:
            for rep in self.replicas:
                # lease upkeep runs on the REPLICA's view of the clock
                # (chaos CLOCK_SKEW): a drifted-slow replica silently
                # skips renewals — its leases expire under it while it
                # keeps committing on stale epochs, and only the
                # authority's fence check stands between that and a
                # silent write
                rep_now = now + rep.clock_skew
                if rep_now >= rep.next_renew:
                    self._lease_step(rep, rep_now)
        order = list(self.replicas)
        if rng is not None:
            rng.shuffle(order)
        for rep in order:
            if rep.headset is not None:
                # seeded head interleave inside the replica — the chaos
                # fuzz's commit order stays a pure function of the seed
                outcome = rep.headset.step(rng)
            else:
                outcome = rep.engine.run_one()
            if outcome is not None:
                return outcome
        return None

    def next_wake_at(self) -> float | None:
        wakes = [w for w in ((r.headset.next_wake_at()
                              if r.headset is not None
                              else r.engine.next_wake_at())
                             for r in self.replicas) if w is not None]
        return min(wakes) if wakes else None

    def run_until_idle(self, max_cycles: int = 100_000,
                       rng: random.Random | None = None) -> int:
        """Drain the whole fleet deterministically (tests/bench harness):
        seeded replica interleave, shared virtual clock."""
        rng = rng if rng is not None else random.Random(self.seed)
        cycles = 0
        while cycles < max_cycles:
            if self.step(rng) is not None:
                cycles += 1
                continue
            wake = self.next_wake_at()
            if wake is None:
                break
            self.clock.sleep(max(wake - self.clock.time(), 0.01))
            cycles += 1
        return cycles

    # ------------------------------------------------------------- threaded
    def start(self, stop: threading.Event) -> None:
        """Serve/bench mode: one thread per replica, each running its own
        cycle loop (lease upkeep inline, cycles whenever ready, parked on
        the engine's wake event otherwise)."""
        self.threaded = True
        for rep in self.replicas:
            t = threading.Thread(target=self._loop, args=(rep, stop),
                                 daemon=True, name=f"fleet-{rep.idx}")
            rep.thread = t
            t.start()
            if rep.headset is not None:
                # worker heads get their own threads; the replica loop
                # above keeps driving the primary (intake, controllers,
                # lease upkeep stay on the replica thread)
                rep.headset.start_workers(stop)

    def _drain_inbox(self, rep: _Replica) -> None:
        """Apply cross-thread submit/forget requests on the replica's own
        thread (the queue has no internal lock)."""
        while rep.inbox:
            try:
                op, arg = rep.inbox.popleft()
            except IndexError:
                return
            if op == "submit":
                rep.engine.submit(arg)
                # after the queue actually holds it, engine.tracks covers
                # it — drop the inflight marker (order matters: removing
                # first would open a tracked-nowhere window)
                self._inflight.discard(arg.key)
            elif op == "submit_workload":
                rep.engine.submit_workload(arg)
            elif op == "withdraw_workload":
                rep.engine.withdraw_workload(*arg)
            else:
                rep.engine.forget(arg)

    def _loop(self, rep: _Replica, stop: threading.Event) -> None:
        engine = rep.engine
        while not stop.is_set():
            if rep.inbox:
                self._drain_inbox(rep)
            now = self.clock.time() + rep.clock_skew
            if self.sharded and now >= rep.next_renew:
                self._lease_step(rep, now)
            try:
                outcome = engine.run_one()
            except Exception:
                # run_one contains cycle crashes; anything escaping is an
                # engine bug — log and keep the replica alive (the fleet's
                # whole point is surviving exactly this)
                log.exception("replica %d cycle escaped containment",
                              rep.idx)
                outcome = None
            if outcome is None:
                wake = engine.next_wake_at()
                timeout = 0.05
                if wake is not None:
                    timeout = min(max(wake - self.clock.time(), 0.001),
                                  0.05)
                if engine.wake.wait(timeout):
                    engine.wake.clear()

    def join(self, timeout: float = 5.0) -> None:
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=timeout)
            if rep.headset is not None:
                # worker heads MUST be down before the caller tears the
                # wire down: a head that dispatches an async bind after
                # the RTT workers exit never gets its completion callback,
                # so its dispatch-window slot is never released and the
                # head strands forever in _dispatch_sem.acquire(),
                # pinning engine + cluster for the life of the process
                rep.headset.join(timeout=timeout)

    # ----------------------------------------------------------- chaos hooks
    def crash_replica(self, idx: int, pods=None) -> _Replica:
        """A replica process dies: every engine-local thing (queue,
        reservations, memos, lease beliefs) is gone. Build a fresh
        incarnation and reconcile ITS share of the workload from cluster
        truth — pods other replicas still track are left alone (fleet-
        level tracks guard), bound pods are adopted, the rest requeue.
        The dead incarnation's leases expire on their own; survivors take
        them over through the ordinary expiry path."""
        if self.threaded:
            # the dead incarnation's thread would keep scheduling and the
            # replacement would never get one — this hook simulates a
            # process death for the DETERMINISTIC driver only
            raise RuntimeError("crash_replica is not available in "
                               "threaded mode")
        old = self.replicas[idx]
        rep = self._build_replica(idx, incarnation=old.incarnation + 1)
        self.replicas[idx] = rep
        if pods:
            rep.engine.reconcile(
                [p for p in pods if not self.tracks(p.key)])
        if rep.engine.workloads is not None and self._wl_registry:
            # re-seed the fresh incarnation from the WHOLE registry —
            # claimed entries included: their clones flow through the
            # admitted_check adopt path (state becomes Admitted,
            # "admitted by peer replica") so the rebuilt replica holds
            # a resolved record again and a LATER withdraw can still
            # run the one-pass member retirement; filtering claimed
            # entries out left withdrawn-after-crash workloads with no
            # engine able to doom their materialized members
            from .workload import Workload

            with self._wl_lock:
                pending = list(self._wl_registry.values())
            for w in pending:
                rep.engine.submit_workload(Workload.from_cr(w.to_cr()))
        return rep

    def skew_replica_clock(self, idx: int, skew_s: float) -> None:
        """Chaos (CLOCK_SKEW): drift one replica's lease clock by
        `skew_s` (negative = running slow). A drift past the lease
        duration makes the replica miss its renewals without noticing —
        the split-brain-by-drift scenario. 0 heals the drift."""
        self.replicas[idx].clock_skew = skew_s

    def revoke_replica_leases(self, idx: int) -> int:
        """Chaos: force-expire every lease the replica currently owns
        (LEASE_EXPIRY window). Its next fenced commit aborts cleanly; the
        shards are up for takeover immediately."""
        rep = self.replicas[idx]
        revoked = 0
        for s in list(rep.owned):
            self.lease_store.revoke(self._lease_name(s))
            revoked += 1
        return revoked

    # ------------------------------------------------------------ reporting
    @property
    def engines(self) -> dict[str, Scheduler]:
        out = {f"replica-{r.idx}": r.engine for r in self.replicas}
        for r in self.replicas:
            if r.headset is not None:
                for i, h in enumerate(r.headset.heads[1:], start=1):
                    out[f"replica-{r.idx}-head-{i}"] = h
        return out

    @property
    def metrics(self):
        return _MergedMetricsView(self)

    @property
    def traces(self):
        return _MergedTracesView(self)

    @property
    def spans(self):
        return _MergedSpansView(self)

    @property
    def flight(self):
        return _MergedFlightView(self)

    def bin_pack_utilization(self) -> float:
        return self.replicas[0].engine.bin_pack_utilization()

    def fleet_stats(self) -> dict:
        """Aggregate + per-replica shared-state counters: binds committed
        per replica (the share), conflicts by resolution, lease aborts,
        and the authority's own rejection book (the server-side proof)."""
        keys = ("pods_scheduled_total", "bind_conflicts_total",
                "bind_conflict_retries_total",
                "foreign_bind_conflicts_total", "foreign_bind_skips_total",
                "lease_lost_aborts_total", "bind_errors_total",
                "async_bind_conflict_corrections_total")
        agg = {k: 0 for k in keys}
        per_replica = []
        for r in self.replicas:
            # a replica's share is the sum over its heads (one engine in
            # the classic case; scheduleHeads engines otherwise)
            engines = (r.headset.heads if r.headset is not None
                       else (r.engine,))
            row = {k: 0 for k in keys}
            for e in engines:
                c = e.metrics.counters
                for k in keys:
                    row[k] += c.get(k, 0)
            per_replica.append(row)
            for k in keys:
                agg[k] += row[k]
        out = dict(agg)
        # async dispatch counts optimistically; a later 409 records a
        # correction — the share is committed binds, not dispatches
        out["pods_scheduled_total"] -= out.pop(
            "async_bind_conflict_corrections_total")
        out["per_replica_binds"] = [
            p["pods_scheduled_total"]
            - p["async_bind_conflict_corrections_total"]
            for p in per_replica]
        out["shards_owned"] = [sorted(r.owned) for r in self.replicas]
        if any(r.headset is not None for r in self.replicas):
            out["heads"] = {f"replica-{r.idx}": r.headset.stats()
                            for r in self.replicas
                            if r.headset is not None}
        out["authority_rejections"] = dict(
            getattr(self.cluster, "bind_conflicts", {}) or {})
        return out


# ======================================================================
# process fleet (fleetProcesses): real OS processes, off the GIL
# ======================================================================
#
# The threaded fleet shares one interpreter, so N replicas still share
# ONE GIL: past the native-kernel fraction, cycles serialize. A process
# fleet runs each replica slot as its own OS process — own interpreter,
# own GIL, own watch cache — against the same wire apiserver. The fleet
# grammar already assumed nothing shared but the authority (sharded
# reflection, per-shard leases, pipelined bind wire, 409 adoption), so
# the slot inside each child is just FleetCoordinator(proc_index=i):
# identities, preferred shards, and rng seeds come out identical to the
# threaded fleet's slot i. Intake partitions by accepts() (crc32 over
# pod key / gang name), restarts re-derive a slot's partition from
# cluster truth through the ordinary startup reconcile, and the only
# cross-process metric plane is the per-child /metrics pull.

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse_prom(text: str) -> dict[str, float]:
    """Prometheus text exposition -> {series: value} (labels kept in the
    key so per-labelset series aggregate independently)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, val = line.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


def _fleet_proc_main(server_url: str, config: SchedulerConfig, enabled,
                     idx: int, total: int, incarnation: int,
                     metrics_port: int, poll_s: float) -> None:
    """Child-process entry (spawn target): serve ONE replica slot of a
    process fleet against the wire apiserver at `server_url`. Runs until
    the parent terminates the process — all durable state lives on the
    server, so teardown needs no handshake."""
    import sys

    from ..k8s.client import KubeClient, run_scheduler_against_cluster

    cfg = config.with_(fleet_processes=total, fleet_proc_index=idx)
    if cfg.gil_switch_interval_ms > 0:
        # children bypass cli.cmd_serve, so the knob is applied here too
        sys.setswitchinterval(cfg.gil_switch_interval_ms / 1000.0)
    client = KubeClient(server_url)
    run_scheduler_against_cluster(client, [(cfg, enabled)],
                                  metrics_port=metrics_port,
                                  poll_s=poll_s,
                                  proc_incarnation=incarnation)


class ProcessFleet:
    """Parent-side controller: spawn `procs` OS processes, each one
    replica slot of the fleet, against the wire apiserver; restart
    crashed children with a bumped incarnation (their startup reconcile
    re-derives the slot's partition from cluster truth); aggregate the
    shared-nothing metrics plane by scraping each child's /metrics."""

    def __init__(self, server_url: str, config: SchedulerConfig,
                 procs: int | None = None, enabled: dict | None = None,
                 poll_s: float = 0.25, restart: bool = True,
                 max_restarts: int = 16) -> None:
        import multiprocessing

        self.server_url = server_url
        self.config = config
        self.n = max(procs if procs is not None
                     else config.fleet_processes, 1)
        self.enabled = enabled
        self.poll_s = poll_s
        self.restart_enabled = restart
        # spawn, never fork: the parent holds live HTTP connections and
        # threads (bench harness, test runner) a forked child would
        # inherit mid-state; spawn re-imports, which is also what a real
        # process manager (systemd, kubelet) does
        self._ctx = multiprocessing.get_context("spawn")
        self.procs: list = [None] * self.n
        self.ports = [_free_port() for _ in range(self.n)]
        self.incarnations = [0] * self.n
        self.restarts = 0
        # crash-loop cap: a child that cannot start (bad config, broken
        # spawn environment) would otherwise restart forever
        self.max_restarts = max_restarts
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None

    def _spawn(self, idx: int) -> None:
        p = self._ctx.Process(
            target=_fleet_proc_main,
            args=(self.server_url, self.config, self.enabled, idx,
                  self.n, self.incarnations[idx], self.ports[idx],
                  self.poll_s),
            daemon=True, name=f"yoda-proc-{idx}")
        p.start()
        self.procs[idx] = p

    def start(self) -> "ProcessFleet":
        for i in range(self.n):
            self._spawn(i)
        if self.restart_enabled:
            self._monitor = threading.Thread(target=self._watch,
                                             daemon=True,
                                             name="proc-fleet-monitor")
            self._monitor.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(0.25):
            for i, p in enumerate(self.procs):
                if p is None or p.is_alive() or self._stop.is_set():
                    continue
                if self.restarts >= self.max_restarts:
                    log.error("fleet process %d died (exit %s) but the "
                              "restart budget (%d) is spent — crash "
                              "loop, giving up on this slot", i,
                              p.exitcode, self.max_restarts)
                    self.procs[i] = None
                    continue
                self.incarnations[i] += 1
                self.restarts += 1
                log.warning("fleet process %d died (exit %s); "
                            "restarting as incarnation %d", i,
                            p.exitcode, self.incarnations[i])
                self._spawn(i)

    def wait_ready(self, timeout: float = 120.0) -> None:
        """Block until every child's /metrics answers (the metrics server
        starts after the child's cluster cache syncs and reconcile ran —
        answering means the slot is serving)."""
        deadline = time.time() + timeout
        pending = set(range(self.n))
        while pending and time.time() < deadline:
            for i in list(pending):
                if self._scrape_raw(i) is not None:
                    pending.discard(i)
            if pending:
                time.sleep(0.25)
        if pending:
            raise TimeoutError(
                f"fleet processes never became ready: {sorted(pending)}")

    def _scrape_raw(self, idx: int) -> str | None:
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.ports[idx]}/metrics",
                    timeout=2.0) as r:
                return r.read().decode()
        except Exception:
            return None

    def scrape(self) -> list[dict[str, float]]:
        """Per-process parsed /metrics; a dead or mid-restart child
        contributes an empty dict (the aggregate is a live pull, exactly
        like a Prometheus scrape of a real fleet)."""
        out = []
        for i in range(self.n):
            raw = self._scrape_raw(i)
            out.append(_parse_prom(raw) if raw else {})
        return out

    def aggregate(self) -> dict[str, float]:
        """Fleet-wide series sums over the per-process scrapes — the
        shared-nothing answer to fleet_stats(): counters add; gauges add
        too (callers that need per-slot gauges read scrape())."""
        agg: dict[str, float] = {}
        for d in self.scrape():
            for k, v in d.items():
                agg[k] = agg.get(k, 0.0) + v
        return agg

    @staticmethod
    def series_sum(scraped: dict[str, float], name: str,
                   prefix: str = "yoda_tpu_") -> float:
        """Sum every labelset of one metric family in a parsed scrape
        (the merged fleet view labels series per replica/head)."""
        full = prefix + name
        return sum(v for k, v in scraped.items()
                   if k == full or k.startswith(full + "{"))

    def kill(self, idx: int) -> None:
        """Chaos hook: SIGKILL one child mid-serve (no cleanup, no
        goodbye — the crash the restart monitor exists for)."""
        p = self.procs[idx]
        if p is not None and p.is_alive():
            p.kill()
            p.join(timeout=10)

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        for p in self.procs:
            if p is not None and p.is_alive():
                p.terminate()
        for p in self.procs:
            if p is not None:
                p.join(timeout=10)
