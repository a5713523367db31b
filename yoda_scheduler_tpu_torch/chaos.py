"""Deterministic chaos injection: seeded fault plans + a chaos cluster.

The scheduler's two single points of failure are the apiserver connection
and the telemetry feed (the paper's placement quality is worthless if the
control loop wedges or double-places when either goes away). This module
scripts those outages DETERMINISTICALLY — a seed fully determines which
faults fire and when, on the engine's injectable clock — so the invariant
fuzz in tests/test_chaos.py can replay hundreds of distinct outage
scenarios and every failure reproduces from its seed alone.

Fault kinds:

- APISERVER_STORM    bind requests fail with wire errors (5xx storm /
                     connection refused); nothing is applied.
- BIND_LOST          the bind IS applied server-side, then the response is
                     lost (fake_apiserver fault ``-1`` / KubeClient
                     AmbiguousRequestError analogue) — the ambiguous
                     failure the adoption path must resolve without a
                     duplicate bind.
- TELEMETRY_BLACKOUT every sniffer heartbeat stops: the whole feed ages
                     out and the engine must degrade to capacity-only
                     scheduling instead of rejecting every node as stale.
- PLUGIN_ERROR       a plugin RAISES mid-cycle (filter/score/reserve);
                     the engine must contain the crash to the pod.
- ENGINE_CRASH       the scheduler process dies mid-drain; the test driver
                     builds a fresh engine against the same cluster and
                     reconciles in-flight state from cluster truth.

The plan is pure data: the driver (test/bench) owns applying the
clock-keyed transitions that cannot be expressed as call-site injection
(telemetry blackout, engine crash); ChaosCluster injects the bind-surface
faults at the exact call the real apiserver would fail.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .scheduler.cluster import FakeCluster
from .scheduler.framework import (
    FilterPlugin,
    ReservePlugin,
    ScorePlugin,
    Status,
)

APISERVER_STORM = "ApiServerStorm"
BIND_LOST = "BindLost"
TELEMETRY_BLACKOUT = "TelemetryBlackout"
PLUGIN_ERROR = "PluginError"
ENGINE_CRASH = "EngineCrash"
# fleet-only kinds (multi-replica shared-state scheduling): one REPLICA
# dies mid-drain (the fleet rebuilds it and reconciles from cluster
# truth), a replica's shard LEASES are revoked mid-bind-window (its
# fenced commits must abort cleanly), and a SPLIT-BRAIN window injects a
# duplicate replica — the same pods queued on two replicas at once, with
# the original holder's lease epoch gone stale — so the authority's
# conflict + fencing checks are the only thing standing between the
# fleet and a double bind.
REPLICA_CRASH = "ReplicaCrash"
LEASE_EXPIRY = "LeaseExpiry"
SPLIT_BRAIN = "SplitBrain"
# the webhook-era kinds, attacking exactly the vanilla-apiserver path:
# a replica that can BIND but not WATCH (its view freezes while commits
# still flow — the webhook is then the only thing standing between its
# stale placements and a double-booking), lease clocks drifting between
# replicas (renewals silently missed; stale fencing epochs travel to the
# authority), a SLOW apiserver (latency is not failure: the breaker must
# not trip and no invariant may bend), and the webhook itself going DOWN
# under both failure policies (Fail = binds 500 until it returns;
# Ignore = pod-level checks only, the documented unsafe-under-partition
# trade).
NETWORK_PARTITION = "NetworkPartition"
CLOCK_SKEW = "ClockSkew"
SLOW_APISERVER = "SlowApiServer"
WEBHOOK_DOWN = "WebhookDown"
# elastic/defrag kind: force the defrag controller's
# migration pass at a seeded instant — the descheduler EVICTING a pod
# while another fleet replica concurrently BINDS onto the same node (and
# while elastic gangs are mid-growth), so the authority's conflict
# battery and the controller's safety rails are the only thing standing
# between active defragmentation and a lost pod / double-booked chip.
DEFRAG_RACE = "DefragRace"
# capacity-provisioner kinds, attacking the closed capacity
# loop through its provider: a STOCKOUT window denies every capacity
# request after full provisioning latency (the cloud said no), a QUOTA
# window denies them as policy (retrying harder is wrong — backoff and
# breaker must absorb it), a LOST_RESPONSE window creates the node but
# never answers (the request is written off; the arriving node must be
# ADOPTED through membership reconciliation, never leaked), and a FLAP
# window delivers the node then yanks it shortly after (orphaned pods
# requeue; the loop must re-provision without fleet-size oscillation).
PROVIDER_STOCKOUT = "ProviderStockout"
PROVIDER_QUOTA_DENIED = "ProviderQuotaDenied"
PROVISION_LOST_RESPONSE = "ProvisionLostResponse"
PROVISION_FLAP = "ProvisionFlap"
# workload-admission kind: at a seeded instant, race the
# admission tier — withdraw a random workload (possibly mid-admission,
# its members half-materialized across replicas) and/or revoke the
# admission owner's leases so the shard-0 handover lands while the
# parked backlog is being decided. The fleet-wide claim-once registry
# and the one-pass withdraw retirement are the only things standing
# between that and a double-materialized workload / leaked quota claim.
ADMISSION_RACE = "AdmissionRace"
# SLO-serving kind: a FLASH_CROWD window multiplies the
# serving class's open-loop arrival rate (the driver reads the plan's
# windows and scales its own generator — the window IS the crowd).
# Crossed with provider stockouts (capacity cannot arrive), lease
# expiry (the guard's shard-0 ownership moves mid-shrink), and replica
# crashes, the burn-rate trip, the shrink-to-min pass, and the
# hysteresis'd give-back are the only things standing between a traffic
# spike and a starved serving class / an oscillating training fleet.
FLASH_CROWD = "FlashCrowd"

ALL_KINDS = (APISERVER_STORM, BIND_LOST, TELEMETRY_BLACKOUT, PLUGIN_ERROR,
             ENGINE_CRASH)
# the fleet fuzz's kind mix: the single-engine kinds that stress the
# commit path, plus the three fleet-only kinds above (blackout/plugin
# crashes are engine-local and already covered by the single-engine fuzz)
FLEET_KINDS = (APISERVER_STORM, BIND_LOST, REPLICA_CRASH, LEASE_EXPIRY,
               SPLIT_BRAIN)
# the webhook/partition fuzz's mix (tests/test_chaos.py, run against a
# VANILLA-authority cluster + webhook gate): storms and lost binds keep
# the wire honest while the four new kinds attack the watch/lease/
# webhook legs, and replica crashes exercise shard rebalancing under it
WEBHOOK_KINDS = (APISERVER_STORM, BIND_LOST, REPLICA_CRASH,
                 NETWORK_PARTITION, CLOCK_SKEW, SLOW_APISERVER,
                 WEBHOOK_DOWN)
# the elastic/defrag fuzz's mix (tests/test_chaos.py): DEFRAG_RACE
# migrations interleaved with the commit-path stressors, replica
# crashes, and partitions — elastic gangs grow through all of it, and
# "no gang ever drops below tpu/gang-min from our own migrations" joins
# the four global invariants
ELASTIC_KINDS = (APISERVER_STORM, BIND_LOST, REPLICA_CRASH,
                 NETWORK_PARTITION, DEFRAG_RACE)
# the workload-admission fuzz's mix (tests/test_workload.py): admission
# races + lease churn + the commit-path stressors, over a fleet whose
# ENTIRE intake is workloads — no pod lost / no double-materialize /
# no leaked claim join the four global invariants
ADMISSION_KINDS = (APISERVER_STORM, BIND_LOST, LEASE_EXPIRY,
                   ADMISSION_RACE)
# the capacity fuzz's mix (tests/test_capacity.py): all four provider
# kinds plus the fleet stressors — partitions freeze a replica's view of
# arriving nodes, lease expiry / replica crashes move provisioner
# ownership mid-wave (the takeover's membership reconciliation is what
# stands between a crashed owner's in-flight requests and a leaked node)
PROVISIONER_KINDS = (APISERVER_STORM, BIND_LOST, REPLICA_CRASH,
                     LEASE_EXPIRY, NETWORK_PARTITION, PROVIDER_STOCKOUT,
                     PROVIDER_QUOTA_DENIED, PROVISION_LOST_RESPONSE,
                     PROVISION_FLAP)
# the SLO-serving fuzz's mix (tests/test_slo.py): flash crowds landing
# inside provider stockouts (shrink is the ONLY source of chips), lease
# expiry moving the guard's ownership mid-pass, and replica crashes —
# "no gang below min, serving never starves once pressure registers,
# zero shrink/give-back oscillation pairs inside one hysteresis window"
# join the four global invariants
SLO_KINDS = (FLASH_CROWD, PROVIDER_STOCKOUT, LEASE_EXPIRY,
             REPLICA_CRASH)


class LostResponseError(ConnectionError):
    """The mutation was applied; the response never arrived (the
    fake-apiserver ``-1`` fault / k8s AmbiguousRequestError analogue)."""


class WebhookUnavailableError(RuntimeError):
    """failurePolicy=Fail with the webhook unreachable: the apiserver
    refuses the bind with a server-returned 500 ('failed calling
    webhook'). status=500 so the engine treats it as an ORDERLY refusal
    — backoff retry, never the breaker (the apiserver itself answered)
    and never the conflict path (nothing was judged)."""

    status = 500


@dataclass(frozen=True)
class FaultWindow:
    kind: str
    start: float
    end: float

    def active(self, now: float) -> bool:
        return self.start <= now < self.end


class FaultPlan:
    """A seeded schedule of fault windows on a virtual clock. The same
    (seed, horizon, kinds) always yields the same windows — the whole
    point: a failing chaos scenario replays from its seed."""

    def __init__(self, seed: int, horizon_s: float = 20.0,
                 kinds: tuple = ALL_KINDS, max_windows: int = 3) -> None:
        rng = random.Random(seed)
        self.seed = seed
        self.horizon_s = horizon_s
        self.windows: list[FaultWindow] = []
        for _ in range(rng.randint(1, max_windows)):
            kind = rng.choice(kinds)
            start = rng.uniform(0.5, horizon_s * 0.6)
            if kind in (ENGINE_CRASH, REPLICA_CRASH, LEASE_EXPIRY,
                        DEFRAG_RACE):
                # a crash / lease revocation / forced defrag pass is an
                # instant, not an interval; the driver fires it once when
                # the clock first passes `start`
                self.windows.append(FaultWindow(kind, start, start))
                continue
            dur = rng.uniform(1.0, horizon_s * 0.4)
            self.windows.append(
                FaultWindow(kind, start, min(start + dur, horizon_s)))
        self.windows.sort(key=lambda w: (w.start, w.kind))

    def active(self, kind: str, now: float) -> bool:
        return any(w.kind == kind and w.active(now) for w in self.windows)

    def kinds(self) -> set:
        return {w.kind for w in self.windows}

    def windows_of(self, kind: str) -> list[FaultWindow]:
        return [w for w in self.windows if w.kind == kind]

    def fault_end(self) -> float:
        """Instant after which no fault is active (convergence must be
        reached some time after this)."""
        return max((w.end for w in self.windows), default=0.0)


class ChaosCluster(FakeCluster):
    """FakeCluster whose binding surface fails on the plan's schedule —
    the in-memory analogue of fault-injecting the apiserver.

    `bind_script` additionally maps absolute bind-call indices (0-based,
    counted across the cluster's lifetime) to fault kinds, for tests that
    need "exactly the Nth bind fails" rather than a time window."""

    def __init__(self, telemetry=None, plan: FaultPlan | None = None,
                 clock=None, bind_script: dict[int, str] | None = None,
                 flight=None) -> None:
        super().__init__(telemetry)
        self.plan = plan
        self.clock = clock
        self.bind_script = dict(bind_script or {})
        self.bind_calls = 0
        self.injected: dict[str, int] = {}
        # optional utils.obs.FlightRecorder: injected faults land in the
        # same black-box ring as the engine's reactions, so a dump reads
        # as one interleaved timeline (fault fired -> breaker opened ->
        # recovery path taken)
        self.flight = flight

    def _now(self) -> float:
        return self.clock.time() if self.clock is not None else 0.0

    def _bind_fault(self) -> str | None:
        idx = self.bind_calls
        self.bind_calls += 1
        scripted = self.bind_script.get(idx)
        if scripted is not None:
            return scripted
        if self.plan is None:
            return None
        now = self._now()
        for kind in (APISERVER_STORM, BIND_LOST):
            if self.plan.active(kind, now):
                return kind
        return None

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        if self.flight is not None:
            self.flight.record("fault_injected", fault=kind,
                               bind_call=self.bind_calls - 1)

    # one bind's injected latency during a SLOW_APISERVER window: long
    # enough to push lease renew deadlines and queue deadlines around
    # (the virtual clock advances), short enough that a window's worth of
    # binds stays inside the convergence budget
    slow_bind_latency_s = 0.25

    def _maybe_slow(self) -> None:
        """SLOW_APISERVER: latency, not failure — the bind completes
        after a delay (virtual clock advances). The breaker must never
        count it and no invariant may bend under it."""
        if (self.plan is not None and self.clock is not None
                and self.plan.active(SLOW_APISERVER, self._now())):
            self._count(SLOW_APISERVER)
            self.clock.sleep(self.slow_bind_latency_s)

    def bind(self, pod, node, assigned_chips=None, fence=None) -> None:
        self._maybe_slow()
        fault = self._bind_fault()
        if fault == APISERVER_STORM:
            self._count(fault)
            raise ConnectionError("chaos: apiserver unavailable (storm)")
        if fault == BIND_LOST:
            # the mutation lands, the response does not — the caller sees
            # an error for a bind the cluster already holds. (A conflict
            # rejection raises INSTEAD of the lost response: the server
            # never applied anything, so there is nothing to lose.)
            super().bind(pod, node, assigned_chips, fence=fence)
            self._count(fault)
            raise LostResponseError("chaos: bind applied, response lost")
        super().bind(pod, node, assigned_chips, fence=fence)


class AsyncChaosCluster(ChaosCluster):
    """ChaosCluster that also speaks the bind_async contract, executing
    the "wire" synchronously inline so the engine's async recovery path
    (_drain_bind_failures) is exercised deterministically: a storm fault
    reports on_fail without applying (the KubeCluster binder's rollback
    already ran by the time on_fail fires there — here nothing was
    applied, which is the same post-rollback state); a lost-response
    fault APPLIES the bind and then reports on_fail."""

    def bind_async(self, pod, node, assigned_chips=None,
                   on_fail=None, on_success=None, fence=None) -> None:
        self._maybe_slow()
        fault = self._bind_fault()
        if fault == APISERVER_STORM:
            self._count(fault)
            if on_fail is not None:
                on_fail(pod, node,
                        ConnectionError("chaos: apiserver storm (async)"))
            return
        if fault == BIND_LOST:
            try:
                super(ChaosCluster, self).bind(pod, node, assigned_chips,
                                               fence=fence)
            except Exception as e:  # conflict rejection: report it, the
                if on_fail is not None:  # response-loss never happened
                    on_fail(pod, node, e)
                return
            self._count(fault)
            if on_fail is not None:
                on_fail(pod, node,
                        LostResponseError("chaos: async bind applied, "
                                          "response lost"))
            return
        try:
            super(ChaosCluster, self).bind(pod, node, assigned_chips,
                                           fence=fence)
        except Exception as e:
            if on_fail is not None:
                on_fail(pod, node, e)
            return
        if on_success is not None:
            on_success(pod, node)


class VanillaAuthorityCluster(ChaosCluster):
    """ChaosCluster in the VANILLA-apiserver posture: the server itself
    enforces only the pod-level 409 (a conformant kube-apiserver's whole
    battery); the chip/HBM/fence half runs in an attached WEBHOOK GATE
    that a WEBHOOK_DOWN window takes away — under both failure policies:

    - ``fail_open=False`` (failurePolicy=Fail): a bind during the window
      is refused with a server-returned 500 (WebhookUnavailableError) —
      safety over availability; the engine backs the pod off and it
      binds when the webhook returns.
    - ``fail_open=True`` (failurePolicy=Ignore): binds flow with only
      the pod-level check. Availability over safety — combined with a
      concurrently PARTITIONED replica this is exactly the double-
      booking window (demonstrated by a targeted test; the fuzz keeps
      the two windows disjoint for fail-open seeds, which is the
      deployment guidance in ARCHITECTURE.md)."""

    def __init__(self, telemetry=None, plan: FaultPlan | None = None,
                 clock=None, bind_script: dict[int, str] | None = None,
                 flight=None, fail_open: bool = False) -> None:
        super().__init__(telemetry, plan=plan, clock=clock,
                         bind_script=bind_script, flight=flight)
        self.fail_open = fail_open
        self.webhook_checked = 0   # full-battery verdicts served
        self.webhook_skipped = 0   # fail-open binds admitted unchecked

    def _webhook_down(self) -> bool:
        return (self.plan is not None
                and self.plan.active(WEBHOOK_DOWN, self._now()))

    def _check_bind(self, pod, node, assigned_chips, fence) -> None:
        # the vanilla half: the binding subresource 409s an already-
        # assigned pod no matter what
        cur = self._bound_keys.get(pod.key)
        if cur is not None:
            self._reject("pod_bound",
                         f"pod {pod.key} is already bound to {cur}")
        if self._webhook_down():
            self._count(WEBHOOK_DOWN)
            if self.fail_open:
                self.webhook_skipped += 1
                if self.flight is not None:
                    self.flight.record("webhook_fail_open", pod=pod.key,
                                       node=node, state="down")
                return  # failurePolicy=Ignore: pod-level check only
            raise WebhookUnavailableError(
                'failed calling webhook "yoda-bind-authority.yoda.tpu": '
                "connection refused (failurePolicy=Fail)")
        self.webhook_checked += 1
        # webhook up: the full battery — the pod-level check re-runs
        # inside, which is harmless (it just passed)
        super()._check_bind(pod, node, assigned_chips, fence)


class PartitionableView:
    """Per-replica cluster facade for NETWORK_PARTITION: while frozen,
    the replica's WATCH-side reads (membership, per-node pod lists, the
    change-log versions) serve a snapshot taken at partition start — the
    replica schedules off an ever-staler view — while its BINDS (and the
    bind path's recovery reads: ``bound_node_of`` models the confirm
    GET) still reach the live cluster. The replica's own binds are
    write-through into the frozen view, as a real client's optimistic
    cache update would be; everything it cannot see is what the
    authority's conflict battery exists for.

    Everything not explicitly frozen delegates to the inner cluster."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self._frozen: dict | None = None
        # post-thaw rebuild floor: change-log versions handed out while
        # frozen count only OUR writes, so a memo holding one cannot be
        # diffed against the real log (foreign changes interleaved with
        # ours would be skipped). Any version below the floor rebuilds.
        self._rebuild_below: int | None = None

    # ------------------------------------------------------------- chaos
    def freeze(self) -> None:
        inner = self._inner
        nodes = inner.node_names()
        self._frozen = {
            "nodes": nodes,
            "pods_on": {n: inner.pods_on(n) for n in nodes},
            "pods_ver": {n: inner.pods_version(n) for n in nodes},
            "nodes_ver": inner.nodes_version,
            "gver": inner.pods_global_version,
        }

    def thaw(self) -> None:
        self._frozen = None
        self._rebuild_below = self._inner.pods_global_version

    @property
    def partitioned(self) -> bool:
        return self._frozen is not None

    # ----------------------------------------------------- frozen reads
    def node_names(self):
        f = self._frozen
        return list(f["nodes"]) if f is not None else \
            self._inner.node_names()

    def pods_on(self, node):
        f = self._frozen
        return list(f["pods_on"].get(node, ())) if f is not None else \
            self._inner.pods_on(node)

    def all_pods(self):
        f = self._frozen
        if f is None:
            return self._inner.all_pods()
        return [p for pods in f["pods_on"].values() for p in pods]

    def pods_version(self, node):
        f = self._frozen
        return f["pods_ver"].get(node, 0) if f is not None else \
            self._inner.pods_version(node)

    @property
    def nodes_version(self):
        f = self._frozen
        return f["nodes_ver"] if f is not None else \
            self._inner.nodes_version

    @property
    def pods_global_version(self):
        f = self._frozen
        return f["gver"] if f is not None else \
            self._inner.pods_global_version

    def changes_since(self, version):
        f = self._frozen
        if f is None:
            if self._rebuild_below is not None \
                    and version < self._rebuild_below:
                # a frozen-era version: not diffable — full rebuild
                return self._inner.pods_global_version, None
            return self._inner.changes_since(version)
        # no watch = no change information: anything not already applied
        # reads as "rebuild from (frozen) state" — deliberately the
        # conservative full-rebuild signal, never a bogus empty diff for
        # a version we cannot actually diff against
        if version == f["gver"]:
            return f["gver"], set()
        return f["gver"], None

    def changes_since_directed(self, version):
        if self._frozen is None:
            if self._rebuild_below is not None \
                    and version < self._rebuild_below:
                return self._inner.pods_global_version, None, None
            return self._inner.changes_since_directed(version)
        ver, dirty = self.changes_since(version)
        # dirty is () or None (rebuild); grew mirrors it per the
        # changelog contract (both None on rebuild, grew ⊆ dirty)
        return ver, dirty, (set() if dirty is not None else None)

    # -------------------------------------------------- live bind path
    def bind(self, pod, node, assigned_chips=None, fence=None) -> None:
        self._inner.bind(pod, node, assigned_chips, fence=fence)
        f = self._frozen
        if f is not None:
            # the client SAW its 2xx: write through into the frozen view
            # (a real scheduler's optimistic cache update), bumping the
            # frozen versions so the replica's memos notice its own write
            f["pods_on"].setdefault(node, []).append(pod)
            f["pods_ver"][node] = f["pods_ver"].get(node, 0) + 1
            f["gver"] += 1

    def evict(self, pod) -> None:
        node = pod.node
        self._inner.evict(pod)
        f = self._frozen
        if f is not None and node in f["pods_on"]:
            f["pods_on"][node] = [p for p in f["pods_on"][node]
                                  if p.uid != pod.uid]
            f["pods_ver"][node] = f["pods_ver"].get(node, 0) + 1
            f["gver"] += 1

    def __getattr__(self, name):
        # telemetry, node_meta, bound_node_of, lease_authority, subscribe,
        # bind_conflicts, ... — everything else is live
        return getattr(self._inner, name)


def blackout(store, now: float, max_age_s: float) -> None:
    """Start a telemetry blackout: every stored heartbeat ages past the
    staleness gate at once (the whole sniffer fleet went dark long
    enough ago that nothing is fresh). Publishes COPIES so the store can
    see the old heartbeat and keep its ceiling (the engine's blackout
    detector) exact."""
    import dataclasses

    for m in store.list():
        store.put(dataclasses.replace(
            m, heartbeat=now - (max_age_s + 1.0)))


def revive(store, now: float) -> None:
    """End a blackout: the sniffer fleet republishes fresh heartbeats."""
    import dataclasses

    for m in store.list():
        store.put(dataclasses.replace(m, heartbeat=now))


class SimulatedProvider:
    """Fault-injected capacity provider (scheduler/capacity/ provider
    contract) for the chaos harness and benches: seeded provisioning-
    latency draws on the engine's injectable clock, with each request's
    FATE decided deterministically from the fault plan at request time:

    - healthy: the node is created (through the given backend adapter —
      FakeBackend or WireBackend, i.e. the ordinary intake) after the
      drawn latency and a ``ready`` result is delivered at the next
      poll.
    - PROVIDER_STOCKOUT / PROVIDER_QUOTA_DENIED: full latency, then a
      denial result — the provisioner's backoff/breaker must absorb it.
    - PROVISION_LOST_RESPONSE: the node IS created on schedule but no
      result ever arrives — the write-off + adoption path's analogue of
      the lost bind response.
    - PROVISION_FLAP: a ready result, then the provider yanks the node
      ``flap_after_s`` later (orphaned pods routed back through the
      backend's orphan router).

    The provider assigns request ids, so fleet replicas sharing one
    provider can never collide; a result whose request the (possibly
    freshly taken-over) provisioner does not recognise exercises the
    adoption path by construction."""

    def __init__(self, backend, clock=None, plan: FaultPlan | None = None,
                 seed: int = 0, latency_s: tuple = (0.2, 1.5),
                 flap_after_s: float = 2.0, flight=None) -> None:
        from .scheduler.capacity import ProvisionRequest, ProvisionResult

        self._Request = ProvisionRequest
        self._Result = ProvisionResult
        self.backend = backend
        self.clock = clock
        self.plan = plan
        self.rng = random.Random(seed)
        self.latency_s = latency_s
        self.flap_after_s = flap_after_s
        self.flight = flight
        self._seq = 0
        self._pending: list = []   # (ready_at, req, fate)
        self._flaps: list = []     # (due_at, node)
        self.injected: dict[str, int] = {}
        self.created: list[str] = []
        self.released: list[str] = []
        self.flapped: list[str] = []
        self.lost_nodes: list[str] = []  # created, response never sent

    def _now(self) -> float:
        return self.clock.time() if self.clock is not None else 0.0

    def _count(self, kind: str, **detail) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        if self.flight is not None:
            self.flight.record("fault_injected", fault=kind, **detail)

    def _fate(self, now: float) -> str:
        if self.plan is None:
            return "ready"
        for kind in (PROVIDER_STOCKOUT, PROVIDER_QUOTA_DENIED,
                     PROVISION_LOST_RESPONSE, PROVISION_FLAP):
            if self.plan.active(kind, now):
                return kind
        return "ready"

    # ------------------------------------------------------------ contract
    def request(self, pool: str, template, now: float | None = None):
        now = self._now() if now is None else now
        self._seq += 1
        req = self._Request(id=self._seq, pool=pool, template=template,
                            requested_at=now)
        fate = self._fate(now)
        if fate not in ("ready", PROVISION_FLAP):
            # a flap's observable fault is the YANK — counting it here
            # too would double-book one fault (and a node released
            # before its flap deadline never flaps at all)
            self._count(fate, pool=pool, request=req.id)
        ready_at = now + self.rng.uniform(*self.latency_s)
        self._pending.append((ready_at, req, fate))
        return req

    def next_event_at(self, now: float) -> float | None:
        """Earliest pending completion or flap — the provisioner's
        next_wake_at contribution on a virtual clock."""
        times = ([t for t, _, _ in self._pending]
                 + [t for t, _ in self._flaps])
        return min(times) if times else None

    def poll(self, now: float | None = None) -> list:
        now = self._now() if now is None else now
        results: list = []
        keep: list = []
        for ready_at, req, fate in self._pending:
            if ready_at > now:
                keep.append((ready_at, req, fate))
                continue
            if fate == PROVIDER_STOCKOUT:
                results.append(self._Result(
                    req.id, req.pool, "stockout",
                    detail="chaos: no capacity for shape"))
                continue
            if fate == PROVIDER_QUOTA_DENIED:
                results.append(self._Result(
                    req.id, req.pool, "quota-denied",
                    detail="chaos: project quota exceeded"))
                continue
            name = f"{req.pool}-{req.id}"
            names = self.backend.create(name, req.template, now)
            self.created.extend(names)
            if fate == PROVISION_LOST_RESPONSE:
                # node real, answer gone: the caller writes the request
                # off and must adopt the node when it shows up
                self.lost_nodes.extend(names)
                continue
            results.append(self._Result(req.id, req.pool, "ready",
                                        node=names[0],
                                        nodes=tuple(names)))
            if fate == PROVISION_FLAP:
                self._flaps.append((now + self.flap_after_s, names))
        self._pending = keep
        due = [f for f in self._flaps if f[0] <= now]
        if due:
            self._flaps = [f for f in self._flaps if f[0] > now]
            for _, names in due:
                for name in names:
                    self._count(PROVISION_FLAP, node=name)
                    self.backend.destroy(name)
                    self.flapped.append(name)
        return results

    def release(self, node: str, pool: str) -> bool:
        # a released node's pending flap is cancelled: the caller gave
        # the node back, so yanking it later would destroy a node that
        # no longer exists and double-book it as released AND flapped
        self._flaps = [(t, [n for n in names if n != node])
                       for t, names in self._flaps]
        self._flaps = [(t, names) for t, names in self._flaps if names]
        self.backend.destroy(node)
        self.released.append(node)
        return True


class _CrashWindow:
    """Shared crash condition for the chaos plugins below: raise during
    the plan's PLUGIN_ERROR windows (all pods, or the seeded subset
    `match` selects), or always when armed without a plan."""

    def __init__(self, plan: FaultPlan | None = None, clock=None,
                 match=None) -> None:
        self.plan = plan
        self.clock = clock
        self.match = match  # pod -> bool; None = every pod
        self.crashes = 0

    def should_crash(self, pod) -> bool:
        if self.plan is not None:
            now = self.clock.time() if self.clock is not None else 0.0
            if not self.plan.active(PLUGIN_ERROR, now):
                return False
        if self.match is not None and not self.match(pod):
            return False
        self.crashes += 1
        return True


class CrashingFilter(FilterPlugin, _CrashWindow):
    """A filter plugin that raises (not: returns ERROR) on schedule — the
    exact misbehaviour cycle-level containment exists for."""

    name = "chaos-crash-filter"

    def __init__(self, plan=None, clock=None, match=None) -> None:
        _CrashWindow.__init__(self, plan, clock, match)

    def filter(self, state, pod, node) -> Status:
        if self.should_crash(pod):
            raise RuntimeError(f"chaos: filter crash for {pod.key}")
        return Status.success()


class CrashingScore(ScorePlugin, _CrashWindow):
    name = "chaos-crash-score"
    weight = 0  # never influences placement when it does not crash

    def __init__(self, plan=None, clock=None, match=None) -> None:
        _CrashWindow.__init__(self, plan, clock, match)

    def score(self, state, pod, node):
        if self.should_crash(pod):
            raise RuntimeError(f"chaos: score crash for {pod.key}")
        return 0.0, Status.success()


class CrashingReserve(ReservePlugin, _CrashWindow):
    name = "chaos-crash-reserve"

    def __init__(self, plan=None, clock=None, match=None) -> None:
        _CrashWindow.__init__(self, plan, clock, match)

    def reserve(self, state, pod, node) -> Status:
        if self.should_crash(pod):
            raise RuntimeError(f"chaos: reserve crash for {pod.key}")
        return Status.success()

    def unreserve(self, state, pod, node) -> None:
        return None
