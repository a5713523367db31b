"""Active defragmentation controller: closed-loop slice reassembly.

FragmentationScore steers 1-chip pods away from nearly-whole
nodes PASSIVELY, and deschedule.py repairs fragmentation ON DEMAND
(run_once has no caller in the serve path). This controller closes the
loop: a continuous pass on the ENGINE thread's injectable clock drives
the descheduler's two strategies — slice conservation (small non-gang
pods denting multi-host gang slices move to standalone nodes) and
intra-node compaction (evictions that enlarge the largest placeable
block) — through the existing victim-drain path: evict, resubmit, let
the ordinary cycle re-place, with the freed chips waking capacity-parked
pods (2-chip requests, elastic-gang GROWTH members) event-driven through
POD_DELETED.

Safety rails, beyond the descheduler's own (never gangs, never protected
priorities, PDB hard veto, only provably-replaceable victims):

- **eviction budget**: at most ``maxMigrationsPerPass`` evictions per
  pass (the descheduler's max_evictions_per_pass);
- **per-pod cooldown**: a migrated pod is immune for
  ``defragCooldownSeconds`` — the chaos matrix pins "no pod migrated
  more than once per cooldown window";
- **breaker interlock**: never migrates while the bind circuit breaker
  is open (evictions against a dead apiserver strand workloads) or
  telemetry-blackout degraded mode is active (stale telemetry would
  plan migrations off capacity that no longer exists) — skips are
  counted per reason;
- **demand gating**: a pass only runs while the engine has pending work
  (queued/parked/waiting pods) — defragmentation for nobody is pure
  churn, and the gate is what lets run_until_idle terminate;
- **fleet ownership**: in a sharded fleet only the replica owning shard
  0 runs the loop (owner_check, wired by FleetCoordinator) — N replicas
  each migrating the same stray would multiply churn N-fold.

Every pass lands in the flight recorder as a ``defrag_pass`` trip (the
black box records the system actively rearranging workloads), and each
eviction counts ``defrag_evictions_total{strategy}``.
"""

from __future__ import annotations


class DefragController:
    """One per engine replica; built by Scheduler.__init__ when
    ``defragIntervalSeconds`` > 0. Engine-thread-only: maybe_run is
    called from run_one inside the cycle loop."""

    def __init__(self, sched, interval_s: float,
                 max_migrations: int = 4,
                 cooldown_s: float = 300.0) -> None:
        from ..deschedule import Descheduler

        self.sched = sched
        self.interval_s = interval_s
        self.desched = Descheduler(
            sched, max_evictions_per_pass=max_migrations,
            cooldown_s=cooldown_s)
        # first pass waits one full interval: a just-started engine's
        # queue is the intake burst, and migrating under it would race
        # placements the ordinary cycle is about to make anyway
        self.next_at = sched.clock.time() + interval_s
        # fleet gating: None = standalone engine, always the owner;
        # FleetCoordinator wires a shard-0-ownership check per replica
        self.owner_check = None
        # demand gating: None = this engine's own queue; FleetCoordinator
        # wires a FLEET-wide check — the pod a migration would unblock
        # usually queues on a DIFFERENT replica than the defrag owner
        self.demand_check = None
        # migration-plan destination pins (pod.key -> node), consumed
        # ONE-SHOT by the victim's next cycle (core narrows its scan to
        # the planned destination). Without the pin the freed hole
        # scores at least as well as the destination and the victim
        # bounces straight back into it — the migration then never
        # sticks and the pod it was for never fits.
        self._pins: dict[str, str] = {}

    def take_pin(self, pod_key: str) -> str | None:
        """Consume the pod's migration-destination pin (one-shot: if the
        pinned cycle fails — the destination was taken meanwhile — later
        retries are unrestricted)."""
        if not self._pins:
            return None
        return self._pins.pop(pod_key, None)

    def demanded(self) -> bool:
        """The demand gate, shared verbatim by maybe_run and the engine's
        next_wake_at (a due pass only matters while somebody pends — and
        the wake computation must agree with the run decision, or drains
        either sleep past a pass or spin waking for refused ones). In a
        fleet the wired check is FLEET-wide: the pod a migration unblocks
        usually queues on a different replica than the shard-0 owner."""
        if self.demand_check is not None:
            return bool(self.demand_check())
        sched = self.sched
        return bool(len(sched.queue) or sched.waiting)

    # ------------------------------------------------------------- the loop
    def maybe_run(self, now: float):
        """One tick: run a pass when due, demanded, owned, and safe.
        Returns the executed DeschedulePlan, or None."""
        if now < self.next_at:
            return None
        self.next_at = now + self.interval_s
        sched = self.sched
        if not self.demanded():
            return None  # nobody pending: migration would be pure churn
        if self.owner_check is not None and not self.owner_check():
            sched.metrics.inc("defrag_skips_total",
                              labels={"reason": "not-owner"})
            return None
        return self.run_pass(now)

    def run_pass(self, now: float):
        """One guarded pass (the chaos DEFRAG_RACE injector calls this
        directly, bypassing the interval/demand gates but never the
        breaker/degraded interlock)."""
        sched = self.sched
        if now < sched._breaker_until:
            # breaker open: the apiserver is failing binds, so an evict
            # would strand its victim Pending behind the same storm
            sched.metrics.inc("defrag_skips_total",
                              labels={"reason": "breaker-open"})
            return None
        if sched._detect_degraded(now):
            # telemetry blackout: last-known capacity is good enough to
            # SCHEDULE off, but not to churn running workloads over
            sched.metrics.inc("defrag_skips_total",
                              labels={"reason": "degraded"})
            return None
        plan = self.desched.run_once()
        if len(self._pins) > 1024:
            self._pins.clear()  # victims that never cycled again
        self._pins.update(plan.destinations)
        sched.metrics.inc("defrag_passes_total")
        for pod in plan.victims:
            sched.metrics.inc(
                "defrag_evictions_total",
                labels={"strategy": plan.strategies.get(
                    pod.key, "compaction")})
        if plan.victims:
            # trip kind: migrations are the system actively rearranging
            # running workloads — exactly what the black box should show
            # (empty passes stay out of the ring; the counter covers them)
            # the pod list must be COMPLETE (bounded by the eviction
            # budget): the chaos cooldown invariant and bench's
            # unique_migrated_pods reconstruct migration history from it
            sched.flight.record(
                "defrag_pass", evictions=len(plan.victims),
                strategies=sorted(set(plan.strategies.values())),
                pods=[p.key for p in plan.victims])
        return plan
