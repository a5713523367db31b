"""SLO guard: burn-rate-driven graceful degradation.

The capacity loop only ever makes room for serving by evicting
the harvest class; the elastic gangs' shrink-to-min machinery fires solely inside
preemption plans. This controller closes ROADMAP item 3's gap: a
continuous pass on the ENGINE thread's injectable clock that, while the
serving SLO burns (utils/obs.SloMonitor's multi-window trip) or serving
pods sit parked unschedulable, shrinks bound elastic training gangs
toward ``tpu/gang-min`` through the same evict/resubmit drain path as
preemption and defrag — and, once the crowd passes, gives the surplus
BACK so the gangs re-grow through the ordinary ``elastic-grow`` park
class.

Discipline, matching the house controllers (defrag, provisioner):

- **two-direction hysteresis** (the provisioner's rule): no shrink
  within one ``sloHysteresisSeconds`` window of the last give-back, and
  no give-back until pressure has been continuously absent for one full
  window AND one window has passed since the last shrink — a flapping
  crowd can never oscillate gang sizes (the chaos fuzz pins
  press/release pairs inside one window at zero).
- **bounded bites**: at most ``sloShrinkBudget`` members evicted per
  pass, never below any gang's min (surplus is counted from CLUSTER
  TRUTH, the bound_member_count discipline, so fleet replicas and
  restarts agree).
- **growth hold**: while pressed — and until the give-back — elastic
  growth binds park under ``elastic-grow`` instead of re-absorbing the
  freed chips (``holding()``, consulted by the engine's cycle); the
  give-back wakes them with a capacity event.
- **breaker/degraded interlock + fleet ownership**: same reasons, same
  skip counters as defrag; only the shard-0 owner shrinks.

Shrink evictions count ``gang_shrink_total{reason="slo"}`` — a DISTINCT
label value from ``reason="preemption"``, so PromQL never conflates
serving-pressure degradation with preemption churn.
"""

from __future__ import annotations

from ...utils.labels import LabelError, spec_for

# flight-ring kinds (neither is a TRIP: shrink/give-back are the guard
# doing its PLANNED job; the fault signal is the slo_burn trip the
# monitor records at the press transition)
SHRINK_EVENT = "slo_shrink"
GIVEBACK_EVENT = "slo_giveback"


class SloGuard:
    """One per engine replica; built by Scheduler.__init__ when
    ``sloServing`` is on and ``sloGuardIntervalSeconds`` > 0.
    Engine-thread-only: maybe_run is called from run_one inside the
    cycle loop."""

    def __init__(self, sched, monitor, interval_s: float, *,
                 shrink_budget: int = 4,
                 hysteresis_s: float = 30.0) -> None:
        self.sched = sched
        self.monitor = monitor  # utils/obs.SloMonitor
        self.interval_s = interval_s
        self.shrink_budget = max(int(shrink_budget), 1)
        self.hysteresis_s = hysteresis_s
        # first pass waits one full interval, the defrag discipline: a
        # just-started engine's burn windows hold no signal yet
        self.next_at = sched.clock.time() + interval_s
        # fleet gating: None = standalone engine, always the owner
        self.owner_check = None
        # fleet-wide pressure: serving binds land on whichever replica
        # owns them, so the shard-0 owner must OR every peer's evaluated
        # state; None = this engine's monitor alone
        self.pressure_check = None
        # fleet-wide parked-serving demand; None = this engine's queue
        self.serving_pending_check = None
        self.pressed = False
        # THIS replica's own evaluation (monitor trip OR local parked
        # serving), before the fleet OR — peers read this, never
        # `pressed`, or two guards OR-ing each other's combined state
        # would latch pressure fleet-wide forever
        self.local_pressed = False
        self._last_shrink: float | None = None
        self._last_giveback: float | None = None
        self._healthy_since: float | None = None
        # gang -> time of its last SLO shrink; non-empty = capacity owed
        # back to training (cleared whole by the give-back)
        self._shrunk: dict[str, float] = {}
        # press/release transition log for the oscillation audit (the
        # chaos fuzz asserts no press within hysteresis of a release)
        self.transitions: list[tuple[float, str]] = []

    # ----------------------------------------------------------- predicates
    def _serving_starved(self) -> bool:
        """Serving demand parked unschedulable — pressure even before
        the SLO burns (a starved replica never binds, so its latency
        never reaches the monitor at all)."""
        if self.serving_pending_check is not None:
            return bool(self.serving_pending_check())
        for info in self.sched.queue.parked_infos():
            try:
                if spec_for(info.pod).serving:
                    return True
            except LabelError:
                continue
        return False

    def holding(self, now: float) -> bool:
        """Whether elastic growth binds must park: while pressed, and
        until the give-back returns the shrunk capacity — otherwise the
        very chips a shrink freed are re-absorbed by the donor gang's
        growth member next cycle and the serving pod never fits."""
        if self.pressed:
            return True
        return bool(self._shrunk)

    def demanded(self) -> bool:
        """Wake gate shared with the engine's next_wake_at (the defrag
        discipline: the wake computation must agree with the run
        decision). The guard needs ticks while pressure is live, while
        capacity is owed back, or while the monitor still holds events
        whose fixed windows must close."""
        return bool(self.pressed or self._shrunk
                    or self.monitor._events or self._serving_starved())

    # ------------------------------------------------------------- the loop
    def maybe_run(self, now: float):
        """One tick: evaluate pressure every interval; shrink or give
        back when owned and safe. Returns the list of evicted members
        (possibly empty), "giveback", or None."""
        if now < self.next_at:
            return None
        self.next_at = now + self.interval_s
        sched = self.sched
        self.local_pressed = (self.monitor.evaluate(now)
                              or self._serving_starved())
        pressed = self.local_pressed
        if self.pressure_check is not None:
            pressed = bool(self.pressure_check()) or pressed
        if pressed != self.pressed:
            self.transitions.append(
                (now, "press" if pressed else "release"))
            self.pressed = pressed
        sched.metrics.set_gauge("slo_pressure", 1.0 if pressed else 0.0)
        if pressed:
            self._healthy_since = None
        elif self._healthy_since is None:
            self._healthy_since = now
        if pressed:
            # ownership gates the SHRINK side only: evictions are the
            # fleet-wide mutation exactly one replica may drive. The
            # give-back below is LOCAL bookkeeping (this replica's own
            # _shrunk ledger + its own queue's wake) — gating it on the
            # shard-0 lease would latch the hold forever when a lease
            # handover lands between a shrink and its give-back
            if self.owner_check is not None and not self.owner_check():
                sched.metrics.inc("slo_guard_skips_total",
                                  labels={"reason": "not-owner"})
                return None
            return self.run_shrink_pass(now)
        if self._shrunk and self._giveback_due(now):
            return self._give_back(now)
        return None

    def _giveback_due(self, now: float) -> bool:
        # continuously healthy for one full window AND one window past
        # the last shrink: the two-direction hysteresis
        if self._healthy_since is None \
                or now - self._healthy_since < self.hysteresis_s:
            return False
        ls = self._last_shrink
        return ls is None or now - ls >= self.hysteresis_s

    def run_shrink_pass(self, now: float):
        """One guarded shrink pass (the chaos FLASH_CROWD assertions
        call this via the ordinary tick; tests may call it directly,
        bypassing the interval gate but never the interlocks)."""
        sched = self.sched
        if now < sched._breaker_until:
            # breaker open: an evict would strand its victim Pending
            # behind the same bind storm the serving pods are stuck in
            sched.metrics.inc("slo_guard_skips_total",
                              labels={"reason": "breaker-open"})
            return None
        if sched._detect_degraded(now):
            # telemetry blackout: shrinking training off stale capacity
            # data frees chips that may no longer exist
            sched.metrics.inc("slo_guard_skips_total",
                              labels={"reason": "degraded"})
            return None
        lg = self._last_giveback
        if lg is not None and now - lg < self.hysteresis_s:
            sched.metrics.inc("slo_guard_skips_total",
                              labels={"reason": "hysteresis"})
            return None
        victims = self._plan_victims()
        if not victims:
            return []
        local = getattr(sched.cluster, "supports_local_requeue", False)
        for victim in victims:
            vspec = spec_for(victim)
            sched.cluster.evict(victim)
            sched.metrics.inc("pods_evicted_total")
            if sched.elastic is not None:
                # reason="slo": the give-back accounting satellite —
                # re-placed members re-grow through elastic-grow and
                # PromQL tells serving pressure from preemption apart
                sched.elastic.on_member_evicted(vspec, reason="slo")
            self._shrunk[vspec.gang_name] = now
            if local:
                router = sched.victim_router or sched.submit
                if not router(victim):
                    sched.metrics.inc("preempt_victims_unrouted_total")
        self._last_shrink = now
        sched.metrics.inc("slo_shrink_passes_total")
        sched.flight.record(SHRINK_EVENT, evictions=len(victims),
                            gangs=sorted({spec_for(v).gang_name
                                          for v in victims}),
                            pods=[v.key for v in victims])
        return victims

    def _plan_victims(self) -> list:
        """Up to shrink_budget surplus members of bound elastic gangs,
        from cluster truth, never taking any gang below its min.
        Largest-surplus gangs donate first (they hurt least per member);
        within a gang, highest pod key first — deterministic across
        replicas and replays."""
        cluster = self.sched.cluster
        gangs: dict[str, list] = {}
        mins: dict[str, int] = {}
        for node in cluster.node_names():
            for p in cluster.pods_on(node):
                if p.terminating:
                    continue
                try:
                    spec = spec_for(p)
                except LabelError:
                    continue
                if not spec.is_gang or spec.gang_min <= 0:
                    continue
                gangs.setdefault(spec.gang_name, []).append(p)
                mins[spec.gang_name] = spec.gang_min
        budget = self.shrink_budget
        victims: list = []
        order = sorted(gangs,
                       key=lambda g: (-(len(gangs[g]) - mins[g]), g))
        for gang in order:
            if budget <= 0:
                break
            surplus = len(gangs[gang]) - mins[gang]
            if surplus <= 0:
                continue
            members = sorted(gangs[gang], key=lambda p: p.key,
                             reverse=True)
            take = min(surplus, budget)
            victims.extend(members[:take])
            budget -= take
        return victims

    def _give_back(self, now: float):
        """Pressure has been absent a full hysteresis window: release
        the growth hold and wake the parked growth members so the
        shrunk gangs re-grow to full size through the ordinary
        elastic-grow path."""
        from ..framework import POD_DELETED, ClusterEvent

        sched = self.sched
        gangs = sorted(self._shrunk)
        self._shrunk.clear()
        self._last_giveback = now
        sched.metrics.inc("slo_giveback_total")
        sched.flight.record(GIVEBACK_EVENT, gangs=gangs)
        # a capacity event through the queue's own hint index: growth
        # members parked under elastic-grow activate exactly as if a pod
        # had departed (because, in effect, the serving crowd just did)
        sched.queue.on_event(ClusterEvent(kind=POD_DELETED), now=now)
        return "giveback"
