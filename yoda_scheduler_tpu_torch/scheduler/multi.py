"""Multi-profile serving: one process, several scheduler profiles.

KubeSchedulerConfiguration parity: the reference's ConfigMap carries a
`profiles:` list (deploy/yoda-scheduler.yaml:21-30 names its profile
`yoda-scheduler2`), and upstream kube-scheduler routes each pod to the
profile matching `spec.schedulerName`. The reference shipped a one-profile
config and mismatched example manifests (test-pod targets yoda-scheduler2,
test-deployment yoda-scheduler — SURVEY §2.1 "Examples": one of them stays
Pending). This module makes both work: every profile in the config is
served, and a pod binds iff some profile claims its schedulerName.

Design: one engine (core.Scheduler: own queue, metrics, traces, backoff)
per profile, all over the SAME cluster and — critically — the same
ChipAllocator and GangCoordinator. Pending chip reservations and gang
state are process-wide, so two profiles can never double-book chips
between Reserve and Bind (upstream shares one scheduler cache the same
way). The run loop drains engines round-robin, one scheduling cycle per
turn — and a cycle is a BATCH cycle whenever the engine's queue head has
equivalence-class company (core.schedule_batch), so a profile with a
same-shape backlog drains whole batches per turn while still yielding to
its co-hosted profiles between cycles (the shared cycle lock serializes
the cycles themselves, exactly as before).
"""

from __future__ import annotations

import threading

from .cluster import FakeCluster
from .config import SchedulerConfig
from .core import Clock, Scheduler, default_profile
from .plugins.allocator import ChipAllocator
from .plugins.gang import GangCoordinator
from .registry import build_profile
from ..utils.pod import Pod


class MultiProfileScheduler:
    """Serve several (SchedulerConfig, plugin-enablement) profiles over one
    cluster. `profiles` is a list of (config, enabled) pairs, as produced by
    cli.load_profiles; enabled=None means the default plugin set."""

    def __init__(self, cluster: FakeCluster,
                 profiles: list[tuple[SchedulerConfig, dict | None]],
                 clock: Clock | None = None) -> None:
        if not profiles:
            raise ValueError("at least one profile is required")
        names = [cfg.scheduler_name for cfg, _ in profiles]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate schedulerName(s): {sorted(dupes)}")
        self.cluster = cluster
        self.clock = clock or Clock()
        # shared across profiles: reservations + gang state are cluster-wide,
        # and scheduling cycles are serialized (upstream kube-scheduler runs
        # one scheduleOne loop over all profiles) — without the shared lock,
        # an engine could reserve from a snapshot taken before a co-hosted
        # engine's bind and double-book chips
        self.allocator = ChipAllocator()
        self.gangs = GangCoordinator()
        self._cycle_lock = threading.RLock()
        self.engines: dict[str, Scheduler] = {}
        for cfg, enabled in profiles:
            if enabled is None:
                profile, _, _ = default_profile(cfg, self.allocator,
                                                self.gangs)
            else:
                profile = build_profile(cfg, enabled, self.allocator,
                                        self.gangs)
            engine = Scheduler(cluster, cfg, profile=profile,
                               clock=self.clock,
                               cycle_lock=self._cycle_lock)
            # profile-distinct pid: the merged /traces/export must not
            # collide two profiles' pods onto the same Perfetto lanes
            engine.spans.pid = len(self.engines)
            self.engines[cfg.scheduler_name] = engine
        # one shared wake event across engines: the serve loop sleeps on it
        # between passes instead of blind-polling — any submission or
        # cluster event (on any engine) sets it
        self.wake = threading.Event()
        for engine in self.engines.values():
            # preemption victims re-route by THEIR schedulerName, not the
            # preemptor's profile (core.py preemption block)
            engine.victim_router = self.submit
            engine.wake = self.wake

    # ------------------------------------------------------------------ intake
    def submit(self, pod: Pod) -> bool:
        """Route by spec.schedulerName; False if no profile claims it (the
        pod stays Pending, exactly as with an unmatched name upstream)."""
        engine = self.engines.get(pod.scheduler_name)
        if engine is None:
            return False
        return engine.submit(pod)

    def claims(self, scheduler_name: str) -> bool:
        """Does some profile serve this spec.schedulerName? (The serve
        loop's intake filter — FleetCoordinator answers the same question
        for its single shared name.)"""
        return scheduler_name in self.engines

    def tracks(self, pod_key: str) -> bool:
        return any(e.tracks(pod_key) for e in self.engines.values())

    def forget(self, pod_key: str) -> None:
        """Drop a vanished pod from every engine (see Scheduler.forget)."""
        for e in self.engines.values():
            e.forget(pod_key)

    def reconcile(self, pods) -> tuple[int, int]:
        """Restart reconciliation across profiles: each pod is judged by
        the ONE engine whose schedulerName claims it (Scheduler.reconcile
        semantics — adopt bound, scrub+requeue stranded). `pods` may be a
        one-shot generator (the paginated iter_pods read): it is bucketed
        per engine in one pass, then each engine reconciles ONCE — a
        per-pod engine.reconcile call would emit one flight-recorder
        event per pod and churn the bounded ring at restart scale."""
        buckets: dict[str, list] = {}
        for pod in pods:
            if pod.scheduler_name in self.engines:
                buckets.setdefault(pod.scheduler_name, []).append(pod)
        adopted = requeued = 0
        for name, batch in buckets.items():
            a, r = self.engines[name].reconcile(batch)
            adopted += a
            requeued += r
        return adopted, requeued

    # ------------------------------------------------------------------- drive
    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        """Drain all engines round-robin, one scheduling cycle per turn
        (a turn is a whole batch when the engine's queue head pops an
        equivalence-class batch); when nobody can progress, sleep the
        shared clock to the earliest gang deadline / backoff expiry across
        engines. Returns total cycles executed."""
        total = 0
        while total < max_cycles:
            progressed = False
            for engine in self.engines.values():
                if engine.run_one() is not None:
                    total += 1
                    progressed = True
                    if total >= max_cycles:
                        break
            if progressed:
                continue
            wakes = [w for w in (e.next_wake_at()
                                 for e in self.engines.values())
                     if w is not None]
            if not wakes:
                break  # all engines fully idle
            self.clock.sleep(max(min(wakes) - self.clock.time(), 0.01))
        return total

    # --------------------------------------------------------------- reporting
    def bin_pack_utilization(self) -> float:
        # identical across engines (shared cluster); take any
        return next(iter(self.engines.values())).bin_pack_utilization()

    def engine(self, scheduler_name: str) -> Scheduler:
        return self.engines[scheduler_name]

    @property
    def metrics(self):
        """Live merged view over every engine's metrics: ONE /metrics
        scrape exposes every profile's (or fleet replica's) activity as
        per-replica LABELED series — counters and gauges carry
        `replica="<engine name>"` (the fleet's replica-0/-1/... or the
        profile's schedulerName), labeled series keep their own labels
        plus the replica dimension, and histograms merge fleet-wide
        (bounded retained samples per engine)."""
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


class _MergedMetricsView:
    def __init__(self, ms) -> None:
        self._ms = ms

    def _merged(self):
        from ..utils.obs import Metrics

        out = Metrics()
        sources = [(name, e.metrics)
                   for name, e in self._ms.engines.items()]
        # the cluster backend's own registry (KubeCluster: binder wire
        # RTTs, watch_confirm, reflector storm counters) rides the same
        # scrape, labeled as the shared wire
        cluster_metrics = getattr(getattr(self._ms, "cluster", None),
                                  "metrics", None)
        if isinstance(cluster_metrics, Metrics):
            sources.append(("wire", cluster_metrics))
        for name, m in sources:
            # consistent copies under the writer lock: engines insert
            # new names/label keys concurrently with a scrape
            counters, lab_c, gauges, lab_g, hists = m.snapshot_families()
            for k, v in counters.items():
                out.inc(k, v, labels={"replica": name})
            for k, fam in lab_c.items():
                for lk, v in fam.items():
                    out.inc(k, v, labels={**dict(lk), "replica": name})
            for k, v in gauges.items():
                out.set_gauge(k, v, labels={"replica": name})
            for k, fam in lab_g.items():
                for lk, v in fam.items():
                    out.set_gauge(k, v,
                                  labels={**dict(lk), "replica": name})
            for k, h in hists.items():
                out.histogram(k).merge_from(h)
        # fleet shard ownership (FleetCoordinator only): which replica
        # holds which shard lease, as a labeled info gauge
        for rep in getattr(self._ms, "replicas", ()):
            for shard in list(rep.owned):
                out.set_gauge("shard_owned", 1.0,
                              labels={"shard": str(shard),
                                      "replica": f"replica-{rep.idx}"})
        return out

    def render_prometheus(self, prefix: str = "yoda_tpu") -> str:
        return self._merged().render_prometheus(prefix)

    def histogram(self, name: str):
        return self._merged().histogram(name)


class _MergedTracesView:
    def __init__(self, ms) -> None:
        self._ms = ms

    def recent(self, n: int = 50):
        all_traces = [t for e in self._ms.engines.values()
                      for t in e.traces.recent(n)]
        all_traces.sort(key=lambda t: t.started)
        return all_traces[-n:]


class _MergedSpansView:
    """Every engine's lifecycle SpanRing (plus the cluster backend's wire
    ring, when it keeps one) behind the rings() contract /traces/export
    consumes."""

    def __init__(self, ms) -> None:
        self._ms = ms

    def rings(self):
        out = list(self._ms.engines.values())
        rings = [e.spans for e in out]
        cluster_ring = getattr(getattr(self._ms, "cluster", None),
                               "spans", None)
        if cluster_ring is not None:
            rings.append(cluster_ring)
        return rings


class _MergedFlightView:
    def __init__(self, ms) -> None:
        self._ms = ms

    def snapshot(self) -> list[dict]:
        events = []
        for name, e in self._ms.engines.items():
            for ev in e.flight.snapshot():
                ev["replica"] = name
                events.append(ev)
        events.sort(key=lambda ev: ev["ts"])
        return events
