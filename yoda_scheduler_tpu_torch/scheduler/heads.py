"""Intra-replica parallel scheduling heads.

The 50k drain artifact (BENCH_SCALE50K.json) shows per-pod cycle compute
flat from 5k to 50k nodes while 99.9% of e2e latency is queue wait behind
ONE engine loop. This module multiplies the loop, not the process: a
HeadSet runs N full scheduling heads inside one replica, all pulling from
the SAME queue and committing through the SAME cluster authority, with
the fleet's optimistic-commit grammar (409 / foreign-bind / node-claim
resolution in core._bind_conflict) resolving intra-process races exactly
as it resolves inter-replica ones.

Head anatomy
------------
Head 0 ("the primary") is the replica's original, unmodified Scheduler:
it owns intake (submit / gang revivals / workload admission), the
controllers (defrag, capacity provisioner, elastic), event routing into
the queue's hint index, breaker bookkeeping, and the waiting/permit map.
Worker heads are additional full Scheduler instances over the same
backend and clock, built with the controller knobs forced off and a
deterministically diversified rng_seed (the fleet's 7919-prime scheme,
offset so replica tie-break seeds never collide with head seeds).

Per-head state is SINGLE-THREADED by construction: each head owns its
score/feasibility memos, columnar mirror + native plane, span ring,
flight recorder, and metrics — the "single-writer table refresh"
discipline. What IS shared:

- the queue: the primary's SchedulingQueue, armed via
  enable_multi_head() (one RLock around every public entry point; a
  single-head engine never takes it). Heads segregate work through the
  `exclude` predicate (Scheduler.head_filter): worker heads never pop
  gang pods (gang permit state lives on the primary — it runs all
  gangs).
- the chip allocator (and gang coordinator): ONE instance per replica,
  shared by every head — the multi.py co-hosted-profiles contract
  ("profiles must see each other's pending reservations or they would
  double-book chips"), which is exactly the intra-replica race. With
  per-head allocators, pick_chips is deterministic and head B picks the
  SAME coords head A just reserved (B cannot see A's pending set until
  the commit lands), so every same-node concurrent bind 409s; measured
  at a 40-50% conflict rate under identical-class load. With the shared
  allocator, Reserve makes a head's claim visible to every sibling's
  free_coords/class_stats BEFORE the wire round-trip, and the
  authority's 409 becomes the cross-REPLICA backstop it was designed to
  be, not the intra-replica common path. The allocator was already
  built for this: one internal lock around mutation, lock-free memo
  reads. Preemption nominations ride along — whichever head pops a
  nominated pod sees (and honors) the nomination.
- the cluster authority: already thread-safe (FakeCluster's RLock, the
  real apiserver's optimistic concurrency). Its internal lock IS the
  single-writer commit lane — commits serialize there, and a losing
  head's 409 resolves attempt-free through the change-log-invalidated
  rows like any fleet conflict.
- telemetry/event fan-in: every head subscribes for WAKE purposes, but
  only the primary routes events into the shared queue's hint index
  (Scheduler.route_events) — N heads funneling every event into one
  inbox would multiply drain work N-fold for identical information.
  Worker memos need no event routing at all: they self-invalidate off
  the cluster version vector at cycle start.

scheduleHeads=1 (the default) builds no workers, installs no lock, no
filter, nothing: the classic loop, bit-identical (pinned by
tests/test_heads.py parity and the YODA_SCHEDULE_HEADS=1 CI leg).

Composition with the fleet: FleetCoordinator builds a HeadSet per
replica when config.schedule_heads > 1. Heads live INSIDE a replica's
shard-lease scope — every head of a replica fences with that replica's
leases (same fence_provider), and a lease handover clears every head's
score memo, not just the primary's.
"""

from __future__ import annotations

import logging
import threading

from .core import Scheduler, default_profile
from ..utils.labels import GANG_NAME_LABEL

log = logging.getLogger("yoda.heads")

# rng diversification prime for heads. Distinct from the fleet's 7919
# replica prime and offset per replica by construction (worker seeds
# derive from the REPLICA's already-diversified seed), so no two heads
# anywhere in a fleet share a tie-break stream.
_HEAD_SEED_PRIME = 104729


class HeadSet:
    """N scheduling heads over one engine's queue and backend.

    `engine` is the fully-built primary (head 0). Workers are built
    here, wired to share its queue, and driven either deterministically
    (step, the chaos-fuzz interleave) or threaded (start_workers; the
    primary stays on its existing driver — the fleet replica loop or a
    standalone serve loop)."""

    def __init__(self, engine: Scheduler, n_heads: int,
                 worker_profile_fn=None) -> None:
        self.primary = engine
        self.n = max(int(n_heads), 1)
        self.heads: list[Scheduler] = [engine]
        self._threads: list[threading.Thread] = []
        if self.n == 1:
            return  # classic loop: no lock, no filter, bit-identical
        engine.queue.enable_multi_head()
        base_cfg = engine.config
        for i in range(1, self.n):
            cfg = base_cfg.with_(
                rng_seed=base_cfg.rng_seed + _HEAD_SEED_PRIME * i,
                # controllers are primary-only (module docstring): a
                # worker running defrag/provisioner/admission would
                # race the primary's pass for zero added throughput
                defrag_interval_s=0.0,
                provisioner_interval_s=0.0,
                workload_admission=False)
            shared_gangs = (engine.gang_permit.gangs
                            if engine.gang_permit is not None else None)
            if worker_profile_fn is not None:
                profile = worker_profile_fn(cfg, engine.allocator,
                                            shared_gangs)
            else:
                profile, _alloc, _gang = default_profile(
                    cfg, allocator=engine.allocator, gangs=shared_gangs)
            worker = Scheduler(engine.cluster, cfg, profile=profile,
                               clock=engine.clock)
            # share the primary's queue; the worker's private one (plus
            # its hint registrations) is garbage from this line on
            worker.queue = engine.queue
            worker.route_events = False
            # elastic growth bookkeeping follows the gang machinery:
            # head-local to the primary
            worker.elastic = None
            worker.victim_router = (engine.victim_router
                                    or engine.submit)
            worker.fence_provider = engine.fence_provider
            # distinct process row per head in a merged trace export
            worker.spans.pid = getattr(engine.spans, "pid", 0) * 64 + i
            self.heads.append(worker)
        for idx, head in enumerate(self.heads):
            head.head_filter = self._make_filter(idx)

    # ------------------------------------------------------------ segregation
    def _make_filter(self, idx: int):
        # allocators foreign to this head (custom worker profiles may
        # decline to share; the default shares one, making this empty —
        # nominations are then globally visible and honored by whichever
        # head pops the pod, so no exclusion is needed)
        own = self.heads[idx].allocator
        foreign = []
        for h in self.heads:
            a = h.allocator
            if a is not None and a is not own \
                    and all(a is not f for f in foreign):
                foreign.append(a)

        def excluded(info) -> bool:
            pod = info.pod
            if idx != 0 and GANG_NAME_LABEL in pod.labels:
                return True  # gangs run on the primary only
            for alloc in foreign:
                if alloc.nomination_of(pod.key) is not None:
                    return True  # preemption entitlement lives elsewhere
            return False

        return excluded

    # --------------------------------------------------------------- driving
    def step(self, rng=None) -> str | None:
        """Deterministic single-step (chaos fuzz / tests): one cycle on
        the first ready head in seeded rotation, mirroring
        FleetCoordinator.step — a seed fully determines the interleave
        and therefore the commit order."""
        order = list(self.heads)
        if rng is not None:
            rng.shuffle(order)
        for head in order:
            outcome = head.run_one()
            if outcome is not None:
                return outcome
        return None

    def run_one(self) -> str | None:
        """Drop-in for Scheduler.run_one where a driver holds a single
        engine: unseeded rotation is fine for serve loops (fairness
        comes from the shared queue, not head order)."""
        return self.step()

    def start_workers(self, stop: threading.Event) -> None:
        """Threaded serve mode: one thread per WORKER head. The primary
        is NOT started here — its existing driver (fleet replica loop /
        standalone serve loop) keeps driving it, so intake, controllers
        and breaker stay exactly where they were."""
        for head in self.heads[1:]:
            t = threading.Thread(
                target=self._worker_loop, args=(head, stop), daemon=True,
                name=f"head-{getattr(head.spans, 'pid', 0)}")
            self._threads.append(t)
            t.start()

    def _worker_loop(self, head: Scheduler, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                outcome = head.run_one()
            except Exception:
                # run_one contains cycle crashes; anything escaping is an
                # engine bug — log and keep the head alive (same posture
                # as the fleet replica loop)
                log.exception("scheduling head escaped containment")
                outcome = None
            if outcome is None:
                wake = head.next_wake_at()
                timeout = 0.05
                if wake is not None:
                    timeout = min(
                        max(wake - head.clock.time(), 0.001), 0.05)
                if head.wake.wait(timeout):
                    head.wake.clear()

    def join(self, timeout: float = 5.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)

    def next_wake_at(self) -> float | None:
        wakes = [w for w in (h.next_wake_at() for h in self.heads)
                 if w is not None]
        return min(wakes) if wakes else None

    # ------------------------------------------------------------- lifecycle
    def clear_score_memos(self) -> None:
        """Shard-lease ownership changed: every head scored against the
        old owned set (ShardScore reads it by reference), so every
        head's memo is stale — the fleet calls this where it used to
        clear only rep.engine's."""
        for head in self.heads:
            head._score_memo.clear()

    def propagate_fence_provider(self) -> None:
        """The fleet assigns fence_provider on the primary after
        construction in some paths; mirror it onto workers so every
        head of a replica fences with the replica's leases."""
        for head in self.heads[1:]:
            head.fence_provider = self.primary.fence_provider

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Aggregate shared-state counters across heads — the
        intra-process analogue of fleet_stats: committed binds per head
        (the share), conflicts by resolution, retry totals."""
        keys = ("pods_scheduled_total", "bind_conflicts_total",
                "bind_conflict_retries_total",
                "foreign_bind_conflicts_total",
                "foreign_bind_skips_total", "lease_lost_aborts_total",
                "bind_errors_total",
                "async_bind_conflict_corrections_total")
        agg = {k: 0 for k in keys}
        per_head = []
        for h in self.heads:
            c = h.metrics.counters
            per_head.append({k: c.get(k, 0) for k in keys})
            for k in keys:
                agg[k] += c.get(k, 0)
        out = dict(agg)
        out["pods_scheduled_total"] -= out[
            "async_bind_conflict_corrections_total"]
        out["per_head_binds"] = [
            p["pods_scheduled_total"]
            - p["async_bind_conflict_corrections_total"]
            for p in per_head]
        out["heads"] = self.n
        return out
