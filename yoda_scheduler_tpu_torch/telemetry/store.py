"""In-memory telemetry store: the analogue of the reference's watch cache.

The reference runs a controller-runtime cache over SCV custom resources for
the life of the process (reference pkg/yoda/scheduler.go:53-68) so that the
per-(pod,node) Filter/Score hot path is a pure in-memory read
(scheduler.go:80,118) and the per-pod aggregation pass is an in-memory list
(scheduler.go:98).

`TelemetryStore` reproduces that contract: `get(node)` / `list()` are lock-
protected dict reads, publishers push full objects, and subscribers get
change callbacks (the watch analogue). The k8s-backed path (k8s/client.py)
feeds the same store from a CRD watch stream; the fake publisher feeds it in
tests and benchmarks.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

from .schema import TpuNodeMetrics
from ..utils.changelog import ChangeLog

WatchCallback = Callable[[str, TpuNodeMetrics | None], None]


class TelemetryStore:
    """Thread-safe node-name -> TpuNodeMetrics map with watch callbacks."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._by_node: dict[str, TpuNodeMetrics] = {}
        self._watchers: list[WatchCallback] = []
        # change watchers get (node, old, new) — old/new object pairs feed
        # the scheduler queue's telemetry queueing hints (a hint must judge
        # whether the update could free capacity, which needs the diff)
        self._change_watchers: list = []
        self._changes = ChangeLog()
        # conservative lower bound over stored heartbeats: lets the
        # scheduler's feasible-list repair skip its per-node staleness
        # re-checks outright when even the oldest heartbeat is fresh (the
        # overwhelmingly common case — sniffers republish every few
        # seconds). Only lowered incrementally; recomputed exactly once
        # per full put round so refreshed heartbeats eventually raise it.
        self._hb_floor: float | None = None
        self._floor_puts = 0
        # conservative upper bound over stored heartbeats: the engine's
        # blackout detector (degraded mode) asks "is even the NEWEST
        # heartbeat stale?" — a cluster-wide feed outage, as opposed to
        # one node's sniffer dying (which the floor/staleness gate
        # handles per node). Raised on put; recomputed exactly on delete
        # (deletes are rare; a stale-high ceiling would mask a blackout).
        self._hb_ceil: float | None = None

    def _recompute_ceil_locked(self) -> None:
        """Exact heartbeat-ceiling recompute (caller holds the lock) —
        the single definition the put/delete/re-anchor paths share, so
        the blackout detector can't desynchronize between them."""
        self._hb_ceil = max(
            (m.heartbeat for m in self._by_node.values()), default=None)

    # ------------------------------------------------------------- publisher
    def put(self, metrics: TpuNodeMetrics) -> None:
        with self._lock:
            old = self._by_node.get(metrics.node)
            if old is metrics:
                # in-place republish (the caller mutated the stored object
                # and put it again): no pre-change state exists to diff
                # against, so hand hints old=None — the conservative
                # "first report" verdict — rather than a no-op diff that
                # would SKIP a genuine change (e.g. a heartbeat revival)
                old = None
            metrics.generation = self._changes.record(metrics.node)
            self._by_node[metrics.node] = metrics
            hb = metrics.heartbeat
            if self._hb_floor is None or hb < self._hb_floor:
                self._hb_floor = hb
            if self._hb_ceil is None or hb > self._hb_ceil:
                self._hb_ceil = hb
            elif (old is not None and hb < old.heartbeat
                    and old.heartbeat >= self._hb_ceil):
                # the (possible) ceiling holder moved DOWN — e.g. a
                # restore-from-backup replay, or a scripted blackout: an
                # exact recompute keeps the blackout detector live (a
                # stuck-high ceiling would mask a dead feed forever).
                # In-place republishes (old unavailable) are covered by
                # the periodic re-anchor below.
                self._recompute_ceil_locked()
            self._floor_puts += 1
            if self._floor_puts > len(self._by_node):
                self._floor_puts = 0
                self._hb_floor = min(
                    (m.heartbeat for m in self._by_node.values()),
                    default=None)
                # in-place republishes mutate stored heartbeats without a
                # fresh put observing the OLD value, so the ceiling can
                # drift high or low — re-anchor it on the same cadence
                self._recompute_ceil_locked()
            watchers = list(self._watchers)
            changed = list(self._change_watchers)
        for cb in watchers:
            cb(metrics.node, metrics)
        for cb in changed:
            cb(metrics.node, old, metrics)

    def delete(self, node: str) -> None:
        with self._lock:
            old = self._by_node.pop(node, None)
            self._changes.record(node)
            # removal can only raise the true minimum; the floor stays a
            # valid (conservative) lower bound. The ceiling CAN drop
            # (the newest node left), so recompute it exactly.
            self._recompute_ceil_locked()
            watchers = list(self._watchers)
            changed = list(self._change_watchers)
        for cb in watchers:
            cb(node, None)
        for cb in changed:
            cb(node, old, None)

    def heartbeat_floor(self) -> float | None:
        """Lower bound over every stored heartbeat (None when empty).
        GIL-atomic single read; see __init__ for the maintenance rule."""
        return self._hb_floor

    def heartbeat_ceiling(self) -> float | None:
        """Upper bound over every stored heartbeat (None when empty) —
        the engine's telemetry-blackout detector: when even the NEWEST
        heartbeat is past the staleness gate, the whole feed is dark and
        degraded mode keeps scheduling off last-known capacity."""
        return self._hb_ceil

    def changes_since(self, version: int) -> tuple[int, set[str] | None]:
        """(current version, nodes changed after `version`) — None for the
        node set when the change log no longer reaches back that far (the
        caller must do a full rebuild). Lets per-cycle consumers refresh
        only dirty nodes instead of scanning every node every cycle."""
        with self._lock:
            return self._changes.changes_since(version)

    # -------------------------------------------------------------- consumer
    def get(self, node: str) -> TpuNodeMetrics | None:
        with self._lock:
            return self._by_node.get(node)

    def list(self) -> list[TpuNodeMetrics]:
        with self._lock:
            return list(self._by_node.values())

    def nodes(self) -> list[str]:
        with self._lock:
            return list(self._by_node)

    @property
    def resource_version(self) -> int:
        return self._changes.version  # single int read: GIL-atomic

    def watch(self, cb: WatchCallback) -> Callable[[], None]:
        """Register a change callback; returns an unsubscribe function."""
        with self._lock:
            self._watchers.append(cb)

        def cancel() -> None:
            with self._lock:
                if cb in self._watchers:
                    self._watchers.remove(cb)

        return cancel

    def watch_changes(self, cb) -> Callable[[], None]:
        """Register a diff callback (cb(node, old, new)); returns an
        unsubscribe function. new=None means deletion."""
        with self._lock:
            self._change_watchers.append(cb)

        def cancel() -> None:
            with self._lock:
                if cb in self._change_watchers:
                    self._change_watchers.remove(cb)

        return cancel

    def load(self, items: Iterable[TpuNodeMetrics]) -> None:
        for m in items:
            self.put(m)
