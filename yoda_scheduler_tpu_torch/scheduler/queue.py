"""Active queue + backoff for pending pods, with event-driven requeue.

The upstream engine the reference embeds provides the priority queue and the
unschedulable-pod backoff (configured 1s initial / 10s max in reference
deploy/yoda-scheduler.yaml:19-20); the plugin only supplies the comparator
(reference pkg/yoda/sort/sort.go:8-10). This module is the native
equivalent: a comparator-ordered active queue plus a backoff parking lot.

Event-driven requeue (upstream QueueingHints/EventsToRegister analogue):
a pod entering backoff records WHICH plugins rejected it; the engine
publishes cluster events (binds, deletions, telemetry updates, node spec
changes, gang arrivals) into `on_event`, which consults exactly the
rejecting plugins' queueing hints. A QUEUE verdict moves the pod to the
active queue immediately — it does not sleep out the rest of its backoff —
while SKIP (and events no rejecting plugin registered for) leave it
parked, so a bind storm cannot thundering-herd every parked pod back into
the filter chain. The backoff deadline stays as the timer fallback, so a
pod whose rejecting plugins have no hint coverage behaves exactly as
before.

Multi-head pop (intra-replica parallel scheduling, scheduler/heads.py):
`enable_multi_head()` arms a reentrant lock around every public entry
point, so N scheduling heads inside one process can pop/requeue/notify
against the SAME queue without double-consuming — pop's consume step
(_consume_active dropping the live stint id) is atomic under the lock,
and a pod handed to one head is structurally gone for every other.
`pop`/`pop_batch`/`peek` additionally accept an `exclude` predicate:
worker heads pass one that defers gang pods (gang-assembly state is
head-local, the same reason fleet routing keys gangs to one replica)
and foreign-head nominees to the head that owns their state. Exclusion
is exact in the heap queue (skipped entries are re-pushed verbatim, so
ordering never shifts); the sharded-DRF queue defers only at the
selection head (returns None when the DRF pick is excluded — the band
structure cannot skip without corrupting tenant counts), which at worst
delays one worker pop until the owning head drains its pod.
Single-head queues never take the lock and never see a predicate:
the classic path is bit-identical.

Equivalence-class batch pop (batch scheduling cycles): when the engine
registers a batch-key function (set_batch_key_fn), pop_batch extends the
ordinary head pop to up to `max_pods` ACTIVE pods sharing the head's
scheduling-equivalence key, so one filter+score pass can place the whole
batch. Ordering contract: the head is still the exact pod pop() would
return; classmates are gathered in (enqueued, seq) FIFO order from a
per-key index. Classmates necessarily share the head's priority and
constraint rank (both are functions of the labels the key covers), so a
batch never overtakes a higher-priority pod — it can only advance
classmates past EQUAL-priority pods of other classes, bounded by
`max_pods` (the documented fairness trade; batchMaxPods=1 restores strict
FIFO). Pods in backoff are never gathered — only an event or their timer
moves them to the active queue, exactly as before.
"""

from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from typing import Callable

from .framework import ClusterEvent, EnqueueExtensions, QUEUE, QueuedPodInfo
from ..utils.pod import Pod

LessFn = Callable[[QueuedPodInfo, QueuedPodInfo], bool]


class SchedulingQueue:
    def __init__(self, less: LessFn, initial_backoff_s: float = 1.0,
                 max_backoff_s: float = 10.0, key=None, metrics=None,
                 hinted_backoff_s: float = 0.0):
        """`less` is the framework comparator contract. When the queue-sort
        plugin also provides an equivalent `key(info)` (PrioritySort does),
        the active queue is a heap — O(log n) pops instead of an O(n)
        comparator scan. A key must order exactly like `less`.

        Ordering contract: heap keys are computed when a pod ENTERS the
        active queue (add / backoff flush — backoff re-entry re-keys), so
        whatever `key`/`less` reads (e.g. the scv/priority label) must be
        immutable while the pod sits in the active queue. Kubernetes
        enforces the same invariant upstream: pod priority is set from the
        PriorityClass at admission and is immutable thereafter.

        `metrics` (utils.obs.Metrics, optional): requeue_events_total /
        requeue_wakeups_total / requeue_hint_skips_total counters and the
        backoff_wait_ms histogram (how long pods actually sat in backoff
        before activation — the number event-driven requeue shrinks)."""
        self._less = less
        self._key = key
        self._seq = itertools.count()  # heap tie-break; preserves FIFO
        self._initial = initial_backoff_s
        self._max = max_backoff_s
        # optional backoff stretch: a pod whose EVERY rejecting plugin
        # registered queueing hints does not need to retry blind — a
        # matching event is its retry trigger, so the timer MAY stretch
        # to this safety net (upstream podMaxInUnschedulablePodsDuration).
        # Opt-in: any value <= max_backoff_s disables it, keeping the
        # classic 1s->10s cadence (event wakes fire either way). Pods
        # with a hint-less rejector always keep the classic cadence,
        # because nothing else would ever retry them.
        self._hinted = (hinted_backoff_s
                        if hinted_backoff_s > max_backoff_s else 0.0)
        self._metrics = metrics
        self._active: list = []  # infos, or (key, seq, info) heap entries
        # backoff lot: a deadline-ordered heap of (not_before, seq, info).
        # Entries go stale when their pod is activated by an event or
        # removed — detected at pop time by not_before mismatch / absence
        # from the parked map (a backoff list rescanned
        # O(parked) on every pop, which dominated retry-heavy bursts).
        self._backoff: list = []
        # parked map: id(info) -> info for every pod currently in backoff
        self._parked: dict[int, QueuedPodInfo] = {}
        # event index: event kind -> {id(info): info} for parked pods whose
        # rejecting plugins registered that kind; "*" holds pods rejected
        # by a plugin without hint support (any event may help them)
        self._by_kind: dict[str, dict[int, QueuedPodInfo]] = {}
        # plugin name -> (registered kinds, hint callable); populated by
        # register_plugin from the profile's EnqueueExtensions plugins
        self._hints: dict[str, tuple[frozenset, Callable]] = {}
        # cross-thread event inbox: notify() appends from ANY thread
        # (reflector, binder, test driver — deque append is GIL-atomic);
        # pop()/next_ready_at() drain it on the thread that owns the
        # queue, so hints and the parked map never race. Bounded: past
        # _INBOX_CAP undrained events (an apiserver event storm
        # outrunning the engine) notify() DROPS the event and counts it.
        # Dropping is safe because events are a latency optimization,
        # never the correctness mechanism: every parked pod keeps its
        # backoff deadline, so a dropped cure event only delays that
        # pod's retry to its timer. The alternative — flushing every
        # parked pod awake — would burn attempts of pods whose hints
        # would have said SKIP, permanently failing them under a
        # sustained storm (max_attempts posture).
        self._inbox: deque = deque()
        self._dropped_events = 0
        # churn plane (config.churn_plane): the owning engine flips this
        # to drain the inbox in one batched slice per cycle instead of
        # one on_event call per event. Wake order, counter totals, and
        # the enqueue-time drop accounting are bit-identical either way.
        self.batch_drain = False
        # pod-key membership counts: contains() is called once per PENDING
        # pod per serve pass (k8s/client._serve intake), so it must be
        # O(1), not a queue scan — at 1000 pending pods the scan made the
        # serve loop O(n^2) per pass
        self._key_counts: dict[str, int] = {}
        # ---- equivalence-class batch pop state ----
        # batch-key function (engine-provided); None disables batching.
        self._bkey_fn: Callable | None = None
        # live membership of the ACTIVE queue: id(info) -> the seq of its
        # CURRENT activation stint. Gathering a classmate from the per-key
        # index (or a lazy removal) deletes the id, and both heaps skip
        # entries whose recorded seq is not the live stint's at pop time —
        # the same lazy-staleness pattern the backoff heap uses. Keying on
        # the stint seq (not bare identity) matters: a gathered-then-
        # requeued info re-enters with a FRESH seq, and its old heap entry
        # must stay dead or the pod would ride the old entry's position
        # ahead of equal-priority pods enqueued during its backoff.
        # _n_active is the live count — heap list lengths over-count once
        # lazy removals exist.
        self._active_ids: dict[int, int] = {}
        self._n_active = 0
        # batch key -> heap of (enqueued, seq, info): FIFO within a class,
        # matching the main heap's intra-band order. _bkey_live counts the
        # LIVE entries per key: when a class's last active pod leaves (by
        # any route — pop, batch gather, removal), its whole heap is
        # dropped, so classes that never recur cannot accumulate dead
        # entries in a long-running serve daemon.
        self._by_bkey: dict = {}
        self._bkey_live: dict = {}
        # multi-head lock (module docstring): None until enable_multi_head
        self._mh_lock = None

    # ------------------------------------------------------------ multi-head
    _MH_GUARDED = ("add", "pop", "pop_batch", "peek", "requeue_backoff",
                   "requeue_immediate", "remove", "on_event",
                   "next_ready_at", "parked_infos", "set_batch_key_fn",
                   "register_plugin", "register_hint")

    def enable_multi_head(self) -> None:
        """Arm the queue for concurrent heads: every public entry point
        (the _MH_GUARDED set — notify stays lock-free, its deque append
        is GIL-atomic by design) runs under one reentrant lock.
        Idempotent; irreversible for the queue's lifetime. Single-head
        queues never call this, so the classic path carries no lock."""
        if self._mh_lock is not None:
            return
        import functools
        import threading

        self._mh_lock = lock = threading.RLock()
        for name in self._MH_GUARDED:
            fn = getattr(self, name)

            def locked(*a, _fn=fn, **kw):
                with lock:
                    return _fn(*a, **kw)

            functools.update_wrapper(locked, fn)
            setattr(self, name, locked)

    # --------------------------------------------------------- hint registry
    def register_plugin(self, plugin) -> None:
        """Register a plugin's EnqueueExtensions (name, events, hint). A
        plugin registering an EMPTY kind set declares "no event can cure
        my rejections": its pods are filed under no event bucket (they
        wait out their backoff timer) instead of the conservative
        any-event wildcard that covers plugins with no EnqueueExtensions
        at all."""
        if not isinstance(plugin, EnqueueExtensions):
            return
        kinds = frozenset(plugin.events_to_register())
        self._hints[plugin.name] = (kinds, plugin.queueing_hint)

    def register_hint(self, name: str, kinds, hint: Callable) -> None:
        """Register a bare (non-plugin) hint source — the engine uses this
        for its own rejections (e.g. waiting-for-victims-to-terminate wakes
        on PodDeleted)."""
        self._hints[name] = (frozenset(kinds), hint)

    def _inc(self, key: str) -> None:
        self._key_counts[key] = self._key_counts.get(key, 0) + 1

    def _dec(self, key: str) -> None:
        n = self._key_counts.get(key, 0) - 1
        if n <= 0:
            self._key_counts.pop(key, None)
        else:
            self._key_counts[key] = n

    def set_batch_key_fn(self, fn: Callable | None) -> None:
        """Install the engine's scheduling-equivalence key function
        (pod -> hashable | None). Must be set before the first add(); the
        function must be pure per pod (the engine memoises it on the pod)."""
        self._bkey_fn = fn

    def _push_active(self, info: QueuedPodInfo) -> None:
        stint = next(self._seq)  # tie-break AND this activation's epoch
        self._active_ids[id(info)] = stint
        self._n_active += 1
        self._order_insert(info, stint)
        if self._key is not None and self._bkey_fn is not None:
            k = self._bkey_fn(info.pod)
            if k is not None:
                heapq.heappush(
                    self._by_bkey.setdefault(k, []),
                    (info.enqueued, stint, info))
                self._bkey_live[k] = self._bkey_live.get(k, 0) + 1

    # ---- ordering layer (overridden by DRFShardedQueue) ----
    def _order_insert(self, info: QueuedPodInfo, stint: int) -> None:
        """File an activated pod into the ordering structure. The base
        queue keeps ONE comparator heap (or list, in comparator-scan
        mode); DRFShardedQueue files into per-tenant priority bands."""
        if self._key is not None:
            heapq.heappush(self._active,
                           (self._key(info), stint, info))
        else:
            self._active.append(info)

    def _active_infos(self):
        if self._key is not None:
            return (e[2] for e in self._active
                    if self._active_ids.get(id(e[2])) == e[1])
        return iter(self._active)

    def add(self, pod: Pod, now: float | None = None) -> None:
        info = QueuedPodInfo(pod=pod)
        if now is not None:
            info.enqueued = now
        info.last_queued_at = info.enqueued  # queue-wait phase starts
        self._push_active(info)
        self._inc(pod.key)

    def __len__(self) -> int:
        return self._n_active + len(self._parked)

    def pending(self) -> int:
        return len(self)

    def parked_infos(self) -> list:
        """Snapshot of every pod currently parked in backoff — the
        capacity provisioner's demand surface (each carries the spec
        shape and the backoff stamp of its last failed cycle).
        Engine-thread exact; advisory (GIL-atomic dict copy) when a
        fleet coordinator reads a peer replica's queue."""
        return list(self._parked.values())

    # ------------------------------------------------------------ parked lot
    def _park(self, info: QueuedPodInfo) -> None:
        heapq.heappush(self._backoff,
                       (info.not_before, next(self._seq), info))
        self._parked[id(info)] = info
        kinds: set[str] = set()
        for name in info.rejected_by:
            reg = self._hints.get(name)
            if reg is None:
                kinds.add("*")  # hint-less rejector: any event may help
            else:
                kinds.update(reg[0])
        for kind in kinds:
            self._by_kind.setdefault(kind, {})[id(info)] = info

    def _unpark(self, info: QueuedPodInfo) -> None:
        """Drop a pod from the parked map and event index (its heap entry
        goes stale and is skipped at pop time)."""
        self._parked.pop(id(info), None)
        for bucket in self._by_kind.values():
            bucket.pop(id(info), None)

    def _activate(self, info: QueuedPodInfo, now: float) -> None:
        self._unpark(info)
        # every parked pod came through requeue_backoff, which stamped
        # backoff_started (0.0 is a legitimate FakeClock epoch)
        if self._metrics is not None:
            self._metrics.observe("backoff_wait_ms",
                                  (now - info.backoff_started) * 1e3)
        self._push_active(info)

    def _flush_backoff(self, now: float) -> None:
        heap = self._backoff
        while heap:
            nb, _, info = heap[0]
            if self._parked.get(id(info)) is not info \
                    or info.not_before != nb:
                heapq.heappop(heap)  # stale: activated by event or removed
                continue
            if nb > now:
                return
            heapq.heappop(heap)
            self._activate(info, now)

    _INBOX_CAP = 4096

    def notify(self, event: ClusterEvent) -> None:
        """Accept a cluster event from any thread; the next pop() (or an
        explicit drain via on_event) routes it through the queueing hints
        on the queue owner's thread. Storm protection: past _INBOX_CAP
        undrained events the event is DROPPED and counted — parked pods
        fall back to their backoff timers (see __init__)."""
        if len(self._inbox) >= self._INBOX_CAP:
            self._dropped_events += 1  # plain int add: GIL-atomic enough
            if self._metrics is not None:
                self._metrics.inc("requeue_events_dropped_total")
            return
        self._inbox.append(event)

    def has_undrained_events(self) -> bool:
        return bool(self._inbox)

    def _drain_inbox(self, now: float) -> None:
        if not self._inbox:
            return
        # cycle-phase attribution: the inbox-drain half of event
        # application (the columnar-sync half stamps the same series)
        t0 = time.perf_counter()
        if self.batch_drain:
            while self._inbox:
                self._drain_batch(now)
        else:
            while True:
                try:
                    ev = self._inbox.popleft()
                except IndexError:
                    break
                self.on_event(ev, now=now)
        if self._metrics is not None:
            self._metrics.observe("cycle_event_apply_ms",
                                  (time.perf_counter() - t0) * 1e3)

    def _drain_batch(self, now: float) -> None:
        """Churn-plane drain: slice the whole inbox at once, count it
        with ONE metrics call, and early-out without consulting any hint
        when nothing is parked (the equilibrium common case — every
        bind/delete event arrives while the parked lot is empty). When
        pods ARE parked, events still route through on_event's exact
        walk IN ARRIVAL ORDER — an event that wakes a pod unparks it
        before the next event is consulted, so wake order (and therefore
        heap stint order) matches the scalar drain bit-for-bit; skip and
        wakeup counters are folded once per batch with identical totals
        (tests/test_churn_plane.py pins both). Drop accounting is
        untouched: notify() counts drops at ENQUEUE against the same
        _INBOX_CAP, so a batched drain frees capacity exactly when the
        scalar drain would have finished freeing it."""
        inbox = self._inbox
        n = len(inbox)
        if not n:
            return
        events = [inbox.popleft() for _ in range(n)]
        if self._metrics is not None:
            self._metrics.inc("requeue_events_total", n)
        if not self._parked:
            return
        by_kind = self._by_kind
        hints = self._hints
        hint_skips = 0
        woken_total = 0
        for event in events:
            bucket = by_kind.get(event.kind)
            wild = by_kind.get("*")
            if not bucket and not wild:
                continue
            candidates = list(bucket.values()) if bucket else []
            if wild:
                seen = {id(i) for i in candidates}
                candidates.extend(i for i in wild.values()
                                  if id(i) not in seen)
            for info in candidates:
                if event.origin is not None and info.pod.key == event.origin:
                    continue  # a pod's own rollback never wakes itself
                verdict = None
                for name in info.rejected_by:
                    reg = hints.get(name)
                    if reg is None:
                        verdict = QUEUE  # hint-less rejector: conservative
                        break
                    kinds, hint = reg
                    if event.kind in kinds and hint(event, info.pod) == QUEUE:
                        verdict = QUEUE
                        break
                if verdict == QUEUE:
                    self._activate(info, now)
                    woken_total += 1
                else:
                    hint_skips += 1
        if self._metrics is not None:
            if hint_skips:
                self._metrics.inc("requeue_hint_skips_total", hint_skips)
            if woken_total:
                self._metrics.inc("requeue_wakeups_total", woken_total)

    def on_event(self, event: ClusterEvent, now: float | None = None) -> int:
        """Route one cluster event through the parked pods' queueing hints;
        returns how many pods were activated. Only pods whose rejecting
        plugins registered this event kind are consulted (plus pods with a
        hint-less rejector); a QUEUE verdict from any such plugin moves the
        pod to the active queue immediately, SKIP leaves its backoff
        intact."""
        if self._metrics is not None:
            self._metrics.inc("requeue_events_total")
        bucket = self._by_kind.get(event.kind)
        wild = self._by_kind.get("*")
        if not bucket and not wild:
            return 0
        now = time.time() if now is None else now
        woken = 0
        candidates = list(bucket.values()) if bucket else []
        if wild:
            seen = {id(i) for i in candidates}
            candidates.extend(i for i in wild.values()
                              if id(i) not in seen)
        for info in candidates:
            if event.origin is not None and info.pod.key == event.origin:
                continue  # a pod's own rollback never wakes itself
            verdict = None
            for name in info.rejected_by:
                reg = self._hints.get(name)
                if reg is None:
                    verdict = QUEUE  # hint-less rejector: conservative
                    break
                kinds, hint = reg
                if event.kind in kinds and hint(event, info.pod) == QUEUE:
                    verdict = QUEUE
                    break
            if verdict == QUEUE:
                self._activate(info, now)
                woken += 1
            elif self._metrics is not None:
                self._metrics.inc("requeue_hint_skips_total")
        if woken and self._metrics is not None:
            self._metrics.inc("requeue_wakeups_total", woken)
        return woken

    def peek(self, now: float | None = None,
             exclude=None) -> QueuedPodInfo | None:
        """Highest-priority READY pod without consuming it — the
        overlapped-prefetch dispatcher asks what the next cycle will
        schedule. Engine-thread-only, like pop. Drains the inbox and
        backoff flush exactly as pop would (so the answer matches the
        next pop), but burns no attempt and leaves the entry queued.
        Comparator-scan mode (no heap key) returns None: peeking there
        would cost a full scan per cycle for a hint. `exclude` follows
        pop's multi-head contract, except peek never re-orders: a head
        whose top pod is excluded simply sees None."""
        now = time.time() if now is None else now
        if self._inbox:
            self._drain_inbox(now)
        self._flush_backoff(now)
        if not self._n_active:
            return None
        return self._order_peek(exclude)

    def _order_peek(self, exclude=None) -> QueuedPodInfo | None:
        if self._key is None:
            return None
        while self._active:
            _, stint, info = self._active[0]
            if self._active_ids.get(id(info)) != stint:
                heapq.heappop(self._active)  # stale entry: discard
                continue
            if exclude is not None and exclude(info):
                return None  # top belongs to another head: no prefetch
            return info
        return None

    def pop(self, now: float | None = None,
            exclude=None) -> QueuedPodInfo | None:
        """Pop the highest-priority ready pod (None if all are backing off).

        Heap pop when the sort plugin provides a key; otherwise a
        comparator selection scan (the framework contract only guarantees a
        strict weak order via `less`). `exclude(info) -> bool` is the
        multi-head segregation predicate (module docstring): excluded
        LIVE entries are skipped without being consumed — exact skip
        (re-pushed verbatim) in heap mode, selection-scan skip in
        comparator mode."""
        now = time.time() if now is None else now
        if self._inbox:
            self._drain_inbox(now)
        self._flush_backoff(now)
        if not self._n_active:
            if self._active:
                del self._active[:]  # no live entries: all stale
            return None
        info = self._order_pop(exclude)
        if info is None:
            return None
        self._consume_active(info, now)
        return info

    def _order_pop(self, exclude=None) -> QueuedPodInfo | None:
        """Select (and structurally detach) the next live pod; the caller
        consumes it. The sharded subclass detaches nothing — its stint
        check retires entries lazily once _consume_active drops the id."""
        if self._key is not None:
            stash = None
            try:
                while self._active:
                    entry = heapq.heappop(self._active)
                    _, stint, info = entry
                    if self._active_ids.get(id(info)) != stint:
                        continue  # gathered/removed, or a PREVIOUS stint's
                        # entry for a since-requeued pod: stale either way
                    if exclude is not None and exclude(info):
                        # live but owned by another head: set it aside and
                        # keep looking — the finally re-push restores the
                        # exact tuples, so ordering is untouched
                        if stash is None:
                            stash = []
                        stash.append(entry)
                        continue
                    return info
                return None
            finally:
                if stash:
                    for entry in stash:
                        heapq.heappush(self._active, entry)
        best_i = -1
        for i in range(len(self._active)):
            if exclude is not None and exclude(self._active[i]):
                continue
            if best_i < 0 or self._less(self._active[i],
                                        self._active[best_i]):
                best_i = i
        if best_i < 0:
            return None
        return self._active.pop(best_i)

    def _consume_active(self, info: QueuedPodInfo,
                        now: float | None = None) -> None:
        if now is not None and info.last_queued_at >= 0.0:
            # e2e decomposition: close the pod's queue-wait stint (covers
            # both active-queue wait and backoff — last_queued_at is
            # stamped at add/requeue time, not at activation). 0.0 is a
            # legitimate FakeClock instant; -1.0 is the unset sentinel.
            info.t_queue += max(now - info.last_queued_at, 0.0)
            info.stint_started = info.last_queued_at
            info.last_queued_at = -1.0
        self._active_ids.pop(id(info), None)
        self._n_active -= 1
        self._dec(info.pod.key)
        if self._bkey_fn is not None:
            k = self._bkey_fn(info.pod)
            if k is not None:
                n = self._bkey_live.get(k, 0) - 1
                if n <= 0:
                    self._bkey_live.pop(k, None)
                    self._by_bkey.pop(k, None)
                else:
                    self._bkey_live[k] = n

    def pop_batch(self, now: float | None = None,
                  max_pods: int = 1,
                  exclude=None) -> list[QueuedPodInfo]:
        """Pop the head plus up to max_pods-1 ACTIVE pods sharing its
        scheduling-equivalence key (module docstring: same-class gather in
        FIFO order, never across a priority boundary). Degrades to a
        single-pod pop when batching is off, the head's class is
        unbatchable, or the sort plugin provides no heap key (the
        comparator-scan mode has no cheap per-key index). `exclude`
        applies to the head pop as in pop(); the class gather STOPS at
        the first excluded live classmate (no reorder within the class
        FIFO — the other head will gather its own batch)."""
        now = time.time() if now is None else now
        head = self.pop(now, exclude)
        if head is None:
            return []
        if (max_pods <= 1 or self._bkey_fn is None
                or self._key is None):
            return [head]
        k = self._bkey_fn(head.pod)
        if k is None:
            return [head]
        heap = self._by_bkey.get(k)
        batch = [head]
        while heap and len(batch) < max_pods:
            _, stint, info = heap[0]
            if self._active_ids.get(id(info)) != stint:
                heapq.heappop(heap)  # stale: popped/removed/requeued
                continue
            if exclude is not None and exclude(info):
                break  # classmate owned by another head: leave it queued
            heapq.heappop(heap)
            self._consume_active(info, now)
            batch.append(info)
        if not heap:
            self._by_bkey.pop(k, None)
        return batch

    def requeue_backoff(self, info: QueuedPodInfo, now: float | None = None,
                        rejected_by: tuple = ()) -> None:
        """Return an unschedulable pod with exponential backoff 1s -> 10s.
        `rejected_by` names the plugins whose rejection parked it — the
        event index wakes the pod early when one of them hints QUEUE for a
        later cluster event."""
        now = time.time() if now is None else now
        info.attempts += 1
        # cap the exponent: a permanently-unschedulable pod with
        # max_attempts=0 retries forever, and 2**attempts overflows float
        # past ~1024 attempts
        delay = min(self._initial * (2 ** min(info.attempts - 1, 32)),
                    self._max)
        if self._hinted and rejected_by and all(
                self._hints.get(name, (None,))[0]
                for name in rejected_by):
            # full hint coverage: every way this pod can become
            # schedulable maps to a registered event, so blind timer
            # retries only burn cycles — stretch the timer to the
            # safety-net duration (events wake the pod the moment one
            # matches)
            delay = max(delay, self._hinted)
        info.not_before = now + delay
        info.backoff_started = now
        info.rejected_by = tuple(rejected_by)
        self._close_cycle_stint(info, now)
        self._park(info)
        self._inc(info.pod.key)

    def requeue_immediate(self, info: QueuedPodInfo,
                          now: float | None = None) -> None:
        """Return a pod to the active queue with no backoff — used for a
        preemptor after its victims were evicted, so its priority wins the
        next pop (the nominated-node fast-retry analogue)."""
        info.not_before = 0.0
        if now is not None:
            self._close_cycle_stint(info, now)
        self._push_active(info)
        self._inc(info.pod.key)

    @staticmethod
    def _close_cycle_stint(info: QueuedPodInfo, now: float) -> None:
        """e2e decomposition: the pod is re-entering the queue after a
        non-binding cycle — fold that cycle's elapsed time into t_cycle
        and open a new queue-wait stint. Batch members carry the stint
        run_one opened at the shared pop, so a breaker-parked leftover
        folds its pop-to-park wait here (it IS batch cycle time); only a
        pod with no open stint (cycle_started sentinel) folds nothing."""
        if info.cycle_started >= 0.0:
            info.t_cycle += max(now - info.cycle_started, 0.0)
            info.cycle_started = -1.0
        info.commit_started = -1.0
        info.last_queued_at = now

    def remove(self, pod_key: str) -> list[QueuedPodInfo]:
        """Drop a pod from the active queue and backoff lot (external
        deletion while queued). Returns the removed entries (callers
        inspect them to release gang state; truthy iff anything was
        removed)."""
        removed: list[QueuedPodInfo] = []
        if self._key is not None:
            # lazy removal: _consume_active drops the live id (and the
            # per-batch-key live count) and the heaps skip the stale
            # entries at pop time — rebuilding + re-heapifying the whole
            # active heap per removal was O(n log n) against churny
            # serve loops
            for info in [i for i in self._active_infos()
                         if i.pod.key == pod_key]:
                self._consume_active(info)
                removed.append(info)
        else:
            keep = []
            for q in self._active:
                (removed if q.pod.key == pod_key else keep).append(q)
            self._active = keep
            self._n_active -= len(removed)
            for info in removed:
                self._active_ids.pop(id(info), None)
                self._dec(pod_key)
        for info in [i for i in self._parked.values()
                     if i.pod.key == pod_key]:
            self._unpark(info)  # heap entry goes stale; skipped at pop
            removed.append(info)
            self._dec(pod_key)
        return removed

    def contains(self, pod_key: str) -> bool:
        return pod_key in self._key_counts

    def drf_stats(self) -> dict:
        """Sharded-DRF introspection (bench/tests); the base queue has
        no tenant shards."""
        return {}

    def next_ready_at(self) -> float | None:
        """Earliest not_before among parked pods (None if active non-empty).
        O(1) amortised: stale heap heads are discarded as encountered.
        An undrained event inbox reads as ready NOW — the next pop may
        activate a parked pod."""
        if self._n_active or self._inbox:
            return 0.0
        heap = self._backoff
        while heap:
            nb, _, info = heap[0]
            if self._parked.get(id(info)) is not info \
                    or info.not_before != nb:
                heapq.heappop(heap)
                continue
            return nb
        return None


class _Band:
    """One priority band of a TenantShareBands: per-tenant entry heaps
    plus the tenant-share heap exact-at-pop DRF selection reads."""

    __slots__ = ("tenants", "share_heap", "entry_share", "live", "n_live")

    def __init__(self) -> None:
        self.tenants: dict[str, list] = {}   # tenant -> [(order, seq, item)]
        self.share_heap: list = []           # (share, seq, tenant)
        self.entry_share: dict[str, float] = {}  # tenant -> CURRENT entry
        self.live: dict[str, int] = {}       # tenant -> live item count
        self.n_live = 0


class TenantShareBands:
    """Per-tenant sharded priority bands with EXACT-at-pop DRF ordering.

    Items file under (priority band, tenant); selection is: highest
    priority band first, then — within the band — the tenant with the
    LOWEST dominant share read from the LIVE DRF book at pop time (the
    pick-the-poorest rule), then the caller's order key FIFO within the
    tenant. This replaces entry-time share sampling, where a heap
    key froze the share a pod entered the queue with and ordering went
    stale the moment any bind moved the book.

    Exactness contract: `share_fn(tenant)` must be O(1) against current
    truth (DRFBook.dominant_share is — one dict read over the
    incrementally-maintained rollup), and the book must report share
    MOVEMENT through `mark_dirty` (DRFBook.add_share_listener wires
    this). Every live tenant then always has one heap entry carrying its
    current share: a bind/unbind pushes a fresh entry (O(log T)),
    superseded and dead entries retire lazily at selection time, and the
    heap top after fix-ups is provably the true minimum — a tenant whose
    share DROPPED can never hide behind a stale higher key, which is the
    failure mode a pop-time-recompute-only scheme has. `mark_dirty(None)`
    (capacity moved: every share rescales) rebuilds the per-band heaps
    outright — rare, O(tenants) when it happens.

    Liveness of individual items is the CALLER's: entries are
    (order_key, seq, payload) and `next(live)` skips entries whose
    `live(payload, seq)` is False — the same lazy-staleness pattern the
    scheduling queue's heaps already use. `discard` reports that a live
    item left (by any route) so tenant/band counts stay truthful.
    """

    def __init__(self, share_fn: Callable[[str], float]) -> None:
        self._share = share_fn
        self._seq = itertools.count()
        self._bands: dict[int, _Band] = {}
        self._band_heap: list = []  # heap of -priority
        self._dirty: set[str] = set()
        self._all_dirty = False
        self.n = 0  # live items across all bands

    def __len__(self) -> int:
        return self.n

    def mark_dirty(self, tenant: str | None) -> None:
        """A tenant's share moved (or, with None, capacity rescaled every
        share). Applied at the next selection."""
        if tenant is None:
            self._all_dirty = True
        else:
            self._dirty.add(tenant)

    def insert(self, prio: int, tenant: str, order_key, seq: int,
               payload) -> None:
        band = self._bands.get(prio)
        if band is None:
            band = self._bands[prio] = _Band()
            heapq.heappush(self._band_heap, -prio)
        heapq.heappush(band.tenants.setdefault(tenant, []),
                       (order_key, seq, payload))
        n = band.live.get(tenant, 0)
        band.live[tenant] = n + 1
        band.n_live += 1
        self.n += 1
        if n == 0:
            s = self._share(tenant)
            heapq.heappush(band.share_heap, (s, next(self._seq), tenant))
            band.entry_share[tenant] = s

    def discard(self, prio: int, tenant: str) -> None:
        """One live item of (prio, tenant) was consumed/removed by the
        caller. Tenant heaps whose last live item leaves are dropped
        whole — their stale entries die with them."""
        band = self._bands.get(prio)
        if band is None:
            return
        n = band.live.get(tenant, 0) - 1
        if n <= 0:
            band.live.pop(tenant, None)
            band.tenants.pop(tenant, None)
            band.entry_share.pop(tenant, None)
        else:
            band.live[tenant] = n
        band.n_live -= 1
        self.n -= 1

    def _apply_dirty(self) -> None:
        if self._all_dirty:
            self._all_dirty = False
            self._dirty.clear()
            for band in self._bands.values():
                band.share_heap = []
                band.entry_share = {}
                for t, n in band.live.items():
                    if n > 0:
                        s = self._share(t)
                        heapq.heappush(band.share_heap,
                                       (s, next(self._seq), t))
                        band.entry_share[t] = s
            return
        if not self._dirty:
            return
        dirty, self._dirty = self._dirty, set()
        for t in dirty:
            s = self._share(t)
            for band in self._bands.values():
                if band.live.get(t) and band.entry_share.get(t) != s:
                    heapq.heappush(band.share_heap,
                                   (s, next(self._seq), t))
                    band.entry_share[t] = s

    def next(self, live: Callable) -> tuple | None:
        """The (prio, tenant, order_key, seq, payload) selection under
        the band/DRF/FIFO order, or None. Detaches NOTHING: the caller
        consumes the payload its own way and reports via discard();
        entries whose live() went False retire here lazily."""
        self._apply_dirty()
        while self._band_heap:
            p = -self._band_heap[0]
            band = self._bands.get(p)
            if band is None or band.n_live <= 0:
                heapq.heappop(self._band_heap)
                self._bands.pop(p, None)
                continue
            got = self._next_in_band(p, band, live)
            if got is not None:
                return got
            # every entry of the top band was stale-dead (live() False
            # without a discard — callers shouldn't, but never loop)
            return None
        return None

    def _next_in_band(self, prio: int, band: _Band, live) -> tuple | None:
        while band.share_heap:
            s, _, t = band.share_heap[0]
            n = band.live.get(t, 0)
            if n <= 0:
                heapq.heappop(band.share_heap)
                if band.entry_share.get(t) == s:
                    band.entry_share.pop(t, None)
                continue
            if band.entry_share.get(t) != s:
                heapq.heappop(band.share_heap)  # superseded entry
                continue
            cur = self._share(t)
            if cur != s:
                # moved since the entry was pushed (mark_dirty landed
                # after the last _apply_dirty): fix up in place
                heapq.heappop(band.share_heap)
                heapq.heappush(band.share_heap,
                               (cur, next(self._seq), t))
                band.entry_share[t] = cur
                continue
            theap = band.tenants.get(t)
            while theap:
                order_key, seq, payload = theap[0]
                if not live(payload, seq):
                    heapq.heappop(theap)  # consumed elsewhere: stale
                    continue
                return (prio, t, order_key, seq, payload)
            # live count said n > 0 but the heap is empty/stale-only —
            # a caller consumed without discard(); repair the count
            band.n_live -= band.live.pop(t, 0)
            band.tenants.pop(t, None)
            band.entry_share.pop(t, None)
        return None

    def live_tenants(self) -> dict[int, dict[str, int]]:
        """prio -> {tenant: live count} (tests/stats)."""
        return {p: {t: n for t, n in b.live.items() if n > 0}
                for p, b in self._bands.items() if b.n_live > 0}


class DRFShardedQueue(SchedulingQueue):
    """SchedulingQueue whose ordering layer is per-tenant sharded
    priority bands with exact-at-pop DRF (TenantShareBands docstring).

    Built by the engine instead of the base queue when the policy
    engine's DRF fairness layer is on (TenantFairnessSort marks itself
    sharded_drf). Everything else — backoff parking, queueing hints,
    the equivalence-class batch index, removal — is inherited: the band
    structure only replaces the single comparator heap, and consumption
    through ANY path (pop, batch gather, removal) flows through
    _consume_active, which keeps the band counts truthful.

    Shares come from the policy engine's DRF book, read at pop time.
    The book is attached lazily (the engine wires policy surfaces after
    queue construction); until then — and whenever no book exists, as in
    bare-queue tests — every share reads 0.0 and ordering degrades to
    per-band FIFO across tenants, exactly the no-data posture the
    entry-time sampler had.
    """

    def __init__(self, less: LessFn, policy=None, tenant_fn=None,
                 priority_fn=None, subkey_fn=None, **kw) -> None:
        super().__init__(less, **kw)
        self.policy = policy
        self._tenant_fn = tenant_fn or (lambda pod: pod.namespace)
        self._prio_fn = priority_fn or (lambda info: 0)
        self._subkey_fn = subkey_fn or (lambda info: info.enqueued)
        self._bands = TenantShareBands(self._live_share)
        self._book_attached = False
        self.drf_at_pop_reads = 0  # stats: live-share selections made

    # ------------------------------------------------------------- shares
    def _book(self):
        return self.policy.book if self.policy is not None else None

    def _live_share(self, tenant: str) -> float:
        book = self._book()
        return book.dominant_share(tenant) if book is not None else 0.0

    def _sync_book(self) -> None:
        """Bring the DRF book (and the band share entries) to current
        cluster truth before a selection — the exact-at-pop read."""
        book = self._book()
        if book is None:
            return
        if not self._book_attached:
            self._book_attached = True
            book.add_share_listener(self._bands.mark_dirty)
            self._bands.mark_dirty(None)  # seed every entry fresh
        book.refresh()
        self.drf_at_pop_reads += 1

    # ------------------------------------------------------ ordering layer
    def _order_insert(self, info: QueuedPodInfo, stint: int) -> None:
        self._bands.insert(self._prio_fn(info),
                           self._tenant_fn(info.pod),
                           self._subkey_fn(info), stint, info)

    def _entry_live(self, info, stint) -> bool:
        return self._active_ids.get(id(info)) == stint

    def _order_peek(self, exclude=None) -> QueuedPodInfo | None:
        self._sync_book()
        got = self._bands.next(self._entry_live)
        if got is None:
            return None
        info = got[4]
        if exclude is not None and exclude(info):
            # Top-only defer (module docstring): the DRF pick belongs to
            # another head, so this head sits the cycle out. We must NOT
            # dig past it — TenantShareBands.next() retires entries its
            # live() callback disowns, so lying about liveness to skip a
            # pod would corrupt the band's tenant counts (pod loss).
            return None
        return info

    _order_pop = _order_peek  # consumption happens in _consume_active

    def _consume_active(self, info: QueuedPodInfo,
                        now: float | None = None) -> None:
        if id(info) in self._active_ids:
            # leaving the active set by ANY route (pop, batch gather,
            # removal): keep the band's tenant counts truthful — the
            # info's heap entry retires lazily via the stint check
            self._bands.discard(self._prio_fn(info),
                                self._tenant_fn(info.pod))
        super()._consume_active(info, now)

    def _active_infos(self):
        seen = self._active_ids
        for band in self._bands._bands.values():
            for theap in band.tenants.values():
                for _, stint, info in theap:
                    if seen.get(id(info)) == stint:
                        yield info

    def drf_stats(self) -> dict:
        return {"at_pop_reads": self.drf_at_pop_reads,
                "bands": {p: dict(t) for p, t in
                          self._bands.live_tenants().items()}}
