"""Chip allocation ledger (Reserve plugin).

No counterpart in the reference: it filters/scores on card counts but never
decides *which* cards a pod gets — that was left to the GPU device plugin.
On TPU, which chips matters (ICI contiguity), so the scheduler assigns
concrete chip coordinates at Reserve time, the binder publishes them on the
pod (``tpu/assigned-chips``), and pending reservations are visible to
subsequent cycles so gang members accumulating on a slice cannot
double-claim chips.
"""

from __future__ import annotations

import threading

from ..framework import (
    CycleState,
    EnqueueExtensions,
    NODE_ADDED,
    NODE_TELEMETRY_UPDATED,
    NodeInfo,
    POD_DELETED,
    QUEUE,
    ReservePlugin,
    Status,
)
from ...telemetry.schema import TpuNodeMetrics
from ...utils.changelog import ChangeLog
from ...topology.torus import Coord, best_fit_block, fits_shape, parse_topology
from ...utils.labels import WorkloadSpec
from ...utils.pod import Pod


class ClassStats:
    """Aggregates over one node's QUALIFYING chips — healthy, unclaimed,
    and meeting a workload class's (min free HBM, min clock). Computed once
    per (node state, class) instead of once per (pod, node) by each of
    Filter / PreScore / Score: bursts are dominated by pods sharing a few
    label classes, and a bind changes ONE node, so nearly every per-chip
    scan a cycle would do is a repeat of the previous cycle's.

    maxima/sums attribute order: (ici_bandwidth_gbps, clock_mhz, core_count,
    hbm_free_mb, power_w, hbm_total_mb). duty_sum is the qualifying chips'
    summed measured MXU duty cycle (utilisation-aware scoring)."""

    __slots__ = ("count", "qcoords", "maxima", "sums", "duty_sum")

    def __init__(self, count: int, qcoords: frozenset,
                 maxima: tuple, sums: tuple, duty_sum: float = 0.0) -> None:
        self.count = count
        self.qcoords = qcoords
        self.maxima = maxima
        self.sums = sums
        self.duty_sum = duty_sum


_ZERO6 = (0, 0, 0, 0, 0, 0)


class ChipAllocator(ReservePlugin, EnqueueExtensions):
    name = "chip-allocator"

    # Reserve rejections ("reserve: no qualifying chips...") are rare
    # races against a concurrent claim; anything that returns or adds
    # capacity can cure them. Rare enough that a blanket QUEUE cannot
    # thundering-herd.
    def events_to_register(self) -> tuple:
        return (POD_DELETED, NODE_ADDED, NODE_TELEMETRY_UPDATED)

    def queueing_hint(self, event, pod) -> str:
        return QUEUE

    def equivalence_key(self, pod):
        """Batch-cycle contract: chip picking is a pure function of the
        WorkloadSpec and live node/ledger state, so classmates are
        interchangeable. Nominated-capacity holds ARE pod-specific, but
        the engine disables batching outright while any hold exists
        (core.run_one), and the batch commit loop drives Reserve/complete
        through the ordinary ledger hooks — every claim lands in the
        change log exactly as a per-pod cycle's would."""
        return ()

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._pending: dict[str, tuple[str, list[Coord]]] = {}  # pod.key -> (node, coords)
        # per-node free-set cache, keyed by (NodeInfo.serial, pending
        # version): NodeInfos persist across cycles while a node is
        # untouched (core.snapshot), so the free set does too; any
        # reserve/unreserve/complete on the node bumps its version. A few
        # slots per node, because co-hosted profiles (multi.py) share this
        # allocator but hold distinct NodeInfos (distinct serials) for the
        # same node — one slot would thrash between engines.
        self._pending_ver: dict[str, int] = {}
        self._free_cache: dict[str, dict[tuple[int, int], set[Coord]]] = {}
        self._free_cache_slots = 4
        # per-node ClassStats cache, keyed by (NodeInfo serial, pending
        # version, min_free_mb, min_clock_mhz) — a few slots per node since
        # a burst usually carries a handful of label classes
        self._class_cache: dict[str, dict[tuple, ClassStats]] = {}
        self._class_cache_slots = 8
        # contiguity-score memo (TopologyScore's per-(pod, node) term is a
        # block search — the single most expensive scoring computation at
        # 1000-node scale), keyed by (serial, pending version, k)
        self._contig_cache: dict[str, dict[tuple, float]] = {}
        # nominated capacity claims (upstream nominatedNodeName semantics):
        # a successful preemption entitles the preemptor to the freed chips
        # on its nominated node until it binds or fails permanently. Claims
        # are counts, not coords — the victims' exact chips return to the
        # free pool, but pods of lower-or-equal priority must not consume
        # them first (or co-hosted profiles rebind victims into the hole
        # and the preemptor livelocks).
        self._nominated: dict[str, tuple] = {}  # pod.key -> (node, chips, priority, cpu_millis, memory_bytes, host_ports)
        # gang-level nominations: a gang that preempted is entitled to
        # `chips_per_host` on EVERY host of its chosen slice until it
        # completes, fails, or the entitlement expires — victims free
        # capacity on several hosts at once and single-pod holds can't
        # cover hosts whose member hasn't cycled yet.
        # gang -> (slice_id, chips_per_host, priority, expires_at)
        self._gang_nominated: dict[str, tuple] = {}  # gang -> (slice, chips/host, prio, expiry, cpu/host, mem/host)
        # change log over reservations + nominations: version is the
        # global counter the engine's unschedulable-class memo keys on;
        # the per-key attribution feeds the per-class feasible-list cache
        # (core.py) — "*" marks a change whose node set is not knowable
        # here (gang slice entitlements span hosts), forcing a full
        # re-filter
        self._changes = ChangeLog()

    @property
    def version(self) -> int:
        return self._changes.version

    def changes_since(self, version: int):
        return self._changes.changes_since(version)

    def changes_since_directed(self, version: int):
        return self._changes.changes_since_directed(version)

    def _bump(self, node: str, grew: bool = True) -> None:
        # grew=False marks capacity-consuming changes (a fresh claim, a
        # reservation confirmed into a bind): repair paths then skip
        # hunting the node for NEW feasibility (changelog docstring)
        self._pending_ver[node] = self._pending_ver.get(node, 0) + 1
        self._changes.record(node, grew=grew)

    def forget_nodes(self, gone: set[str]) -> None:
        """Drop cached per-node state for nodes that left the cluster
        (called by the scheduler's snapshot prune; without it, node churn
        grows the caches without bound)."""
        with self._lock:
            for n in gone:
                self._free_cache.pop(n, None)
                self._class_cache.pop(n, None)
                self._contig_cache.pop(n, None)
                self._pending_ver.pop(n, None)

    # ----------------------------------------------------------------- views
    def pending_on(self, node: str) -> set[Coord]:
        with self._lock:
            return {c for n, coords in self._pending.values() if n == node for c in coords}

    def pending_chip_count(self, node: str) -> int:
        return len(self.pending_on(node))

    def pending_version(self, node: str) -> int:
        """Per-node reservation version — cache-key component for anything
        derived from free_coords (which subtracts pending reservations, a
        dimension NodeInfo.serial does not see)."""
        return self._pending_ver.get(node, 0)

    def free_coords(self, node_info: NodeInfo) -> set[Coord]:
        """Healthy chips not claimed by bound pods nor pending reservations.

        Memoised across cycles: the key pairs the NodeInfo's serial (a new
        serial appears whenever telemetry or the bound-pod set changed) with
        this allocator's per-node pending version. Every plugin asks for the
        same node's free set several times per cycle, and most nodes are
        untouched between cycles."""
        # lock-free read path: slot dicts are only ever replaced/extended
        # under the lock, and single dict reads are GIL-atomic; a stale
        # miss just recomputes
        key = (node_info.serial, self._pending_ver.get(node_info.name, 0))
        slot = self._free_cache.get(node_info.name)
        if slot is not None:
            hit = slot.get(key)
            if hit is not None:
                return hit
        m = node_info.metrics
        if m is None:
            return set()
        free = (m.healthy_coords() - node_info.assigned_coords()
                - self.pending_on(node_info.name))
        with self._lock:
            slot = self._free_cache.setdefault(node_info.name, {})
            slot[key] = free
            while len(slot) > self._free_cache_slots:
                slot.pop(next(iter(slot)))  # evict oldest (insertion order)
        return free

    def assignment_of(self, pod: Pod) -> tuple[str, list[Coord]] | None:
        with self._lock:
            return self._pending.get(pod.key)

    def pending_node_of(self, pod_key: str) -> str | None:
        """Node a pending reservation (by key) sits on, if any."""
        with self._lock:
            entry = self._pending.get(pod_key)
            return entry[0] if entry else None

    def class_stats(self, node_info: NodeInfo, min_free_mb: int,
                    min_clock_mhz: int) -> ClassStats:
        """Qualifying-chip aggregates for one workload class on one node,
        memoised while the node's telemetry, bound pods, and pending
        reservations are unchanged (see ClassStats)."""
        name = node_info.name
        key = (node_info.serial, self._pending_ver.get(name, 0),
               min_free_mb, min_clock_mhz)
        # lock-free read path (see free_coords)
        slot = self._class_cache.get(name)
        if slot is not None:
            hit = slot.get(key)
            if hit is not None:
                return hit
        m = node_info.metrics
        if m is None:
            stats = ClassStats(0, frozenset(), _ZERO6, _ZERO6)
        else:
            free = self.free_coords(node_info)
            qcoords = set()
            mbw = mck = mco = mfm = mpw = mtm = 0
            sbw = sck = sco = sfm = spw = stm = 0
            duty = 0.0
            for c in m.healthy_chips():
                if (c.coords in free and c.hbm_free_mb >= min_free_mb
                        and c.clock_mhz >= min_clock_mhz):
                    qcoords.add(c.coords)
                    bw, ck, co, fm, pw, tm = (
                        c.ici_bandwidth_gbps, c.clock_mhz, c.core_count,
                        c.hbm_free_mb, c.power_w, c.hbm_total_mb)
                    if bw > mbw: mbw = bw
                    if ck > mck: mck = ck
                    if co > mco: mco = co
                    if fm > mfm: mfm = fm
                    if pw > mpw: mpw = pw
                    if tm > mtm: mtm = tm
                    sbw += bw; sck += ck; sco += co
                    sfm += fm; spw += pw; stm += tm
                    duty += c.duty_cycle_pct
            stats = ClassStats(len(qcoords), frozenset(qcoords),
                               (mbw, mck, mco, mfm, mpw, mtm),
                               (sbw, sck, sco, sfm, spw, stm), duty)
        with self._lock:
            slot = self._class_cache.setdefault(name, {})
            slot[key] = stats
            while len(slot) > self._class_cache_slots:
                slot.pop(next(iter(slot)))  # evict oldest (insertion order)
        return stats

    def contiguity(self, node_info: NodeInfo, k: int) -> float:
        """Memoised torus.contiguity_score over the node's free set (see
        _contig_cache)."""
        from ...topology.torus import contiguity_score

        name = node_info.name
        key = (node_info.serial, self._pending_ver.get(name, 0), k)
        slot = self._contig_cache.get(name)  # lock-free read (free_coords)
        if slot is not None:
            hit = slot.get(key)
            if hit is not None:
                return hit
        m = node_info.metrics
        if m is None:
            return 0.0
        free = self.free_coords(node_info)
        score = contiguity_score(_node_shape(m), free, min(k, len(free)))
        with self._lock:
            slot = self._contig_cache.setdefault(name, {})
            slot[key] = score
            while len(slot) > self._class_cache_slots:
                slot.pop(next(iter(slot)))
        return score

    # ---------------------------------------------------------- nominations
    def nominate(self, pod_key: str, node: str, chips: int, priority: int,
                 cpu_millis: int = 0, memory_bytes: int = 0,
                 host_ports: tuple = ()) -> None:
        with self._lock:
            self._nominated[pod_key] = (node, chips, priority,
                                        cpu_millis, memory_bytes,
                                        host_ports)
            self._changes.record(node, grew=False)  # a hold only consumes

    def unnominate(self, pod_key: str) -> None:
        with self._lock:
            nom = self._nominated.pop(pod_key, None)
            if nom is not None:
                self._changes.record(nom[0])

    def has_pod_nominations(self) -> bool:
        """GIL-atomic emptiness read of the per-pod nomination book — a
        hot-path guard before the locked nomination_of (the doomed-retry
        tail asks once per failed cycle, almost always against an empty
        book)."""
        return bool(self._nominated)

    def nomination_of(self, pod_key: str) -> tuple | None:
        """(node, chips, priority, cpu_millis, memory_bytes, host_ports)
        this pod is entitled to, if any."""
        if not self._nominated:
            return None  # fast path: checked every cycle (GIL-atomic read)
        with self._lock:
            return self._nominated.get(pod_key)

    def nominate_gang(self, gang: str, slice_id: str, chips_per_host: int,
                      priority: int, expires_at: float,
                      cpu_millis: int = 0, memory_bytes: int = 0) -> None:
        """cpu_millis/memory_bytes are PER HOST (one gang member each)."""
        with self._lock:
            self._gang_nominated[gang] = (slice_id, chips_per_host, priority,
                                          expires_at, cpu_millis,
                                          memory_bytes)
            self._changes.record("*")

    def unnominate_gang(self, gang: str) -> None:
        with self._lock:
            if self._gang_nominated.pop(gang, None) is not None:
                self._changes.record("*")

    def gang_nomination_of(self, gang: str) -> tuple[str, int, int, float] | None:
        with self._lock:
            return self._gang_nominated.get(gang)

    def gang_hold(self, slice_id: str, priority: int,
                  exclude_gang: str | None = None,
                  now: float | None = None) -> int:
        """Chips per host on `slice_id` held for nominated gangs that
        outrank (or tie) `priority`. Expired entitlements are pruned lazily
        (a gang that never completed must not block the slice forever).
        Held on every host of the slice — coarser than the gang strictly
        needs when the slice has more hosts than the gang, by design:
        which hosts the members land on is decided at Reserve time."""
        if not self._gang_nominated:
            return 0  # fast path (GIL-atomic read)
        with self._lock:
            hold = 0
            for gang, nom in list(self._gang_nominated.items()):
                sid, chips, prio, exp = nom[:4]
                if now is not None and exp < now:
                    del self._gang_nominated[gang]
                    self._changes.record("*")
                    continue
                if sid == slice_id and prio >= priority and gang != exclude_gang:
                    hold += chips
            return hold

    def gang_cpu_mem_hold(self, slice_id: str, priority: int,
                          exclude_gang: str | None = None,
                          now: float | None = None) -> tuple[int, int]:
        """(cpu millicores, memory bytes) PER HOST held on `slice_id` for
        nominated gangs that outrank (or tie) `priority` — the cpu/mem
        twin of gang_hold, with the same lazy expiry pruning (a gang that
        never completed must not poison the slice's cpu accounting)."""
        if not self._gang_nominated:
            return 0, 0
        with self._lock:
            cpu = mem = 0
            for gang, nom in list(self._gang_nominated.items()):
                if now is not None and nom[3] < now:
                    del self._gang_nominated[gang]
                    self._changes.record("*")
                    continue
                if (nom[0] == slice_id and nom[2] >= priority
                        and gang != exclude_gang):
                    cpu += nom[4]
                    mem += nom[5]
            return cpu, mem

    def nominated_hold(self, node: str, priority: int,
                       exclude_key: str | None = None) -> int:
        """Chips on `node` held for nominated preemptors that outrank (or
        tie) `priority` — capacity the asking pod must treat as taken. A
        pod never blocks on its own nomination."""
        if not self._nominated:
            return 0  # fast path: nominations are rare (GIL-atomic read)
        with self._lock:
            return sum(
                nom[1] for key, nom in self._nominated.items()
                if nom[0] == node and nom[2] >= priority
                and key != exclude_key
            )

    def nominated_cpu_mem(self, node: str, priority: int,
                          exclude_key: str | None = None) -> tuple[int, int]:
        """(cpu millicores, memory bytes) on `node` held for nominated
        preemptors that outrank (or tie) `priority` — the cpu/mem twin of
        nominated_hold, so a third pod cannot steal the resources a
        preemption freed during the victims' drain window."""
        if not self._nominated:
            return 0, 0
        with self._lock:
            cpu = mem = 0
            for key, nom in self._nominated.items():
                if nom[0] == node and nom[2] >= priority \
                        and key != exclude_key:
                    cpu += nom[3]
                    mem += nom[4]
            return cpu, mem

    def nominated_ports(self, node: str, priority: int,
                        exclude_key: str | None = None) -> tuple:
        """hostPort claims on `node` held for nominated preemptors that
        outrank (or tie) `priority` — the ports twin of
        nominated_cpu_mem, so a third pod cannot bind the port a
        preemption freed during the victims' drain window."""
        if not self._nominated:
            return ()
        with self._lock:
            out = []
            for key, nom in self._nominated.items():
                if nom[0] == node and nom[2] >= priority \
                        and key != exclude_key:
                    out.extend(nom[5])
            return tuple(out)

    def has_holds(self) -> bool:
        """Any nominated capacity outstanding (per-pod or gang-slice).
        The columnar filter masks don't model holds — their presence
        sends pods down the scalar path (GIL-atomic dict reads)."""
        return bool(self._nominated or self._gang_nominated)

    def holds_for(self, spec: WorkloadSpec, node_info: NodeInfo,
                  pod_key: str | None, now: float | None = None) -> int:
        """Combined per-node + gang-slice nominated capacity this pod must
        treat as taken on this node."""
        hold = self.nominated_hold(node_info.name, spec.priority, pod_key)
        m = node_info.metrics
        if m is not None and m.slice_id:
            hold += self.gang_hold(m.slice_id, spec.priority,
                                   exclude_gang=spec.gang_name, now=now)
        return hold

    # ------------------------------------------------------------ placement
    def pick_chips(self, spec: WorkloadSpec, node_info: NodeInfo,
                   pod_key: str | None = None,
                   now: float | None = None) -> list[Coord] | None:
        """Choose concrete chips for the spec on this node, best-fit
        contiguous. Falls back to any qualifying chips when the node's free
        space has no contiguous block (still schedulable, just lower quality —
        the topology scorer will have steered away from such nodes)."""
        m = node_info.metrics
        if m is None:
            return None
        stats = self.class_stats(node_info, spec.min_free_mb,
                                 spec.min_clock_mhz)
        qualifying = stats.qcoords
        hold = self.holds_for(spec, node_info, pod_key, now=now)
        if stats.count - hold < spec.chips:
            return None
        shape = _node_shape(m)
        if spec.topology is not None:
            fit = fits_shape(shape, qualifying, parse_topology(spec.topology))
            if fit is None:
                return None
            return sorted(fit[2])
        fit = best_fit_block(shape, qualifying, spec.chips)
        if fit is not None:
            return sorted(fit[2])
        return sorted(qualifying)[: spec.chips]

    # ---------------------------------------------------------- reserve hook
    def reserve(self, state: CycleState, pod: Pod, node: str) -> Status:
        snapshot = state.read_or("snapshot")
        node_info = snapshot.get(node) if snapshot is not None else None
        spec = state.read_or("workload_spec")
        if node_info is None or spec is None:
            return Status.error("allocator: cycle state missing node_info/spec")
        coords = self.pick_chips(spec, node_info, pod_key=pod.key,
                                 now=state.read_or("now"))
        if coords is None:
            return Status.unschedulable(f"{node}: chips vanished before reserve")
        with self._lock:
            self._pending[pod.key] = (node, coords)
            self._bump(node, grew=False)  # a claim only consumes
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node: str) -> None:
        with self._lock:
            entry = self._pending.pop(pod.key, None)
            if entry is not None:
                self._bump(entry[0])

    def complete(self, pod: Pod) -> list[Coord] | None:
        """Called by the binder: consume the reservation."""
        with self._lock:
            entry = self._pending.pop(pod.key, None)
            if entry is not None:
                # the reservation becomes a bound assignment in the same
                # cycle: the node's free set never grows through this
                self._bump(entry[0], grew=False)
        return entry[1] if entry else None

    def finish_bind(self, pod: Pod) -> None:
        """complete() + unnominate() fused under ONE lock round — the
        engine's post-bind pair, called once per bound pod (two separate
        acquisitions were measurable across a 25k-bind drain)."""
        key = pod.key
        with self._lock:
            entry = self._pending.pop(key, None)
            if entry is not None:
                self._bump(entry[0], grew=False)
            nom = self._nominated.pop(key, None)
            if nom is not None:
                self._changes.record(nom[0])


def _node_shape(m: TpuNodeMetrics) -> tuple[int, int, int]:
    """Bounding box of this node's chip coordinates (coords are slice-global,
    so this is the enclosing box; placement search intersects it with the
    node's actual free set)."""
    xs = [c.coords[0] for c in m.chips] or [0]
    ys = [c.coords[1] for c in m.chips] or [0]
    zs = [c.coords[2] for c in m.chips] or [0]
    return (max(xs) + 1, max(ys) + 1, max(zs) + 1)
