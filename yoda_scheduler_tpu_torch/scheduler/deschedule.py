"""Descheduler: slice defragmentation by evict-and-reschedule.

No counterpart in the reference (it only ever places; fragmentation
accumulates until operators intervene). On TPU clusters fragmentation is
the dominant waste: one stray single-chip pod on a multi-host pod-slice
blocks every whole-slice gang, and scattered free chips on a board block
`tpu/topology` block requests even when the free count is sufficient.
This is the k8s-descheduler pattern (strategy passes that pick victims,
evict, and let the scheduler re-place them) specialised to ICI topology.

Strategies, in order:

1. **Slice conservation**: a multi-host slice hosting only a few small
   non-gang pods is a blocked gang target; if those pods fit on a
   STANDALONE node, evict them (slice hosts are never destinations —
   that would just relocate the fragmentation).
2. **Intra-node compaction**: a node whose largest placeable block is
   smaller than what its free count could form, where evicting a small
   resident pod would actually enlarge that block.
3. **Torus reassembly** (torusPlacement knob only): when no standalone
   destination exists, a stray that is the SOLE resident of a slice host
   migrates to an already-dented host of the SAME slice — the move
   strictly increases the slice's count of WHOLE (fully-free) hosts, so
   repeated passes reassemble contiguous host blocks for gang carves
   instead of bailing the moment standalone capacity is gone. The
   monotone whole-host gate (victim's eviction makes its host whole;
   destination is dented and stays dented) is what makes the strategy
   terminate instead of shuffling strays around the torus forever.

Safety rails, k8s-descheduler-style: never touch gang members, pods at
or above `protect_priority`, or other profiles' pods; never evict more
than `max_evictions_per_pass`; only evict what provably fits somewhere
else RIGHT NOW (a dry-run through the live filter path, accounting chips
already promised to earlier victims of the same plan); and a per-pod
cooldown so a victim the scheduler places back into an equivalent spot
is not churned every pass — a descheduler that strands or thrashes pods
is worse than fragmentation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .core import Scheduler
from .plugins.allocator import _node_shape
from ..topology.torus import best_fit_block
from ..utils.labels import LabelError, spec_for
from ..utils.pod import Pod


@dataclass
class DeschedulePlan:
    """What a pass would do: victims + the reasons, for operators/tests.
    `strategies` attributes each victim to the strategy that picked it
    ("slice-conservation" | "compaction") — the defrag controller's
    defrag_evictions_total{strategy} label reads it. `destinations`
    (pod.key -> node) is the MIGRATION PLAN: the standalone node the
    dry-run proved accepts the victim; run_once nominates the victim
    onto it so its re-placement cycle lands there instead of re-scoring
    the cluster — without the pin, the freed hole scores at least as
    well as anywhere else and the victim bounces straight back into it,
    churning forever while the pod the migration was FOR never fits."""
    victims: list[Pod] = field(default_factory=list)
    reasons: dict[str, str] = field(default_factory=dict)  # pod.key -> why
    strategies: dict[str, str] = field(default_factory=dict)
    destinations: dict[str, str] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.victims)


def movable(pod: Pod, sched, protect_priority: int) -> bool:
    """THE eviction-safety predicate for optional (non-preemption)
    moves — shared by the descheduler's strategies and the capacity
    provisioner's scale-down drains, so a new protection rule added
    here applies to both."""
    if pod.terminating:
        return False  # already draining; nothing to gain by re-evicting
    if pod.scheduler_name != sched.config.scheduler_name:
        # another profile's pod: evicting it here would strand it
        # (our submit() rejects foreign schedulerNames)
        return False
    if not getattr(sched.cluster, "supports_local_requeue", False) \
            and not pod.has_controller:
        # on a real cluster evict() is a permanent API DELETE; a bare
        # (controllerless) pod would be destroyed, not rescheduled —
        # upstream k8s-descheduler refuses ownerless victims the same way
        return False
    try:
        spec = spec_for(pod)
    except LabelError:
        return False
    if spec.is_gang:
        return False  # moving one member breaks the gang
    if spec.priority >= protect_priority:
        return False
    return True


class Descheduler:
    def __init__(self, sched: Scheduler,
                 protect_priority: int = 5,
                 max_evictions_per_pass: int = 4,
                 cooldown_s: float = 300.0) -> None:
        self.sched = sched
        self.protect_priority = protect_priority
        self.max_evictions = max_evictions_per_pass
        self.cooldown_s = cooldown_s
        self._recent: dict[str, float] = {}  # pod.key -> last eviction time
        # rotating collection offset: successive bounded passes start
        # their node walk at different positions (see plan's work cap)
        self._scan_start = 0

    # ------------------------------------------------------------------ plan
    def plan(self) -> DeschedulePlan:
        from ..utils.pdb import DisruptionLedger

        plan = DeschedulePlan()
        snapshot = self.sched.snapshot()
        # destination capacity pre-scan: one walk over the non-slice
        # nodes (free counts ride the allocator's per-node cache). A
        # saturated cluster — the common steady state once a drain
        # consumed everything — has nowhere to migrate anything, and
        # bailing here keeps the closed defrag loop's no-op passes
        # O(nodes) cheap instead of paying candidate collection plus
        # dry-run filter fan-outs for nothing.
        dest_free: dict[str, int] = {}
        for ni in snapshot.list():
            dm = ni.metrics
            if dm is None or (dm.slice_id and dm.num_hosts > 1):
                continue
            f = len(self.sched.allocator.free_coords(ni))
            if f > 0:
                dest_free[ni.name] = f
        # torus-reassembly destinations (knob only): DENTED same-slice
        # hosts — partially occupied, some room. Whole hosts are never
        # destinations (stacking a stray onto one would DECREASE the
        # slice's whole-host count, the opposite of reassembly).
        torus = bool(getattr(self.sched.config, "torus_placement", False))
        slice_dest: dict[str, tuple[str, int]] = {}
        if torus:
            for ni in snapshot.list():
                dm = ni.metrics
                if dm is None or not (dm.slice_id and dm.num_hosts > 1):
                    continue
                f = len(self.sched.allocator.free_coords(ni))
                if 0 < f < dm.chip_count:
                    slice_dest[ni.name] = (dm.slice_id, f)
        if not dest_free and not slice_dest:
            return plan
        # per-plan destination memo: victims sharing a scheduling class
        # (the engine's memo key: spec + selectors + namespace) share one
        # dry-run filter fan-out instead of paying O(nodes) each — the
        # 1-chip strays a fragmented fleet accumulates are all one class
        dest_cache: dict = {}
        # Defrag moves are OPTIONAL work: unlike preemption (which may
        # violate a budget when nothing else places the pod), a move that
        # would breach a PodDisruptionBudget is simply not worth making —
        # hard veto, upstream-descheduler semantics. The ledger is consumed
        # as the plan grows so a pass can't spend one budget twice.
        budgets = getattr(snapshot, "budgets", ())
        ledger = DisruptionLedger(
            budgets,
            [p for ni in snapshot.list() for p in ni.pods] if budgets else ())
        # (pod, node, reason, strategy): compaction (strategy-2) benefit
        # is computed against the node's CURRENT free set, so at most one
        # defrag victim per node per pass — the first eviction may already
        # deliver the enlarged block a second candidate was credited with
        candidates: list[tuple[Pod, str, str, str]] = []
        # per-pass work bound: collection stops once the pool is 8x the
        # eviction budget — a 5k-node fleet mid-drain has thousands of
        # movable strays, and walking every one's block math per pass
        # would make the closed loop's tick cost O(cluster * strays)
        # (the rotating start keeps later passes looking at different
        # nodes, so bounded collection still covers the fleet over time)
        cap = 8 * self.max_evictions
        nodes_in_order = snapshot.list()
        start = self._scan_start % max(len(nodes_in_order), 1)
        self._scan_start += 1
        for ni in (nodes_in_order[start:] + nodes_in_order[:start]):
            if len(candidates) >= cap:
                break
            m = ni.metrics
            if m is None or m.accelerator != "tpu":
                continue
            movable = [p for p in ni.pods if self._movable(p)]
            if not movable:
                continue
            if m.slice_id and m.num_hosts > 1:
                # strategy 1: small non-gang pods denting a multi-host slice
                for p in movable:
                    candidates.append(
                        (p, ni.name,
                         f"frees gang slice {m.slice_id} ({m.num_hosts} hosts)",
                         "slice-conservation"))
                # strategy 3 (torusPlacement): the stray is this host's
                # sole resident AND its eviction makes the host WHOLE
                # (every chip free and healthy) — candidate for an
                # intra-slice move onto an already-dented host. Ordered
                # AFTER the standalone candidate for the same pod: moving
                # the fragmentation off the slice entirely is always
                # preferred, the intra-slice move is the fallback when
                # standalone capacity is gone.
                if torus:
                    residents = [q for q in ni.pods if not q.terminating]
                    if len(residents) == 1 and residents[0] in movable:
                        p = residents[0]
                        free = self.sched.allocator.free_coords(ni)
                        if len(free | p.assigned_chips()) == m.chip_count:
                            candidates.append(
                                (p, ni.name,
                                 f"torus reassembly: sole resident off "
                                 f"{ni.name} makes a whole host on slice "
                                 f"{m.slice_id}",
                                 "torus-reassembly"))
            else:
                # strategy 2: scattered free chips on a standalone node —
                # fragmented iff the largest placeable block is smaller
                # than what len(free) chips COULD form within this node's
                # shape (3 free chips on a 2x2 board are already maximally
                # contiguous: no volume-3 box fits, so nothing to gain),
                # AND evicting the specific pod would actually enlarge the
                # block (a hole caused by a protected neighbour is not this
                # pod's fault — evicting around it churns for no benefit)
                free = self.sched.allocator.free_coords(ni)
                if len(free) < 2:
                    continue
                shape = _node_shape(m)
                achievable = _max_achievable_block(shape, len(free))
                current = _largest_placeable_block(shape, free, achievable)
                if current >= achievable:
                    continue
                for p in movable:
                    chips = p.assigned_chips()
                    union = free | chips
                    better = _largest_placeable_block(
                        shape, union,
                        _max_achievable_block(shape, len(union)))
                    own = _largest_placeable_block(
                        shape, chips, _max_achievable_block(shape, len(chips)))
                    # genuine defragmentation only: the enlarged block must
                    # beat both the current free block AND what the pod's
                    # own chips form by themselves (a contiguous pod's spot
                    # reverting to free is relocation, not compaction)
                    if better <= max(current, own):
                        continue
                    candidates.append(
                        (p, ni.name,
                         f"defragments {ni.name}: largest free block "
                         f"{current} -> {better} after eviction",
                         "compaction"))
        # round-robin the candidates ACROSS nodes: node-major order spends
        # the whole eviction budget denting ONE host deep while its
        # neighbours keep their strays — one victim per host per round
        # frees a pair (or a whole host) on the most nodes per pass,
        # which is what both consumers want (2-chip capacity recovery
        # and gang-slice reassembly both count freed HOSTS, not freed
        # chips on one host)
        by_node: dict[str, list] = {}
        for cand in candidates:
            by_node.setdefault(cand[1], []).append(cand)
        interleaved: list[tuple[Pod, str, str, bool]] = []
        rounds = max((len(v) for v in by_node.values()), default=0)
        for r in range(rounds):
            for node_cands in by_node.values():
                if r < len(node_cands):
                    interleaved.append(node_cands[r])
        candidates = interleaved
        # chips already promised to earlier victims of THIS plan, per
        # destination — two victims must not be "proven" to fit in the
        # same free slot
        planned: dict[str, int] = {}
        defrag_done: set[str] = set()  # nodes with a planned defrag victim
        picked: set[str] = set()  # a pod may appear under two strategies
        now = self.sched.clock.time()
        for pod, node, reason, strategy in candidates:
            if len(plan.victims) >= self.max_evictions:
                break
            if pod.key in picked:
                continue  # already a victim under an earlier strategy
            if strategy == "compaction" and node in defrag_done:
                continue  # benefit already claimed by this pass's eviction
            if now - self._recent.get(pod.key, -1e18) < self.cooldown_s:
                continue  # recently moved; don't thrash the workload
            if ledger.would_violate(pod):
                continue  # optional move never breaches a disruption budget
            if strategy == "torus-reassembly":
                dest = self._torus_dest(pod, node, snapshot, planned,
                                        slice_dest)
            else:
                dest = self._fits_elsewhere(pod, node, snapshot, planned,
                                            dest_free, dest_cache)
            if dest is not None:
                if strategy == "compaction":
                    defrag_done.add(node)
                picked.add(pod.key)
                try:
                    planned[dest] = planned.get(dest, 0) + spec_for(pod).chips
                except LabelError:  # _movable already parsed it
                    pass
                plan.victims.append(pod)
                plan.reasons[pod.key] = reason
                plan.strategies[pod.key] = strategy
                plan.destinations[pod.key] = dest
                ledger.consume([pod])
        return plan

    def _movable(self, pod: Pod) -> bool:
        return movable(pod, self.sched, self.protect_priority)

    def _torus_dest(self, pod: Pod, current_node: str, snapshot,
                    planned: dict[str, int],
                    slice_dest: dict[str, tuple[str, int]]) -> str | None:
        """Intra-slice destination for a torus-reassembly victim: a
        DENTED host of the SAME slice with room (net of chips promised
        to earlier victims), validated through the live filter path like
        _fits_elsewhere. Destinations fill in HOST-COORDINATE order (low
        corner of the torus grid first): which hosts receive strays is
        which hosts END UP dented, so compacting the dented set into one
        corner is what leaves the reassembled whole hosts as a single
        carvable block instead of a scatter that strands the very gang
        the reassembly is for."""
        try:
            spec = spec_for(pod)
        except LabelError:
            return None
        src = snapshot.get(current_node)
        sid = (src.metrics.slice_id
               if src is not None and src.metrics is not None else None)
        if not sid:
            return None
        from .carve import slice_grid, slice_host_coord
        from .framework import CycleState

        def _corner_key(name: str):
            ni = snapshot.get(name)
            m = ni.metrics if ni is not None else None
            if m is not None:
                gw = slice_grid(m)
                if gw is not None:
                    x, y, z = slice_host_coord(m, gw[0])
                    return (0, z, y, x, name)
            return (1, 0, 0, 0, name)  # no coherent geometry: after all

        state = CycleState()
        state.write("now", self.sched.clock.time())
        state.write("snapshot", snapshot)
        state.write("workload_spec", spec)
        for name, (dsid, f) in sorted(slice_dest.items(),
                                      key=lambda kv: _corner_key(kv[0])):
            if name == current_node or dsid != sid:
                continue
            if f - planned.get(name, 0) < spec.chips:
                continue
            ni = snapshot.get(name)
            if ni is None:
                continue
            if all(fl.filter(state, pod, ni).ok
                   for fl in self.sched.profile.filter):
                return name
        return None

    def _fits_elsewhere(self, pod: Pod, current_node: str, snapshot,
                        planned: dict[str, int],
                        dest_free: dict[str, int],
                        dest_cache: dict) -> str | None:
        """Dry-run the live filter path: returns the name of a STANDALONE
        node that accepts the pod as things stand (not counting space the
        eviction itself frees, and not counting chips already promised to
        earlier victims of this plan via `planned`). Multi-host slice
        hosts are not destinations — moving a stray from one gang slice to
        another (or around the same slice) just relocates the
        fragmentation. The filter fan-out is memoised per scheduling
        class for this plan (`dest_cache`; the snapshot is frozen, so
        same-class verdicts are verbatim repeats), while the
        planned-chips bookkeeping stays per victim."""
        try:
            spec = spec_for(pod)
        except LabelError:
            return None
        # _memo_key_of omits hostPorts, so two same-class victims with
        # different port claims would wrongly share a verdict — such pods
        # dry-run uncached (same exclusion the batcher applies). And the
        # anti-affinity SYMMETRY rule makes a bound pod's selector read
        # ARBITRARY victim labels the class key cannot see, so no verdict
        # is shareable while any bound pod carries anti-affinity (the
        # engine gates its unsched/feasible memos identically). The
        # victim's OWN topology constraints are location-relative too:
        # two same-class victims bound in different zones satisfy a
        # required affinity term (or a spread skew) near DIFFERENT
        # nodes, so their destination orders must not be shared — the
        # same pods the engine's feas_ok sends to the full scan.
        cacheable = (not getattr(pod, "host_ports", None)
                     and not pod.topology_spread
                     and not pod.pod_affinity
                     and not pod.pod_anti_affinity
                     and not snapshot.any_pod_anti_affinity())
        key = Scheduler._memo_key_of(pod, spec) if cacheable else None
        order = dest_cache.get(key) if cacheable else None
        if order is None:
            from .framework import CycleState

            state = CycleState()
            state.write("now", self.sched.clock.time())
            # the live filter path reads the snapshot for inter-pod
            # affinity; omitting it would silently skip those checks in
            # the dry-run and evict a pod the real cycle then refuses to
            # place
            state.write("snapshot", snapshot)
            state.write("workload_spec", spec)
            order = []
            for ni in snapshot.list():
                if ni.name not in dest_free:
                    continue  # slice host, or nothing free
                ok = True
                for f in self.sched.profile.filter:
                    if not f.filter(state, pod, ni).ok:
                        ok = False
                        break
                if ok:
                    order.append(ni.name)
            if cacheable:
                dest_cache[key] = order
        for name in order:
            if name == current_node:
                continue
            if dest_free[name] - planned.get(name, 0) >= spec.chips:
                return name
        return None

    # --------------------------------------------------------------- execute
    def run_once(self) -> DeschedulePlan:
        """Plan, evict, resubmit. Returns the executed plan. Evicted pods
        re-enter the scheduling queue and re-place through the normal cycle
        (chips label cleared by evict)."""
        plan = self.plan()
        now = self.sched.clock.time()
        # resubmit locally only where eviction does NOT destroy the pod
        # object's identity: on FakeCluster an evicted pod is simply
        # unbound. On a real API server, evict() is a DELETE — the
        # controller recreates the pod as a NEW incarnation which the serve
        # poll loop submits; locally requeueing the dead incarnation would
        # race it (and bind a pod that no longer exists).
        local = getattr(self.sched.cluster, "supports_local_requeue", False)
        for pod in plan.victims:
            self.sched.cluster.evict(pod)
            self.sched.metrics.inc("pods_descheduled_total")
            self._recent[pod.key] = now
            if local:
                # enforce the migration plan: nominate the victim onto
                # the destination the dry-run proved (its next cycle
                # evaluates that node FIRST and the hold keeps the spot),
                # and resubmit on THIS engine — the nomination lives in
                # this engine's allocator, so a fleet's shard routing
                # must not carry the pod to a replica that cannot see it
                dest = plan.destinations.get(pod.key)
                if dest is not None and self.sched.allocator is not None:
                    try:
                        spec = spec_for(pod)
                        self.sched.allocator.nominate(
                            pod.key, dest, spec.chips, spec.priority,
                            cpu_millis=pod.cpu_millis,
                            memory_bytes=pod.memory_bytes,
                            host_ports=pod.host_ports)
                    except LabelError:
                        pass
                if not self.sched.submit(pod):
                    self.sched.metrics.inc("deschedule_requeue_failed_total")
        if self._recent and len(self._recent) > 10_000:
            cutoff = now - self.cooldown_s
            self._recent = {k: t for k, t in self._recent.items()
                            if t >= cutoff}
        return plan


def _max_achievable_block(shape: tuple[int, int, int], n: int) -> int:
    """Largest rectangular-box volume <= n that fits within `shape` — the
    contiguity ceiling n free chips could reach on this node."""
    best = 0
    sx, sy, sz = shape
    for bx in range(1, sx + 1):
        for by in range(1, sy + 1):
            for bz in range(1, sz + 1):
                v = bx * by * bz
                if v <= n and v > best:
                    best = v
    return best


def _largest_placeable_block(shape, free, upper: int) -> int:
    """Largest box volume actually placeable in `free`, searching down from
    `upper` (0 if even a single chip cannot be placed)."""
    for k in range(upper, 0, -1):
        if best_fit_block(shape, free, k) is not None:
            return k
    return 0
