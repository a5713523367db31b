"""Gang scheduling: all-or-nothing admission of multi-host pod-slice jobs.

New TPU-native capability (SURVEY §7 "hard part (1)"): a v4-32 Llama job is
one worker pod per host of a 4-host slice; binding 3 of 4 workers deadlocks
the job while holding 12 chips. The k8s framework scores nodes one pod at a
time, so cross-pod state lives in a shared GangCoordinator and admission
goes through Permit:

- first member to Reserve picks the slice (members' Filter then sticks to it)
- every member's Permit returns WAIT until the gang is complete
- the last member's arrival approves all waiting members (bind together)
- timeout or any member's failure rejects the whole gang: all reservations
  roll back, the chosen slice resets, everything requeues with backoff.
"""

from __future__ import annotations

import threading

from ..framework import (
    CANDIDATE_NODES_KEY,
    ClusterEvent,
    CycleState,
    EnqueueExtensions,
    GANG_MEMBER_ARRIVED,
    NO_BATCH,
    NODE_TELEMETRY_UPDATED,
    PermitPlugin,
    POD_DELETED,
    PreFilterPlugin,
    QUEUE,
    ReservePlugin,
    SKIP,
    Status,
)
from ...utils.labels import GANG_NAME_LABEL, WorkloadSpec, spec_for
from ...utils.pod import Pod


def bound_gang_members(state: CycleState, gang: str) -> tuple[set[str], str | None, dict[str, int]]:
    """(pod keys, a slice id, per-slice member counts) of gang members
    ALREADY BOUND in the cluster, from this cycle's snapshot — cluster
    truth, not coordinator state.

    This is what lets a gang survive partial binds: if a peer's bind fails
    after the anchor bound (API outage mid-gang), or the scheduler restarts
    mid-assembly, the coordinator's waiting set is gone but the bound
    members are still visible on their nodes. A retrying member counts them
    toward gang completeness and sticks to their slice(s). Cached per cycle
    in CycleState (one snapshot scan per gang per cycle).

    Caveat: gang names must be unique per job — reusing a name while an
    older gang's pods are still bound would let the new gang 'complete'
    against them."""
    key = "gang_bound:" + gang
    cached = state.read_or(key)
    if cached is not None:
        return cached
    keys: set[str] = set()
    slice_id: str | None = None
    by_slice: dict[str, int] = {}
    snapshot = state.read_or("snapshot")
    if snapshot is not None:
        for ni in snapshot.list():
            for p in ni.pods:
                if (p.labels.get(GANG_NAME_LABEL) == gang
                        and not p.terminating):
                    keys.add(p.key)
                    if ni.metrics is not None and ni.metrics.slice_id:
                        slice_id = ni.metrics.slice_id
                        by_slice[slice_id] = by_slice.get(slice_id, 0) + 1
    result = (keys, slice_id, by_slice)
    state.write(key, result)
    return result


class GangCoordinator:
    """Shared cross-cycle gang state (gang name -> members/slice/plan)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._slice: dict[str, str] = {}          # gang -> chosen slice id
        self._waiting: dict[str, set[str]] = {}   # gang -> waiting pod keys
        # multi-slice placement plan (set when no single slice can host the
        # whole gang): gang -> {slice_id: member quota}; `placed` counts
        # members that RESERVED onto each slice (decremented on unreserve,
        # kept across bind — a bound member still occupies its quota slot)
        self._plan: dict[str, dict[str, int]] = {}
        self._placed: dict[str, dict[str, int]] = {}
        # geometric carve (scheduler/carve.py, torusPlacement knob):
        # gang -> {slice_id: frozenset(host names)} — advisory narrowing
        # for _write_candidates, torn down with the rest of the gang
        # state so a failed assembly re-carves against fresh capacity
        self._carve: dict[str, dict[str, frozenset]] = {}

    def chosen_slice(self, gang: str) -> str | None:
        with self._lock:
            return self._slice.get(gang)

    def choose_slice(self, gang: str, slice_id: str) -> None:
        with self._lock:
            self._slice.setdefault(gang, slice_id)

    # -------------------------------------------------- multi-slice plans
    def set_plan(self, gang: str, plan: dict[str, int],
                 pre_placed: dict[str, int] | None = None) -> None:
        with self._lock:
            self._plan[gang] = dict(plan)
            self._placed[gang] = dict(pre_placed or {})

    def plan_of(self, gang: str) -> dict[str, int] | None:
        with self._lock:
            p = self._plan.get(gang)
            return dict(p) if p is not None else None

    def quota_left(self, gang: str, slice_id: str) -> int | None:
        """Remaining member slots on `slice_id` under the gang's plan;
        None when the gang has no multi-slice plan."""
        with self._lock:
            plan = self._plan.get(gang)
            if plan is None:
                return None
            placed = self._placed.get(gang, {})
            return plan.get(slice_id, 0) - placed.get(slice_id, 0)

    def quotas_left(self, gang: str) -> dict[str, int] | None:
        """All slices' remaining quotas in ONE lock round-trip (the
        per-node narrowing pass would otherwise take the lock O(nodes)
        times per cycle); None when the gang has no plan. Slices absent
        from the dict have no quota (same verdict as quota_left <= 0)."""
        with self._lock:
            plan = self._plan.get(gang)
            if plan is None:
                return None
            placed = self._placed.get(gang, {})
            return {sid: q - placed.get(sid, 0) for sid, q in plan.items()}

    # ------------------------------------------------- geometric carves
    def set_carve(self, gang: str, carve: dict[str, frozenset]) -> None:
        with self._lock:
            self._carve[gang] = dict(carve)

    def carve_of(self, gang: str) -> dict[str, frozenset] | None:
        with self._lock:
            c = self._carve.get(gang)
            return dict(c) if c is not None else None

    def clear_carve(self, gang: str) -> None:
        with self._lock:
            self._carve.pop(gang, None)

    def record_placement(self, gang: str, slice_id: str, delta: int = 1) -> None:
        with self._lock:
            if gang in self._plan:
                placed = self._placed.setdefault(gang, {})
                placed[slice_id] = max(placed.get(slice_id, 0) + delta, 0)

    def add_waiting(self, gang: str, pod_key: str) -> int:
        with self._lock:
            s = self._waiting.setdefault(gang, set())
            s.add(pod_key)
            return len(s)

    def waiting_members(self, gang: str) -> set[str]:
        with self._lock:
            return set(self._waiting.get(gang, set()))

    def reset(self, gang: str) -> set[str]:
        """Tear down gang state; returns the members that were waiting."""
        with self._lock:
            members = self._waiting.pop(gang, set())
            self._slice.pop(gang, None)
            self._plan.pop(gang, None)
            self._placed.pop(gang, None)
            self._carve.pop(gang, None)
            return members


class GangPermit(PermitPlugin, ReservePlugin, PreFilterPlugin,
                 EnqueueExtensions):
    name = "gang-permit"

    # --------------------------------------------------- queueing hints
    def events_to_register(self) -> tuple:
        """A parked gang member becomes schedulable when a sibling
        (re)arrives (assembly can complete / a doomed gang revives), or
        when slice capacity frees up (a departing pod or recovered chips
        can make a big-enough slice appear)."""
        return (GANG_MEMBER_ARRIVED, POD_DELETED, NODE_TELEMETRY_UPDATED)

    def queueing_hint(self, event: ClusterEvent, pod) -> str:
        if event.kind == GANG_MEMBER_ARRIVED:
            # only the arriving member's OWN gang benefits — other gangs'
            # members stay parked (their assembly state is unchanged)
            if event.gang and event.gang == pod.labels.get(GANG_NAME_LABEL):
                return QUEUE
            return SKIP
        return QUEUE  # capacity events: a slice may now fit the gang

    def __init__(self, gangs: GangCoordinator, timeout_s: float = 30.0,
                 allocator=None, elastic=None, carver=None) -> None:
        self.gangs = gangs
        self.timeout_s = timeout_s
        self.allocator = allocator  # ChipAllocator, for multi-slice planning
        # ElasticGangs controller (scheduler/elastic/): None = classic
        # all-or-nothing admission, placements bit-identical
        self.elastic = elastic
        # TorusCarver (scheduler/carve.py): None = classic free-host-count
        # planning, placements bit-identical (the torusPlacement knob)
        self.carver = carver

    def equivalence_key(self, pod):
        """Batch-cycle contract: gang members carry cross-pod assembly
        state (chosen slice, plan quotas, Permit parking) and NEVER batch;
        for everything else this plugin's PreFilter/Reserve/Permit hooks
        are immediate no-op successes."""
        if GANG_NAME_LABEL in pod.labels:
            return NO_BATCH
        return ()

    # PreFilter: when no single slice can host the whole gang, partition it
    # across slices — fewest slices, largest chunks
    # first, which minimises the number of cross-slice DCN hops the job's
    # collectives must take (intra-slice traffic rides ICI; every extra
    # slice adds a DCN boundary).
    def pre_filter(self, state: CycleState, pod: Pod, snapshot) -> Status:
        spec: WorkloadSpec = state.read("workload_spec")
        if not spec.is_gang or self.allocator is None:
            return Status.success()
        self._maybe_carve(state, pod, snapshot, spec)
        st = self._maybe_plan(state, pod, snapshot, spec)
        if not st.ok:
            return st
        cand = self._write_candidates(state, spec, snapshot)
        if not cand:
            # no node can possibly host a member: fail HERE with the
            # narrowing's reason — the engine's scan would otherwise
            # skip every node and report an empty "no feasible node"
            return Status.unschedulable(
                f"gang {spec.gang_name}: no pod-slice node survives "
                "slice narrowing (membership / chosen slice / plan "
                f"quotas / {spec.gang_size} gang-sized slices)")
        return st

    def _maybe_carve(self, state: CycleState, pod: Pod, snapshot,
                     spec: WorkloadSpec) -> None:
        """Geometric narrowing (torusPlacement knob): carve the gang as
        contiguous host blocks before the legacy planner runs. A
        multi-slice carve fixes the plan too (quota accounting rides the
        existing machinery); a single-slice carve leaves slice choice to
        the first Reserve as usual. Skipped once assembly is underway or
        members are already bound — re-forming a partially-bound gang is
        the legacy path's job (its slice is pinned by cluster truth, a
        fresh carve could contradict it)."""
        if self.carver is None:
            return
        gang = spec.gang_name
        if (self.gangs.carve_of(gang) is not None
                or self.gangs.plan_of(gang) is not None
                or self.gangs.chosen_slice(gang) is not None
                or self.gangs.waiting_members(gang)):
            return
        bound, _, _ = bound_gang_members(state, gang)
        if bound:
            return
        carve = self.carver.carve_gang(state, pod, snapshot, spec,
                                       state.read_or("now"),
                                       state.read_or("degraded"))
        if carve is None:
            return
        self.gangs.set_carve(gang, carve)
        if len(carve) > 1:
            self.gangs.set_plan(
                gang, {sid: len(hosts) for sid, hosts in carve.items()})

    def _maybe_plan(self, state: CycleState, pod: Pod, snapshot,
                    spec: WorkloadSpec) -> Status:
        if self.gangs.plan_of(spec.gang_name) is not None:
            return Status.success()  # plan already fixed
        if (self.gangs.chosen_slice(spec.gang_name) is not None
                or self.gangs.waiting_members(spec.gang_name)):
            # single-slice assembly already underway: parked peers' chip
            # reservations make their slice LOOK short of free hosts, so
            # planning now would wrongly split a gang that fits one slice
            # (and pay an O(nodes) scan per member cycle for nothing)
            return Status.success()
        now = state.read_or("now")
        free_hosts: dict[str, int] = {}  # slice -> hosts that fit a member
        for ni in snapshot.list():
            m = ni.metrics
            if m is None or not m.slice_id:
                continue
            if (now is not None and m.stale(now=now)
                    and not state.read_or("degraded")):
                # blackout degraded mode: last-known slice capacity is
                # the best (only) planning input available
                continue
            if spec.accelerator is not None and m.accelerator != spec.accelerator:
                continue
            if (spec.tpu_generation is not None
                    and m.tpu_generation != spec.tpu_generation):
                continue
            stats = self.allocator.class_stats(ni, spec.min_free_mb,
                                               spec.min_clock_mhz)
            hold = self.allocator.holds_for(spec, ni, pod.key, now=now)
            if stats.count - hold >= spec.chips:
                free_hosts[m.slice_id] = free_hosts.get(m.slice_id, 0) + 1
                if (m.num_hosts >= spec.gang_size
                        and free_hosts[m.slice_id] >= spec.gang_size):
                    # single-slice path (chosen_slice mechanism); no plan
                    return Status.success()
        # account members already bound (partial re-form): their slices are
        # part of the plan and their slots pre-filled
        _, _, bound_by_slice = bound_gang_members(state, spec.gang_name)
        remaining = spec.gang_size - sum(bound_by_slice.values())
        plan = dict(bound_by_slice)
        for sid, count in sorted(free_hosts.items(),
                                 key=lambda kv: (-kv[1], kv[0])):
            if remaining <= 0:
                break
            take = min(count, remaining)
            if take > 0:
                plan[sid] = plan.get(sid, 0) + take
                remaining -= take
        if remaining > 0 or len(plan) <= 1:
            # cannot place even across slices (Filter will fail the pod and
            # preemption may run), or a single slice suffices after all
            return Status.success()
        self.gangs.set_plan(spec.gang_name, plan,
                            pre_placed=bound_by_slice)
        return Status.success()

    def _write_candidates(self, state: CycleState, spec: WorkloadSpec,
                          snapshot) -> frozenset:
        """Narrow the engine's filter scan to the nodes that can possibly
        host this gang member (framework.CANDIDATE_NODES_KEY). Hoists the
        cheap, eviction-invariant predicates of TelemetryFilter's gang
        branch — slice membership, plan quotas, the chosen (or
        bound-member-pinned) slice, gang-sized slices — so a 4-host
        placement stops paying a full-cluster filter fan-out per member
        cycle. Must stay aligned with _filter_checked's gang rejections:
        every node skipped here would be rejected there."""
        gang = spec.gang_name
        quotas = self.gangs.quotas_left(gang)
        chosen = self.gangs.chosen_slice(gang) if quotas is None else None
        if quotas is None and chosen is None:
            # members already bound pin the slice even when the
            # coordinator's state is gone (restart / peer bind failure)
            _, chosen, _ = bound_gang_members(state, gang)
        names = []
        for ni in snapshot.list():
            m = ni.metrics
            if m is None or not m.slice_id:
                continue
            if quotas is not None:
                if quotas.get(m.slice_id, 0) <= 0:
                    continue
            elif chosen is not None:
                if m.slice_id != chosen:
                    continue
            elif m.num_hosts < spec.gang_size:
                continue
            names.append(ni.name)
        carve = (self.gangs.carve_of(gang)
                 if self.carver is not None else None)
        if carve:
            # geometric narrowing: only the carved blocks' hosts. Safety
            # valve: if the carve no longer intersects the feasible set
            # (host lost since the carve), drop it and keep the legacy
            # candidates — the gang degrades instead of wedging
            allowed = set()
            for hosts in carve.values():
                allowed.update(hosts)
            narrowed = [n for n in names if n in allowed]
            if narrowed:
                names = narrowed
            else:
                self.gangs.clear_carve(gang)
        cand = frozenset(names)
        state.write(CANDIDATE_NODES_KEY, cand)
        return cand

    # Reserve: the first member fixes the slice choice for the whole gang
    # (single-slice path) or consumes its planned slice's quota.
    def reserve(self, state: CycleState, pod: Pod, node: str) -> Status:
        spec: WorkloadSpec = state.read("workload_spec")
        if spec.is_gang:
            snapshot = state.read_or("snapshot")
            node_info = snapshot.get(node) if snapshot is not None else None
            if node_info is not None and node_info.metrics is not None:
                slice_id = node_info.metrics.slice_id
                if self.gangs.plan_of(spec.gang_name) is not None:
                    self.gangs.record_placement(spec.gang_name, slice_id)
                else:
                    self.gangs.choose_slice(spec.gang_name, slice_id)
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node: str) -> None:
        spec = state.read_or("workload_spec")
        if spec is None or not getattr(spec, "is_gang", False):
            return None
        snapshot = state.read_or("snapshot")
        node_info = snapshot.get(node) if snapshot is not None else None
        if node_info is not None and node_info.metrics is not None:
            self.gangs.record_placement(spec.gang_name,
                                        node_info.metrics.slice_id, delta=-1)
        return None

    def permit(self, state: CycleState, pod: Pod, node: str) -> tuple[Status, float]:
        spec: WorkloadSpec = state.read("workload_spec")
        if not spec.is_gang:
            return Status.success(), 0.0
        n_waiting = self.gangs.add_waiting(spec.gang_name, pod.key)
        # members already bound in the cluster count toward completeness:
        # this re-admits stragglers of a partially-bound gang (peer bind
        # failure, scheduler restart mid-assembly) instead of parking them
        # at 1/N forever
        bound, _, _ = bound_gang_members(state, spec.gang_name)
        n_bound = len(bound - {pod.key})
        n = n_waiting + n_bound
        if n >= spec.gang_size:
            # gang complete: this pod proceeds; the engine approves the rest
            return Status.success(), 0.0
        if self.elastic is not None and spec.gang_min > 0:
            self.elastic.note_member_seen(spec.gang_name,
                                          state.read_or("now"))
            if n_bound >= spec.gang_min:
                # GROW: the gang already runs at (at least) min in
                # cluster truth — assembly is over, each further member
                # binds the moment it places (the engine counts the
                # bind via elastic.on_member_bound)
                return Status.success(), 0.0
            if (n >= spec.gang_min
                    and self.elastic.deadline_pressed(
                        spec, state.read_or("now"))):
                # deadline/SLO pressure: waiting for full assembly risks
                # the start deadline — admit at the current (>= min)
                # size; the engine approves the parked peers
                self.elastic.note_admitted_at_min(
                    spec.gang_name, initial=n_waiting, reason="deadline")
                return Status.success(), 0.0
        return Status.wait(
            f"gang {spec.gang_name}: {n}/{spec.gang_size} members placed"
        ), self.timeout_s

    # ------------------------------------------------------------ engine hooks
    def peers_to_approve(self, pod: Pod) -> set[str]:
        """After `pod`'s Permit succeeded, which waiting pods bind with it."""
        try:
            spec = spec_for(pod)
        except Exception:
            return set()
        if not spec.is_gang:
            return set()
        members = self.gangs.reset(spec.gang_name)
        members.discard(pod.key)
        return members

    def gang_of(self, pod: Pod) -> str | None:
        try:
            spec = spec_for(pod)
        except Exception:
            return None
        return spec.gang_name

    def fail_gang(self, gang: str) -> set[str]:
        """Timeout/failure: tear down and report members needing rollback."""
        return self.gangs.reset(gang)
