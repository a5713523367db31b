"""PostFilter plugin: priority preemption.

In the modern scheduling framework PostFilter is the preemption hook — the
role the reference's upstream engine provided and the reference accidentally
displaced by registering its aggregation pass there (SURVEY §3.2). Native
rebuild: when no node passes Filter, evict the cheapest set of strictly
lower-priority pods (by ``scv/priority``) from one node so the pod fits next
cycle. The plugin returns the victim plan; the engine evicts.

Fit simulation uses the *allocation* view (chip coords + label claims) and
chip HBM capacity — measured free HBM cannot be simulated for evicted pods
because their memory is only released once they actually terminate.
"""

from __future__ import annotations

from ..framework import CycleState, NodeInfo, PostFilterPlugin, Snapshot, Status
from ...utils.labels import (
    GANG_NAME_LABEL, LabelError, WorkloadSpec, is_harvest, spec_for)
from ...utils.pdb import DisruptionLedger
from ...utils.pod import Pod
from .admission import admissible, preemption_obstacles
from .allocator import ChipAllocator


def _priority(pod: Pod) -> int:
    """Pod priority straight from the memoised spec — this runs per bound
    pod per candidate node on every preemption scan, so it must not
    allocate wrappers (sort.pod_priority's QueuedPodInfo shim dominated
    unschedulable-burst cycles at 1000 nodes)."""
    try:
        return spec_for(pod).priority
    except LabelError:
        return 0


def _victim_rank(pod: Pod) -> tuple[int, int]:
    """Victim ordering key: harvest-class pods (scv/harvest) ALWAYS rank
    below every ordinary pod — they soak idle capacity and are evicted
    for free, so a plan takes them first regardless of their nominal
    scv/priority. With no harvest pods in a pool this orders exactly
    like bare _priority (the parity the harvest-off placements rely on)."""
    return (0 if is_harvest(pod) else 1, _priority(pod))


def _shrinkable_gang_of(pod: Pod) -> str | None:
    """The pod's gang name when it is an ELASTIC gang member (carries a
    positive tpu/gang-min) — the only gang members shrink-to-min may
    consider; None otherwise."""
    try:
        spec = spec_for(pod)
    except LabelError:
        return None
    if spec.is_gang and spec.gang_min > 0:
        return spec.gang_name
    return None


def _evictable(pod: Pod) -> bool:
    """Gang members are never preemption victims: evicting one strands its
    peers bound and holding chips — exactly the partial-gang deadlock
    GangCoordinator's all-or-nothing admission exists to prevent. (The
    descheduler applies the same exclusion in its _movable check.)
    Already-terminating pods are excluded too: their chips free on their
    own shortly, and re-evicting them frees nothing extra."""
    if pod.terminating:
        return False
    try:
        return not spec_for(pod).is_gang
    except LabelError:
        return True  # unparsable labels can't declare a gang


class PriorityPreemption(PostFilterPlugin):
    name = "priority-preemption"

    def equivalence_key(self, pod):
        """Batch-cycle contract: PostFilter only runs when a pod found no
        feasible node, and the batch commit loop never handles that case —
        a member with exhausted candidates falls back to the full per-pod
        cycle, which runs this plugin exactly as before."""
        return ()
    # the planner's per-node verdicts are independent (absent PDBs, which
    # the engine gates on): restricting the scan to a caller-supplied node
    # set yields exactly the full scan's verdicts for those nodes, so the
    # unschedulable-class repair path may re-plan only the dirty nodes
    supports_restricted = True

    def __init__(self, allocator: ChipAllocator, gangs=None) -> None:
        self.allocator = allocator
        self.gangs = gangs  # GangCoordinator: chosen-slice pin for gangs

    def post_filter(self, state: CycleState, pod: Pod, snapshot: Snapshot,
                    failures: dict[str, str],
                    only_nodes: set | None = None
                    ) -> tuple[str | None, list[Pod], Status]:
        spec: WorkloadSpec = state.read("workload_spec")
        if spec.harvest:
            # harvest pods soak IDLE capacity only — they never evict
            # anything. (Also load-bearing: harvest victims are
            # evictable by ANY preemptor, so a harvest preemptor could
            # displace a harvest peer at equal priority and the two
            # would evict each other forever.)
            return None, [], Status.unschedulable(
                f"harvest pod {pod.key} never preempts")
        now = state.read_or("now")
        my_prio = _priority(pod)
        # PDB allowance accounting over the whole cluster's bound pods
        # (upstream parity: violations are minimized, never an absolute
        # veto — see utils/pdb.py). The cluster-wide pod walk only happens
        # when budgets actually exist.
        ledger = DisruptionLedger(
            snapshot.budgets,
            [p for ni in snapshot.list() for p in ni.pods]
            if snapshot.budgets else ())
        # elastic shrink-to-min (scheduler/elastic/): bound members of an
        # elastic gang running ABOVE its tpu/gang-min are preemption
        # donors — a strictly cheaper plan than the previous only option
        # (gangs untouchable). Per-plan surplus accounting (`shrink_taken`
        # consumed at pick time) guarantees no plan ever takes a gang
        # below its min; conservative across the whole planning pass, so
        # candidate plans that lose the ranking still count against the
        # surplus they would have spent.
        shrink_ok = None
        shrink_taken: dict[str, int] = {}
        if state.read_or("elastic_shrinkable"):
            shrink_ok = self._make_shrink_ok(snapshot, shrink_taken)
        if spec.is_gang:
            return self._gang_post_filter(state, spec, my_prio, pod,
                                          snapshot, now, ledger,
                                          shrink_ok, shrink_taken)
        # per-tenant preemption budgets (scheduler/policy/): a tenant
        # with NO remaining budget contributes no victims, so the
        # planner routes around it toward admissible plans instead of
        # proposing one the engine's whole-plan budget gate must refuse
        # (that gate stays the backstop for multi-victim overdraws)
        victim_ok = state.read_or("victim_budget_ok")
        # minimal disruption: no-PDB-violation plans always win, then
        # fewest victims, then lowest max victim priority
        best: tuple[tuple, str, list[Pod]] | None = None
        def evictable_victim(p: Pod) -> bool:
            # harvest pods are evictable by ANY preemptor (priority
            # irrelevant — they exist to yield) and never consume a
            # tenant's preemption budget
            return ((_priority(p) < my_prio or is_harvest(p))
                    and (_evictable(p)
                         or (shrink_ok is not None and shrink_ok(p)))
                    and (victim_ok is None or is_harvest(p)
                         or victim_ok(p)))

        for node in snapshot.list():
            if only_nodes is not None and node.name not in only_nodes:
                continue
            m = node.metrics
            if m is None or (now is not None and m.stale(now=now)):
                continue
            if spec.accelerator is not None and m.accelerator != spec.accelerator:
                continue
            # never plan evictions on a node the preemptor itself cannot
            # pass admission on (nodeSelector/taints) — the evictions would
            # repeat every cycle while the pod stays Pending
            if not admissible(pod, node):
                continue
            # inter-pod constraints: skip nodes eviction cannot cure
            # (required podAffinity, or an unevictable conflicting pod);
            # otherwise the conflicting pods join the victim plan
            obstacles = preemption_obstacles(state, pod, node, snapshot,
                                             evictable_victim,
                                             allocator=self.allocator,
                                             priority=my_prio)
            if obstacles is None:
                continue
            victims = self._plan_node(spec, my_prio, node, pod_key=pod.key,
                                      ledger=ledger, pod=pod, now=now,
                                      victim_ok=victim_ok,
                                      shrink_ok=shrink_ok,
                                      shrink_taken=shrink_taken)
            if victims is None:
                continue  # capacity unreachable even with evictions
            seen_keys = {v.key for v in victims}
            extra = [o for o in obstacles if o.key not in seen_keys]
            # affinity obstacles folded into the plan consume gang
            # surplus too — and must be RE-GATED against the live
            # surplus here: _plan_node's picks may have exhausted it
            # since preemption_obstacles admitted the obstacle, and an
            # unevictable obstacle invalidates the whole node's plan
            # (evicting around it would repeat every cycle)
            obstacle_blocked = False
            for o in extra:
                g = _shrinkable_gang_of(o)
                if g is None:
                    continue
                if shrink_ok is None or not shrink_ok(o):
                    obstacle_blocked = True
                    break
                shrink_taken[g] = shrink_taken.get(g, 0) + 1
            if obstacle_blocked:
                continue
            full = victims + extra
            if not full:
                # fits as-is with no conflicts to clear: the
                # infeasibility has a cause preemption cannot cure
                continue
            # harvest victims are FREE: they never weigh a plan's PDB
            # violation count, its victim count, or its max-victim-
            # priority cost (a plan that only harvests always beats one
            # that evicts tenants — counting them in the size term
            # would let a one-tenant-victim plan outrank a two-harvest
            # plan)
            charged = [v for v in full if not is_harvest(v)]
            key = (ledger.violations_for(charged), len(charged),
                   max((_priority(v) for v in charged), default=-1),
                   node.name)
            if best is None or key < best[0]:
                best = (key, node.name, full)
        if best is None:
            return None, [], Status.unschedulable(
                f"preemption: no node can fit {pod.key} even after evicting "
                f"lower-priority pods"
            )
        # surface budget violations to the engine's metrics (key read at
        # the eviction site in core.py)
        state.write("preempt_pdb_violations", best[0][0])
        return best[1], best[2], Status.success()

    @staticmethod
    def _make_shrink_ok(snapshot: Snapshot, taken: dict):
        """Shrink-to-min victim predicate over one plan's lifetime:
        True for a bound elastic-gang member whose gang still has
        surplus above tpu/gang-min AFTER the members this plan already
        picked (`taken` is consumed at pick time by _plan_node). Bound
        counts come from the plan's own snapshot — cluster truth, so
        fleet replicas and restarts agree — computed lazily once per
        gang per plan."""
        counts: dict[str, int] = {}

        def shrink_ok(p: Pod) -> bool:
            if p.terminating:
                return False
            gang = _shrinkable_gang_of(p)
            if gang is None:
                return False
            n = counts.get(gang)
            if n is None:
                n = sum(1 for ni in snapshot.list() for q in ni.pods
                        if q.labels.get(GANG_NAME_LABEL) == gang
                        and not q.terminating)
                counts[gang] = n
            return n - taken.get(gang, 0) > spec_for(p).gang_min

        return shrink_ok

    def _gang_post_filter(self, state: CycleState, spec: WorkloadSpec,
                          my_prio: int, pod: Pod, snapshot: Snapshot,
                          now, ledger: DisruptionLedger,
                          shrink_ok=None, shrink_taken=None
                          ) -> tuple[str | None, list[Pod], Status]:
        """All-or-nothing slice eviction for a gang (
        the workload MOST likely to find its slice dented by low-priority
        singles is the one that previously could neither evict them nor go
        elsewhere). Plan: for each big-enough slice, a per-host victim set
        freeing `spec.chips` qualifying chips on `gang_size` hosts; choose
        the slice with the fewest total victims. The engine then evicts
        the whole plan and takes a GANG nomination (chips held on every
        host of the slice until the gang completes or the hold expires)."""
        # honour the slice pin: members already parked (coordinator) or
        # bound (cluster truth) tie the whole gang to ONE slice — evicting
        # pods on any other slice would free capacity the gang's filter
        # refuses to use
        pinned = self.gangs.chosen_slice(spec.gang_name) \
            if self.gangs is not None else None
        if pinned is None:
            from .gang import bound_gang_members

            _, pinned, _ = bound_gang_members(state, spec.gang_name)
        by_slice: dict[str, list[NodeInfo]] = {}
        for node in snapshot.list():
            m = node.metrics
            if m is None or not m.slice_id:
                continue
            if pinned is not None and m.slice_id != pinned:
                continue
            if now is not None and m.stale(now=now):
                continue
            if spec.accelerator is not None and m.accelerator != spec.accelerator:
                continue
            # a host the gang member can't pass admission on disqualifies
            # it from the per-slice plan the same way capacity would;
            # inter-pod obstructions disqualify conservatively (gang plans
            # don't fold conflicting pods into their per-host victim sets)
            if not admissible(pod, node):
                continue
            if preemption_obstacles(state, pod, node, snapshot,
                                    lambda p: False,
                                    allocator=self.allocator,
                                    priority=my_prio) != []:
                continue
            if m.num_hosts < spec.gang_size:
                continue
            by_slice.setdefault(m.slice_id, []).append(node)
        # hosts already serving this gang's own members — parked peers'
        # pending reservations and bound members — are covered: they need
        # no planning (their chips look taken, but by US), and only
        # gang_size - covered more hosts must be freed
        covered: set[str] = set()
        if self.gangs is not None:
            for key in self.gangs.waiting_members(spec.gang_name):
                n = self.allocator.pending_node_of(key)
                if n is not None:
                    covered.add(n)
        for ni in snapshot.list():
            for p in ni.pods:
                if (p.labels.get(GANG_NAME_LABEL) == spec.gang_name
                        and not p.terminating):
                    covered.add(ni.name)
        need = max(spec.gang_size - len(covered), 1)
        best: tuple[tuple, str, list[Pod]] | None = None
        for sid, hosts in by_slice.items():
            if len(hosts) < spec.gang_size:
                continue
            plans: list[tuple[int, int, str, list[Pod]]] = []
            for host in hosts:
                if host.name in covered:
                    continue
                victims = self._plan_node(spec, my_prio, host, pod_key=pod.key,
                                          ledger=ledger, pod=pod, now=now,
                                          victim_ok=state.read_or(
                                              "victim_budget_ok"),
                                          shrink_ok=shrink_ok,
                                          shrink_taken=shrink_taken)
                if victims is None:
                    continue  # this host can't reach spec.chips at all
                # per-host cost leads with this host's own PDB violations
                # so the `need`-cheapest hosts prefer non-violating ones
                # (harvest victims free in every cost term, as in the
                # single-pod path)
                hc = [v for v in victims if not is_harvest(v)]
                plans.append((ledger.violations_for(hc), len(hc),
                              max((_priority(v) for v in hc), default=-1),
                              host.name, victims))
            if len(plans) < need:
                continue  # not enough viable hosts even with evictions
            plans.sort()
            chosen = plans[:need]
            victims = [v for _, _, _, _, vs in chosen for v in vs]
            if not victims:
                # every chosen host already fits without evicting: the
                # gang's infeasibility has a non-capacity cause preemption
                # cannot cure
                continue
            # slice cost uses the COMBINED victim set: per-budget demand
            # aggregates across hosts, so two hosts each within allowance
            # can still violate together (harvest victims stay free)
            charged = [v for v in victims if not is_harvest(v)]
            key = (ledger.violations_for(charged), len(charged),
                   max((_priority(v) for v in charged), default=-1), sid)
            if best is None or key < best[0]:
                best = (key, chosen[0][3], victims)
        if best is None:
            return None, [], Status.unschedulable(
                f"preemption: no slice can host gang {spec.gang_name} even "
                f"after evicting lower-priority pods"
            )
        state.write("preempt_pdb_violations", best[0][0])
        return best[1], best[2], Status.success()

    def _plan_eviction(self, spec: WorkloadSpec, my_prio: int, node: NodeInfo,
                       now: float | None = None,
                       pod_key: str | None = None,
                       ledger: DisruptionLedger | None = None
                       ) -> list[Pod] | None:
        """Smallest non-empty victim set on this node that frees enough
        qualifying chips; victims chosen lowest-priority-first. None if
        impossible — or if no eviction is needed at all, in which case the
        pod's infeasibility has a non-capacity cause preemption cannot cure
        (stale telemetry, accelerator mismatch)."""
        m = node.metrics
        if m is None:
            return None
        if now is not None and m.stale(now=now):
            return None
        if spec.accelerator is not None and m.accelerator != spec.accelerator:
            return None
        victims = self._plan_node(spec, my_prio, node, pod_key=pod_key,
                                  ledger=ledger, now=now)
        return victims or None

    def _plan_node(self, spec: WorkloadSpec, my_prio: int, node: NodeInfo,
                   pod_key: str | None = None,
                   ledger: DisruptionLedger | None = None,
                   pod: Pod | None = None,
                   now: float | None = None,
                   victim_ok=None, shrink_ok=None,
                   shrink_taken=None) -> list[Pod] | None:
        """Victims on this node that free `spec.chips` qualifying chips AND
        (when `pod` carries container requests and the node reports
        allocatable) enough cpu/memory: [] when the node already fits
        without evicting, None when it cannot reach the target at all.
        Shared by the single-pod path and the per-host step of gang slice
        planning."""
        m = node.metrics
        free = self.allocator.free_coords(node)
        # capacity already held for OTHER nominated preemptors (pod-level
        # and gang-level) of >= priority counts as taken, exactly as in
        # TelemetryFilter — otherwise two preemptors can be "proven" to fit
        # in the same freshly-freed hole, nominate overlapping chips, and
        # deadlock each other's holds
        hold = self.allocator.holds_for(spec, node, pod_key)
        # capacity check against chip HBM totals (see module docstring)
        ok_coords = {
            c.coords for c in m.healthy_chips()
            if c.hbm_total_mb >= spec.min_free_mb and c.clock_mhz >= spec.min_clock_mhz
        }
        # cpu/mem target (NodeResourcesFit): how much must be freed.
        # Nominated preemptors' cpu/mem holds count as used, exactly as
        # holds_for does for chips — otherwise two preemptors prove
        # themselves into the same freed resources.
        need_cpu = need_mem = 0
        used_cpu = used_mem = 0
        if (pod is not None and (pod.cpu_millis or pod.memory_bytes)
                and node.allocatable is not None):
            used_cpu, used_mem = node.requested_cpu_mem()
            hold_cpu, hold_mem = self.allocator.nominated_cpu_mem(
                node.name, spec.priority, pod_key)
            used_cpu += hold_cpu
            used_mem += hold_mem
            if m is not None and m.slice_id:
                # gang-level holds count too, exactly as holds_for folds
                # gang_hold into the chips side — otherwise this planner
                # proves a zero-victim fit the admission filter then
                # rejects, and the preemptor ping-pongs on the node.
                # `now` prunes expired entitlements like the filter does.
                gcpu, gmem = self.allocator.gang_cpu_mem_hold(
                    m.slice_id, spec.priority,
                    exclude_gang=spec.gang_name if spec.is_gang else None,
                    now=now)
                used_cpu += gcpu
                used_mem += gmem
            need_cpu, need_mem = pod.cpu_millis, pod.memory_bytes

        def resources_fit() -> bool:
            if not need_cpu and not need_mem:
                return True
            return (used_cpu + need_cpu <= node.allocatable[0]
                    and used_mem + need_mem <= node.allocatable[1])

        if len(free & ok_coords) - hold >= spec.chips and resources_fit():
            return []  # fits as-is; nothing to evict here
        # fast reject before sorting: with no evictable lower-priority pod
        # the target is unreachable. This is the common case for every node
        # during an unschedulable burst. Elastic shrink-to-min extends the
        # pool with surplus members of elastic gangs (re-checked at every
        # pick so one plan can never take a gang below its min).
        pool = [p for p in node.pods
                if (_priority(p) < my_prio or is_harvest(p))
                and (_evictable(p)
                     or (shrink_ok is not None and shrink_ok(p)))
                and (victim_ok is None or is_harvest(p) or victim_ok(p))]
        if not pool:
            return None
        if len(ok_coords) - hold < spec.chips:
            return None
        # budget-protected victims go LAST (upstream's victim ordering:
        # prefer evictions that violate no PDB), then lowest priority
        # first. The protection check runs against a WORKING allowance
        # copy that each pick consumes — a static snapshot would let two
        # same-budget picks drain an allowance of one without either
        # looking protected, taking an avoidable violation.
        pool.sort(key=_victim_rank)
        tracker = (ledger.tracker()
                   if ledger is not None and ledger.budgets else None)
        victims: list[Pod] = []
        while (len(free & ok_coords) - hold < spec.chips
               or not resources_fit()):
            if not pool:
                return None
            chips_met = len(free & ok_coords) - hold >= spec.chips
            candidates = pool
            if shrink_ok is not None:
                # re-gate gang members against the LIVE surplus: an
                # earlier pick (this node or an earlier host of a gang
                # plan) may have consumed the last member above min
                candidates = [p for p in candidates
                              if _evictable(p) or shrink_ok(p)]
                if not candidates:
                    return None
            if chips_met:
                # only the resource target remains: restrict picks to pods
                # that actually free some of the short resource — evicting
                # resource-less pods makes no progress
                candidates = [
                    p for p in pool
                    if (used_cpu + need_cpu > node.allocatable[0]
                        and p.cpu_millis)
                    or (used_mem + need_mem > node.allocatable[1]
                        and p.memory_bytes)
                ]
                if not candidates:
                    return None
            if tracker is None:
                v = min(candidates, key=_victim_rank)
            else:
                # harvest pods never touch the PDB ledger: their
                # eviction is free by contract, so they neither read a
                # budget's allowance nor consume it
                v = min(candidates,
                        key=lambda p: ((False if is_harvest(p)
                                        else tracker.would_violate(p)),
                                       _victim_rank(p)))
                if not is_harvest(v):
                    tracker.consume_one(v)
            pool.remove(v)
            victims.append(v)
            if shrink_taken is not None:
                g = _shrinkable_gang_of(v)
                if g is not None:
                    shrink_taken[g] = shrink_taken.get(g, 0) + 1
            free = free | v.assigned_chips()
            used_cpu -= v.cpu_millis
            used_mem -= v.memory_bytes
        # reprieve pass (upstream parity): drop victims whose eviction
        # turned out unnecessary — early chip-driven picks can be
        # superseded by later resource-driven ones. Highest priority
        # reprieved first (spare the most valuable workloads).
        for v in sorted(victims, key=_victim_rank, reverse=True):
            without = free - v.assigned_chips()
            if (len(without & ok_coords) - hold >= spec.chips
                    and (not need_cpu and not need_mem
                         or (used_cpu + v.cpu_millis + need_cpu
                             <= node.allocatable[0]
                             and used_mem + v.memory_bytes + need_mem
                             <= node.allocatable[1]))):
                victims.remove(v)
                if shrink_taken is not None:
                    g = _shrinkable_gang_of(v)
                    if g is not None and shrink_taken.get(g, 0) > 0:
                        shrink_taken[g] -= 1
                free = without
                used_cpu += v.cpu_millis
                used_mem += v.memory_bytes
        return victims
