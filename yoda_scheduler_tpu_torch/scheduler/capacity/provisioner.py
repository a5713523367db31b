"""Closed-loop capacity: the node-provisioner control loop.

Every scenario before this PR assumed a fixed fleet; production TPU
clusters breathe. This controller — one per engine replica, built by
``Scheduler.__init__`` when ``provisionerIntervalSeconds`` > 0 and run
on the ENGINE thread's injectable clock like the defrag loop — closes
the loop in both directions:

**Scale-up** is driven by the pending backlog's recorded *why*: parked
pods that failed a cycle carry their WorkloadSpec (the same shape the
unschedulable-class memo keys on — chips, HBM floor, accelerator,
generation), and the demand router maps each shape onto the first
registered pool whose NodeTemplate satisfies it. Requests go to the
attached provider one wave per pool (no new requests while a wave is in
flight), bounded by the pool's max, and only count demand that failed
AFTER the pool's last delivery — a parked pod waiting out its backoff
must not be re-counted into a second wave for the same hole.

**Scale-down** runs the defrag machinery in reverse: when a pool sits
above its min with no unmet demand, the least-loaded provisioned node
is drained — harvest pods (scv/harvest) evicted first and for free,
ordinary movable pods dry-run-proven onto other nodes and migrated
through the victim-drain path with destination pins — and a node is
RELEASED only when it has been empty past ``scaleDownCooldownSeconds``
and has survived one further cordoned pass (in-flight optimistic binds
from fleet peers get a full interval to land or 409). A node with an
unmovable resident (gang member, protected priority) blocks its pool's
drain until the cluster changes.

**Misbehaving providers** get the repo's established robustness
grammar: exponential backoff with seeded jitter per pool on stockout /
quota-denial / write-off, a per-pool circuit breaker
(``provisioner_breaker_open`` trip) after consecutive failures, a
write-off deadline for lost responses with ADOPTION by membership
reconciliation (a node that arrives after its request was written off —
or was requested by a crashed fleet replica — is folded into its pool's
book off the scv/pool node label, never leaked), and hysteresis: one
pool never both scales up and scales down within one
``provisionerHysteresisSeconds`` window, so flapping demand cannot
oscillate the fleet.

**Interlocks**: an open apiserver circuit breaker or telemetry-blackout
degraded mode pauses scale-DOWN (never release or drain capacity off
stale data) while scale-up continues degraded — stranding pending work
is worse than over-provisioning. In a fleet only the shard-0 lease
holder runs the loop (the defrag ownership discipline; crash =>
takeover), and the claim-by-label reconciliation is what makes a
takeover unable to leak or double-release the crashed owner's nodes.
"""

from __future__ import annotations

import random

from .provider import MANAGED_LABEL, POOL_LABEL, NodeTemplate
from ...utils.labels import LabelError, is_harvest, spec_for

# a drained non-harvest resident above this scv/priority is never
# migrated for scale-down (the descheduler's protect_priority default)
PROTECT_PRIORITY = 5
# consecutive provider failures (per pool) that open its breaker
BREAKER_FAILURES = 3


class _Pool:
    """Per-pool control state. Membership itself is NOT stored here —
    it is re-derived from cluster truth (the scv/pool node label) every
    pass, which is what makes fleet takeover and lost-response adoption
    correct by construction."""

    __slots__ = ("template", "min", "max", "in_flight", "deadlines",
                 "backoff_until", "backoff_s", "fails", "breaker_until",
                 "last_scale_up", "last_scale_down", "last_delivery",
                 "empty_since", "pending_release", "drain_blocked_vers",
                 "written_off")

    def __init__(self, template: NodeTemplate, lo: int, hi: int) -> None:
        self.template = template
        self.min = lo
        self.max = hi
        self.in_flight: dict = {}        # request id -> ProvisionRequest
        self.deadlines: dict = {}        # request id -> write-off time
        self.backoff_until = 0.0
        self.backoff_s = 0.0
        self.fails = 0
        self.breaker_until = 0.0
        self.last_scale_up = float("-inf")
        self.last_scale_down = float("-inf")
        self.last_delivery = float("-inf")
        self.empty_since: dict = {}      # node -> first-seen-empty time
        self.pending_release: set = set()  # cordoned, one pass from release
        # cluster version vector at the last drain attempt that found
        # only unmovable residents: no retry until the cluster moves
        self.drain_blocked_vers = None
        self.written_off = 0


class CapacityProvisioner:
    """One per engine replica (``Scheduler.provisioner``); engine-thread
    only. ``maybe_run`` is called from run_one BEFORE the breaker gate —
    scale-up must keep working through an apiserver storm."""

    def __init__(self, sched, interval_s: float) -> None:
        cfg = sched.config
        self.sched = sched
        self.interval_s = interval_s
        # first pass waits one interval, the defrag discipline: the
        # intake burst right after start is the ordinary cycle's job
        self.next_at = sched.clock.time() + interval_s
        self.pools: dict[str, _Pool] = {}
        self.provider = None
        # fleet hooks (FleetCoordinator): ownership follows the shard-0
        # lease; demand is fleet-wide (a starved shape usually queues on
        # a different replica than the loop's owner)
        self.owner_check = None
        self.demand_fn = None
        self.cooldown_s = cfg.scale_down_cooldown_s
        self.hysteresis_s = cfg.provisioner_hysteresis_s
        self.backoff_s = cfg.provisioner_backoff_s
        self.backoff_max_s = cfg.provisioner_backoff_max_s
        self.timeout_s = cfg.provision_timeout_s
        self.max_drains = cfg.max_migrations_per_pass
        self._bounds = {name: (lo, hi) for name, lo, hi in cfg.pool_bounds}
        # nodes whose arrival this replica has already accounted (a
        # ready result or an adoption); a managed node outside this set
        # at reconcile time is the adoption case
        self._known: set[str] = set()
        self._nodes_vers = None
        # seeded jitter: backoff spreads deterministically per replica
        self.rng = random.Random(cfg.rng_seed ^ 0x5CA1E)
        # fleet ownership edge detection: a replica that just ACQUIRED
        # the loop (initial lease or crash takeover) holds BOTH
        # hysteresis directions for one window — it cannot know what
        # the previous owner did inside the current window, and acting
        # blind is exactly the oscillation hysteresis exists to prevent
        self._was_owner = False
        # cluster-TRUTH backend for membership/occupancy reads: under
        # reflectorSharding the engine's own cluster is an owned-pools
        # view that may not even SEE the managed pools — the fleet
        # wires the unsharded cluster here (bound_node_of's global-
        # truth discipline). None = the engine's cluster IS truth.
        self.truth = None
        # busy() memo: the wake gate runs on every next_wake_at() call
        # (a hot idle-loop path), but its answer is interval-granular
        # by nature — recompute at most twice per interval
        self._busy_cache: tuple | None = None

    # ------------------------------------------------------------- wiring
    def add_pool(self, template: NodeTemplate) -> _Pool:
        """Register a pool the loop may scale. Config poolBounds
        override the template's own bounds. Slice templates are
        validated against the generation catalog HERE: a template
        claiming more chips per host than the generation's host block
        delivers would route demand to a pool whose nodes can never
        host it — an endless useless-wave loop, refused loudly."""
        if template.hosts > 1:
            from ...topology.generations import generation as gen_of

            block = gen_of(template.generation).host_block
            per_host = 1
            for d in block:
                per_host *= d
            if template.chips != per_host:
                raise ValueError(
                    f"pool {template.pool}: chips={template.chips} but "
                    f"{template.generation} slice hosts carry {per_host} "
                    f"chips ({'x'.join(map(str, block))} block)")
            if template.slice_topology:
                # torus-shape guard, same class as the chips-per-host
                # check: the generation catalog rejects degenerate/zero
                # axes, over-max volumes, rank mismatches, and per-axis
                # host-block indivisibility; on top, the shape's volume
                # must equal exactly hosts x chips-per-host or the pool
                # would provision slices whose host grid disagrees with
                # the template's own host count (carves computed on a
                # grid that doesn't exist)
                from ...topology.generations import generation as g_of
                from ...topology.torus import chips_in

                shape = g_of(template.generation).validate_slice_topology(
                    template.slice_topology)
                if chips_in(shape) != template.hosts * per_host:
                    raise ValueError(
                        f"pool {template.pool}: slice topology "
                        f"{template.slice_topology} holds "
                        f"{chips_in(shape)} chips but the template "
                        f"provisions {template.hosts} hosts x {per_host} "
                        "chips")
        lo, hi = self._bounds.get(template.pool,
                                  (template.min_nodes, template.max_nodes))
        pool = _Pool(template, lo, hi)
        self.pools[template.pool] = pool
        return pool

    def attach_provider(self, provider) -> None:
        self.provider = provider

    # ------------------------------------------------------------ helpers
    def _skip(self, reason: str) -> None:
        self.sched.metrics.inc("provisioner_skips_total",
                               labels={"reason": reason})

    def _cluster(self):
        return self.truth if self.truth is not None else self.sched.cluster

    def _node_pool(self, name: str) -> str | None:
        """The pool a node belongs to, off its scv/pool label (managed
        nodes) — None for unmanaged/unlabeled nodes."""
        meta = getattr(self._cluster(), "node_meta", None)
        if meta is None:
            return None
        labels, _ = meta(name)
        if labels.get(MANAGED_LABEL) != "1":
            return None
        return labels.get(POOL_LABEL)

    def _survey(self) -> tuple[dict, dict]:
        """ONE cluster-truth scan: (pool -> managed member nodes,
        pool -> total population). Population counts managed members
        plus hand-built nodes sharing the pool name prefix — the
        number the min/max bounds govern."""
        from ..columnar import pool_of

        c = self._cluster()
        meta = getattr(c, "node_meta", None)
        members: dict[str, list[str]] = {n: [] for n in self.pools}
        sizes: dict[str, int] = {n: 0 for n in self.pools}
        for n in c.node_names():
            labels = meta(n)[0] if meta is not None else {}
            if labels.get(MANAGED_LABEL) == "1":
                p = labels.get(POOL_LABEL)
                if p in members:
                    members[p].append(n)
                    sizes[p] += 1
                continue
            p = pool_of(n)
            if p in sizes:
                sizes[p] += 1
        return members, sizes

    def busy(self) -> bool:
        """Whether an interval tick could make progress with no other
        wake pending — the next_wake_at contribution. Must eventually go
        False on a stable cluster or idle drains never terminate; pools
        whose drain is provably stuck (drain_blocked_vers pinned at the
        current version vector) stop waking until the cluster moves.
        Memoized for half an interval: this runs on every next_wake_at
        call, and its answer is interval-granular by nature (maybe_run
        itself still ticks on every scheduling cycle regardless)."""
        if self.provider is None or not self.pools:
            return False
        if self.owner_check is not None and not self.owner_check():
            # not this replica's loop: the owner computes the wakes
            # (a takeover's first pass is driven by the lease step and
            # the ordinary queue wakes, not by the dormant loser)
            return False
        now = self.sched.clock.time()
        if self._busy_cache is not None \
                and abs(now - self._busy_cache[0]) < self.interval_s / 2:
            return self._busy_cache[1]
        value = self._busy_compute(now)
        self._busy_cache = (now, value)
        return value

    def _busy_compute(self, now: float) -> bool:
        nxt = getattr(self.provider, "next_event_at", None)
        if nxt is not None and nxt(now) is not None:
            return True
        # pending non-harvest work anywhere is potential demand: the
        # interval tick must fire even when every pod sleeps in backoff
        # (the defrag demand-gate discipline — the queue drains or
        # fails eventually, so idle stays reachable). Parked HARVEST
        # pods are deliberately not a wake source: they wait for
        # capacity that exists for other reasons.
        if self._demand() or self.sched.waiting:
            return True
        for pool in self.pools.values():
            if pool.in_flight or pool.pending_release:
                return True
        members, sizes = self._survey()
        pods_on = self._cluster().pods_on
        for name, pool in self.pools.items():
            managed = members.get(name, ())
            size = sizes.get(name, 0)
            if size < pool.min:
                return True  # below min: bounds maintenance pending
            if size <= pool.min:
                continue
            # above min: an empty member is in (or headed into) the
            # cooldown->release pipeline; otherwise only an unblocked
            # drain can make progress
            if pool.template.hosts > 1:
                # slices release whole or not at all: only a fully
                # empty slice is actionable
                for hosts in self._by_slice(managed).values():
                    if all(not pods_on(h) for h in hosts):
                        return True
                continue
            if any(not pods_on(n) for n in managed):
                return True
            if pool.drain_blocked_vers is None \
                    or pool.drain_blocked_vers != self._vers():
                return True
        return False

    def _by_slice(self, managed) -> dict:
        tel = getattr(self._cluster(), "telemetry", None)
        out: dict = {}
        for n in managed:
            m = tel.get(n) if tel is not None else None
            out.setdefault(m.slice_id if m is not None else "",
                           []).append(n)
        return out

    def _vers(self) -> tuple:
        c = self._cluster()
        tel = getattr(c, "telemetry", None)
        return (getattr(c, "pods_global_version", None),
                getattr(c, "nodes_version", None),
                getattr(tel, "resource_version", None))

    # ------------------------------------------------------------ the loop
    def maybe_run(self, now: float):
        if now < self.next_at:
            return None
        self.next_at = now + self.interval_s
        if self.provider is None or not self.pools:
            return None
        if self.owner_check is not None:
            owner = self.owner_check()
            if not owner:
                self._was_owner = False
                self._skip("not-owner")
                return None
            if not self._was_owner:
                self._was_owner = True
                for pool in self.pools.values():
                    pool.last_scale_up = max(pool.last_scale_up, now)
                    pool.last_scale_down = max(pool.last_scale_down, now)
        return self.run_pass(now)

    def run_pass(self, now: float) -> dict:
        """One guarded pass (chaos injectors call this directly,
        bypassing the interval/ownership gates but never the
        scale-down interlocks). Returns a summary dict for tests."""
        summary = {"requested": 0, "released": 0, "adopted": 0,
                   "drained": 0}
        self._busy_cache = None  # the pass changes what busy() reads
        self._poll(now, summary)
        self._write_off(now)
        self._reconcile(now, summary)
        members, sizes = self._survey()
        demand = self._demand()
        self._scale_up(now, members, sizes, demand, summary)
        self._scale_down(now, members, sizes, demand, summary)
        self._publish(members)
        return summary

    # ----------------------------------------------------------- provider
    def _poll(self, now: float, summary: dict) -> None:
        m = self.sched.metrics
        for res in self.provider.poll(now):
            pool = self.pools.get(res.pool)
            req = (pool.in_flight.pop(res.request_id, None)
                   if pool is not None else None)
            if pool is not None:
                pool.deadlines.pop(res.request_id, None)
            if res.outcome == "ready":
                m.inc("provision_requests_total",
                      labels={"outcome": "ready"})
                for n in (res.nodes or
                          ((res.node,) if res.node else ())):
                    self._known.add(n)
                if pool is not None:
                    pool.last_delivery = now
                    if req is None:
                        # a request this replica never issued (written
                        # off, or a crashed peer's): the node is real —
                        # adopt it, never leak it, and clear the
                        # failure state the write-off charged exactly
                        # like the reconcile adoption path (the
                        # provider actually delivered); the hysteresis
                        # stamp rides along for the same reason
                        m.inc("provisioner_nodes_adopted_total")
                        summary["adopted"] += 1
                        pool.last_scale_up = now
                    pool.fails = 0
                    pool.backoff_s = 0.0
                    pool.backoff_until = 0.0
            else:
                m.inc("provision_requests_total",
                      labels={"outcome": res.outcome})
                if pool is not None:
                    self._fail(pool, now, res.outcome)

    def _fail(self, pool: _Pool, now: float, why: str) -> None:
        """Provider failure: exponential backoff with seeded jitter,
        doubling to the cap; BREAKER_FAILURES consecutive failures open
        the pool's circuit breaker for the max backoff."""
        pool.fails += 1
        pool.backoff_s = min(
            (pool.backoff_s * 2.0) if pool.backoff_s else self.backoff_s,
            self.backoff_max_s)
        jitter = 0.5 + self.rng.random()  # 0.5x-1.5x
        pool.backoff_until = now + pool.backoff_s * jitter
        if pool.fails >= BREAKER_FAILURES \
                and now >= pool.breaker_until:
            pool.breaker_until = now + self.backoff_max_s
            self.sched.metrics.inc(
                "provisioner_breaker_opens_total",
                labels={"pool": pool.template.pool})
            self.sched.flight.record(
                "provisioner_breaker_open", pool=pool.template.pool,
                fails=pool.fails, reason=why)

    def _write_off(self, now: float) -> None:
        """An in-flight request unanswered past the deadline is written
        off — failure-path backoff applies, and if the node still
        arrives later the reconcile pass adopts it."""
        for pool in self.pools.values():
            for rid, deadline in list(pool.deadlines.items()):
                if now < deadline:
                    continue
                pool.in_flight.pop(rid, None)
                pool.deadlines.pop(rid, None)
                pool.written_off += 1
                self.sched.metrics.inc(
                    "provision_requests_total",
                    labels={"outcome": "written-off"})
                self._fail(pool, now, "written-off")

    def _reconcile(self, now: float, summary: dict) -> None:
        """Membership reconciliation: every managed node (scv/pool
        label) must be accounted. One that is not — its request was
        written off, or a crashed fleet replica issued it — is ADOPTED:
        folded into the pool book this pass derives from cluster truth
        anyway, and counted so operators can see the lost-response path
        working. O(nodes), but only when membership actually moved."""
        vers = self._cluster().nodes_version
        if vers == self._nodes_vers:
            return
        self._nodes_vers = vers
        live = set()
        for n in self._cluster().node_names():
            pname = self._node_pool(n)
            if pname is None:
                continue
            live.add(n)
            if n not in self._known:
                self._known.add(n)
                self.sched.metrics.inc("provisioner_nodes_adopted_total")
                summary["adopted"] += 1
                pool = self.pools.get(pname)
                if pool is not None:
                    pool.last_delivery = now
                    # an adoption is a scale-up ARRIVAL from the pool's
                    # perspective: stamping it keeps the hysteresis
                    # window intact across fleet takeover (the new
                    # owner adopts the dead owner's fleet here, and
                    # must not turn around and release it within one
                    # window of the capacity having just arrived)
                    pool.last_scale_up = now
                    if pool.in_flight:
                        # the arrival implicitly answers the pool's
                        # OLDEST outstanding request (its response was
                        # lost): retire it as fulfilled rather than
                        # letting the write-off charge a failure for a
                        # node that actually came
                        rid = min(pool.in_flight)
                        pool.in_flight.pop(rid, None)
                        pool.deadlines.pop(rid, None)
                        pool.fails = 0
                        pool.backoff_s = 0.0
                        pool.backoff_until = 0.0
        self._known &= live  # released/flapped nodes leave the book
        for pool in self.pools.values():
            pool.empty_since = {n: t for n, t in pool.empty_since.items()
                                if n in live}
            pool.pending_release &= live

    # ----------------------------------------------------------- scale-up
    def _demand(self) -> list:
        """(info, spec) for every parked NON-harvest pod. Harvest pods
        are never demand: the fleet never grows for them and a parked
        harvest pod never holds a shrink back — they soak capacity that
        exists for other reasons, which is the whole class contract
        (and what lets scale-down use them as its shock absorber
        without the evictions re-inflating the pool)."""
        infos = (self.demand_fn() if self.demand_fn is not None
                 else self.sched.queue.parked_infos())
        out = []
        for info in infos:
            try:
                spec = spec_for(info.pod)
            except LabelError:
                continue
            if not spec.harvest:
                out.append((info, spec))
        return out

    def _scale_up(self, now: float, members: dict, sizes: dict,
                  demand: list, summary: dict) -> None:
        # unmet demand per pool: parked pods that FAILED a cycle, routed
        # by shape, counted only when they failed after the pool's last
        # delivery (a pod waiting out backoff against a node already on
        # its way is covered, not demand)
        routed: dict[str, dict[int, int]] = {}
        gang_routed: dict[str, set] = {}
        for info, spec in demand:
            if info.attempts < 1:
                continue
            for name, pool in self.pools.items():
                if not pool.template.satisfies(spec):
                    continue
                if info.backoff_started < pool.last_delivery:
                    break  # supplied; let the retry cycle judge it
                if spec.is_gang:
                    # one SLICE per distinct gang, however many members
                    # are parked — the whole gang lands on one slice
                    gang_routed.setdefault(name, set()).add(
                        spec.gang_name)
                else:
                    routed.setdefault(name, {})
                    routed[name][spec.chips] = \
                        routed[name].get(spec.chips, 0) + 1
                break  # first matching pool wins (registration order)
        for name, pool in self.pools.items():
            t = pool.template
            unit = max(t.hosts, 1)  # nodes one request delivers
            size = sizes.get(name, 0)
            # bounds maintenance: a pool below min scales up regardless
            # of demand (and regardless of hysteresis — min is a floor)
            want = 0
            by_chips = routed.get(name)
            if by_chips:
                for chips, count in sorted(by_chips.items()):
                    per_node = max(t.chips // max(chips, 1), 1)
                    want += -(-count // per_node)  # ceil
            want += len(gang_routed.get(name, ()))
            floor_deficit = -(-max(
                pool.min - size - len(pool.in_flight) * unit, 0) // unit)
            if pool.in_flight:
                # one wave at a time: outstanding requests cover the
                # current demand snapshot; re-evaluate at delivery
                want = 0
            want = max(want, floor_deficit)
            if want <= 0:
                continue
            if now < pool.breaker_until:
                self._skip("pool-breaker-open")
                continue
            if now < pool.backoff_until:
                self._skip("pool-backoff")
                continue
            guard = getattr(self.sched, "sloguard", None)
            if (not floor_deficit
                    and now - pool.last_scale_down < self.hysteresis_s
                    and not (guard is not None and guard.holding(now))):
                # hysteresis: never scale up within one window of our
                # own scale-down (flap damping; min-floor repair exempt,
                # and so is live SLO pressure — a flash crowd arriving
                # right after a valley scale-down must not wait out the
                # flap window while the serving class burns)
                self._skip("hysteresis")
                continue
            room = pool.max - size - len(pool.in_flight) * unit
            want = min(want, max(room, 0) // unit)
            if want <= 0:
                self._skip("pool-at-max")
                continue
            for _ in range(want):
                req = self.provider.request(name, t, now)
                pool.in_flight[req.id] = req
                pool.deadlines[req.id] = now + self.timeout_s
                summary["requested"] += 1
            pool.last_scale_up = now
            self.sched.metrics.inc("provisioner_scale_ups_total",
                                   labels={"pool": name}, by=want)

    # --------------------------------------------------------- scale-down
    def _scale_down(self, now: float, members: dict, sizes: dict,
                    demand: list, summary: dict) -> None:
        sched = self.sched
        busy_pools = {name for name in self.pools
                      if self.pools[name].in_flight}
        # interlocks: an open apiserver breaker or a dark telemetry
        # feed pauses scale-DOWN whole — never strand capacity on stale
        # data — while the scale-up half above keeps running degraded
        if now < sched._breaker_until:
            self._skip("breaker-open")
            return
        if sched._detect_degraded(now):
            self._skip("degraded")
            return
        guard = getattr(sched, "sloguard", None)
        if guard is not None and guard.holding(now):
            # SLO pressure (or shrunk capacity still owed back): every
            # chip is spoken for — releasing nodes now would force the
            # guard into deeper gang shrinks, and the give-back needs
            # the capacity intact to re-grow them
            self._skip("slo-pressure")
            return
        demand_pools = self._demanded_pools(demand)
        for name, pool in self.pools.items():
            managed = sorted(members.get(name, []))
            if not managed:
                pool.empty_since.clear()
                pool.pending_release.clear()
                continue
            if name in busy_pools or name in demand_pools:
                # demand present or a wave in flight: hands off — and
                # every cordoned candidate (armed for release OR
                # drained-empty awaiting cooldown) goes BACK to service:
                # the pending demand wants exactly that capacity, and
                # leaving it cordoned would starve a pod beside idle
                # chips
                unsched = getattr(self._cluster(),
                                  "node_unschedulable", None)
                for n in set(pool.pending_release) | set(pool.empty_since):
                    if unsched is None or unsched(n):
                        self._cordon(n, False)
                pool.pending_release.clear()
                continue
            if now - pool.last_scale_up < self.hysteresis_s:
                self._skip("hysteresis")
                continue
            surplus = sizes.get(name, 0) - pool.min
            if surplus <= 0:
                continue
            self._shrink_pool(pool, managed, surplus, now, summary)

    def _demanded_pools(self, demand: list) -> set:
        """Pools some pending non-harvest pod's shape routes to —
        scale-down keeps clear of them even before the demand becomes
        a request."""
        out: set = set()
        for _info, spec in demand:
            for name, pool in self.pools.items():
                if pool.template.satisfies(spec):
                    out.add(name)
                    break
        return out

    def _shrink_pool(self, pool: _Pool, managed: list, surplus: int,
                     now: float, summary: dict) -> None:
        sched = self.sched
        pods_on = self._cluster().pods_on
        # reserved targets (parked Permit holds, pending nominations)
        # count as occupancy: a node a gang member is assembling on is
        # not empty, whatever pods_on says
        reserved = {w.node for w in sched.waiting.values()}
        if pool.template.hosts > 1:
            self._shrink_slices(pool, managed, surplus, now, summary,
                                pods_on, reserved)
            return
        by_load = []
        for n in managed:
            load = len(pods_on(n))
            if n in reserved:
                load = max(load, 1)
            by_load.append((load, n))
        by_load.sort()
        released = 0
        # phase 2 first: cordoned pending_release nodes that stayed
        # empty a full interval actually release now
        for load, n in by_load:
            if released >= surplus:
                break
            if n not in pool.pending_release:
                continue
            pool.pending_release.discard(n)
            if load > 0:
                # a bind landed during the cordoned window: demand is
                # real — hand the node back
                self._cordon(n, False)
                pool.empty_since.pop(n, None)
                continue
            if self.provider.release(n, pool.template.pool):
                released += 1
                summary["released"] += 1
                pool.empty_since.pop(n, None)
                self._known.discard(n)
                pool.last_scale_down = now
                sched.metrics.inc("provisioner_nodes_released_total",
                                  labels={"pool": pool.template.pool})
                # routine planned behavior: ring + counter, no dump
                # (RING_ONLY_TRIPS, the defrag_pass discipline)
                sched.flight.record("pool_scaledown", node=n,
                                    pool=pool.template.pool)
        # phase 1: empty + cooldown-expired nodes cordon and arm
        for load, n in by_load:
            if released + len(pool.pending_release) >= surplus:
                break
            if n in pool.pending_release:
                continue
            if load > 0:
                pool.empty_since.pop(n, None)
                continue
            seen = pool.empty_since.setdefault(n, now)
            if now - seen < self.cooldown_s:
                continue
            self._cordon(n, True)
            pool.pending_release.add(n)
        # drain-and-consolidate: still over target with only non-empty
        # nodes left -> migrate the least-loaded node's residents off
        # (harvest first, free), bounded per pass. Nodes already empty
        # and merely waiting out their cooldown count toward the target
        # — draining a busy node while an empty one cools would release
        # more than the surplus asks for.
        cooling = sum(1 for n in pool.empty_since
                      if n not in pool.pending_release)
        if released + len(pool.pending_release) + cooling < surplus:
            self._drain_one(pool, by_load, now, summary, reserved)

    def _shrink_slices(self, pool: _Pool, managed: list, surplus: int,
                       now: float, summary: dict, pods_on,
                       reserved: set) -> None:
        """Slice-pool scale-down: every phase is WHOLE-SLICE atomic —
        per-host arming or release against a node-granular surplus
        would split an empty slice into a degraded remnant no gang can
        ever use. An armed slice where even one host took a bind (or a
        Permit reservation) during the cordoned window is handed back
        whole. With the torusPlacement knob on, a scale-down blocked on
        lightly-loaded slices migrates residents off ONE whole slice
        (_drain_slice) — otherwise slices never consolidate."""
        sched = self.sched
        units_budget = surplus // pool.template.hosts
        units_done = 0
        had_busy = False
        cooling_units = 0
        for sid, hosts in sorted(self._by_slice(managed).items()):
            busy = any(pods_on(h) or h in reserved for h in hosts)
            armed = [h for h in hosts if h in pool.pending_release]
            if armed:
                # resolve an armed slice whole: release all-or-nothing
                for h in hosts:
                    pool.pending_release.discard(h)
                if busy or len(armed) != len(hosts) \
                        or units_done >= units_budget:
                    for h in hosts:
                        self._cordon(h, False)
                        pool.empty_since.pop(h, None)
                    continue
                for h in hosts:
                    self.provider.release(h, pool.template.pool)
                    summary["released"] += 1
                    pool.empty_since.pop(h, None)
                    self._known.discard(h)
                    sched.metrics.inc(
                        "provisioner_nodes_released_total",
                        labels={"pool": pool.template.pool})
                    sched.flight.record("pool_scaledown", node=h,
                                        pool=pool.template.pool)
                pool.last_scale_down = now
                units_done += 1
                continue
            if busy:
                had_busy = True
                for h in hosts:
                    pool.empty_since.pop(h, None)
                continue
            if units_done + len(pool.pending_release) \
                    // pool.template.hosts >= units_budget:
                continue
            # stamp EVERY host's empty-since first, then judge: a
            # short-circuiting check would start the timers serially
            # and multiply the cooldown by the host count
            for h in hosts:
                pool.empty_since.setdefault(h, now)
            if any(now - pool.empty_since[h] < self.cooldown_s
                   for h in hosts):
                cooling_units += 1
                continue
            for h in hosts:
                self._cordon(h, True)
                pool.pending_release.add(h)
        # slice drain-and-reassemble: still over target with only busy
        # slices left. Empty slices merely cooling (or already armed)
        # count toward the target first — draining a busy slice while
        # an idle one cools would release more than the surplus asks.
        pending_units = len(pool.pending_release) // pool.template.hosts
        if had_busy and getattr(sched.config, "torus_placement", False) \
                and units_done + pending_units + cooling_units \
                < units_budget:
            self._drain_slice(pool, managed, now, summary, reserved)

    def _cordon(self, node: str, on: bool) -> None:
        c = self._cluster()
        cordon = getattr(c, "cordon_node", None)
        if cordon is not None:
            # wire backends (KubeCluster -> KubeClient.cordon_node): a
            # spec.unschedulable PATCH, exactly kubectl cordon — the flag
            # returns through the reflector watch so EVERY replica's
            # admission plugin starts filtering the node, not just ours
            try:
                cordon(node, on)
            except Exception:
                # best-effort like the rest of the release path: a failed
                # cordon leaves the node schedulable; the emptiness gate
                # below still guards the actual delete
                self.sched.metrics.inc("provision_cordon_errors_total")
            return
        setter = getattr(c, "set_node_meta", None)
        if setter is None:
            return  # backend can't cordon: release gates on emptiness alone
        labels, taints = c.node_meta(node)
        setter(node, labels=labels, taints=taints,
               allocatable=c.node_allocatable(node)
               if hasattr(c, "node_allocatable") else None,
               unschedulable=on)

    def _drain_one(self, pool: _Pool, by_load: list, now: float,
                   summary: dict, reserved: set = frozenset()) -> None:
        """Drain-and-consolidate ONE node, all-or-nothing: the plan is
        pre-flighted — every non-harvest resident must have a dry-run-
        proven destination BEFORE anything is evicted (harvest pods
        need none; they are the shock absorber and may simply park).
        A node whose plan cannot complete is left untouched and the
        pool's drain is pinned to the current version vector, so the
        wake loop never churns the same impossible drain — and never
        ping-pongs harvest pods on and off a node it cannot empty."""
        sched = self.sched
        vers = self._vers()
        if pool.drain_blocked_vers is not None \
                and pool.drain_blocked_vers == vers:
            return  # provably stuck since nothing changed
        candidate = None
        residents: list = []
        dests: dict[str, str] = {}
        planned: dict[str, int] = {}
        for load, n in by_load:
            if load <= 0 or load > self.max_drains \
                    or n in pool.pending_release or n in reserved:
                # reserved = a gang Permit is assembling here: draining
                # (or even cordoning) it would stall the assembly the
                # reservation exists to protect
                continue
            pods = [p for p in self._cluster().pods_on(n)
                    if not p.terminating]
            if not pods or not all(self._drainable(p) for p in pods):
                continue
            plan_d: dict[str, str] = {}
            plan_p: dict[str, int] = {}
            viable = True
            for p in pods:
                if is_harvest(p):
                    continue
                d = self._fits_elsewhere(p, n, plan_p)
                if d is None:
                    viable = False
                    break
                plan_d[p.key] = d
                try:
                    plan_p[d] = plan_p.get(d, 0) + spec_for(p).chips
                except LabelError:
                    pass
            if viable:
                candidate = n
                residents = pods
                dests = plan_d
                planned = plan_p
                break
        if candidate is None:
            pool.drain_blocked_vers = vers
            self._skip("drain-blocked")
            return
        pool.drain_blocked_vers = None
        # harvest first — the class contract — then the proven moves
        residents.sort(key=lambda p: (0 if is_harvest(p) else 1))
        self._cordon(candidate, True)
        local = getattr(sched.cluster, "supports_local_requeue", False)
        for p in residents:
            harvest = is_harvest(p)
            sched.cluster.evict(p)
            summary["drained"] += 1
            if harvest:
                sched.metrics.inc("harvest_evictions_total",
                                  labels={"reason": "scale-down"})
            else:
                sched.metrics.inc("provisioner_drain_evictions_total")
                dest = dests.get(p.key)
                if dest is not None and local \
                        and sched.allocator is not None:
                    try:
                        spec = spec_for(p)
                        sched.allocator.nominate(
                            p.key, dest, spec.chips, spec.priority,
                            cpu_millis=p.cpu_millis,
                            memory_bytes=p.memory_bytes,
                            host_ports=p.host_ports)
                    except LabelError:
                        pass
            if local:
                router = sched.victim_router or sched.submit
                router(p)
        # the drained node stays CORDONED and enters the empty-cooldown
        # pipeline: it releases through the ordinary two-phase path
        pool.empty_since.setdefault(candidate, now)
        pool.pending_release.discard(candidate)

    def _drain_slice(self, pool: _Pool, managed: list, now: float,
                     summary: dict, reserved: set = frozenset()) -> None:
        """Drain-and-reassemble ONE whole slice (torusPlacement knob):
        migrate every resident off the least-loaded busy slice so the
        freed slice conserves its carvable shape and releases through
        the ordinary whole-slice cooldown pipeline. Same all-or-nothing
        rails as _drain_one — every non-harvest resident must have a
        dry-run-proven destination OUTSIDE the slice (moving a victim
        onto a sibling host would just re-dirty the slice being freed)
        BEFORE anything is evicted, and a blocked plan pins the pool's
        drain to the version vector so the wake loop never churns the
        same impossible drain."""
        sched = self.sched
        vers = self._vers()
        if pool.drain_blocked_vers is not None \
                and pool.drain_blocked_vers == vers:
            return  # provably stuck since nothing changed
        loads = []
        for sid, hosts in sorted(self._by_slice(managed).items()):
            if any(h in pool.pending_release or h in reserved
                   for h in hosts):
                continue
            pods = [(p, h) for h in hosts
                    for p in self._cluster().pods_on(h)
                    if not p.terminating]
            if not pods:
                continue  # idle slice: the cooldown pipeline owns it
            loads.append((len(pods), sid, hosts, pods))
        loads.sort(key=lambda t: (t[0], t[1]))
        candidate = None
        for load, sid, hosts, pods in loads:
            if load > self.max_drains:
                continue
            if not all(self._drainable(p) for p, _ in pods):
                continue
            excluded = frozenset(hosts)
            plan_d: dict[str, str] = {}
            plan_p: dict[str, int] = {}
            viable = True
            for p, h in pods:
                if is_harvest(p):
                    continue
                d = self._fits_elsewhere(p, h, plan_p, exclude=excluded)
                if d is None:
                    viable = False
                    break
                plan_d[p.key] = d
                try:
                    plan_p[d] = plan_p.get(d, 0) + spec_for(p).chips
                except LabelError:
                    pass
            if viable:
                candidate = (sid, hosts, pods, plan_d)
                break
        if candidate is None:
            pool.drain_blocked_vers = vers
            self._skip("slice-drain-blocked")
            return
        pool.drain_blocked_vers = None
        sid, hosts, pods, dests = candidate
        # cordon the WHOLE slice up front: a bind landing on a sibling
        # host mid-drain would leave the slice busy again after all the
        # evictions were spent
        for h in hosts:
            self._cordon(h, True)
        local = getattr(sched.cluster, "supports_local_requeue", False)
        # harvest first — the class contract — then the proven moves
        pods.sort(key=lambda pr: (0 if is_harvest(pr[0]) else 1))
        for p, _ in pods:
            harvest = is_harvest(p)
            sched.cluster.evict(p)
            summary["drained"] += 1
            if harvest:
                sched.metrics.inc("harvest_evictions_total",
                                  labels={"reason": "scale-down"})
            else:
                sched.metrics.inc("provisioner_drain_evictions_total")
                dest = dests.get(p.key)
                if dest is not None and local \
                        and sched.allocator is not None:
                    try:
                        spec = spec_for(p)
                        sched.allocator.nominate(
                            p.key, dest, spec.chips, spec.priority,
                            cpu_millis=p.cpu_millis,
                            memory_bytes=p.memory_bytes,
                            host_ports=p.host_ports)
                    except LabelError:
                        pass
            if local:
                router = sched.victim_router or sched.submit
                router(p)
        # the drained slice stays CORDONED and enters the whole-slice
        # empty-cooldown pipeline: it releases atomically through the
        # ordinary two-phase path
        for h in hosts:
            pool.empty_since.setdefault(h, now)
            pool.pending_release.discard(h)
        sched.metrics.inc("provisioner_slice_drains_total",
                          labels={"pool": pool.template.pool})
        sched.flight.record("slice_drain", slice=sid,
                            pool=pool.template.pool, pods=len(pods))

    def _drainable(self, pod) -> bool:
        """May scale-down move this pod? Harvest pods always (evicted
        for free, eviction IS their contract); ordinary pods under the
        descheduler's shared eviction-safety predicate — never gang
        members, never protected priorities, never foreign profiles,
        never controllerless pods on a real cluster."""
        if pod.terminating:
            return False
        if is_harvest(pod):
            return True
        from ..deschedule import movable

        return movable(pod, self.sched, PROTECT_PRIORITY)

    def _fits_elsewhere(self, pod, src: str, planned: dict,
                        exclude: frozenset = frozenset()) -> str | None:
        """Dry-run the live filter path for a drain victim: the first
        node outside the shrinking candidate that accepts the pod as
        things stand (minus chips already promised to earlier victims
        of this drain). Mirrors deschedule._fits_elsewhere but any
        destination qualifies — consolidation packs the survivors onto
        whatever can hold them. `exclude` widens the off-limits set
        beyond src: a slice drain must land victims outside the WHOLE
        slice, not just off the victim's own host."""
        from ..framework import CycleState

        sched = self.sched
        try:
            spec = spec_for(pod)
        except LabelError:
            return None
        snapshot = sched.snapshot()
        state = CycleState()
        state.write("now", sched.clock.time())
        state.write("snapshot", snapshot)
        state.write("workload_spec", spec)
        for ni in snapshot.list():
            if ni.name == src or ni.name in exclude:
                continue
            if sched.allocator is not None:
                free = len(sched.allocator.free_coords(ni))
                if free - planned.get(ni.name, 0) < spec.chips:
                    continue
            ok = True
            for f in sched.profile.filter:
                if not f.filter(state, pod, ni).ok:
                    ok = False
                    break
            if ok:
                return ni.name
        return None

    # ---------------------------------------------------------- reporting
    def _publish(self, members: dict) -> None:
        for name in self.pools:
            self.sched.metrics.set_gauge(
                "pool_nodes", float(len(members.get(name, ()))),
                labels={"pool": name})
