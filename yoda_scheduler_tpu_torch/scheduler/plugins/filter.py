"""Filter plugin: node feasibility from live telemetry + allocation ledger.

Capability parity with the reference's three predicates
(pkg/yoda/filter/filter.go):
- PodFitsNumber (filter.go:11-16)  -> enough unclaimed healthy chips
- PodFitsMemory (filter.go:18-33)  -> >= N chips with free HBM >= scv/memory
- PodFitsClock  (filter.go:35-50)  -> >= N chips with clock >= scv/clock
  (>= semantics, resolving the ==-vs->= inconsistency; SURVEY §3.3)

plus TPU-native predicates the reference has no equivalent for:
- telemetry freshness (stale sniffer = unschedulable, not trusted)
- accelerator-type partition for mixed GPU+TPU clusters (BASELINE #5)
- allocation awareness: chips already claimed by bound pods and pending
  gang reservations are not offered twice (the reference re-offered the
  same cards until the live telemetry caught up)
- exact ICI block shape for ``tpu/topology`` requests
- gang pods only land on slices big enough for the whole gang, and stick
  to the slice the gang's first member chose.
"""

from __future__ import annotations

import time

from ..framework import (
    ClusterEvent,
    CycleState,
    EnqueueExtensions,
    FilterPlugin,
    NODE_ADDED,
    NODE_TELEMETRY_UPDATED,
    NodeInfo,
    POD_DELETED,
    QUEUE,
    SKIP,
    Status,
)
from ...topology.torus import fits_shape, parse_topology, best_fit_block
from ...utils.labels import WorkloadSpec
from .allocator import ChipAllocator, _node_shape
from .gang import GangCoordinator, bound_gang_members


class TelemetryFilter(FilterPlugin, EnqueueExtensions):
    name = "telemetry-filter"
    # advertises a verdict input that moves with TIME rather than with any
    # cluster version counter (telemetry staleness): the feasible-class
    # memo repair (core._repair_feasible) re-verifies staleness on
    # unchanged nodes only when an active filter declares this — profiles
    # without a staleness gate (reference emulation) must not have one
    # silently imposed on their repaired lists
    time_dependent = True

    def __init__(self, allocator: ChipAllocator, gangs: GangCoordinator | None = None,
                 telemetry_max_age_s: float = 60.0, require_contiguous: bool = False) -> None:
        self.allocator = allocator
        self.gangs = gangs
        self.max_age = telemetry_max_age_s
        self.require_contiguous = require_contiguous
        # verdict cache: the full capacity verdict (including its message
        # string — f-string builds dominate failing full-scan cycles at
        # 1000 nodes) per (spec, node serial, pending version, hold).
        # WorkloadSpec is a frozen dataclass, so it hashes by value and
        # identical label classes share entries. Time-dependent (staleness)
        # and externally-stateful (gang) checks stay OUTSIDE the cache.
        self._verdict_cache: dict[str, dict[tuple, Status]] = {}
        self._verdict_slots = 8

    def forget_nodes(self, gone: set[str]) -> None:
        for n in gone:
            self._verdict_cache.pop(n, None)

    def equivalence_key(self, pod):
        """Batch-cycle contract: every predicate here reads the parsed
        WorkloadSpec (chips / HBM / clock / accelerator / generation —
        all inside the engine's memo key) against node state; gang slice
        checks never apply because gang pods are excluded upstream by
        GangPermit's NO_BATCH vote."""
        return ()

    # ------------------------------------------------- queueing hints
    def events_to_register(self) -> tuple:
        """Events that can cure a capacity/staleness rejection: chips
        freed by a departing pod, a node joining, or a telemetry update.
        Deliberately NOT PodBound — binds only consume capacity, so a
        bind storm must not thundering-herd chip-starved pods back into
        the filter chain."""
        return (POD_DELETED, NODE_ADDED, NODE_TELEMETRY_UPDATED)

    def queueing_hint(self, event: ClusterEvent, pod) -> str:
        if event.kind != NODE_TELEMETRY_UPDATED:
            return QUEUE  # freed chips / a fresh node can always help
        old, new = event.old, event.new
        if new is None:
            return SKIP  # telemetry deletion never frees capacity
        if old is None:
            return QUEUE  # first report for this node = new capacity
        # a periodic republish with unchanged capacity must SKIP — the
        # sniffer fleet re-puts every few seconds, and waking every
        # parked pod each time would reintroduce the retry storm the
        # backoff existed to prevent. QUEUE only when the update could
        # flip a verdict this plugin produces:
        if (new.accelerator != old.accelerator
                or new.tpu_generation != old.tpu_generation
                or new.slice_id != old.slice_id
                or new.num_hosts != old.num_hosts):
            return QUEUE  # partition / slice-shape change
        if new.heartbeat - old.heartbeat > self.max_age:
            # the node skipped at least one max_age window: a pod may
            # have been rejected on staleness that this report cures
            return QUEUE
        nh, oh = new.healthy_chips(), old.healthy_chips()
        if len(nh) > len(oh):
            return QUEUE  # chips recovered
        if (max((c.hbm_free_mb for c in nh), default=0)
                > max((c.hbm_free_mb for c in oh), default=0)):
            return QUEUE  # freed HBM can cure a memory-class rejection
        if (max((c.clock_mhz for c in nh), default=0)
                > max((c.clock_mhz for c in oh), default=0)):
            return QUEUE
        return SKIP

    def native_filter_args(self, state: CycleState, pod, table):
        """Fused-kernel capability hook (framework.FilterPlugin): the
        same predicate PARAMETERS filter_batch evaluates, handed to the
        native kernel instead of computed in numpy. The veto set is
        filter_batch's exactly — anything the columns don't express
        keeps the pod off the native path entirely."""
        spec: WorkloadSpec = state.read("workload_spec")
        if spec.is_gang or spec.topology is not None:
            return None
        if self.require_contiguous and spec.chips > 1:
            return None
        if self.allocator.has_holds():
            return None
        args = {"tel_filter": 1, "max_age": float(self.max_age)}
        if spec.accelerator is not None:
            args["use_accel"] = 1
            args["accel_id"] = table.intern_of(spec.accelerator)
        if spec.tpu_generation is not None:
            args["use_gen"] = 1
            args["gen_id"] = table.intern_of(spec.tpu_generation)
        return args

    def filter_batch(self, state: CycleState, pod, table, rows=None):
        """Columnar verdicts for the capacity/staleness predicates —
        one boolean per node (whole table, or the `rows` subset the
        memo-repair paths re-filter), all in a handful of numpy calls.
        Bails (None) for everything the columns don't express: gang
        slice state, exact-topology / contiguity block search, and
        nominated-capacity holds. Predicate-for-predicate identical to
        `filter` for the pods it accepts (the checks are
        order-independent: a node passes iff it passes every one)."""
        spec: WorkloadSpec = state.read("workload_spec")
        if spec.is_gang or spec.topology is not None:
            return None
        if self.require_contiguous and spec.chips > 1:
            return None
        if self.allocator.has_holds():
            return None
        now = state.read_or("now")
        if now is None:
            now = time.time()
        if rows is None:
            valid, hb = table.valid, table.heartbeat
            accel, gen, fc = table.accel, table.gen, table.free_count
            _, qcount = table.qual(spec.min_free_mb, spec.min_clock_mhz)
        else:
            valid, hb = table.valid[rows], table.heartbeat[rows]
            accel, gen = table.accel[rows], table.gen[rows]
            fc = table.free_count[rows]
            q = (table.chip_free[rows]
                 & (table.chip_hbm_free[rows] >= spec.min_free_mb)
                 & (table.chip_clock[rows] >= spec.min_clock_mhz))
            qcount = q.sum(axis=1)
        # telemetry present + fresh (schema.stale: age > max_age);
        # blackout degraded mode waives freshness, same as `filter`
        if state.read_or("degraded"):
            ok = valid.copy()
        else:
            ok = valid & ((now - hb) <= self.max_age)
        if spec.accelerator is not None:
            ok &= accel == table.intern_of(spec.accelerator)
        if spec.tpu_generation is not None:
            ok &= gen == table.intern_of(spec.tpu_generation)
        # unclaimed-healthy-chip count, then the per-chip HBM/clock class
        # floors (allocator.class_stats' columnar twin); holds are zero
        # by the gate above
        ok &= fc >= spec.chips
        ok &= qcount >= spec.chips
        return ok

    def filter(self, state: CycleState, pod, node: NodeInfo) -> Status:
        spec: WorkloadSpec = state.read("workload_spec")
        m = node.metrics
        # telemetry presence: reference returns Unschedulable "Node:%v scv is not exist"
        # on cache miss (pkg/yoda/scheduler.go:80-84)
        if m is None:
            return Status.unschedulable(f"{node.name}: no accelerator telemetry")
        # degraded mode (engine-detected telemetry blackout): the WHOLE
        # feed is dark, so "stale" carries no per-node signal — waive the
        # gate and schedule off last-known capacity (the capacity
        # predicates below still apply) instead of rejecting every node
        if m.stale(now=state.read_or("now", time.time()),
                   max_age_s=self.max_age) \
                and not state.read_or("degraded"):
            return Status.unschedulable(f"{node.name}: telemetry stale")
        if spec.is_gang:
            return self._filter_checked(state, spec, pod, node, m)
        hold = self.allocator.holds_for(spec, node, pod.key,
                                        now=state.read_or("now"))
        key = (spec, node.serial,
               self.allocator.pending_version(node.name), hold)
        slot = self._verdict_cache.get(node.name)
        if slot is not None:
            hit = slot.get(key)
            if hit is not None:
                return hit
        st = self._filter_checked(state, spec, pod, node, m, hold)
        slot = self._verdict_cache.setdefault(node.name, {})
        slot[key] = st
        while len(slot) > self._verdict_slots:
            slot.pop(next(iter(slot)))
        return st

    def _filter_checked(self, state: CycleState, spec: WorkloadSpec, pod,
                        node: NodeInfo, m, hold: int | None = None) -> Status:
        if spec.accelerator is not None and m.accelerator != spec.accelerator:
            return Status.unschedulable(
                f"{node.name}: accelerator {m.accelerator} != requested {spec.accelerator}"
            )
        if spec.tpu_generation is not None and m.tpu_generation != spec.tpu_generation:
            return Status.unschedulable(
                f"{node.name}: generation {m.tpu_generation or 'unset'}"
                f" != requested {spec.tpu_generation}"
            )

        # gang constraints: the gang fits one slice (and sticks to the
        # chosen one) — or, when no single slice can host it, follows its
        # multi-slice plan within per-slice quotas (GangPermit.pre_filter)
        if spec.is_gang:
            if not m.slice_id:
                return Status.unschedulable(f"{node.name}: gang pod needs a pod-slice node")
            plan_quota = (self.gangs.quota_left(spec.gang_name, m.slice_id)
                          if self.gangs is not None else None)
            if plan_quota is not None:
                if plan_quota <= 0:
                    return Status.unschedulable(
                        f"{node.name}: slice {m.slice_id} quota filled for "
                        f"gang {spec.gang_name}"
                    )
            else:
                if m.num_hosts < spec.gang_size:
                    return Status.unschedulable(
                        f"{node.name}: slice {m.slice_id} has {m.num_hosts} hosts < gang size {spec.gang_size}"
                    )
                if self.gangs is not None:
                    chosen = self.gangs.chosen_slice(spec.gang_name)
                    if chosen is None:
                        # partially-bound gang (peer bind failure / scheduler
                        # restart): members already on a slice pin the choice
                        # even though the coordinator's state is gone
                        _, chosen, _ = bound_gang_members(state, spec.gang_name)
                    if chosen is not None and chosen != m.slice_id:
                        return Status.unschedulable(
                            f"{node.name}: gang {spec.gang_name} is placing on slice {chosen}"
                        )

        # chips-count predicate over *unclaimed* healthy chips, minus
        # capacity held for nominated preemptors of >= priority (upstream
        # nominated-pod semantics: don't schedule into a freshly-preempted
        # hole that a higher-priority pod is entitled to)
        free = self.allocator.free_coords(node)
        if hold is None:
            hold = self.allocator.holds_for(spec, node, pod.key,
                                            now=state.read_or("now"))
        if len(free) - hold < spec.chips:
            return Status.unschedulable(
                f"{node.name}: {len(free)} unclaimed healthy chips"
                + (f" ({hold} held for nominated preemptors)" if hold else "")
                + f" < {spec.chips} requested"
            )

        # per-chip memory + clock predicates over unclaimed healthy chips
        # (aggregates memoised per (node state, label class) — see
        # allocator.ClassStats)
        stats = self.allocator.class_stats(node, spec.min_free_mb,
                                           spec.min_clock_mhz)
        if stats.count - hold < spec.chips:
            return Status.unschedulable(
                f"{node.name}: only {stats.count} chips satisfy "
                f"hbm>={spec.min_free_mb}MB clock>={spec.min_clock_mhz}MHz "
                f"(need {spec.chips})"
            )

        # exact topology request must fit contiguously
        if spec.topology is not None:
            if fits_shape(_node_shape(m), stats.qcoords,
                          parse_topology(spec.topology)) is None:
                return Status.unschedulable(
                    f"{node.name}: no free contiguous {spec.topology} block"
                )
        elif self.require_contiguous and spec.chips > 1:
            if best_fit_block(_node_shape(m), stats.qcoords, spec.chips) is None:
                return Status.unschedulable(
                    f"{node.name}: no contiguous block of {spec.chips} chips"
                )

        return Status.success()
