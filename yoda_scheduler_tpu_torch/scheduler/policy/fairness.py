"""Multi-tenant fairness: DRF accounting, quotas, queue ordering,
preemption budgets.

The unit of tenancy is the scv/tenant label (falling back to the pod's
namespace — utils.labels.tenant_of). Quotas are HIERARCHICAL by path:
tenant "acme/ml" is capped by its own quota AND by "acme"'s, with a
parent's usage aggregating every descendant — the usual org/team shape.

Dominant-resource fairness (Ghodsi et al., via the Gavel/Tesserae
multi-tenant framing in PAPERS.md): a tenant's DOMINANT SHARE is the
max over resources (chips, HBM) of used/cluster-capacity. The DRFBook
maintains per-tenant usage INCREMENTALLY from the cluster's bind/unbind
change logs — the same directed logs the columnar table and class memos
consume — so a refresh costs O(dirty nodes), not a cluster walk. It
reads CLUSTER TRUTH (bound pods), never engine-side bookkeeping: in a
scheduler fleet, a replica's optimistically-committed bind only enters
the book once the authority accepted it, and a 409'd commit never does
— which is the whole shared-correctness argument (each replica's book
converges on the same cluster state; pinned by tests/test_policy.py).

Enforcement has three teeth, each its own knob:

- ``TenantQuotaGate`` (PreFilter): a pod whose bind would push any
  quota level over its cap is unschedulable NOW (it wakes event-driven
  when capacity frees). Tenants without a configured quota are
  work-conserving — never gated.
- ``TenantFairnessSort`` (QueueSort): within a scv/priority band,
  tenants with LOWER dominant share schedule first — DRF's pick-the-
  poorest rule as a queue ordering, converging shares toward quota
  proportions under contention.
- ``PreemptionBudgets``: per-tenant cap on how many of a tenant's
  bound pods may be evicted by preemption per rolling window. The
  engine gates the existing preempt/victim-drain path on it — a plan
  that would overdraw ANY victim tenant's budget is refused outright
  (the PDB ledger still ranks plans below the budget, so both layers
  hold).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..framework import (
    CycleState,
    EnqueueExtensions,
    NODE_ADDED,
    NO_BATCH,
    POD_DELETED,
    PreFilterPlugin,
    QUEUE,
    QueuedPodInfo,
    Snapshot,
    Status,
)
from ..plugins.sort import PrioritySort, constraint_rank
from ...utils.labels import (
    GANG_NAME_LABEL, LabelError, spec_for, tenant_of)


@dataclass(frozen=True)
class TenantQuota:
    """One configured tenant: `quota` is the dominant-share cap in
    [0, 1] (0 = no cap), `preemption_budget` the max victims this
    tenant may LOSE to preemption per window (-1 = unlimited)."""

    name: str
    quota: float = 0.0
    preemption_budget: int = -1


def _ancestors(tenant: str):
    """The tenant itself, then each ancestor path ("a/b/c" -> a/b/c,
    a/b, a) — the quota levels a pod is checked against."""
    yield tenant
    while "/" in tenant:
        tenant = tenant.rsplit("/", 1)[0]
        yield tenant


class DRFBook:
    """Per-tenant resource usage + dominant shares, incremental from
    the cluster change logs (module docstring). Engine-thread-only,
    like the memos: refresh() runs inside the cycle/bind paths."""

    def __init__(self, cluster, metrics=None, flight=None,
                 quotas: dict[str, TenantQuota] | None = None,
                 serving_reserve_pct: float = 0.0) -> None:
        self.cluster = cluster
        self.metrics = metrics
        self.flight = flight
        self.quotas = quotas or {}
        # node -> {tenant: (chips, hbm_mb)} — the per-node slices the
        # change logs repair; totals are their fold
        self._node_usage: dict[str, dict[str, tuple[int, int]]] = {}
        self._usage: dict[str, list[int]] = {}  # leaf tenant -> [chips, hbm]
        # all-tenant totals, maintained delta-wise alongside _usage —
        # the workload-admission tier's live free-capacity read
        self._total = [0, 0]
        # serving-headroom reservation: the scv/serving class
        # is carved its own quota LEVEL above every tenant — the
        # NON-serving aggregate may never occupy more than
        # (1 - pct) of cluster chips. 0 tracks nothing (bit-identical
        # to the pre-SLO book).
        self._serve_pct = serving_reserve_pct
        # node -> (chips, hbm) used by serving pods; total is the fold
        self._node_serving: dict[str, tuple[int, int]] = {}
        self._serving_total = [0, 0]
        # share-movement listeners (queue.TenantShareBands.mark_dirty):
        # called with each quota LEVEL whose usage moved, or None when
        # capacity rescaled every share. Engine-thread like refresh().
        self._share_listeners: list = []
        # hierarchical rollup: every quota LEVEL (the tenant and each
        # path ancestor) -> [chips, hbm], maintained delta-wise in
        # _apply_node so usage_of/dominant_share are O(1) dict reads —
        # a prefix scan over all tenants per query made the quota gate
        # O(depth*T) per cycle at the thousands-of-tenants target
        self._levels: dict[str, list[int]] = {}
        self._cursor: int | None = None  # pods_global_version watermark
        # capacity memo keyed by (nodes_version, telemetry version)
        self._cap_key: tuple | None = None
        self._capacity = (0, 0)  # (chips, hbm_mb)
        # quota-breach flight trips rate-limit: one per tenant per
        # breach episode (cleared when the share drops back under)
        self._breached: set[str] = set()
        # tenants whose gauge we last published: a tenant whose usage
        # drains to zero must publish a FINAL 0.0, or /metrics reports
        # its last non-zero share forever
        self._published: set[str] = set()
        self.rebuilds = 0
        self.repairs = 0

    # ------------------------------------------------------------ accounting
    @staticmethod
    def _pod_demand(pod) -> tuple[int, int]:
        try:
            spec = spec_for(pod)
        except LabelError:
            return (0, 0)
        return (spec.chips, spec.min_free_mb * spec.chips)

    def _scan_node(self, node: str) -> dict[str, tuple[int, int]]:
        out: dict[str, list[int]] = {}
        for p in self.cluster.pods_on(node):
            chips, hbm = self._pod_demand(p)
            if not chips and not hbm:
                continue
            u = out.setdefault(tenant_of(p), [0, 0])
            u[0] += chips
            u[1] += hbm
        return {t: (u[0], u[1]) for t, u in out.items()}

    def _delta(self, tenant: str, dc: int, dh: int) -> None:
        """Fold a usage delta into the leaf map and every ancestor
        level's rollup."""
        u = self._usage.setdefault(tenant, [0, 0])
        u[0] += dc
        u[1] += dh
        if not u[0] and not u[1]:
            del self._usage[tenant]
        self._total[0] += dc
        self._total[1] += dh
        for level in _ancestors(tenant):
            lv = self._levels.setdefault(level, [0, 0])
            lv[0] += dc
            lv[1] += dh
            if not lv[0] and not lv[1]:
                del self._levels[level]
            for cb in self._share_listeners:
                cb(level)

    def _scan_serving(self, node: str) -> tuple[int, int]:
        c = h = 0
        for p in self.cluster.pods_on(node):
            try:
                if not spec_for(p).serving:
                    continue
            except LabelError:
                continue
            dc, dh = self._pod_demand(p)
            c += dc
            h += dh
        return (c, h)

    def _apply_node(self, node: str, fresh: dict) -> None:
        if self._serve_pct > 0.0:
            # BEFORE the tenant-view early return: a pod's serving flag
            # can move without moving its tenant's usage slice
            s = self._scan_serving(node)
            old_s = self._node_serving.get(node, (0, 0))
            if s != old_s:
                self._serving_total[0] += s[0] - old_s[0]
                self._serving_total[1] += s[1] - old_s[1]
                if s == (0, 0):
                    self._node_serving.pop(node, None)
                else:
                    self._node_serving[node] = s
        old = self._node_usage.get(node, {})
        if old == fresh:
            return
        for t, (c, h) in old.items():
            self._delta(t, -c, -h)
        for t, (c, h) in fresh.items():
            self._delta(t, c, h)
        if fresh:
            self._node_usage[node] = fresh
        else:
            self._node_usage.pop(node, None)

    def _rebuild(self) -> None:
        # one shared accumulate path with the incremental repair: a
        # future change to the accounting (a third resource axis) must
        # not be able to diverge the two
        self._node_usage = {}
        self._usage = {}
        self._levels = {}
        self._total = [0, 0]
        self._node_serving = {}
        self._serving_total = [0, 0]
        for node in self.cluster.node_names():
            self._apply_node(node, self._scan_node(node))
        for cb in self._share_listeners:
            cb(None)  # everything may have moved
        self.rebuilds += 1

    def refresh(self) -> None:
        """Bring usage and capacity to the cluster's current version.
        O(dirty) off the change log; full rebuild when the log was
        trimmed or the backend exposes no counters. Gauges republish
        only when something actually MOVED — the quota gate refreshes
        once per cycle, and paying the all-tenants publish walk on
        every no-change cycle was measurable hot-path waste."""
        changed = False
        ver = getattr(self.cluster, "pods_global_version", None)
        csince = getattr(self.cluster, "changes_since", None)
        if ver is None or csince is None:
            self._rebuild()
            changed = True
        elif self._cursor is None:
            self._rebuild()
            self._cursor = ver
            changed = True
        elif ver != self._cursor:
            _, dirty = csince(self._cursor)
            if dirty is None:
                self._rebuild()
            else:
                for node in dirty:
                    self._apply_node(node, self._scan_node(node))
                self.repairs += 1
            self._cursor = ver
            changed = True
        if self._refresh_capacity() or changed:
            self._publish()

    def _refresh_capacity(self) -> bool:
        tel = getattr(self.cluster, "telemetry", None)
        key = (getattr(self.cluster, "nodes_version", None),
               getattr(tel, "resource_version", None))
        if key == self._cap_key and key != (None, None):
            return False
        chips = hbm = 0
        if tel is not None:
            members = set(self.cluster.node_names())
            for m in tel.list():
                if m.node not in members:
                    continue
                chips += len(m.chips)
                hbm += m.hbm_total_sum
        changed = (chips, hbm) != self._capacity
        self._cap_key = key
        self._capacity = (chips, hbm)
        if changed:
            # every dominant share rescales with the denominators
            for cb in self._share_listeners:
                cb(None)
        return True

    # --------------------------------------------------------------- queries
    def add_share_listener(self, cb) -> None:
        """Register a share-movement callback (cb(level | None)): every
        quota level whose usage moves is reported, None means capacity
        rescaled all shares. The exact-at-pop DRF queue and the workload
        admission tier keep their tenant-share heaps current off this."""
        self._share_listeners.append(cb)

    def total_usage(self) -> tuple[int, int]:
        """(chips, hbm_mb) used across ALL tenants — with capacity(),
        the live free-capacity read workload admission gates on."""
        return (self._total[0], self._total[1])

    @property
    def capacity(self) -> tuple[int, int]:
        return self._capacity

    def usage_of(self, tenant: str) -> tuple[int, int]:
        """(chips, hbm_mb) used by `tenant` and every descendant —
        O(1) off the hierarchical rollup _apply_node maintains."""
        u = self._levels.get(tenant)
        return (u[0], u[1]) if u is not None else (0, 0)

    def dominant_share(self, tenant: str, extra: tuple[int, int] = (0, 0)
                       ) -> float:
        cap_c, cap_h = self._capacity
        c, h = self.usage_of(tenant)
        c += extra[0]
        h += extra[1]
        share = 0.0
        if cap_c:
            share = c / cap_c
        if cap_h:
            share = max(share, h / cap_h)
        return share

    def tenants(self) -> set[str]:
        """Every tenant with live usage or a configured quota."""
        return set(self._usage) | set(self.quotas)

    def would_exceed(self, tenant: str, demand: tuple[int, int],
                     inflight=None) -> str | None:
        """First quota level (the tenant or an ancestor) whose cap the
        added demand would push past; None = admissible. `inflight`
        (level -> (chips, hbm)) adds engine-local claims not yet in
        cluster truth — the quota gate passes the admitted-gang
        ledger through it."""
        for level in _ancestors(tenant):
            q = self.quotas.get(level)
            if q is None or q.quota <= 0.0:
                continue
            extra = demand
            if inflight is not None:
                ic, ih = inflight(level)
                extra = (demand[0] + ic, demand[1] + ih)
            if self.dominant_share(level, extra=extra) > q.quota + 1e-9:
                return level
        return None

    def serving_usage(self) -> tuple[int, int]:
        """(chips, hbm_mb) used by the scv/serving class cluster-wide
        (tracked only when a headroom reservation is configured)."""
        return (self._serving_total[0], self._serving_total[1])

    def serving_headroom_chips(self) -> float:
        """Unused reserved headroom: reservation minus serving usage,
        floored at zero (serving may legitimately spill past its
        reservation — the reservation is a floor for serving, a ceiling
        for everyone else)."""
        if self._serve_pct <= 0.0:
            return 0.0
        return max(self._serve_pct * self._capacity[0]
                   - self._serving_total[0], 0.0)

    def nonserving_over_reserve(self, chips_demand: int) -> bool:
        """Whether adding `chips_demand` non-serving chips would push
        the NON-serving aggregate past its ceiling of
        (1 - reserve) * capacity — the serving-headroom quota level's
        admission check. Capacity-less clusters gate nothing (the
        ordinary filters own that case)."""
        if self._serve_pct <= 0.0:
            return False
        cap_c = self._capacity[0]
        if not cap_c:
            return False
        ceiling = (1.0 - self._serve_pct) * cap_c
        used = self._total[0] - self._serving_total[0]
        return used + chips_demand > ceiling + 1e-9

    # ---------------------------------------------------------- observability
    def _publish(self) -> None:
        if self.metrics is None:
            return
        if self._serve_pct > 0.0:
            self.metrics.set_gauge("serving_headroom_chips",
                                   round(self.serving_headroom_chips(), 3))
        live = self.tenants()
        for gone in self._published - live:
            self.metrics.set_gauge("tenant_dominant_share", 0.0,
                                   labels={"tenant": gone})
        self._published = set(live)
        for t in live:
            share = self.dominant_share(t)
            self.metrics.set_gauge("tenant_dominant_share", share,
                                   labels={"tenant": t})
            q = self.quotas.get(t)
            if q is not None and q.quota > 0.0:
                if share > q.quota + 1e-9:
                    # a BREACH: the cap is already exceeded in cluster
                    # truth (pre-existing pods, a foreign scheduler, a
                    # quota lowered mid-flight) — the gate can only stop
                    # FURTHER binds, so record the state loudly, once
                    # per episode
                    if t not in self._breached:
                        self._breached.add(t)
                        self.metrics.inc("tenant_quota_breaches_total",
                                         labels={"tenant": t})
                        if self.flight is not None:
                            self.flight.record(
                                "tenant_quota_breach", tenant=t,
                                share=round(share, 4), quota=q.quota)
                else:
                    self._breached.discard(t)


class TenantQuotaGate(PreFilterPlugin, EnqueueExtensions):
    """PreFilter: refuse a pod whose bind would push any quota level of
    its tenant over the cap. Node-independent (one check per cycle, not
    per node); tenants with no configured quota anywhere on their path
    pass untouched (work-conserving)."""

    name = "tenant-quota-gate"

    def __init__(self, policy: "PolicyEngine") -> None:
        self.policy = policy

    def equivalence_key(self, pod):
        """Batch-cycle audit: for a QUOTA'D tenant
        the verdict moves with every same-tenant bind — including OUR
        OWN mid-batch commits, which the batch loop would not re-check —
        so quota'd pods never batch. Unquota'd tenants' pre_filter is a
        no-op by construction (always SUCCESS, no state written), which
        is exactly the contract a key asserts; the tenant rides the key
        so classes can never mix tenants."""
        tenant = tenant_of(pod)
        for level in _ancestors(tenant):
            q = self.policy.quotas.get(level)
            if q is not None and q.quota > 0.0:
                return NO_BATCH
        return (tenant,)

    def events_to_register(self):
        # a same-tenant pod leaving frees share; new capacity shrinks
        # every share — either can cure an over-quota rejection
        return (POD_DELETED, NODE_ADDED)

    def queueing_hint(self, event, pod) -> str:
        return QUEUE

    def pre_filter(self, state: CycleState, pod, snapshot: Snapshot) -> Status:
        book = self.policy.book
        if book is None:
            return Status.success()
        tenant = tenant_of(pod)
        spec = state.read_or("workload_spec")
        if spec is None:
            try:
                spec = spec_for(pod)
            except LabelError:
                return Status.success()  # the filter owns malformed pods
        book.refresh()
        # a gang member is gated on the WHOLE gang's demand: siblings
        # parked at Permit hold no cluster-truth usage yet, so per-member
        # gating would admit each member against the same headroom and
        # the completed gang would bind past the cap at once.
        # Conservative at the boundary: a straggler REJOINING an
        # already-bound gang re-counts its bound peers (they are in the
        # book too) and may be over-rejected near the cap — it wakes
        # event-driven like any other quota rejection; the safety side
        # of a cap is the right side to err on.
        mult = max(spec.gang_size, 1) if spec.is_gang else 1
        demand = (spec.chips * mult, spec.min_free_mb * spec.chips * mult)
        # ...and admitted-but-unbound gangs hold an ENGINE-LOCAL
        # in-flight claim (PolicyEngine._gang_inflight): without it a
        # SECOND same-tenant gang would be gated against the same
        # headroom while the first is still assembling at Permit, and
        # both would bind past the cap together
        now = state.read_or("now")
        exclude = spec.gang_name if spec.is_gang else None
        level = book.would_exceed(
            tenant, demand,
            inflight=lambda lvl: self.policy.gang_inflight(
                lvl, exclude, now))
        if level is None and spec.is_gang:
            # admitted: record (idempotently) the whole gang's claim
            # until it binds (retired in PolicyEngine.on_bind) or its
            # assembly window expires
            self.policy.note_gang_admitted(spec.gang_name, tenant,
                                           demand, now)
        if level is None:
            return Status.success()
        if self.policy.metrics is not None:
            self.policy.metrics.inc("tenant_quota_rejections_total",
                                    labels={"tenant": tenant})
        q = self.policy.quotas[level]
        return Status.unschedulable(
            f"tenant {tenant} over quota: dominant share would exceed "
            f"{q.quota:.2f} at level {level}")


class TenantFairnessSort(PrioritySort):
    """QueueSort: strict scv/priority first (priority semantics are
    never traded away), then DRF's pick-the-poorest — the tenant with
    the LOWER dominant share schedules first — then the existing
    most-constrained/FIFO tie-breaks.

    The tenant-selection half no longer lives in this comparator: an earlier design
    sampled each pod's share AT QUEUE ENTRY (heap keys are computed at
    entry — the queue's ordering contract) and the order went stale the
    moment any bind moved the book, converging only round-by-round
    through backoff re-entries. That stale path is DELETED: the plugin
    now marks itself `sharded_drf`, and the engine builds a
    DRFShardedQueue (queue.py) — per-tenant sharded priority bands
    whose tenant pick reads the LIVE book at pop time through an
    O(log tenants) share heap. This class contributes the band inputs:
    the priority, the intra-tenant order (constraint rank, FIFO), and
    the tenant-carrying equivalence key. less()/key() stay the
    PrioritySort order so any comparator-mode fallback remains a strict
    weak order (tests/test_policy.py pins the at-pop convergence a
    sampled key provably fails)."""

    name = "tenant-fairness-sort"
    # the engine builds the sharded exact-at-pop DRF queue for this sort
    sharded_drf = True

    def __init__(self, policy: "PolicyEngine") -> None:
        self.policy = policy

    def equivalence_key(self, pod):
        """Ordering reads priority/constraint labels (inside the spec)
        plus the TENANT — classmates must share it, or a batch gather
        would advance one tenant's pods on another's share."""
        return (tenant_of(pod),)

    @staticmethod
    def subkey(info: QueuedPodInfo):
        """Intra-tenant order inside a priority band: most-constrained
        first, then FIFO — the non-tenant half of PrioritySort.key."""
        return (-constraint_rank(info), info.enqueued)


class PreemptionBudgets:
    """Per-tenant rolling-window cap on preemption VICTIMS. `admits`
    asks whether a whole victim plan fits every affected tenant's
    remaining budget — all-or-nothing, so a plan can never be half
    charged; `charge` burns it when the engine actually evicts."""

    def __init__(self, quotas: dict[str, TenantQuota],
                 window_s: float = 60.0, metrics=None) -> None:
        self.quotas = quotas
        self.window_s = window_s
        self.metrics = metrics
        self._events: dict[str, deque] = {}  # tenant -> eviction stamps

    def _budget_of(self, tenant: str) -> tuple[str, int] | None:
        """Nearest configured budget level on the tenant's path."""
        for level in _ancestors(tenant):
            q = self.quotas.get(level)
            if q is not None and q.preemption_budget >= 0:
                return level, q.preemption_budget
        return None

    def _spent(self, level: str, now: float) -> int:
        dq = self._events.get(level)
        if dq is None:
            return 0
        if self.window_s > 0:
            floor = now - self.window_s
            while dq and dq[0] <= floor:
                dq.popleft()
        return len(dq)

    def has_budget(self, tenant: str, now: float) -> bool:
        """At least one victim's worth of remaining budget at the
        tenant's budget level (True when no budget is configured) —
        the planner's route-around predicate (victim_budget_ok)."""
        b = self._budget_of(tenant)
        if b is None:
            return True
        level, budget = b
        return self._spent(level, now) < budget

    def admits(self, victims, now: float) -> bool:
        need: dict[str, int] = {}
        for v in victims:
            b = self._budget_of(tenant_of(v))
            if b is not None:
                need[b[0]] = need.get(b[0], 0) + 1
        for level, n in need.items():
            _, budget = self._budget_of(level)  # level IS configured
            if self._spent(level, now) + n > budget:
                if self.metrics is not None:
                    self.metrics.inc("preemptions_budget_denied_total",
                                     labels={"tenant": level})
                return False
        return True

    def charge(self, victims, now: float) -> None:
        for v in victims:
            b = self._budget_of(tenant_of(v))
            if b is not None:
                self._events.setdefault(b[0], deque()).append(now)

    def spent(self, tenant: str, now: float) -> int:
        """Window-resident evictions charged at `tenant`'s budget level
        (test/bench read)."""
        b = self._budget_of(tenant)
        return self._spent(b[0], now) if b is not None else 0


class PolicyEngine:
    """The policy subsystem's shared state, one per engine replica:
    throughput model, tenant quotas, DRF book, preemption budgets,
    starvation watch. Built plugin-side (default_profile / registry)
    from the config alone; the engine attaches its cluster/metrics/
    flight/clock at construction (Scheduler.__init__), after which the
    gates go live. Replicas of a fleet each attach their own engine's
    surfaces to their own PolicyEngine — the books all read the one
    cluster, which is what keeps the shared accounting correct under
    optimistic multi-replica commits (module docstring)."""

    def __init__(self, config) -> None:
        from .heterogeneity import ThroughputModel

        self.config = config
        self.model = ThroughputModel(
            {c: dict(gens) for c, gens in config.workload_classes})
        self.quotas: dict[str, TenantQuota] = {
            name: TenantQuota(name, float(q), int(b))
            for name, q, b in config.tenant_quotas}
        self.budgets = PreemptionBudgets(
            self.quotas, window_s=config.preemption_budget_window_s)
        self.book: DRFBook | None = None
        self.metrics = None
        self.flight = None
        self.clock = None
        # pods already flagged as starving (one trip per pod, bounded
        # like the engine's failed/quarantined maps)
        self._starved: set[str] = set()
        # gang name -> (tenant, (chips, hbm), expires_at): whole-gang
        # claims ADMITTED by the quota gate but not yet in cluster truth
        # (members parked at Permit). Counted against the tenant's
        # headroom so a second gang cannot ride the same gap; retired
        # when a member binds (cluster truth then covers the gang) or
        # when the assembly window expires (2x gang_timeout_s — the same
        # bound the allocator's gang nomination uses)
        self._gang_inflight: dict[str, tuple[str, tuple[int, int],
                                             float]] = {}

    def attach(self, cluster, metrics, flight, clock) -> None:
        self.metrics = metrics
        self.flight = flight
        self.clock = clock
        self.budgets.metrics = metrics
        reserve = (getattr(self.config, "serving_headroom_pct", 0.0)
                   if getattr(self.config, "slo_serving", False) else 0.0)
        self.book = DRFBook(cluster, metrics=metrics, flight=flight,
                            quotas=self.quotas,
                            serving_reserve_pct=reserve)

    # ------------------------------------------------------------- fair share
    def fair_share(self, tenant: str) -> float:
        """The tenant's entitlement: its configured quota when set, else
        an equal split among currently-known tenants (the DRF default
        when no quotas are declared)."""
        for level in _ancestors(tenant):
            q = self.quotas.get(level)
            if q is not None and q.quota > 0.0:
                return q.quota
        if self.book is None:
            return 0.0
        n = len(self.book.tenants()) or 1
        return 1.0 / n

    # --------------------------------------------------------- gang in-flight
    def note_gang_admitted(self, gang: str, tenant: str,
                           demand: tuple[int, int],
                           now: float | None) -> None:
        # claims are only ever CONSULTED at positive-quota levels, so a
        # tenant with no quota anywhere on its path records nothing —
        # otherwise churning never-binding gangs (unique names, no
        # quota'd tenant to prune via would_exceed's lazy expiry) would
        # grow the dict without bound in a long-lived process
        if not any(q is not None and q.quota > 0.0
                   for q in (self.quotas.get(l)
                             for l in _ancestors(tenant))):
            return
        ttl = 2 * getattr(self.config, "gang_timeout_s", 30.0)
        expires = (now + ttl) if now is not None else float("inf")
        if now is not None and len(self._gang_inflight) > 64:
            # backstop sweep alongside gang_inflight()'s lazy pruning
            for g, (_, _, exp) in list(self._gang_inflight.items()):
                if now > exp:
                    del self._gang_inflight[g]
        self._gang_inflight[gang] = (tenant, demand, expires)

    def gang_inflight(self, level: str, exclude: str | None,
                      now: float | None) -> tuple[int, int]:
        """Summed in-flight gang claims charged at `level` (the tenant
        or a path ancestor), excluding `exclude`'s own gang. Expired
        entries prune lazily."""
        if not self._gang_inflight:
            return (0, 0)
        c = h = 0
        prefix = level + "/"
        for gang, (tenant, demand, expires) in list(
                self._gang_inflight.items()):
            if now is not None and now > expires:
                del self._gang_inflight[gang]
                continue
            if gang == exclude:
                continue
            if tenant == level or tenant.startswith(prefix):
                c += demand[0]
                h += demand[1]
        return (c, h)

    # ------------------------------------------------------------ engine hooks
    def on_bind(self, pod=None) -> None:
        """Post-bind bookkeeping: fold the bind into the DRF book (one
        dirty node off the change log) and republish shares/breaches.
        A gang member binding retires its gang's in-flight claim —
        cluster truth covers the gang from here."""
        if pod is not None and self._gang_inflight:
            gang = pod.labels.get(GANG_NAME_LABEL)
            if gang:
                self._gang_inflight.pop(gang, None)
        if self.book is not None:
            self.book.refresh()

    def gang_failed(self, gang: str) -> None:
        """Assembly failed (Permit timeout, doomed gang, external
        deletion of a parked member): retire the gang's engine-local
        in-flight quota claim NOW. Without this the claim lingered until
        its TTL (2x gang_timeout_s), gating same-tenant admissions
        against headroom the dead assembly no longer holds — the engine
        calls this from every fail_gang path."""
        self._gang_inflight.pop(gang, None)

    def note_wait(self, pod, waited_s: float) -> None:
        """Starvation watch: a pod still unbound past the configured
        threshold trips the flight recorder once and counts per tenant
        — the black box the fairness fuzz and operators read."""
        limit = self.config.starvation_after_s
        if limit <= 0 or waited_s < limit or pod.key in self._starved:
            return
        if len(self._starved) > 4096:
            self._starved.clear()
        self._starved.add(pod.key)
        tenant = tenant_of(pod)
        if self.metrics is not None:
            self.metrics.inc("tenant_starvation_trips_total",
                             labels={"tenant": tenant})
        if self.flight is not None:
            self.flight.record("tenant_starvation", pod=pod.key,
                               tenant=tenant,
                               waited_s=round(waited_s, 3))

    def resolved(self, pod_key: str) -> None:
        self._starved.discard(pod_key)
