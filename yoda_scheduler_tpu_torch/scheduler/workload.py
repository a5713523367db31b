"""Workload-tier admission: one decision per workload, O(1) parked cost.

The 5k-tier latency decomposition says 99.9% of end-to-end p50 is QUEUE
WAIT — at production backlog depths the pod-at-a-time intake tier, not
the scheduling cycle, is the product. This module adds the Kueue/
Tesserae-shaped tier above the pod queue (PAPERS.md arXiv:2508.04953):

- A ``Workload`` describes N gang members x M replicas through ONE
  shared label template. Parked, it holds the template + counts — a
  few hundred bytes whatever N*M is — never per-pod ``QueuedPodInfo``s.
- ``WorkloadAdmission`` parks submitted workloads in per-tenant sharded
  priority bands (queue.TenantShareBands — the same exact-at-pop DRF
  structure the scheduling queue uses) and runs ONE admission decision
  per workload against the DRF book: hierarchical quota caps
  (whole-workload demand, through the same in-flight claim surface the
  gang quota gate uses), live free capacity, and queue backpressure.
- Pods MATERIALIZE lazily: only an admitted workload's pods enter the
  scheduling queue (each replica becomes an ordinary gang, so every
  downstream surface — Permit assembly, elastic growth, preemption,
  fleet routing — is unchanged). One admission replaces N*M queue
  operations, and a million-pod backlog is 10k parked workload objects.
- Backpressure and rejection surface as Workload CONDITIONS (the CRD
  status shape both apiserver backends serve) plus labeled metrics.

Everything is gated on the ``workloadAdmission`` knob (default off):
with it off this module is never constructed and intake is bit-identical
to the pod-at-a-time path (tests/test_workload.py parity + CI leg).
"""

from __future__ import annotations

import itertools
import time
from collections import deque

from .queue import TenantShareBands
from ..utils.labels import (
    GANG_MIN_LABEL, GANG_NAME_LABEL, GANG_SIZE_LABEL, LabelError,
    TENANT_LABEL, WorkloadSpec)
from ..utils.pod import Pod

WORKLOAD_GROUP = "scheduling.yoda.tpu"
WORKLOAD_VERSION = "v1"
WORKLOAD_PLURAL = "workloads"
WORKLOADS_PATH = f"/apis/{WORKLOAD_GROUP}/{WORKLOAD_VERSION}/{WORKLOAD_PLURAL}"

# lifecycle states (also the CRD status.state values)
PARKED = "Parked"
ADMITTED = "Admitted"
REJECTED = "Rejected"
WITHDRAWN = "Withdrawn"

# condition reasons surfaced on the Admitted condition
REASON_BACKPRESSURE = "Backpressure"
REASON_OVER_QUOTA = "OverQuota"
REASON_NO_CAPACITY = "NoCapacity"
REASON_RATE_LIMITED = "RateLimited"
REASON_ADMITTED = "Admitted"
REASON_REJECTED = "Rejected"
REASON_WITHDRAWN = "Withdrawn"


class Workload:
    """N gang members x M replicas sharing one WorkloadSpec template.

    ``members`` > 1 makes each replica a gang (tpu/gang-name/size are
    SYNTHESIZED per replica at materialization — the template must not
    carry them); ``members`` == 1 materializes plain pods. The parked
    representation is exactly these fields: O(1), independent of
    members*replicas.
    """

    __slots__ = ("name", "namespace", "labels", "members", "replicas",
                 "scheduler_name", "created", "state", "conditions",
                 "resource_version", "uid", "parked_at", "replica_status",
                 "_spec")

    def __init__(self, name: str, members: int = 1, replicas: int = 1,
                 labels: dict | None = None, namespace: str = "default",
                 scheduler_name: str = "yoda-scheduler",
                 created: float = 0.0) -> None:
        if members < 1 or replicas < 1:
            raise ValueError(
                f"workload {name}: members/replicas must be >= 1")
        labels = dict(labels or {})
        if GANG_NAME_LABEL in labels or GANG_SIZE_LABEL in labels:
            raise ValueError(
                f"workload {name}: template must not set {GANG_NAME_LABEL}/"
                f"{GANG_SIZE_LABEL} — gangs come from members > 1")
        self.name = name
        self.namespace = namespace
        self.labels = labels
        self.members = int(members)
        self.replicas = int(replicas)
        self.scheduler_name = scheduler_name
        self.created = created
        self.state = PARKED
        self.conditions: list[dict] = []
        self.resource_version: str | None = None
        # metadata.uid on wire backends: the incarnation identity a
        # delete+recreate of the same ns/name is distinguished by
        self.uid = ""
        self.parked_at = created
        # per-replica partial-gang progress (status.replicas): a
        # half-bound workload is observable from the CR alone, no
        # engine-metric grepping. Maintained by the admission tier off
        # the in-flight claim's unbound remainder; [] until admitted.
        self.replica_status: list[dict] = []
        self._spec = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def total_pods(self) -> int:
        return self.members * self.replicas

    def _unit_labels(self, replica: int) -> dict:
        labels = dict(self.labels)
        if self.members > 1:
            labels[GANG_NAME_LABEL] = f"{self.name}-r{replica}"
            labels[GANG_SIZE_LABEL] = str(self.members)
        else:
            # a gang-min without a gang would fail label validation
            labels.pop(GANG_MIN_LABEL, None)
        return labels

    @property
    def spec(self) -> WorkloadSpec:
        """The shared per-pod spec (parsed once; LabelError propagates —
        admission surfaces it as a Rejected condition)."""
        if self._spec is None:
            self._spec = WorkloadSpec.from_labels(self._unit_labels(0))
        return self._spec

    @property
    def tenant(self) -> str:
        return self.labels.get(TENANT_LABEL) or self.namespace

    @property
    def priority(self) -> int:
        try:
            return self.spec.priority
        except LabelError:
            return 0

    def demand(self) -> tuple[int, int]:
        """Whole-workload (chips, hbm_mb) — the one number admission
        gates against quota and capacity."""
        spec = self.spec
        n = self.total_pods
        return (spec.chips * n, spec.min_free_mb * spec.chips * n)

    # -------------------------------------------------------- materialization
    def pod_name(self, replica: int, member: int) -> str:
        if self.members > 1:
            return f"{self.name}-r{replica}-{member}"
        return f"{self.name}-{replica}"

    def member_keys(self) -> tuple[list[str], list[str]]:
        """(gang names, pod keys) this workload materializes — derived,
        never stored, so a withdraw pass can doom members without the
        workload ever having held per-pod state."""
        gangs = ([f"{self.name}-r{r}" for r in range(self.replicas)]
                 if self.members > 1 else [])
        keys = [f"{self.namespace}/{self.pod_name(r, m)}"
                for r in range(self.replicas)
                for m in range(self.members)]
        return gangs, keys

    def materialize(self) -> list[Pod]:
        """The admitted workload's pods: each replica an ordinary gang
        (members > 1) or a plain pod. Built only AFTER admission — this
        is the lazy step that keeps parked workloads O(1)."""
        pods = []
        for r in range(self.replicas):
            labels = self._unit_labels(r)
            for m in range(self.members):
                p = Pod(self.pod_name(r, m),
                        namespace=self.namespace,
                        labels=dict(labels),
                        scheduler_name=self.scheduler_name)
                # owner back-reference (wire materialization stamps it
                # into ownerReferences; harmless engine-side)
                p._workload_name = self.name
                pods.append(p)
        return pods

    # ------------------------------------------------------------- conditions
    def set_condition(self, type_: str, status: str, reason: str,
                      message: str, now: float) -> bool:
        """Upsert a status condition; lastTransitionTime moves only when
        the status flips (the k8s condition contract). Returns whether
        anything changed (the status write-back dedup)."""
        for c in self.conditions:
            if c["type"] == type_:
                changed = (c["status"] != status or c["reason"] != reason
                           or c["message"] != message)
                if c["status"] != status:
                    c["lastTransitionTime"] = now
                c["status"] = status
                c["reason"] = reason
                c["message"] = message
                return changed
        self.conditions.append({
            "type": type_, "status": status, "reason": reason,
            "message": message, "lastTransitionTime": now})
        return True

    def condition(self, type_: str) -> dict | None:
        for c in self.conditions:
            if c["type"] == type_:
                return c
        return None

    # -------------------------------------------------------------- CRD shape
    def to_cr(self) -> dict:
        cr = {
            "apiVersion": f"{WORKLOAD_GROUP}/{WORKLOAD_VERSION}",
            "kind": "Workload",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "members": self.members,
                "replicas": self.replicas,
                "schedulerName": self.scheduler_name,
                "template": {"metadata": {"labels": dict(self.labels)}},
            },
            "status": self.status(),
        }
        if self.resource_version is not None:
            cr["metadata"]["resourceVersion"] = self.resource_version
        if self.uid:
            cr["metadata"]["uid"] = self.uid
        return cr

    def status(self) -> dict:
        st = {"state": self.state,
              "conditions": [dict(c) for c in self.conditions]}
        if self.replica_status:
            st["replicas"] = [dict(r) for r in self.replica_status]
        return st

    @classmethod
    def from_cr(cls, cr: dict) -> "Workload":
        md = cr.get("metadata", {})
        spec = cr.get("spec", {})
        tpl = spec.get("template", {}).get("metadata", {})
        w = cls(md.get("name", ""),
                members=int(spec.get("members", 1)),
                replicas=int(spec.get("replicas", 1)),
                labels=tpl.get("labels", {}),
                namespace=md.get("namespace", "default"),
                scheduler_name=spec.get("schedulerName", "yoda-scheduler"))
        w.resource_version = md.get("resourceVersion")
        w.uid = md.get("uid", "")
        st = cr.get("status") or {}
        if st.get("state"):
            w.state = st["state"]
            w.conditions = [dict(c) for c in st.get("conditions", [])]
            w.replica_status = [dict(r) for r in st.get("replicas", [])]
        return w


class WorkloadAdmission:
    """The admission tier of ONE engine (engine-thread-owned, with a
    GIL-atomic cross-thread inbox like the queue's). Module docstring
    has the shape; the per-cycle contract is: ``tick`` spends at most
    ``admissionBurst`` O(1) decisions however deep the parked backlog
    is, and a workload that cannot admit NOW parks with a condition
    naming why and costs nothing until the cluster moves.

    Fleet hooks (wired by FleetCoordinator): ``owner_check`` gates
    admission to the shard-0 lease holder (the defrag ownership
    discipline — every replica parks the full workload set so a lease
    handover needs no state transfer, but only the owner materializes);
    ``admitted_check`` is the fleet-wide claim-once guard that makes a
    mid-admission handover unable to double-materialize; ``submit_pod``
    and ``forget_pod`` route through the coordinator so materialized
    gangs land on their shard-stable replica.
    """

    # in-flight claim TTL multiplier over gang_timeout_s — the same
    # assembly-window bound the gang quota claims use
    _CLAIM_TTL_X = 2.0
    # resolved-workload registry bound: the oldest record evicts past
    # this (FIFO — dicts are ordered), so a long-lived serve loop with
    # workload churn cannot grow it forever. The trade, stated: a
    # withdraw arriving after eviction cannot doom engine-side members
    # any more (on the wire the CR body still drives server-side pod
    # cleanup).
    _RESOLVED_CAP = 16384

    def __init__(self, engine) -> None:
        self.engine = engine
        self.config = engine.config
        self.metrics = engine.metrics
        self.flight = engine.flight
        self.clock = engine.clock
        self._inbox: deque = deque()  # ("submit", Workload) | ("withdraw", ...)
        self._bands = TenantShareBands(self._share)
        self._order = itertools.count()
        self._parked: dict[str, Workload] = {}   # in bands, undecided
        self._blocked: dict[str, Workload] = {}  # quota/capacity-parked
        self._resolved: dict[str, Workload] = {}  # admitted/rejected/withdrawn
        # workload key -> [tenant, demand, expires, unbound member keys]:
        # admission-time claims counted against quota headroom and free
        # capacity until cluster truth covers EVERY materialized pod
        # (the unbound remainder drains as binds land — retiring on the
        # first bind would under-count the not-yet-bound members and let
        # a second workload ride the same headroom) or the assembly TTL
        # lapses — the workload-tier face of the policy engine's in-flight claims
        self._inflight: dict[str, list] = {}
        self._book = None
        self._pass_vers: tuple | None = ()
        self._tokens = float(max(self.config.admission_burst, 1))
        self._stamp: float | None = None
        # fleet hooks (class docstring)
        self.owner_check = None
        self.admitted_check = None
        self.submit_pod = engine.submit
        self.forget_pod = engine.forget
        self.tracks_pod = engine.tracks
        self.pending_fn = (lambda: engine.queue.pending()
                           + len(engine.waiting))
        # wire hook: called with a Workload whose status changed (the
        # serve loop's CRD status writer); must never block
        self.status_sink = None
        self.decisions = 0
        self._more = False  # last tick hit the burst cap mid-backlog

    # --------------------------------------------------------------- intake
    def submit(self, w: Workload) -> None:
        """Any-thread: park a workload (the engine thread drains)."""
        self._inbox.append(("submit", w))

    def withdraw(self, key: str, reason: str = "withdrawn") -> None:
        """Any-thread: withdraw by key — parked workloads unpark,
        admitted ones doom their materialized members (one pass)."""
        self._inbox.append(("withdraw", (key, reason)))

    def parked_count(self) -> int:
        return len(self._parked) + len(self._blocked)

    def _remember(self, w: Workload) -> None:
        self._resolved[w.key] = w
        while len(self._resolved) > self._RESOLVED_CAP:
            self._resolved.pop(next(iter(self._resolved)))

    def get(self, key: str) -> Workload | None:
        return (self._parked.get(key) or self._blocked.get(key)
                or self._resolved.get(key))

    def workloads(self):
        yield from self._parked.values()
        yield from self._blocked.values()
        yield from self._resolved.values()

    # ---------------------------------------------------------------- shares
    def _share(self, tenant: str) -> float:
        return (self._book.dominant_share(tenant)
                if self._book is not None else 0.0)

    def _book_ref(self):
        if self._book is None:
            pol = self.engine.policy
            if pol is not None and pol.book is not None:
                self._book = pol.book
            else:
                # no policy engine: admission still wants the live
                # usage/capacity ledger — own book, no quotas
                from .policy.fairness import DRFBook

                self._book = DRFBook(self.engine.cluster)
            self._book.add_share_listener(self._bands.mark_dirty)
            self._bands.mark_dirty(None)
        return self._book

    def _vers(self) -> tuple:
        c = self.engine.cluster
        tel = getattr(c, "telemetry", None)
        return (getattr(c, "pods_global_version", None),
                getattr(c, "nodes_version", None),
                getattr(tel, "resource_version", None))

    # ----------------------------------------------------------------- tick
    def tick(self, now: float) -> int:
        """One admission pass (run_one calls this before the pod pop).
        Returns how many workloads were admitted."""
        if self._inbox:
            self._drain_inbox(now)
        vers = self._vers()
        self._retire_claims(now)
        if self._blocked and vers != self._pass_vers:
            # the cluster moved: quota/capacity verdicts may have too
            for key in list(self._blocked):
                w = self._blocked.pop(key)
                self._park(w)
        if not self._bands.n:
            self._pass_vers = vers
            self._publish()
            return 0
        if self.owner_check is not None and not self.owner_check():
            # fleet: not the admission owner — park everything as-is
            # (the owner replica holds the same set and admits)
            self.metrics.inc("workload_admission_skips_total",
                             labels={"reason": "not-owner"})
            self._pass_vers = vers
            self._publish()
            return 0
        rate = self.config.admission_rate_per_s
        burst = max(self.config.admission_burst, 1)
        if rate > 0:
            if self._stamp is None:
                self._stamp = now
            self._tokens = min(float(burst),
                               self._tokens + (now - self._stamp) * rate)
            self._stamp = now
        book = self._book_ref()
        book.refresh()
        admitted = 0
        exams = burst
        while exams > 0 and self._bands.n:
            if rate > 0 and self._tokens < 1.0:
                got = self._bands.next(self._live)
                if (self.config.slo_serving and got is not None
                        and self._serving_workload(got[4])):
                    # serving fastpath: the rate limit damps
                    # training submission storms, but a flash crowd's
                    # replica turn-ups are exactly the demand the SLO
                    # tier must not meter — admit without tokens
                    self.metrics.inc("workload_serving_fastpath_total",
                                     labels={"check": "rate-limit"})
                else:
                    if got is not None:
                        # surface WHY the head is not admitting (peek
                        # only — next() detaches nothing)
                        self._note_parked(got[4], REASON_RATE_LIMITED,
                                          "admission rate limit", now)
                    self.metrics.inc("workload_backpressure_total",
                                     labels={"reason": "rate-limit"})
                    if self.config.slo_serving:
                        admitted += self._serving_sweep(exams, now)
                    break
            got = self._bands.next(self._live)
            if got is None:
                break
            w = got[4]
            t0 = time.perf_counter()
            verdict, detail = self._decide(w, now)
            self.metrics.observe("workload_admission_decision_ms",
                                 (time.perf_counter() - t0) * 1e3)
            self.decisions += 1
            exams -= 1
            if verdict == "admit":
                self._admit(w, now)
                admitted += 1
                if rate > 0 and not (self.config.slo_serving
                                     and self._serving_workload(w)):
                    # serving rides outside the token budget entirely:
                    # a crowd's admissions must not starve the next
                    # training admission's tokens either
                    self._tokens -= 1.0
            elif verdict == "reject":
                self._reject(w, detail, now)
            elif verdict == REASON_BACKPRESSURE:
                # head-of-line: nothing NON-serving admits past a
                # backpressured head, so band/DRF order is preserved —
                # the queue draining (binds move the version) re-opens
                # the pass
                self._note_parked(w, REASON_BACKPRESSURE, detail, now)
                self.metrics.inc("workload_backpressure_total",
                                 labels={"reason": "queue-depth"})
                if self.config.slo_serving:
                    admitted += self._serving_sweep(exams, now)
                break
            else:
                # quota/capacity/oversized: set the condition, move
                # aside — a smaller or other-tenant workload behind
                # may fit
                reason = (REASON_BACKPRESSURE
                          if verdict == "backpressure-aside" else verdict)
                self._unpark(w)
                self._blocked[w.key] = w
                self._note_parked(w, reason, detail, now)
                self.metrics.inc("workload_parked_total",
                                 labels={"reason": reason})
        # burst cap hit with live candidates left: more work NOW (the
        # cap keeps one cycle O(burst), not the backlog undecided)
        self._more = exams == 0 and self._bands.n > 0
        self._pass_vers = self._vers()
        self._publish()
        return admitted

    def _live(self, w, _seq) -> bool:
        return self._parked.get(w.key) is w

    def _serving_sweep(self, exams: int, now: float) -> int:
        """The serving lane past a blocked head: rate-limit
        and queue-depth backpressure both break the admission pass at
        the HEAD of the band order, so the per-decision fastpaths in
        _decide never even see a serving workload parked BEHIND a
        backpressured training head — exactly the moment a flash
        crowd's replica turn-ups must not wait for a training backlog
        to drain. Decide parked serving workloads directly (quota and
        capacity still enforce; only the two backpressure checks are
        bypassed, and _decide's fastpath handles those). Bounded by the
        tick's remaining exam budget; non-admit verdicts leave the
        workload parked in band order for the ordinary pass."""
        admitted = 0
        for w in [p for p in self._parked.values()
                  if self._serving_workload(p)]:
            if exams <= 0:
                break
            verdict, detail = self._decide(w, now)
            self.decisions += 1
            exams -= 1
            if verdict == "admit":
                self.metrics.inc("workload_serving_fastpath_total",
                                 labels={"check": "head-of-line"})
                self._admit(w, now)
                admitted += 1
            elif verdict == "reject":
                self._reject(w, detail, now)
            else:
                self._note_parked(w, verdict, detail, now)
        return admitted

    @staticmethod
    def _serving_workload(w) -> bool:
        try:
            return w.spec.serving
        except LabelError:
            return False

    def _drain_inbox(self, now: float) -> None:
        while True:
            try:
                op, payload = self._inbox.popleft()
            except IndexError:
                return
            if op == "submit":
                w = payload
                existing = self.get(w.key)
                if existing is not None:
                    if (existing.state in (WITHDRAWN, REJECTED)
                            and w.uid != existing.uid):
                        # delete + recreate under the same ns/name (a
                        # routine kubectl delete/apply): the NEW uid is
                        # a new incarnation — drop the terminal record
                        # and park it afresh
                        self._resolved.pop(w.key, None)
                    else:
                        continue  # duplicate (fleet broadcast/re-list)
                if w.state != PARKED:
                    # a restarted scheduler re-listing workload CRs:
                    # an already-Admitted/Rejected/Withdrawn workload is
                    # ADOPTED, never re-decided — its pods (if any) come
                    # back through the ordinary pod reconcile, and
                    # re-admitting here would double-materialize them
                    self._remember(w)
                    self.metrics.inc("workloads_adopted_total")
                    continue
                w.parked_at = now
                if not w.created:
                    w.created = now
                self._park(w)
                self.metrics.inc("workloads_submitted_total")
            else:
                key, reason = payload
                self._withdraw_now(key, reason, now)

    def _park(self, w: Workload) -> None:
        self._parked[w.key] = w
        self._bands.insert(w.priority, w.tenant,
                           (w.created, next(self._order)), 0, w)

    def _unpark(self, w: Workload) -> None:
        if self._parked.pop(w.key, None) is not None:
            self._bands.discard(w.priority, w.tenant)

    # -------------------------------------------------------------- decision
    def _decide(self, w: Workload, now: float) -> tuple[str, str]:
        """ONE O(1) admission decision — the whole point of the tier.
        Reads: queue depth (backpressure), the DRF book's hierarchical
        quota levels with in-flight claims, live free capacity."""
        try:
            demand = w.demand()
        except LabelError as e:
            return ("reject", f"malformed template: {e}")
        cap = self.config.max_materialized_pods
        if cap:
            pending = self.pending_fn()
            # a workload bigger than the whole window still admits into
            # an EMPTY queue — the cap bounds concurrency, not size
            if pending and pending + w.total_pods > cap:
                if self.config.slo_serving and self._serving_workload(w):
                    # serving fastpath: queue-depth
                    # backpressure protects cycle latency from training
                    # backlogs, but holding a crowd's replicas OUT of
                    # the queue guarantees the SLO burns — let the
                    # headroom gate and guard make room instead
                    self.metrics.inc("workload_serving_fastpath_total",
                                     labels={"check": "queue-depth"})
                else:
                    if w.total_pods > cap:
                        # oversized: only an EMPTY queue ever fits it,
                        # so head-of-line blocking on it would stall
                        # every other admission for as long as any
                        # intake trickles — park it ASIDE like a quota
                        # verdict
                        return ("backpressure-aside",
                                f"workload wider than window {cap}; "
                                f"waiting for an empty queue")
                    return (REASON_BACKPRESSURE,
                            f"{pending} pods pending >= window {cap}")
        book = self._book
        pol = self.engine.policy
        if pol is not None and pol.quotas:
            level = book.would_exceed(w.tenant, demand,
                                      inflight=self._quota_inflight)
            if level is not None:
                q = pol.quotas[level]
                cap_c, cap_h = book.capacity
                alone = 0.0
                if cap_c:
                    alone = demand[0] / cap_c
                if cap_h and demand[1]:
                    alone = max(alone, demand[1] / cap_h)
                if (cap_c or cap_h) and alone > q.quota + 1e-9:
                    # no amount of draining ever fits this under the
                    # cap: reject now instead of parking forever
                    return ("reject",
                            f"demand alone exceeds quota {q.quota:.2f} "
                            f"at level {level}")
                return (REASON_OVER_QUOTA,
                        f"would exceed quota at level {level}")
        cap_c, cap_h = book.capacity
        if cap_c <= 0:
            return (REASON_NO_CAPACITY, "no cluster capacity known")
        used_c, used_h = book.total_usage()
        inf_c, inf_h = self._inflight_totals(now)
        if used_c + inf_c + demand[0] > cap_c or (
                cap_h and demand[1]
                and used_h + inf_h + demand[1] > cap_h):
            return (REASON_NO_CAPACITY,
                    f"demand {demand[0]} chips > free capacity")
        return ("admit", "")

    def _quota_inflight(self, level: str) -> tuple[int, int]:
        c, h = self._wl_inflight(level)
        pol = self.engine.policy
        if pol is not None:
            gc, gh = pol.gang_inflight(level, None, self.clock.time())
            c += gc
            h += gh
        return (c, h)

    def _wl_inflight(self, level: str) -> tuple[int, int]:
        if not self._inflight:
            return (0, 0)
        c = h = 0
        prefix = level + "/"
        for tenant, per_pod, _, remaining in self._inflight.values():
            if tenant == level or tenant.startswith(prefix):
                c += per_pod[0] * len(remaining)
                h += per_pod[1] * len(remaining)
        return (c, h)

    def _inflight_totals(self, now: float) -> tuple[int, int]:
        c = h = 0
        for _, per_pod, _, remaining in self._inflight.values():
            c += per_pod[0] * len(remaining)
            h += per_pod[1] * len(remaining)
        return (c, h)

    def _retire_claims(self, now: float) -> None:
        """A claim retires when cluster truth covers every member (the
        book then counts the whole workload) or the assembly TTL lapses;
        the per-pod quota gate remains the exact enforcement either
        way. O(outstanding unbound members) per tick, and outstanding
        claims are capacity-bounded — admission stops while they hold
        headroom. Bind progress observed here also refreshes the
        workload's per-replica status (boundMembers moves as the claim's
        unbound remainder drains) through the latest-wins writer."""
        if not self._inflight:
            return
        bn = getattr(self.engine.cluster, "bound_node_of", None)
        for key, claim in list(self._inflight.items()):
            if now > claim[2]:
                del self._inflight[key]
                continue
            if bn is None:
                continue
            before = len(claim[3])
            claim[3] = [k for k in claim[3] if bn(k) is None]
            if len(claim[3]) != before:
                w = self._resolved.get(key)
                if w is not None:
                    self._refresh_progress(w)
                    self._push_status(w)
            if not claim[3]:
                del self._inflight[key]

    def _refresh_progress(self, w: Workload) -> None:
        """Recompute status.replicas from cluster truth: per replica
        index, how many member pods are BOUND and how many exist at all
        (bound or still tracked pending). O(members) — paid only when a
        claim's unbound remainder actually moved."""
        bn = getattr(self.engine.cluster, "bound_node_of", None)
        if bn is None:
            return
        rows = []
        for r in range(w.replicas):
            bound = mat = 0
            for m in range(w.members):
                k = f"{w.namespace}/{w.pod_name(r, m)}"
                if bn(k) is not None:
                    bound += 1
                    mat += 1
                elif self.tracks_pod(k):
                    mat += 1
            rows.append({"index": r, "boundMembers": bound,
                         "materializedMembers": mat})
        w.replica_status = rows

    # -------------------------------------------------------------- outcomes
    def _admit(self, w: Workload, now: float) -> None:
        self._unpark(w)
        if self.admitted_check is not None \
                and not self.admitted_check(w):
            # fleet handover race: another replica materialized this
            # workload already — adopt the outcome, touch nothing
            w.state = ADMITTED
            w.set_condition("Admitted", "True", REASON_ADMITTED,
                            "admitted by peer replica", now)
            self._remember(w)
            self.metrics.inc("workload_admission_dedup_total")
            return
        demand = w.demand()
        # re-derive in-flight claims from CLUSTER truth before touching
        # anything: the claim-once registry above is coordinator-local,
        # so a PROCESS-fleet lease handover (old owner dead, new process
        # inherits shard 0) reaches here with an empty registry even
        # though the dead owner already materialized this workload. The
        # members it created are on the apiserver — adopt them instead
        # of re-materializing duplicates.
        member_keys = w.member_keys()[1]
        known_fn = getattr(self.engine.cluster, "known_pod_keys", None)
        existing: set = set()
        if known_fn is not None:
            existing = set(known_fn()) & set(member_keys)
        else:
            bn0 = getattr(self.engine.cluster, "bound_node_of", None)
            if bn0 is not None:
                existing = {k for k in member_keys if bn0(k) is not None}
        if existing and len(existing) == len(member_keys):
            w.state = ADMITTED
            w.set_condition("Admitted", "True", REASON_ADMITTED,
                            "members already materialized by prior "
                            "owner (adopted from cluster truth)", now)
            self._remember(w)
            self._refresh_progress(w)
            self.metrics.inc("workload_handover_adoptions_total")
            self.flight.record("workload_adopted", workload=w.key,
                               members=len(existing))
            self._push_status(w)
            return
        bn = getattr(self.engine.cluster, "bound_node_of", None)
        if bn is not None and any(bn(k) is not None
                                  for k in w.member_keys()[1]):
            # a DIFFERENT workload's bound pod already owns one of our
            # deterministic member names (e.g. workload "job" members>1
            # vs workload "job-r0" — both derive job-r0-0). Admitting
            # would let a later withdraw of either doom the other's
            # members; refuse loudly instead. (Pending-name overlap is
            # ultimately resolved by the authority's already-bound 409;
            # this guards the destructive case.)
            w.state = REJECTED
            w.set_condition("Admitted", "False", REASON_REJECTED,
                            "member pod name already bound by another "
                            "workload", now)
            self._remember(w)
            self.metrics.inc("workload_rejections_total",
                             labels={"reason": "name-collision"})
            self.flight.record("workload_rejected", workload=w.key,
                               reason="member name collision")
            self._push_status(w)
            return
        pods = w.materialize()
        if existing:
            # partial handover: the dead owner materialized only SOME
            # members before dying — complete the remainder; never
            # duplicate what cluster truth already holds
            pods = [p for p in pods if p.key not in existing]
            self.metrics.inc("workload_handover_completions_total")
        w.state = ADMITTED
        w.set_condition(
            "Admitted", "True", REASON_ADMITTED,
            f"{len(pods)} pods materialized "
            f"({w.replicas}x{w.members})", now)
        self._remember(w)
        ttl = self._CLAIM_TTL_X * getattr(self.config, "gang_timeout_s",
                                          30.0)
        # the claim charges PER-POD demand x the unbound remainder:
        # the book already counts bound members, so a full-demand
        # charge would double-count every bind until the last one
        n_total = max(len(member_keys), 1)
        per_pod = (demand[0] // n_total, demand[1] // n_total)
        self._inflight[w.key] = [w.tenant, per_pod, now + ttl,
                                 [p.key for p in pods]]
        for p in pods:
            self.submit_pod(p)
        self._refresh_progress(w)
        self.metrics.inc("workload_admissions_total",
                         labels={"tenant": w.tenant})
        self.metrics.inc("workload_materialized_pods_total", len(pods))
        self.metrics.observe("workload_park_wait_ms",
                             (now - w.parked_at) * 1e3)
        self._push_status(w)

    def _reject(self, w: Workload, reason: str, now: float) -> None:
        self._unpark(w)
        w.state = REJECTED
        w.set_condition("Admitted", "False", REASON_REJECTED, reason, now)
        self._remember(w)
        self.metrics.inc("workload_rejections_total",
                         labels={"reason": "admission"})
        self.flight.record("workload_rejected", workload=w.key,
                           reason=reason)
        self._push_status(w)

    def _note_parked(self, w: Workload, reason: str, detail: str,
                     now: float) -> None:
        if w.set_condition("Admitted", "False", reason, detail, now):
            self._push_status(w)

    def _withdraw_now(self, key: str, reason: str, now: float) -> None:
        w = self._parked.get(key)
        if w is not None:
            self._unpark(w)
        else:
            w = self._blocked.pop(key, None)
        if w is not None:
            w.state = WITHDRAWN
            w.set_condition("Admitted", "False", REASON_WITHDRAWN,
                            reason, now)
            self._remember(w)
            self.metrics.inc("workload_rejections_total",
                             labels={"reason": "withdrawn"})
            self._push_status(w)
            return
        w = self._resolved.get(key)
        if w is None or w.state != ADMITTED:
            return  # unknown, or already rejected/withdrawn: no-op
        # ONE retirement pass over everything the admission created:
        # the workload-tier in-flight quota claim, every materialized
        # member still in our hands (queued / backing off / parked at
        # Permit — forget() unwinds reservations, nominations, and
        # fails the gang through the gang_failed audit so the
        # gate's per-gang claims retire too), and the per-gang claims
        # of units whose members never reached a queue.
        self._inflight.pop(key, None)
        gangs, pod_keys = w.member_keys()
        doomed = 0
        for pk in pod_keys:
            bn = getattr(self.engine.cluster, "bound_node_of", None)
            if bn is not None and bn(pk) is not None:
                continue  # bound members stay bound (gang semantics)
            self.forget_pod(pk)
            doomed += 1
        pol = self.engine.policy
        if pol is not None:
            for g in gangs:
                pol.gang_failed(g)
        w.state = WITHDRAWN
        w.set_condition("Admitted", "False", REASON_WITHDRAWN,
                        f"{reason}; {doomed} members retired", now)
        self.metrics.inc("workload_rejections_total",
                         labels={"reason": "withdrawn"})
        self.flight.record("workload_withdrawn", workload=key,
                           reason=reason, members_retired=doomed)
        self._push_status(w)

    # ------------------------------------------------------------- reporting
    def _push_status(self, w: Workload) -> None:
        sink = self.status_sink
        if sink is not None:
            try:
                sink(w)
            except Exception:
                self.metrics.inc("workload_status_push_errors_total")

    def _publish(self) -> None:
        self.metrics.set_gauge("workloads_parked",
                               float(self.parked_count()))

    def next_ready_at(self, now: float) -> float | None:
        """Earliest instant tick() could make progress (None = only a
        cluster event can — run loops wake on those already)."""
        if self._inbox:
            return now
        if not self._bands.n and not self._blocked:
            return None
        if self._more or self._vers() != self._pass_vers:
            return now
        rate = self.config.admission_rate_per_s
        if self._bands.n and rate > 0 and self._tokens < 1.0:
            return now + (1.0 - self._tokens) / rate
        if self._blocked and self._inflight:
            # a blocked verdict can also clear when an in-flight claim
            # TTLs out with no version movement
            return min(e for _, _, e, _ in self._inflight.values())
        return None
