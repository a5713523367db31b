"""Cluster backends: where pods live and binds land.

The reference's cluster backend is the Kubernetes API server reached through
client-go/controller-runtime (reference pkg/yoda/scheduler.go:53-68,111).
Here the backend is an interface with two implementations:

- FakeCluster (this module): in-memory API-server stand-in. Primary target
  for tests and the benchmark harness — the fake control plane SURVEY.md §4
  says the reference lacks entirely.
- KubeCluster (k8s/client.py): the same interface over a real API server,
  gated on network availability.
"""

from __future__ import annotations

import threading
from typing import Protocol

from .framework import (
    ClusterEvent,
    NODE_ADDED,
    NODE_SPEC_CHANGED,
    POD_BOUND,
    POD_DELETED,
)
from ..telemetry.store import TelemetryStore
from ..utils.changelog import ChangeLog
from ..utils.pod import ASSIGNED_CHIPS_LABEL, Pod, PodPhase, format_assigned_chips


class Cluster(Protocol):
    def node_names(self) -> list[str]: ...
    def pods_on(self, node: str) -> list[Pod]: ...
    # `fence` is only passed when the engine's fence_provider is set
    # (sharded fleet replicas); fence-unaware backends are safe anywhere
    # else, but a backend used under a sharded fleet must accept it
    def bind(self, pod: Pod, node: str,
             assigned_chips: list[tuple[int, int, int]] | None,
             fence: tuple | None = None) -> None: ...
    def evict(self, pod: Pod) -> None: ...


class BindConflictError(RuntimeError):
    """The authority rejected a bind at commit time: the target pod is
    already bound, the chip/HBM claim would oversubscribe the node, or the
    caller's fencing token is stale. The HTTP analogue is a server-returned
    409 — `status` carries that so the engine's breaker logic (which only
    counts WIRE failures, status 0) never trips on a healthy-but-contended
    cluster, and the conflict path can route on it."""

    status = 409


class FakeCluster:
    """In-memory nodes + bound-pod book-keeping, with a telemetry store
    playing the role of the SCV CRD cache."""

    # evict() here merely unbinds — the same Pod object can be resubmitted
    # (descheduler local requeue). A real API server's evict is a DELETE,
    # where the controller recreates a new incarnation instead.
    supports_local_requeue = True

    def __init__(self, telemetry: TelemetryStore | None = None) -> None:
        self.telemetry = telemetry or TelemetryStore()
        self._lock = threading.RLock()
        self._nodes: set[str] = set()
        self._bound: dict[str, list[Pod]] = {}  # node -> pods
        # pod.key -> node, maintained alongside _bound: O(1) already-bound
        # conflict checks at bind time and O(1) bound_node_of (the fleet's
        # foreign-bind guard reads it on the scheduling path)
        self._bound_keys: dict[str, str] = {}
        # optional shard-lease authority (scheduler/fleet.py
        # LocalLeaseStore): when set, a bind carrying a fencing token is
        # validated against it — a replica whose lease epoch went stale
        # (split-brain, expiry mid-bind) gets a 409, never a silent write
        self.lease_authority = None
        # server-side rejections, by reason — the fleet bench and chaos
        # fuzz read these to prove the authority (not engine bookkeeping)
        # is what held the invariants
        self.bind_conflicts: dict[str, int] = {}
        self._meta: dict[str, tuple[dict, tuple]] = {}  # node -> (labels, taints)
        self._pdbs: tuple = ()
        self._namespaces: dict[str, dict] = {}  # ns -> metadata.labels
        # monotonic per-node change counter (bind/evict/removal): lets the
        # scheduler reuse per-node snapshot state across cycles — a bind
        # invalidates one node, not the whole cluster
        self._pods_ver: dict[str, int] = {}
        # global change log + node-membership version for incremental
        # snapshots and the unschedulable-class memo
        self._changes = ChangeLog()
        self._nodes_ver = 0
        # event subscribers (scheduler engines): called OUTSIDE the lock
        # with a framework.ClusterEvent per mutation, feeding the queues'
        # event-driven requeue (list append/iteration are GIL-atomic)
        self._subscribers: list = []

    def subscribe(self, cb) -> None:
        """Register a cluster-event callback (cb(ClusterEvent)). Callbacks
        must be cheap and thread-safe — they run on whichever thread
        mutated the cluster."""
        self._subscribers.append(cb)

    def _publish(self, event: ClusterEvent) -> None:
        for cb in list(self._subscribers):
            cb(event)

    def _bump(self, node: str, grew: bool = True) -> None:
        # callers hold self._lock; every mutation of a node's bound-pod set
        # MUST bump, or cross-cycle snapshot reuse serves stale NodeInfos.
        # grew=False marks capacity-consuming changes (a bind): repair
        # paths then skip hunting that node for NEW feasibility.
        self._pods_ver[node] = self._pods_ver.get(node, 0) + 1
        self._changes.record(node, grew=grew)

    @property
    def nodes_version(self) -> int:
        """Bumped whenever node MEMBERSHIP changes (add/remove)."""
        return self._nodes_ver

    @property
    def pods_global_version(self) -> int:
        """Bumped on any bound-pod mutation anywhere (cheap read)."""
        return self._changes.version

    def changes_since(self, version: int) -> tuple[int, set[str] | None]:
        """(current version, nodes whose bound-pod set changed after
        `version`); None when the log was trimmed past it (full rebuild).
        Mirrors TelemetryStore.changes_since."""
        with self._lock:
            return self._changes.changes_since(version)

    def changes_since_directed(self, version: int):
        """changes_since plus the grew subset (changelog docstring): a
        node only in dirty (all its changes were binds/claims) cannot
        have gained capacity since `version`."""
        with self._lock:
            return self._changes.changes_since_directed(version)

    # ------------------------------------------------------------- node admin
    def add_node(self, name: str) -> None:
        with self._lock:
            fresh = name not in self._nodes
            if fresh:
                self._nodes_ver += 1
            self._nodes.add(name)
            self._bound.setdefault(name, [])
        if fresh:
            self._publish(ClusterEvent(NODE_ADDED, node=name))

    def add_nodes_from_telemetry(self) -> None:
        for m in self.telemetry.list():
            self.add_node(m.node)

    def pods_version(self, node: str) -> int:
        with self._lock:
            return self._pods_ver.get(node, 0)

    def remove_node(self, name: str) -> list[Pod]:
        """Node goes away; its pods return to the caller for requeueing."""
        with self._lock:
            if name in self._nodes:
                self._nodes_ver += 1
            self._nodes.discard(name)
            self._meta.pop(name, None)
            orphans = self._bound.pop(name, [])
            for p in orphans:
                if self._bound_keys.get(p.key) == name:
                    del self._bound_keys[p.key]
            self._bump(name)
        for p in orphans:
            p.node = None
            p.phase = PodPhase.PENDING
        return orphans

    def set_pdbs(self, budgets) -> None:
        """Install the cluster's PodDisruptionBudgets (utils/pdb.py model).
        Bumps the global change log: allowance changes can unblock pods
        whose preemption previously had no non-violating plan."""
        with self._lock:
            self._pdbs = tuple(budgets)
            self._nodes_ver += 1

    def disruption_budgets(self) -> tuple:
        with self._lock:
            return self._pdbs

    def set_namespace_labels(self, ns: str, labels: dict[str, str]) -> None:
        """Install a namespace object's metadata.labels (podAffinityTerm
        namespaceSelector input). Bumps the membership version like a PDB
        change: verdicts anywhere can depend on namespace labels."""
        with self._lock:
            self._namespaces[ns] = dict(labels)
            self._nodes_ver += 1

    def namespace_labels_map(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._namespaces)

    def set_node_meta(self, name: str, labels: dict[str, str] | None = None,
                      taints: list[dict] | tuple = (),
                      allocatable: tuple | None = None,
                      unschedulable: bool = False) -> None:
        """Node-object metadata.labels / spec.taints / status.allocatable
        as (cpu millicores, memory bytes) / spec.unschedulable (cordon)
        (admission plugin inputs). Bumps the node's change counter: an
        edit must invalidate cached NodeInfos and filter verdicts — and
        an uncordon must wake pending classmates event-driven."""
        with self._lock:
            self.add_node(name)
            self._meta[name] = (dict(labels or {}), tuple(taints),
                                allocatable, bool(unschedulable))
            self._bump(name)
        self._publish(ClusterEvent(NODE_SPEC_CHANGED, node=name))

    def node_meta(self, name: str) -> tuple[dict[str, str], tuple]:
        with self._lock:
            return self._meta.get(name, ({}, (), None, False))[:2]

    def node_allocatable(self, name: str) -> tuple | None:
        with self._lock:
            meta = self._meta.get(name)
            return meta[2] if meta is not None else None

    def node_unschedulable(self, name: str) -> bool:
        with self._lock:
            meta = self._meta.get(name)
            return bool(meta[3]) if meta is not None else False

    # ---------------------------------------------------------------- reading
    def node_names(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def pods_on(self, node: str) -> list[Pod]:
        with self._lock:
            return list(self._bound.get(node, []))

    def all_pods(self) -> list[Pod]:
        with self._lock:
            return [p for pods in self._bound.values() for p in pods]

    def bound_node_of(self, key: str) -> str | None:
        """Node holding pod `key`, or None — the cluster-truth read the
        engine's ambiguous-bind adoption, restart reconciliation, and
        foreign-bind conflict handling use (binding present in the
        cluster => adopt/drop; absent => requeue). O(1) off the bound-key
        index."""
        with self._lock:
            return self._bound_keys.get(key)

    # ---------------------------------------------------------------- binding
    def _reject(self, reason: str, message: str) -> None:
        # callers hold self._lock
        self.bind_conflicts[reason] = self.bind_conflicts.get(reason, 0) + 1
        raise BindConflictError(message)

    def _check_bind(self, pod: Pod, node: str, assigned_chips,
                    fence) -> None:
        """Bind-time conflict enforcement, the authority's half of the
        optimistic-concurrency contract (callers hold self._lock; raises
        BEFORE any mutation). A fleet replica commits from its own
        snapshot — the one place its stale view is actually checked is
        here: already-bound pod, overlapping chip claim, per-chip HBM
        oversubscription, or a stale fencing token all 409."""
        cur = self._bound_keys.get(pod.key)
        if cur is not None:
            self._reject("pod_bound",
                         f"pod {pod.key} is already bound to {cur}")
        if fence is not None and self.lease_authority is not None \
                and not self.lease_authority.validate_fence(fence):
            self._reject("stale_fence",
                         f"fencing token {fence} is stale (lease "
                         "expired or reassigned)")
        claimed = set(assigned_chips or ())
        if not claimed:
            return
        taken: set = set()
        for q in self._bound.get(node, ()):
            taken |= q.assigned_chips()
        overlap = claimed & taken
        if overlap:
            self._reject("chip_claim",
                         f"chip claim conflict on {node}: "
                         f"{sorted(overlap)} already owned")
        need_mb = int(pod.labels.get("scv/memory", "0") or 0)
        if need_mb:
            m = self.telemetry.get(node)
            if m is not None:
                # coords index memoised per metrics incarnation (put()
                # installs a fresh object): rebuilt dicts per bind were
                # a measurable slice of authority cost at drain scale
                by_coord = m.__dict__.get("_by_coord")
                if by_coord is None:
                    by_coord = {c.coords: c for c in m.chips}
                    m.__dict__["_by_coord"] = by_coord
                for c in claimed:
                    chip = by_coord.get(c)
                    if chip is not None and need_mb > chip.hbm_free_mb:
                        self._reject(
                            "hbm",
                            f"HBM oversubscription on {node}/{c}: "
                            f"need {need_mb}MB > free {chip.hbm_free_mb}MB")

    def bind(self, pod: Pod, node: str,
             assigned_chips: list[tuple[int, int, int]] | None = None,
             fence=None) -> None:
        with self._lock:
            if node not in self._nodes:
                raise KeyError(f"bind target {node!r} is not a node")
            self._check_bind(pod, node, assigned_chips, fence)
            pod.node = node
            pod.phase = PodPhase.BOUND
            if assigned_chips is not None:
                pod.labels[ASSIGNED_CHIPS_LABEL] = format_assigned_chips(assigned_chips)
            self._bound[node].append(pod)
            self._bound_keys[pod.key] = node
            self._bump(node, grew=False)  # a bind only consumes capacity
        self._publish(ClusterEvent(POD_BOUND, node=node))

    def evict(self, pod: Pod) -> None:
        node = pod.node
        removed = False
        with self._lock:
            if pod.node and pod.node in self._bound:
                before = self._bound[pod.node]
                after = [p for p in before if p.uid != pod.uid]
                removed = len(after) != len(before)
                self._bound[pod.node] = after
                if removed and self._bound_keys.get(pod.key) == pod.node:
                    del self._bound_keys[pod.key]
                self._bump(pod.node)
        pod.node = None
        pod.phase = PodPhase.PENDING
        pod.labels.pop(ASSIGNED_CHIPS_LABEL, None)
        if removed:
            # only a REAL departure frees capacity; evicting a pod that
            # was never bound (or already gone) must not wake every
            # capacity-parked pod for a doomed retry (mirrors
            # KubeCluster._pod_event, which emits POD_DELETED only for
            # cached pods with a node). The gang label rides along so
            # the elastic controller can retire a growing record whose
            # gang was deleted externally (core._drain_elastic_retires).
            self._publish(ClusterEvent(
                POD_DELETED, node=node,
                gang=pod.labels.get("tpu/gang-name")))
