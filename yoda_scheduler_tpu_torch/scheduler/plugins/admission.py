"""Node admission: nodeSelector + taints/tolerations (upstream parity).

The reference never implemented these checks itself — it registered one
plugin INTO full kube-scheduler (reference pkg/register/register.go:10-12),
so every pod it placed also passed upstream's NodeAffinity and
TaintToleration plugins (enabled by default in the embedded framework).
A standalone engine that dropped them would bind pods onto cordoned or
dedicated nodes that the reference deployment would have refused, so this
plugin restores the same contract:

- Filter: ``spec.nodeSelector`` must be a subset of the node's labels
  (upstream NodeAffinity's required term for plain selectors), and every
  node taint with effect NoSchedule/NoExecute must be tolerated
  (upstream TaintToleration filter semantics).
- Score: nodes with untolerated PreferNoSchedule taints score lower
  (upstream TaintToleration scoring), so tainted-but-admissible nodes are
  a last resort rather than a coin flip.

Toleration matching follows the Kubernetes spec: operator Exists matches
any value (an empty key with Exists tolerates everything); operator Equal
(the default) requires the values to match; an empty toleration effect
matches every effect.
"""

from __future__ import annotations

from ..framework import (
    ClusterEvent,
    CycleState,
    EnqueueExtensions,
    FilterPlugin,
    NO_BATCH,
    NODE_ADDED,
    NODE_SPEC_CHANGED,
    NodeInfo,
    POD_DELETED,
    QUEUE,
    ScorePlugin,
    SKIP,
    Status,
)
from ..columnar import np as _np
from ...utils.pod import NODE_NAME_FIELD, Pod

NO_SCHEDULE = "NoSchedule"
NO_EXECUTE = "NoExecute"
PREFER_NO_SCHEDULE = "PreferNoSchedule"

# the taint the node controller adds for a cordoned node; upstream's
# NodeUnschedulable plugin checks spec.unschedulable directly but admits
# pods tolerating this taint — same escape hatch here
UNSCHEDULABLE_TAINT = {"key": "node.kubernetes.io/unschedulable",
                       "value": "", "effect": NO_SCHEDULE}


def _tolerates_cordon(pod: Pod) -> bool:
    return not untolerated(pod, (UNSCHEDULABLE_TAINT,), (NO_SCHEDULE,))


_WILDCARD_IPS = ("", "0.0.0.0")


def ports_conflict(a: tuple, b: tuple) -> bool:
    """Two (hostPort, protocol, hostIP) claims conflict iff the port and
    protocol match and the host IPs overlap — "" and "0.0.0.0" are both
    the bind-all address, overlapping everything (upstream NodePorts
    semantics, DefaultBindAllHostIP)."""
    return (a[0] == b[0] and a[1] == b[1]
            and (a[2] == b[2] or a[2] in _WILDCARD_IPS
                 or b[2] in _WILDCARD_IPS))


def _port_conflicts(wanted: tuple, held: tuple) -> bool:
    return any(ports_conflict(w, h) for w in wanted for h in held)


def tolerates(toleration: dict, taint: dict) -> bool:
    """One toleration vs one taint, k8s semantics."""
    effect = toleration.get("effect", "")
    if effect and effect != taint.get("effect", ""):
        return False
    key = toleration.get("key", "")
    op = toleration.get("operator", "Equal")
    if not key:
        # empty key + Exists tolerates all taints; empty key + Equal is
        # invalid per the API (apiserver rejects it) — treat as no match
        return op == "Exists"
    if key != taint.get("key", ""):
        return False
    if op == "Exists":
        return True
    return toleration.get("value", "") == taint.get("value", "")


def _match_expression(labels: dict, key: str, op: str, values: tuple) -> bool:
    """One nodeAffinity matchExpression vs node labels (k8s semantics)."""
    present = key in labels
    if op == "In":
        return present and labels[key] in values
    if op == "NotIn":
        return not present or labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        if not present or not values:
            return False
        try:
            node_v = int(labels[key])
            want = int(values[0])
        except ValueError:
            return False
        return node_v > want if op == "Gt" else node_v < want
    return False  # unknown operator matches nothing (apiserver rejects it)


def affinity_matches(pod: Pod, labels: dict,
                     node_name: str | None = None) -> bool:
    """Required nodeAffinity: terms OR together, expressions within a term
    AND together; no terms = no constraint. matchFields expressions on
    metadata.name resolve against `node_name`."""
    terms = pod.node_affinity
    if not terms:
        return True

    def match(k, op, vals):
        if k == NODE_NAME_FIELD:
            if node_name is None:
                return False
            return _match_expression({k: node_name}, k, op, vals)
        return _match_expression(labels, k, op, vals)

    return any(
        all(match(k, op, vals) for k, op, vals in term)
        for term in terms
    )


def _term_applies_ns(term: tuple, subject_ns: str, ns: str,
                     ns_labels_of) -> bool:
    """Is namespace `ns` applicable for this PodAffinityTerm? Applicable
    namespaces are the UNION of the term's explicit list and the
    namespaces its namespaceSelector picks (matched against NAMESPACE
    labels via `ns_labels_of`); with neither, the owner's namespace
    (upstream semantics). An EMPTY namespaceSelector ({}) selects every
    namespace; a selector we cannot resolve (no namespace-labels source)
    selects nothing — conservative."""
    namespaces = term[2]
    ns_sel = term[5] if len(term) > 5 else None
    if namespaces and ns in namespaces:
        return True
    if ns_sel is not None:
        sml, sexprs, sall = ns_sel
        if sall:
            return True
        nl = ns_labels_of(ns) if ns_labels_of is not None else None
        if nl is not None and (
                all(nl.get(k) == v for k, v in sml)
                and all(_match_expression(nl, k, op, vals)
                        for k, op, vals in sexprs)):
            return True
    if not namespaces and ns_sel is None:
        return ns == subject_ns
    return False


def _pod_term_selects(term: tuple, subject_ns: str, candidate: Pod,
                      ns_labels_of=None, ns_memo: dict | None = None) -> bool:
    """Does one PodAffinityTerm's labelSelector select `candidate`?
    Namespace applicability per _term_applies_ns; `ns_memo` (a per-index-
    build dict) memoises it per (term, namespace) — the index scans are
    O(nodes x bound pods) and re-deriving a namespaceSelector verdict per
    candidate repeats identical work. LabelSelector semantics: a NIL
    (absent) selector matches no pods; a present-but-EMPTY selector
    matches every pod in the applicable namespaces."""
    if ns_memo is not None:
        mkey = (id(term), candidate.namespace)
        in_ns = ns_memo.get(mkey)
        if in_ns is None:
            in_ns = _term_applies_ns(term, subject_ns, candidate.namespace,
                                     ns_labels_of)
            ns_memo[mkey] = in_ns
    else:
        in_ns = _term_applies_ns(term, subject_ns, candidate.namespace,
                                 ns_labels_of)
    if not in_ns:
        return False
    ml, exprs, _namespaces, _key, match_all = term[:5]
    if match_all:
        return True
    if not ml and not exprs:
        return False
    labels = candidate.labels
    return (
        all(labels.get(k) == v for k, v in ml)
        and all(_match_expression(labels, k, op, vals)
                for k, op, vals in exprs)
    )


_POD_AFFINITY_STATE = "admission/pod-affinity-index"

# affinity term satisfied everywhere: the incoming pod matches its OWN
# term and no bound pod does — upstream's bootstrap special case, without
# which the first replica of a self-affinity workload deadlocks forever
_SELF_SATISFIED = None


def _pod_affinity_index(state: CycleState, pod: Pod, snapshot) -> tuple:
    """Per-cycle index for inter-pod (anti-)affinity, computed once per
    pod cycle and cached in CycleState:

    - affinity: for each of the pod's podAffinity terms,
      (term, frozenset of satisfying domain values, or _SELF_SATISFIED)
    - anti: for each of the pod's podAntiAffinity terms,
      (term, {domain value: [conflicting bound pods]})
    - reverse: (term, owner pod, topology_key, domain_value) for every
      BOUND pod's anti-affinity term in its node's domain — the symmetry
      rule (an existing pod's anti-affinity also repels incoming matches)
    """
    cached = state.read_or(_POD_AFFINITY_STATE)
    if cached is not None:
        return cached
    nodes = snapshot.list()
    nlo = getattr(snapshot, "namespace_labels", None)
    ns_memo: dict = {}

    affinity = []
    for term in pod.pod_affinity:
        counts = _term_domain_counts(term, pod.namespace, nodes, nlo,
                                     ns_memo)
        if not counts and _pod_term_selects(term, pod.namespace, pod, nlo,
                                            ns_memo):
            affinity.append((term, _SELF_SATISFIED))
        else:
            affinity.append((term, frozenset(counts)))

    anti = []
    for term in pod.pod_anti_affinity:
        key = term[3]
        by_dom: dict = {}
        if key:
            for ni in nodes:
                dom = ni.labels.get(key)
                if dom is None:
                    continue
                for p in ni.pods:
                    if not p.terminating and _pod_term_selects(
                            term, pod.namespace, p, nlo, ns_memo):
                        by_dom.setdefault(dom, []).append(p)
        anti.append((term, by_dom))

    reverse = []
    for ni in nodes:
        for bound in ni.pods:
            if bound.terminating:
                continue
            for term in bound.pod_anti_affinity:
                key = term[3]
                dom = ni.labels.get(key) if key else None
                if dom is not None:
                    reverse.append((term, bound, key, dom))
    index = (tuple(affinity), tuple(anti), tuple(reverse))
    state.write(_POD_AFFINITY_STATE, index)
    return index


def untolerated(pod: Pod, taints: tuple, effects: tuple[str, ...]) -> list[dict]:
    """Taints with an effect in `effects` that no pod toleration covers."""
    tols = pod.tolerations
    return [
        t for t in taints
        if t.get("effect") in effects
        and not any(tolerates(tol, t) for tol in tols)
    ]


def admissible(pod: Pod, node: NodeInfo) -> bool:
    """Would NodeAdmission.filter pass this (pod, node)? Used by the
    preemption planner: evicting victims on a node the preemptor's
    nodeSelector/tolerations/affinity can never accept would disrupt
    workloads for a pod that stays Pending (upstream preemption re-filters
    candidate nodes the same way)."""
    if pod.node_selector:
        labels = node.labels
        for k, v in pod.node_selector.items():
            if labels.get(k) != v:
                return False
    if not affinity_matches(pod, node.labels, node.name):
        return False
    if node.taints and untolerated(pod, node.taints,
                                   (NO_SCHEDULE, NO_EXECUTE)):
        return False
    if node.unschedulable and not _tolerates_cordon(pod):
        return False
    return True


_PREF_POD_AFF_STATE = "admission/preferred-pod-affinity-index"


def _term_domain_counts(term: tuple, subject_ns: str, nodes,
                        ns_labels_of=None, ns_memo: dict | None = None
                        ) -> dict:
    """{topology-domain value: number of matching bound pods} for one
    PodAffinityTerm — the shared scan behind both the required-affinity
    index and preferred scoring (multiplicity matters for the latter:
    upstream weights once per matching pod, not once per domain)."""
    key = term[3]
    counts: dict = {}
    if key:
        for ni in nodes:
            dom = ni.labels.get(key)
            if dom is None:
                continue
            n = sum(1 for p in ni.pods
                    if not p.terminating
                    and _pod_term_selects(term, subject_ns, p, ns_labels_of,
                                          ns_memo))
            if n:
                counts[dom] = counts.get(dom, 0) + n
    return counts


def _preferred_pod_affinity_index(state: CycleState, pod: Pod,
                                  snapshot) -> tuple:
    """Per-cycle index for PREFERRED inter-pod (anti-)affinity scoring.
    Two contribution kinds, both upstream InterPodAffinity semantics:

    - the incoming pod's own preferred terms: (weight, key,
      {domain: matching-pod count}) — weight accrues once per matching
      pod in the candidate's domain
    - SYMMETRIC entries from bound pods' preferred terms that select the
      incoming pod: (weight, key, {domain-of-that-bound-pod: 1})
    """
    cached = state.read_or(_PREF_POD_AFF_STATE)
    if cached is not None:
        return cached
    nodes = snapshot.list()
    nlo = getattr(snapshot, "namespace_labels", None)
    ns_memo: dict = {}
    out = []
    for w, term in pod.preferred_pod_affinity:
        counts = _term_domain_counts(term, pod.namespace, nodes, nlo,
                                     ns_memo)
        if counts:
            out.append((w, term[3], counts))
    if snapshot.any_preferred_pod_affinity():
        for ni in nodes:
            for bound in ni.pods:
                if bound.terminating:
                    continue
                for w, term in bound.preferred_pod_affinity:
                    key = term[3]
                    dom = ni.labels.get(key) if key else None
                    if dom is not None and _pod_term_selects(
                            term, bound.namespace, pod, nlo, ns_memo):
                        out.append((w, key, {dom: 1}))
    index = tuple(out)
    state.write(_PREF_POD_AFF_STATE, index)
    return index


_SPREAD_STATE = "admission/topology-spread-index"


def _spread_selects(constraint: tuple, pod: Pod, candidate: Pod) -> bool:
    """Does a topologySpreadConstraint's labelSelector select `candidate`?
    Spread selectors are namespace-local to the incoming pod.
    matchLabelKeys (upstream fine grain): the INCOMING pod's values for
    those label keys become exact requirements on the candidate — the
    pod-template-hash idiom, spreading within one revision only. A key
    the incoming pod lacks is skipped (upstream drops it)."""
    _skew, _key, _when, ml, exprs, match_all = constraint[:6]
    mlk = constraint[7] if len(constraint) > 7 else ()
    if candidate.namespace != pod.namespace:
        return False
    for k in mlk:
        v = pod.labels.get(k)
        if v is not None and candidate.labels.get(k) != v:
            return False
    if match_all:
        return True
    if not ml and not exprs:
        return False
    labels = candidate.labels
    return (
        all(labels.get(k) == v for k, v in ml)
        and all(_match_expression(labels, k, op, vals)
                for k, op, vals in exprs)
    )


def _spread_index(state: CycleState, pod: Pod, snapshot) -> tuple:
    """Per-cycle index: for each of the pod's spread constraints,
    (constraint, {domain: matching-pod count}, global minimum count,
    self-match). Domains are the distinct values of the constraint's
    topologyKey over nodes IN THE SPREADING SPACE:

    - nodes without the key are outside it (upstream semantics)
    - nodeAffinityPolicy Honor (the default): nodes the pod's own
      nodeSelector / required nodeAffinity exclude are outside it
    - nodeTaintsPolicy Honor: nodes with untolerated NoSchedule/NoExecute
      taints are outside it (default Ignore)
    - minDomains (DoNotSchedule only): while the space holds fewer than
      minDomains domains, the global minimum is treated as 0, forcing new
      pods onto new domains (upstream semantics)"""
    cached = state.read_or(_SPREAD_STATE)
    if cached is not None:
        return cached
    nodes = snapshot.list()
    out = []
    for c in pod.topology_spread:
        key = c[1]
        min_domains = c[6] if len(c) > 6 else None
        na_policy = c[8] if len(c) > 8 else "Honor"
        nt_policy = c[9] if len(c) > 9 else "Ignore"
        counts: dict = {}
        for ni in nodes:
            dom = ni.labels.get(key)
            if dom is None:
                continue
            if na_policy != "Ignore" and not _node_passes_pod_node_affinity(
                    pod, ni):
                continue
            if (nt_policy == "Honor" and ni.taints
                    and untolerated(pod, ni.taints,
                                    (NO_SCHEDULE, NO_EXECUTE))):
                continue
            counts[dom] = counts.get(dom, 0) + sum(
                1 for p in ni.pods
                if not p.terminating and _spread_selects(c, pod, p)
            )
        global_min = min(counts.values()) if counts else 0
        if (min_domains is not None and c[2] == "DoNotSchedule"
                and len(counts) < min_domains):
            global_min = 0
        # upstream selfMatchNum: placing the pod raises its domain's count
        # only when the pod matches its OWN selector
        self_match = 1 if _spread_selects(c, pod, pod) else 0
        out.append((c, counts, global_min, self_match))
    index = tuple(out)
    state.write(_SPREAD_STATE, index)
    return index


def _node_passes_pod_node_affinity(pod: Pod, ni: NodeInfo) -> bool:
    """Is this node inside the pod's own nodeSelector + required
    nodeAffinity? (The spreading-space membership test behind
    nodeAffinityPolicy: Honor.)"""
    if pod.node_selector:
        labels = ni.labels
        for k, v in pod.node_selector.items():
            if labels.get(k) != v:
                return False
    return affinity_matches(pod, ni.labels, ni.name)


def preemption_obstacles(state: CycleState, pod: Pod, node: NodeInfo,
                         snapshot, evictable_fn, allocator=None,
                         priority: int = 0) -> list[Pod] | None:
    """Can eviction make this node pass the pod's inter-pod constraints?

    Returns None when it cannot (required podAffinity needs a matching
    pod PRESENT — eviction only removes; or a conflicting pod is not
    evictable), else the (possibly empty) list of conflicting pods that
    must be evicted alongside any capacity victims. Used by the
    preemption planner so it never churns victims on a node the
    preemptor still couldn't pass (the same contract admissible() gives
    it for node-level admission)."""
    # NodePorts: a port conflict is curable only when every conflicting
    # holder can be evicted (terminating holders free it on their own);
    # the evictions join the plan so the bind actually succeeds
    port_victims: list[Pod] = []
    if pod.host_ports:
        if allocator is not None:
            # a port held for an outranking nominated preemptor is NOT
            # cured by eviction — the holder is a pending pod, not a
            # bound one, so planning victims here only churns evictions
            # while the NodeAdmission filter keeps rejecting the bind
            nom_fn = getattr(allocator, "nominated_ports", None)
            held = (nom_fn(node.name, priority, exclude_key=pod.key)
                    if nom_fn is not None else ())
            if held and _port_conflicts(pod.host_ports, held):
                return None
        for p in node.pods:
            if p.host_ports and _port_conflicts(pod.host_ports,
                                                p.host_ports):
                if p.terminating:
                    continue
                if not evictable_fn(p):
                    return None
                port_victims.append(p)
    # NodeResourcesFit: if even evicting every evictable pod leaves too
    # little cpu/mem for the preemptor, the node is uncurable
    if (pod.cpu_millis or pod.memory_bytes) and node.allocatable is not None:
        keep_cpu = keep_mem = 0
        for p in node.pods:
            if not p.terminating and not evictable_fn(p):
                keep_cpu += p.cpu_millis
                keep_mem += p.memory_bytes
        if (keep_cpu + pod.cpu_millis > node.allocatable[0]
                or keep_mem + pod.memory_bytes > node.allocatable[1]):
            return None
    # DoNotSchedule spread violations: eviction COULD cure skew, but
    # proving it needs plan simulation — skip such nodes conservatively
    # rather than churn victims on a still-infeasible node
    for c, counts, global_min, self_match in _spread_index(
            state, pod, snapshot):
        if c[2] != "DoNotSchedule":
            continue
        dom = node.labels.get(c[1])
        if dom is None or counts.get(dom, 0) + self_match - global_min > c[0]:
            return None
    if not (pod.pod_affinity or pod.pod_anti_affinity
            or snapshot.any_pod_anti_affinity()):
        return port_victims
    aff, anti, reverse = _pod_affinity_index(state, pod, snapshot)
    labels = node.labels
    for term, domains in aff:
        if domains is _SELF_SATISFIED:
            continue
        key = term[3]
        dom = labels.get(key) if key else None
        if dom is None or dom not in domains:
            return None  # eviction cannot ADD a matching pod
    must: dict[str, Pod] = {}
    for term, by_dom in anti:
        key = term[3]
        dom = labels.get(key) if key else None
        for conflict in by_dom.get(dom, ()) if dom is not None else ():
            if not evictable_fn(conflict):
                return None
            must[conflict.key] = conflict
    nlo = getattr(snapshot, "namespace_labels", None)
    for term, owner, key, dom in reverse:
        if labels.get(key) == dom and _pod_term_selects(
                term, owner.namespace, pod, nlo):
            if not evictable_fn(owner):
                return None
            must[owner.key] = owner
    for v in port_victims:
        must.setdefault(v.key, v)
    return list(must.values())


class NodeAdmission(FilterPlugin, ScorePlugin, EnqueueExtensions):
    name = "node-admission"
    weight = 1
    # normalize below is exactly min_max_normalize with default bounds
    # (framework.ScorePlugin.normalize_kind fusion contract)
    normalize_kind = "minmax"

    def __init__(self, allocator=None) -> None:
        # ChipAllocator (optional): source of nominated-preemptor cpu/mem
        # holds, so a third pod can't steal resources a preemption freed
        # while the victims drain
        self.allocator = allocator

    # --------------------------------------------------- queueing hints
    def events_to_register(self) -> tuple:
        """Admission rejections cure on a node spec edit (label added,
        taint removed, uncordon), a node join, or — for the pod-shaped
        predicates (anti-affinity, hostPorts, cpu/mem, spread) — a pod
        leaving."""
        return (NODE_SPEC_CHANGED, NODE_ADDED, POD_DELETED)

    def queueing_hint(self, event: ClusterEvent, pod: Pod) -> str:
        if event.kind == POD_DELETED:
            # a departure can only cure predicates that counted pods;
            # nodeSelector/taint/cordon rejections stay parked
            if (pod.host_ports or pod.cpu_millis or pod.memory_bytes
                    or pod.pod_anti_affinity or pod.pod_affinity
                    or pod.topology_spread):
                return QUEUE
            return SKIP
        return QUEUE

    def equivalence_key(self, pod: Pod):
        """Batch-cycle contract: admission verdicts read several
        POD-SPECIFIC inputs beyond the WorkloadSpec. The per-node ones
        (selector, tolerations, node affinity incl. preferences, cpu/mem
        requests) are pure functions of the pod fields below, so they go
        INTO the key — classmates must carry identical values. The
        pod-shaped predicates (inter-pod terms, spread, hostPorts) couple
        a verdict to OTHER pods' placement mid-batch, so such pods never
        batch at all."""
        if (pod.pod_affinity or pod.pod_anti_affinity
                or pod.preferred_pod_affinity or pod.topology_spread
                or pod.host_ports):
            return NO_BATCH
        if not (pod.node_selector or pod.tolerations or pod.node_affinity
                or pod.preferred_affinity or pod.cpu_millis
                or pod.memory_bytes):
            return ()
        return (frozenset(pod.node_selector.items()),
                tuple((t.get("key", ""), t.get("operator", "Equal"),
                       t.get("value", ""), t.get("effect", ""))
                      for t in pod.tolerations),
                pod.node_affinity, pod.preferred_affinity,
                pod.cpu_millis, pod.memory_bytes)

    def relevant(self, pod: Pod, snapshot) -> bool:
        """Hot-loop gate (core.py): on an untainted cluster a pod without
        selectors, affinities, or inter-pod terms — and with no bound pod
        carrying anti-affinity (the symmetry rule) — cannot be affected by
        this plugin, so the engine drops it from the per-(pod, node)
        filter/score loops. Tolerations alone never change a verdict —
        they only permit what taints would block."""
        return (bool(pod.node_selector) or bool(pod.node_affinity)
                or bool(pod.preferred_affinity) or bool(pod.pod_affinity)
                or bool(pod.pod_anti_affinity)
                or bool(pod.preferred_pod_affinity)
                or bool(pod.topology_spread)
                or bool(pod.host_ports)
                or (bool(pod.cpu_millis or pod.memory_bytes)
                    and snapshot.any_allocatable())
                or snapshot.any_taints()
                or snapshot.any_unschedulable()
                or snapshot.any_pod_anti_affinity())

    def score_relevant(self, pod: Pod, snapshot) -> bool:
        """Score-side gate: only preferred affinity, spread constraints,
        and PreferNoSchedule taints contribute to scoring — inter-pod
        terms (which re-enable the FILTER for every pod via the symmetry
        rule) must not drag the constant-zero score hook back into the
        hot loop cluster-wide."""
        return (bool(pod.preferred_affinity) or bool(pod.topology_spread)
                or bool(pod.preferred_pod_affinity)
                or snapshot.any_preferred_pod_affinity()
                or snapshot.any_taints())

    def _fast_checks_only(self, pod: Pod, snapshot) -> bool:
        """True when cordon + nodeSelector are the ONLY admission
        predicates that can fire for this pod on this snapshot — the
        eligibility gate shared by filter_batch and the native kernel."""
        return not (pod.node_affinity or pod.pod_affinity
                    or pod.pod_anti_affinity
                    or pod.topology_spread or pod.host_ports
                    or ((pod.cpu_millis or pod.memory_bytes)
                        and snapshot.any_allocatable())
                    or snapshot.any_taints()
                    or snapshot.any_pod_anti_affinity())

    def native_filter_args(self, state: CycleState, pod: Pod, table):
        """Fused-kernel capability hook: cordon flag + the per-label-class
        nodeSelector verdict vector, evaluated inside the kernel. Veto
        set identical to filter_batch's."""
        snapshot = state.read_or("snapshot")
        if snapshot is None or not self._fast_checks_only(pod, snapshot):
            return None
        args = {}
        if not _tolerates_cordon(pod):
            args["check_cordon"] = 1
        if pod.node_selector:
            args["sel_by_class"] = table.selector_classes(pod.node_selector)
        return args

    def filter_batch(self, state: CycleState, pod: Pod, table, rows=None):
        """Columnar verdicts for the admission FAST checks — cordon flag
        and exact-match nodeSelector, the two predicates expressible over
        the cordon-bit and label-class-id columns. Bails (None) whenever
        any other admission predicate could fire for this pod on this
        snapshot (affinity, spread, ports, cpu/mem vs allocatable,
        taints, the anti-affinity symmetry rule): those need the object
        snapshot, so the whole pod takes the scalar path."""
        snapshot = state.read_or("snapshot")
        if snapshot is None:
            return None
        if not self._fast_checks_only(pod, snapshot):
            return None
        ok = _np.ones(len(table) if rows is None else len(rows), dtype=bool)
        if not _tolerates_cordon(pod):
            ok &= ~(table.unsched if rows is None else table.unsched[rows])
        if pod.node_selector:
            ok &= table.selector_mask(pod.node_selector, rows)
        return ok

    def filter(self, state: CycleState, pod: Pod, node: NodeInfo) -> Status:
        # NodeUnschedulable (kubectl cordon): upstream checks
        # spec.unschedulable itself — relying on the auto-added
        # unschedulable taint alone would admit pods while the node
        # controller lags
        if node.unschedulable and not _tolerates_cordon(pod):
            return Status.unschedulable(
                f"{node.name}: node is cordoned (spec.unschedulable)")
        sel = pod.node_selector
        if sel:
            labels = node.labels
            for k, v in sel.items():
                if labels.get(k) != v:
                    return Status.unschedulable(
                        f"{node.name}: nodeSelector {k}={v} not satisfied")
        if pod.node_affinity and not affinity_matches(
                pod, node.labels, node.name):
            return Status.unschedulable(
                f"{node.name}: required nodeAffinity not satisfied")
        snapshot = state.read_or("snapshot")
        if snapshot is not None and (
                pod.pod_affinity or pod.pod_anti_affinity
                or snapshot.any_pod_anti_affinity()):
            st = self._filter_pod_affinity(state, pod, node, snapshot)
            if not st.ok:
                return st
        if snapshot is not None and pod.topology_spread:
            st = self._filter_spread(state, pod, node, snapshot)
            if not st.ok:
                return st
        # NodePorts: a claimed hostPort must not collide with one a bound
        # pod already holds (wildcard hostIP overlaps everything) — nor
        # with a port held for a nominated preemptor of outranking
        # priority (the ports twin of the cpu/mem hold below: a third
        # pod must not bind the port a preemption just freed)
        if pod.host_ports:
            held = node.used_host_ports()
            if self.allocator is not None:
                spec = state.read_or("workload_spec")
                held = held + self.allocator.nominated_ports(
                    node.name, spec.priority if spec is not None else 0,
                    pod.key)
            if _port_conflicts(pod.host_ports, held):
                return Status.unschedulable(
                    f"{node.name}: hostPort already in use")
        # NodeResourcesFit: cpu/memory requests vs node allocatable
        # (nodes reporting no allocatable are unconstrained — in-memory
        # fakes and accelerator-only fleets)
        if (pod.cpu_millis or pod.memory_bytes) \
                and node.allocatable is not None:
            used_cpu, used_mem = node.requested_cpu_mem()
            if self.allocator is not None:
                spec = state.read_or("workload_spec")
                prio = spec.priority if spec is not None else 0
                hold_cpu, hold_mem = self.allocator.nominated_cpu_mem(
                    node.name, prio, pod.key)
                used_cpu += hold_cpu
                used_mem += hold_mem
                m = node.metrics
                if m is not None and m.slice_id:
                    gcpu, gmem = self.allocator.gang_cpu_mem_hold(
                        m.slice_id, prio,
                        exclude_gang=spec.gang_name if spec is not None
                        else None,
                        now=state.read_or("now"))
                    used_cpu += gcpu
                    used_mem += gmem
            alloc_cpu, alloc_mem = node.allocatable
            if used_cpu + pod.cpu_millis > alloc_cpu:
                return Status.unschedulable(
                    f"{node.name}: insufficient cpu "
                    f"({used_cpu}m used + {pod.cpu_millis}m requested "
                    f"> {alloc_cpu}m allocatable)")
            if used_mem + pod.memory_bytes > alloc_mem:
                return Status.unschedulable(
                    f"{node.name}: insufficient memory "
                    f"({used_mem} used + {pod.memory_bytes} requested "
                    f"> {alloc_mem} allocatable)")
        if node.taints:
            bad = untolerated(pod, node.taints, (NO_SCHEDULE, NO_EXECUTE))
            if bad:
                t = bad[0]
                return Status.unschedulable(
                    f"{node.name}: untolerated taint "
                    f"{t.get('key')}={t.get('value')}:{t.get('effect')}")
        return Status.success()

    def _filter_pod_affinity(self, state: CycleState, pod: Pod,
                             node: NodeInfo, snapshot) -> Status:
        """Required inter-pod (anti-)affinity against the candidate node,
        driven by the per-cycle index (one cluster scan per pod cycle, not
        per node)."""
        aff, anti, reverse = _pod_affinity_index(state, pod, snapshot)
        nlo = getattr(snapshot, "namespace_labels", None)
        labels = node.labels
        for term, domains in aff:
            if domains is _SELF_SATISFIED:
                continue  # first replica of a self-affinity workload
            key = term[3]
            dom = labels.get(key) if key else None
            if dom is None or dom not in domains:
                return Status.unschedulable(
                    f"{node.name}: required podAffinity "
                    f"(topologyKey={key or '?'}) not satisfied")
        for term, by_dom in anti:
            key = term[3]
            dom = labels.get(key) if key else None
            if dom is not None and dom in by_dom:
                return Status.unschedulable(
                    f"{node.name}: podAntiAffinity conflict "
                    f"(topologyKey={key})")
        for term, owner, key, dom in reverse:
            if labels.get(key) == dom and _pod_term_selects(
                    term, owner.namespace, pod, nlo):
                return Status.unschedulable(
                    f"{node.name}: repelled by a bound pod's "
                    f"podAntiAffinity (topologyKey={key})")
        return Status.success()

    def _filter_spread(self, state: CycleState, pod: Pod, node: NodeInfo,
                       snapshot) -> Status:
        """DoNotSchedule topologySpreadConstraints: placing here must keep
        (candidate domain count + 1) - global minimum <= maxSkew. A node
        without the topologyKey cannot satisfy a DoNotSchedule constraint
        (upstream semantics)."""
        for c, counts, global_min, self_match in _spread_index(
                state, pod, snapshot):
            if c[2] != "DoNotSchedule":
                continue
            dom = node.labels.get(c[1])
            if dom is None:
                return Status.unschedulable(
                    f"{node.name}: node has no {c[1]!r} label "
                    f"(topologySpreadConstraint)")
            if counts.get(dom, 0) + self_match - global_min > c[0]:
                return Status.unschedulable(
                    f"{node.name}: topologySpreadConstraint maxSkew={c[0]} "
                    f"exceeded for {c[1]}={dom}")
        return Status.success()

    def score(self, state: CycleState, pod: Pod, node: NodeInfo
              ) -> tuple[float, Status]:
        score = 0.0
        snapshot = state.read_or("snapshot")
        if snapshot is not None and (
                pod.preferred_pod_affinity
                or snapshot.any_preferred_pod_affinity()):
            # preferred inter-pod (anti-)affinity, incl. bound pods'
            # symmetric terms: signed weight per matching pod in the
            # candidate's domain (index computed once per cycle)
            for w, key, counts in _preferred_pod_affinity_index(
                    state, pod, snapshot):
                dom = node.labels.get(key) if key else None
                if dom is not None and dom in counts:
                    score += w * counts[dom]
        if pod.topology_spread:
            snapshot = state.read_or("snapshot")
            if snapshot is not None:
                # ScheduleAnyway constraints: penalize skew instead of
                # filtering (upstream PodTopologySpread scoring). Nodes
                # OUTSIDE the spreading space (no topologyKey) score
                # strictly worse than any in-space domain — scoring them
                # 0 would invert the preference and pile the workload
                # onto unlabeled nodes.
                for c, counts, global_min, _self in _spread_index(
                        state, pod, snapshot):
                    if c[2] != "ScheduleAnyway":
                        continue
                    dom = node.labels.get(c[1])
                    if dom is not None:
                        score -= float(counts.get(dom, 0) - global_min)
                    else:
                        score -= float(
                            max(counts.values(), default=0) + 1 - global_min)
        # preferred nodeAffinity: sum of weights of matching preference
        # terms (upstream NodeAffinity scoring; weights 1-100 per term);
        # metadata.name matchFields resolve against the node's NAME
        for w, term in pod.preferred_affinity:
            if all(_match_expression(
                    {k: node.name} if k == NODE_NAME_FIELD else node.labels,
                    k, op, vals)
                   for k, op, vals in term):
                score += w
        if node.taints:
            n = len(untolerated(pod, node.taints, (PREFER_NO_SCHEDULE,)))
            score -= 100.0 * n
        return score, Status.success()

    def normalize(self, state: CycleState, pod: Pod,
                  scores: dict[str, float]) -> None:
        """Min-max rescale like the other score plugins: raw admission
        scores mix units (preference weights, skew counts, taint
        penalties) whose magnitudes would otherwise be swamped by — or
        swamp — the telemetry scorer's [0,100] range."""
        from ..framework import min_max_normalize

        min_max_normalize(scores)
