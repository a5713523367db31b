"""Minimal pod model — the slice of the Kubernetes Pod object the scheduler
actually consumes (reference uses *v1.Pod but touches only metadata.labels,
namespace/name, spec.schedulerName and nodeName)."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum

from .memo import memo
from .quantity import pod_host_ports, pod_requests


class PodPhase(str, Enum):
    PENDING = "Pending"
    BOUND = "Bound"
    FAILED = "Failed"


# Bind-time chip assignment, published on the pod (the device-plugin handshake
# analogue). Wire format: ";"-joined "x,y,z" coordinate triples.
ASSIGNED_CHIPS_LABEL = "tpu/assigned-chips"


def format_assigned_chips(coords) -> str:
    return ";".join(f"{x},{y},{z}" for x, y, z in coords)


_uid_counter = itertools.count(1)

# upstream's built-in PriorityClass values (scheduling/v1 defaults)
_WELL_KNOWN_PRIORITY = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}


# sentinel expression no node can satisfy (_match_expression returns False
# for unknown operators): represents terms we cannot evaluate — empty
# terms (match nothing per the API spec) and matchFields terms other than
# metadata.name (treating an unevaluable field selector as match-all would
# schedule a node-pinned pod anywhere)
_UNMATCHABLE_EXPR = ("", "__unsupported__", ())

# matchFields on metadata.name (the only field selector the NodeAffinity
# API accepts) translates to an expression on this reserved key, which the
# matcher resolves against the node's NAME rather than its labels
NODE_NAME_FIELD = "__field:metadata.name"


def _as_dict(x):
    return x if isinstance(x, dict) else {}


def _parse_term(term) -> tuple:
    """One nodeSelectorTerm/preference -> tuple of (key, operator,
    values-tuple) expressions. Shared by the required and preferred
    parsers so both evaluate expressions identically. matchFields on
    metadata.name (the only field the API accepts there) becomes a
    NODE_NAME_FIELD expression; other unevaluable content (non-dict
    expressions, unknown matchFields, empty terms) yields the unmatchable
    sentinel. Malformed shapes never raise (cli validate reports them)."""
    term = _as_dict(term)
    exprs = []
    raw_exprs = term.get("matchExpressions")
    for e in (raw_exprs if isinstance(raw_exprs, list) else []):
        if not isinstance(e, dict):
            exprs.append(_UNMATCHABLE_EXPR)
            continue
        vals = e.get("values")
        exprs.append((str(e.get("key", "")), str(e.get("operator", "")),
                      tuple(str(v) for v in vals)
                      if isinstance(vals, list) else ()))
    raw_fields = term.get("matchFields")
    if raw_fields is not None and not isinstance(raw_fields, list):
        # a malformed node pin must not be DROPPED — the term would lose
        # its constraint and the pod could bind anywhere
        exprs.append(_UNMATCHABLE_EXPR)
    for e in (raw_fields if isinstance(raw_fields, list) else []):
        if not isinstance(e, dict) or e.get("key") != "metadata.name":
            exprs.append(_UNMATCHABLE_EXPR)
            continue
        vals = e.get("values")
        exprs.append((NODE_NAME_FIELD, str(e.get("operator", "")),
                      tuple(str(v) for v in vals)
                      if isinstance(vals, list) else ()))
    if not exprs:
        exprs.append(_UNMATCHABLE_EXPR)  # empty term matches nothing
    return tuple(exprs)


def _node_affinity_of(spec):
    return _as_dict(_as_dict(_as_dict(spec).get("affinity"))
                    .get("nodeAffinity"))


def _parse_node_affinity(spec) -> tuple:
    """spec.affinity.nodeAffinity.requiredDuringSchedulingIgnoredDuring
    Execution -> tuple of terms (OR of terms), each a _parse_term tuple
    (AND within a term). The preferred... variant (scoring) parses
    separately via _parse_preferred_affinity."""
    req = _as_dict(_node_affinity_of(spec)
                   .get("requiredDuringSchedulingIgnoredDuringExecution"))
    raw_terms = req.get("nodeSelectorTerms")
    return tuple(_parse_term(t)
                 for t in (raw_terms if isinstance(raw_terms, list) else []))


def _parse_preferred_affinity(spec) -> tuple:
    """spec.affinity.nodeAffinity.preferredDuringSchedulingIgnoredDuring
    Execution -> tuple of (weight, term); same term shape as the required
    variant. Malformed entries — including weights outside the API's
    1-100 range, which a real apiserver rejects — are dropped (cli
    validate reports them)."""
    raw = _node_affinity_of(spec).get(
        "preferredDuringSchedulingIgnoredDuringExecution")
    out = []
    for pref in (raw if isinstance(raw, list) else []):
        pref = _as_dict(pref)
        w = pref.get("weight")
        if (not isinstance(w, int) or isinstance(w, bool)
                or not 1 <= w <= 100):
            continue
        out.append((w, _parse_term(pref.get("preference"))))
    return tuple(out)


def _parse_pod_affinity_terms(spec, which: str) -> tuple:
    """spec.affinity.{podAffinity|podAntiAffinity}.requiredDuringScheduling
    IgnoredDuringExecution -> tuple of (match_labels frozenset,
    match_expressions tuple, namespaces tuple, topology_key, match_all,
    namespace_selector). LabelSelector semantics: a NIL (absent) selector
    matches no pods; a PRESENT-but-empty selector ({}) matches every pod
    in the applicable namespaces — match_all carries that distinction.
    namespace_selector is None (absent) or (ml, exprs, all) matched
    against NAMESPACE labels; applicable namespaces are the UNION of the
    explicit list and the selector's matches (upstream semantics). An
    empty topologyKey is invalid upstream and parses to "" (the admission
    plugin treats it as never satisfiable / never conflicting). Malformed
    shapes never raise; cli validate reports them."""
    raw = _as_dict(_as_dict(_as_dict(spec).get("affinity")).get(which)).get(
        "requiredDuringSchedulingIgnoredDuringExecution")
    return tuple(_parse_pod_term(t) for t in (raw if isinstance(raw, list)
                                              else []))


def _parse_label_selector(raw_sel) -> tuple:
    """A LabelSelector dict -> (match_labels frozenset, match_expressions
    tuple, match_all). match_all marks the PRESENT-but-empty selector
    ({}: matches everything); an absent selector is the caller's concern
    (nil semantics differ per API)."""
    sel = _as_dict(raw_sel)
    ml = _as_dict(sel.get("matchLabels"))
    raw_exprs = sel.get("matchExpressions")
    exprs = tuple(
        (str(e.get("key", "")), str(e.get("operator", "")),
         tuple(str(v) for v in e.get("values") or ())
         if isinstance(e.get("values"), list) else ())
        for e in (raw_exprs if isinstance(raw_exprs, list) else [])
        if isinstance(e, dict)
    )
    return (
        frozenset((str(k), str(v)) for k, v in ml.items()),
        exprs,
        isinstance(raw_sel, dict) and not ml and not exprs,
    )


def _parse_pod_term(term) -> tuple:
    """One PodAffinityTerm -> the 6-tuple documented above."""
    term = _as_dict(term)
    raw_sel = term.get("labelSelector")
    ml, exprs, match_all = _parse_label_selector(raw_sel)
    if raw_sel is None:
        match_all = False  # nil labelSelector selects no pods
    namespaces = term.get("namespaces")
    # namespaceSelector (matched against NAMESPACE labels): None when
    # absent (term applies to explicit namespaces, else the owner's);
    # an empty selector ({}) selects EVERY namespace
    raw_ns_sel = term.get("namespaceSelector")
    ns_sel = (_parse_label_selector(raw_ns_sel)
              if isinstance(raw_ns_sel, dict) else None)
    return (
        ml,
        exprs,
        tuple(str(n) for n in namespaces)
        if isinstance(namespaces, list) else (),
        str(term.get("topologyKey", "")),
        isinstance(raw_sel, dict) and not ml and not exprs,
        ns_sel,
    )


def _parse_preferred_pod_affinity(spec, which: str, sign: int) -> tuple:
    """spec.affinity.{which}.preferredDuringSchedulingIgnoredDuring
    Execution -> tuple of (signed weight, PodAffinityTerm tuple). Entries
    with an out-of-range weight or no podAffinityTerm are dropped (the
    apiserver rejects them; cli validate reports)."""
    raw = _as_dict(_as_dict(_as_dict(spec).get("affinity")).get(which)).get(
        "preferredDuringSchedulingIgnoredDuringExecution")
    out = []
    for pref in (raw if isinstance(raw, list) else []):
        pref = _as_dict(pref)
        w = pref.get("weight")
        if (not isinstance(w, int) or isinstance(w, bool)
                or not 1 <= w <= 100):
            continue
        term_raw = pref.get("podAffinityTerm")
        if not isinstance(term_raw, dict):
            continue
        out.append((sign * w, _parse_pod_term(term_raw)))
    return tuple(out)


def _parse_topology_spread(spec) -> tuple:
    """spec.topologySpreadConstraints -> tuple of (max_skew, topology_key,
    when_unsatisfiable, match_labels frozenset, match_expressions tuple,
    match_all, min_domains, match_label_keys, node_affinity_policy,
    node_taints_policy). Entries without a positive integer maxSkew or a
    topologyKey are dropped (the apiserver rejects them); cli validate
    reports them. LabelSelector semantics as in _parse_pod_affinity_terms
    (nil = no pods, {} = all pods in the namespace).

    Fine-grain fields (upstream PodTopologySpread semantics):
    - min_domains: None, or the minimum number of eligible domains —
      below it the global minimum is treated as 0 (forces spreading onto
      new domains); only honoured for DoNotSchedule upstream
    - match_label_keys: label keys whose values are copied from the
      INCOMING pod into the selector as exact requirements (the
      pod-template-hash idiom: spread within one revision)
    - node_affinity_policy: "Honor" (default — nodes the pod's own
      nodeSelector/affinity exclude are outside the spreading space) or
      "Ignore"
    - node_taints_policy: "Ignore" (default) or "Honor" (untolerated
      tainted nodes are outside the spreading space)
    """
    raw = _as_dict(spec).get("topologySpreadConstraints")
    out = []
    for c in (raw if isinstance(raw, list) else []):
        c = _as_dict(c)
        skew = c.get("maxSkew")
        key = str(c.get("topologyKey", ""))
        if (not isinstance(skew, int) or isinstance(skew, bool)
                or skew < 1 or not key):
            continue
        raw_sel = c.get("labelSelector")
        ml, exprs, match_all = _parse_label_selector(raw_sel)
        if raw_sel is None:
            match_all = False
        md = c.get("minDomains")
        mlk = c.get("matchLabelKeys")
        out.append((
            skew, key,
            str(c.get("whenUnsatisfiable", "DoNotSchedule")),
            ml,
            exprs,
            match_all,
            md if isinstance(md, int) and not isinstance(md, bool)
            and md >= 1 else None,
            tuple(str(k) for k in mlk) if isinstance(mlk, list) else (),
            str(c.get("nodeAffinityPolicy", "Honor")),
            str(c.get("nodeTaintsPolicy", "Ignore")),
        ))
    return tuple(out)


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    scheduler_name: str = "yoda-scheduler"
    node: str | None = None           # spec.nodeName after bind
    phase: PodPhase = PodPhase.PENDING
    uid: int = field(default_factory=lambda: next(_uid_counter))
    k8s_uid: str = ""                 # metadata.uid on real clusters; a
                                      # recreated same-name pod gets a new one
    # metadata.ownerReferences carries a controller entry for managed pods
    # (Deployment/Job/...); bare pods have none and are NOT recreated after
    # an API DELETE — eviction-based flows must refuse them on real clusters
    has_controller: bool = False
    # metadata.deletionTimestamp set: the pod is in graceful termination
    # (DELETE issued, still holding its node/chips for up to
    # terminationGracePeriodSeconds). Terminating pods keep occupying
    # capacity in the cache but are never scheduled or re-evicted, and a
    # preemptor's nomination hold survives while its victims drain.
    terminating: bool = False
    # spec.nodeSelector / spec.tolerations / required nodeAffinity: the
    # reference ran inside full kube-scheduler, so its users got upstream
    # NodeAffinity/TaintToleration admission for free alongside the yoda
    # plugin; the standalone engine must provide the same contract
    # (plugins/admission.py). node_affinity is the required-during-
    # scheduling term list: a tuple of terms (OR), each a tuple of
    # (key, operator, values) expressions (AND).
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: tuple = ()
    node_affinity: tuple = ()
    # preferredDuringSchedulingIgnoredDuringExecution: tuple of
    # (weight, term) where term is a tuple of (key, op, values) — scoring
    # only (admission plugin's Score hook), never feasibility
    preferred_affinity: tuple = ()
    # required inter-pod (anti-)affinity: tuples of PodAffinityTerm =
    # (match_labels frozenset, match_expressions tuple, namespaces tuple
    # or () for the pod's own, topology_key). Anti-affinity is enforced
    # SYMMETRICALLY: a bound pod's terms also repel incoming matches
    # (upstream InterPodAffinity semantics).
    pod_affinity: tuple = ()
    pod_anti_affinity: tuple = ()
    # preferred inter-pod (anti-)affinity: tuples of (signed weight, term)
    # — positive for podAffinity preferences, negative for podAntiAffinity
    # (upstream scores them as one summed term list)
    preferred_pod_affinity: tuple = ()
    # spec.topologySpreadConstraints: tuple of (max_skew, topology_key,
    # when_unsatisfiable, match_labels frozenset, match_expressions tuple,
    # match_all) — DoNotSchedule constraints filter, ScheduleAnyway ones
    # score (skew penalty)
    topology_spread: tuple = ()
    # effective container resource requests (upstream NodeResourcesFit
    # inputs): cpu in millicores, memory in bytes; 0 = unconstrained
    cpu_millis: int = 0
    memory_bytes: int = 0
    # container hostPorts (upstream NodePorts plugin inputs): tuple of
    # (port, protocol, hostIP) — empty hostIP means the wildcard address
    host_ports: tuple = ()
    created: float = field(default_factory=time.time)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def assigned_chips(self) -> set[tuple[int, int, int]]:
        """ICI coords assigned to this pod at bind time (empty if unbound).
        Parsed once per label value — every scheduling cycle asks for every
        bound pod's coords (allocation accounting), so this is hot-path."""
        raw = self.labels.get(ASSIGNED_CHIPS_LABEL, "")

        def parse() -> set[tuple[int, int, int]]:
            out: set[tuple[int, int, int]] = set()
            for part in raw.split(";"):
                if part:
                    x, y, z = part.split(",")
                    out.add((int(x), int(y), int(z)))
            return out

        return memo(self, "_chips_cache", raw, parse)

    @classmethod
    def from_manifest(cls, manifest: dict) -> "Pod":
        """Build from a parsed Kubernetes Pod manifest dict."""
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})
        labels = dict(meta.get("labels", {}))
        # priority resolution: the scv/priority label (reference contract)
        # wins; otherwise spec.priority (the integer the apiserver resolves
        # from priorityClassName) or the two well-known system classes feed
        # the SAME label so every consumer (queue sort, preemption,
        # validate) sees one source of truth. Cache-local only — nothing
        # writes the label back to the API server.
        from .labels import PRIORITY_LABEL

        if PRIORITY_LABEL not in labels:
            prio = spec.get("priority")
            if prio is None:
                prio = _WELL_KNOWN_PRIORITY.get(
                    spec.get("priorityClassName", ""))
            if isinstance(prio, int) and not isinstance(prio, bool):
                labels[PRIORITY_LABEL] = str(prio)
        cpu_m, mem_b = pod_requests(spec)
        return cls(
            name=meta.get("name", "pod"),
            namespace=meta.get("namespace", "default"),
            labels=labels,
            scheduler_name=spec.get("schedulerName", "default-scheduler"),
            node=spec.get("nodeName"),
            k8s_uid=meta.get("uid", ""),
            has_controller=any(
                ref.get("controller")
                for ref in meta.get("ownerReferences", []) or []
            ),
            terminating=bool(meta.get("deletionTimestamp")),
            node_selector=dict(spec.get("nodeSelector", {}) or {}),
            tolerations=tuple(
                {
                    "key": t.get("key", ""),
                    "operator": t.get("operator", "Equal"),
                    "value": t.get("value", ""),
                    "effect": t.get("effect", ""),
                }
                for t in spec.get("tolerations", []) or []
            ),
            node_affinity=_parse_node_affinity(spec),
            preferred_affinity=_parse_preferred_affinity(spec),
            pod_affinity=_parse_pod_affinity_terms(spec, "podAffinity"),
            pod_anti_affinity=_parse_pod_affinity_terms(
                spec, "podAntiAffinity"),
            preferred_pod_affinity=(
                _parse_preferred_pod_affinity(spec, "podAffinity", 1)
                + _parse_preferred_pod_affinity(spec, "podAntiAffinity", -1)),
            topology_spread=_parse_topology_spread(spec),
            cpu_millis=cpu_m,
            memory_bytes=mem_b,
            host_ports=pod_host_ports(spec),
        )
