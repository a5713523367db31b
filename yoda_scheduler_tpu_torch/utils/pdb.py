"""PodDisruptionBudget model + the disruption ledger preemption consults.

The reference's embedded kube-scheduler minimizes PDB violations when it
picks preemption victims (upstream `pkg/scheduler` preemption sorts
candidate nodes by violation count; PDBs are best-effort there, never an
absolute veto) — a capability its users relied on implicitly whenever a
serving workload declared a budget. The standalone engine restores it:

- `DisruptionBudget`: the slice of `policy/v1 PodDisruptionBudget` the
  scheduler consumes — namespace, label selector (matchLabels AND
  matchExpressions with In/NotIn/Exists/DoesNotExist; an EMPTY selector
  matches every pod in the namespace, policy/v1 semantics), and exactly
  one of minAvailable / maxUnavailable, integer or percentage ("50%").
  Percentages resolve against the OBSERVED matching pod count (healthy +
  terminating) at ledger-build time — the in-cache approximation of the
  disruption controller's scale-subresource expectedCount (equal in
  steady state; during a rollout the observed count tracks reality
  faster than the declared scale). Rounding follows upstream
  `GetScaledValueFromIntOrPercent(..., roundUp=true)` for both fields.
- `DisruptionLedger`: per-cycle allowance accounting. Built once from the
  cluster's bound pods, then consulted/consumed as a victim plan grows.

Preemption semantics (upstream parity): plans that violate no budget are
always preferred; if the ONLY way to place the preemptor violates budgets,
the plan with the fewest violations wins. The descheduler, whose moves are
optional, refuses violating evictions outright.
"""

from __future__ import annotations

from dataclasses import dataclass


def _match_expression(labels: dict, key: str, op: str, values: tuple) -> bool:
    """Label-selector matchExpression (the 4 set-based operators the
    LabelSelector API defines). Unknown operators match nothing."""
    present = key in labels
    if op == "In":
        return present and labels[key] in values
    if op == "NotIn":
        return not present or labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    return False


@dataclass(frozen=True)
class DisruptionBudget:
    name: str
    namespace: str = "default"
    # selector.matchLabels as a frozenset of (k, v) pairs and
    # selector.matchExpressions as a tuple of (key, op, values) — both must
    # match (AND, LabelSelector semantics). match_all marks the policy/v1
    # empty selector, which selects EVERY pod in the namespace.
    match_labels: frozenset = frozenset()
    match_expressions: tuple = ()
    match_all: bool = False
    min_available: int | None = None
    max_unavailable: int | None = None
    # percentage forms, 0-100 (e.g. minAvailable: "50%"); resolved against
    # the observed matching-pod count when the ledger is built
    min_available_pct: int | None = None
    max_unavailable_pct: int | None = None

    def matches(self, pod) -> bool:
        if pod.namespace != self.namespace:
            return False
        if self.match_all:
            return True
        if not self.match_labels and not self.match_expressions:
            return False  # no selector at all: selects nothing
        labels = pod.labels
        return (
            all(labels.get(k) == v for k, v in self.match_labels)
            and all(_match_expression(labels, k, op, vals)
                    for k, op, vals in self.match_expressions)
        )

    @classmethod
    def from_manifest(cls, manifest: dict) -> "DisruptionBudget":
        """policy/v1 PodDisruptionBudget object -> model. Integer and
        percentage forms both evaluate (module docstring)."""
        meta = manifest.get("metadata") or {}
        spec = manifest.get("spec") or {}
        sel = spec.get("selector")
        sel = sel if isinstance(sel, dict) else None
        ml = (sel or {}).get("matchLabels") or {}
        ml = ml if isinstance(ml, dict) else {}
        raw_exprs = (sel or {}).get("matchExpressions") or []
        exprs = tuple(
            (str(e.get("key", "")), str(e.get("operator", "")),
             tuple(str(v) for v in e.get("values") or ()))
            for e in (raw_exprs if isinstance(raw_exprs, list) else [])
            if isinstance(e, dict)
        )

        def as_int(v):
            return v if isinstance(v, int) and not isinstance(v, bool) else None

        def as_pct(v):
            if isinstance(v, str) and v.endswith("%"):
                try:
                    pct = int(v[:-1])
                except ValueError:
                    return None
                return pct if 0 <= pct <= 100 else None
            return None

        return cls(
            name=meta.get("name", "pdb"),
            namespace=meta.get("namespace", "default"),
            match_labels=frozenset((str(k), str(v)) for k, v in ml.items()),
            match_expressions=exprs,
            # selector PRESENT but empty (selector: {}) = all pods in the
            # namespace (policy/v1); selector absent = selects nothing
            match_all=sel is not None and not ml and not exprs,
            min_available=as_int(spec.get("minAvailable")),
            max_unavailable=as_int(spec.get("maxUnavailable")),
            min_available_pct=as_pct(spec.get("minAvailable")),
            max_unavailable_pct=as_pct(spec.get("maxUnavailable")),
        )


class DisruptionLedger:
    """Allowed-disruption accounting for one scheduling cycle.

    `allowance` per budget = how many matching pods may still be evicted:
    maxUnavailable (already-terminating matches count against it), or
    healthy_matches - minAvailable. Consuming below zero is a violation.
    """

    def __init__(self, budgets, all_pods) -> None:
        self.budgets = [b for b in budgets
                        if b.min_available is not None
                        or b.max_unavailable is not None
                        or b.min_available_pct is not None
                        or b.max_unavailable_pct is not None]
        self._allow: dict[tuple[str, str], int] = {}
        if not self.budgets:
            return

        def ceil_pct(pct: int, count: int) -> int:
            # upstream GetScaledValueFromIntOrPercent(..., roundUp=true)
            return -((-pct * count) // 100)

        for b in self.budgets:
            healthy = disrupting = 0
            for p in all_pods:
                if b.matches(p):
                    if p.terminating:
                        disrupting += 1
                    else:
                        healthy += 1
            observed = healthy + disrupting  # expectedCount approximation
            max_unavail = b.max_unavailable
            if max_unavail is None and b.max_unavailable_pct is not None:
                max_unavail = ceil_pct(b.max_unavailable_pct, observed)
            min_avail = b.min_available
            if min_avail is None and b.min_available_pct is not None:
                min_avail = ceil_pct(b.min_available_pct, observed)
            if max_unavail is not None:
                allow = max_unavail - disrupting
            else:
                allow = healthy - min_avail
            self._allow[(b.namespace, b.name)] = allow

    def violations_for(self, victims) -> int:
        """How many budget violations evicting `victims` (on top of what
        was already consumed) would cause. Pure — does not consume."""
        if not self.budgets:
            return 0
        need: dict[tuple[str, str], int] = {}
        for v in victims:
            for b in self.budgets:
                if b.matches(v):
                    need[(b.namespace, b.name)] = need.get(
                        (b.namespace, b.name), 0) + 1
        return sum(
            1 for key, n in need.items() if n > max(self._allow[key], 0)
        )

    def consume(self, victims) -> None:
        """Record `victims` as planned evictions (gang planning spans
        hosts; later hosts must see earlier hosts' consumption)."""
        for v in victims:
            for b in self.budgets:
                if b.matches(v):
                    key = (b.namespace, b.name)
                    self._allow[key] = self._allow[key] - 1

    def would_violate(self, pod) -> bool:
        """True if evicting this one pod now would breach any budget —
        the descheduler's hard veto (its moves are optional)."""
        if not self.budgets:
            return False
        return any(
            b.matches(pod) and self._allow[(b.namespace, b.name)] <= 0
            for b in self.budgets
        )

    def tracker(self) -> "LedgerTracker":
        """A scratch view for greedy victim selection: consuming through
        the tracker updates a LOCAL allowance copy, so the second pick of
        a plan sees the first pick's consumption without committing
        anything to the cycle ledger."""
        return LedgerTracker(self)


class LedgerTracker:
    def __init__(self, ledger: DisruptionLedger) -> None:
        self.budgets = ledger.budgets
        self._allow = dict(ledger._allow)

    def would_violate(self, pod) -> bool:
        return any(
            b.matches(pod) and self._allow[(b.namespace, b.name)] <= 0
            for b in self.budgets
        )

    def consume_one(self, pod) -> None:
        for b in self.budgets:
            if b.matches(pod):
                key = (b.namespace, b.name)
                self._allow[key] = self._allow[key] - 1
