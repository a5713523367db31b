"""Policy engine: heterogeneity-aware placement + multi-tenant fairness.

ROADMAP item 3, built from two papers' ideas (PAPERS.md):

- Gavel (arXiv:2008.09213): per-workload-class throughput ratios across
  accelerator generations should drive placement, with the policy
  OBJECTIVE (makespan, average JCT, finish-time fairness) selectable per
  deployment rather than baked into the scorer. `heterogeneity.py` is
  that model plus the `HeterogeneityScore` plugin.
- Tesserae (arXiv:2508.04953) / DRF (Ghodsi et al.): multi-tenant
  clusters need dominant-resource fairness and quota, or one tenant
  starves the rest. `fairness.py` is the DRF book (incremental from the
  bind/unbind change logs), the `TenantFairnessSort` queue ordering, the
  `TenantQuotaGate` admission check, and per-tenant preemption budgets.

Everything is OFF by default: with `policyObjective` unset and no
tenants configured, `default_profile` builds exactly the pre-policy
plugin set and placements are bit-identical (pinned by
tests/test_policy.py).
"""

from .heterogeneity import (
    HeterogeneityScore,
    OBJECTIVES,
    ThroughputModel,
    throughput_class,
)
from .fairness import (
    DRFBook,
    PolicyEngine,
    PreemptionBudgets,
    TenantFairnessSort,
    TenantQuotaGate,
)

__all__ = [
    "DRFBook",
    "HeterogeneityScore",
    "OBJECTIVES",
    "PolicyEngine",
    "PreemptionBudgets",
    "TenantFairnessSort",
    "TenantQuotaGate",
    "ThroughputModel",
    "throughput_class",
]
