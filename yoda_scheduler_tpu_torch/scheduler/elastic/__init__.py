"""Elastic gangs + active defragmentation (ROADMAP item 4, Tesserae's
scalable placement policies, arXiv:2508.04953).

Cooperating controllers, all OFF by default:

- :class:`ElasticGangs` (gangs.py): gangs labeled ``tpu/gang-min`` admit
  at min replicas when the full size does not fit, park the remaining
  members as a distinct event-woken queue class, and grow toward
  ``tpu/gang-size`` as chips free; ``scv/deadline-seconds`` drives the
  start-now-at-min vs wait-for-full decision off the policy engine's
  throughput model; bound elastic gangs become shrink-to-min preemption
  donors (cheaper than whole-gang eviction, charged against the
  per-tenant preemption budgets under the PDB ledger).
- :class:`DefragController` (defrag.py): a closed loop on the engine
  thread's injectable clock driving deschedule.py's slice-conservation /
  compaction strategies through the existing victim-drain path —
  migration plans with eviction budgets, per-pod cooldowns, and a
  breaker/degraded interlock; fleet-aware (shard-0 owner only).
- :class:`SloGuard` (sloguard.py): serving-SLO graceful degradation
  — while the burn-rate monitor trips or serving pods park
  unschedulable, bound elastic gangs shrink toward ``tpu/gang-min``
  (``gang_shrink_total{reason="slo"}``) with a two-direction-hysteresis
  give-back that re-grows them through ``elastic-grow`` in the valleys.
"""

from .defrag import DefragController
from .gangs import ELASTIC_GROW_HINT, ElasticGangs, bound_member_count
from .sloguard import SloGuard

__all__ = ["DefragController", "ELASTIC_GROW_HINT", "ElasticGangs",
           "SloGuard", "bound_member_count"]
