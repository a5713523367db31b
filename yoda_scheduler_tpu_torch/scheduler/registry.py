"""Plugin registry: name -> factory, and profile assembly from config.

The reference registers its plugin into the upstream framework registry via
``app.NewSchedulerCommand(app.WithPlugin(yoda.Name, yoda.New))`` (reference
pkg/register/register.go:9-13). Native equivalent: a registry mapping plugin
names to factories plus `build_profile`, which wires a Profile from a
KubeSchedulerConfiguration-style plugin enablement block so deployments can
enable/disable/weight plugins in config rather than code.
"""

from __future__ import annotations

from typing import Callable

from .config import SchedulerConfig
from .core import Profile, default_profile
from .plugins import (
    ChipAllocator,
    FragmentationScore,
    GangCoordinator,
    GangPermit,
    MaxCollection,
    NodeAdmission,
    PriorityPreemption,
    PrioritySort,
    TelemetryFilter,
    TelemetryScore,
    TopologyScore,
)

# shared-state objects (allocator, gang coordinator, policy engine,
# elastic-gang controller) are built once per profile and injected into
# every plugin factory that wants them; `policy`/`elastic` are None
# unless the config's knobs (or an explicitly-enabled plugin) ask
Factory = Callable[
    [SchedulerConfig, ChipAllocator, GangCoordinator, object, object],
    object]

_REGISTRY: dict[str, Factory] = {}


def register(name: str, factory: Factory) -> None:
    if name in _REGISTRY:
        raise ValueError(f"plugin {name!r} already registered")
    _REGISTRY[name] = factory


def registered() -> list[str]:
    return sorted(_REGISTRY)


register("priority-sort", lambda cfg, alloc, gangs, pol, el: PrioritySort())
register("node-admission",
         lambda cfg, alloc, gangs, pol, el: NodeAdmission(alloc))
register("telemetry-filter",
         lambda cfg, alloc, gangs, pol, el: TelemetryFilter(
             alloc, gangs, cfg.telemetry_max_age_s))
register("max-collection",
         lambda cfg, alloc, gangs, pol, el: MaxCollection(alloc))
register("telemetry-score",
         lambda cfg, alloc, gangs, pol, el: TelemetryScore(
             alloc, cfg.weights, weight=1))
register("topology-score",
         lambda cfg, alloc, gangs, pol, el: TopologyScore(
             alloc, weight=cfg.topology_weight))
def _carver(cfg, alloc):
    """TorusCarver when the torusPlacement knob asks; None keeps the
    classic (bit-identical) paths. Instances are cheap and stateless —
    one per consuming plugin is fine."""
    if not cfg.torus_placement:
        return None
    from .carve import TorusCarver

    return TorusCarver(alloc)


register("gang-permit",
         lambda cfg, alloc, gangs, pol, el: GangPermit(
             gangs, timeout_s=cfg.gang_timeout_s, allocator=alloc,
             elastic=el, carver=_carver(cfg, alloc)))
register("fragmentation-score",
         lambda cfg, alloc, gangs, pol, el: FragmentationScore(
             alloc, weight=cfg.fragmentation_weight,
             carver=_carver(cfg, alloc)))
register("priority-preemption",
         lambda cfg, alloc, gangs, pol, el: PriorityPreemption(alloc, gangs))


def _hetero(cfg, pol):
    from .policy import HeterogeneityScore

    return HeterogeneityScore(
        pol.model, cfg.policy_objective or "makespan",
        weight=cfg.heterogeneity_weight, policy=pol)


def _fair_sort(pol):
    from .policy import TenantFairnessSort

    return TenantFairnessSort(pol)


def _quota_gate(pol):
    from .policy import TenantQuotaGate

    return TenantQuotaGate(pol)


def _headroom_gate(pol):
    from .policy.headroom import ServingHeadroomGate

    return ServingHeadroomGate(pol)


# policy-engine plugins (scheduler/policy/): not in DEFAULT_ENABLED —
# the knobs (policyObjective / drfFairness / tenants) or an explicit
# `plugins:` enablement opt a deployment in
register("heterogeneity-score",
         lambda cfg, alloc, gangs, pol, el: _hetero(cfg, pol))
register("tenant-fairness-sort",
         lambda cfg, alloc, gangs, pol, el: _fair_sort(pol))
register("tenant-quota-gate",
         lambda cfg, alloc, gangs, pol, el: _quota_gate(pol))
register("serving-headroom-gate",
         lambda cfg, alloc, gangs, pol, el: _headroom_gate(pol))


def _gpu_locality(cfg, alloc, gangs):
    from .plugins.gpulocality import GpuLocalityScore

    return GpuLocalityScore(alloc, gangs, max_age_s=cfg.telemetry_max_age_s)


# GPU fleets (plugins/gpulocality.py): IB-leaf and NVLink-domain locality.
# Not in DEFAULT_ENABLED — a GPU profile enables it under `score:`
register("gpu-locality",
         lambda cfg, alloc, gangs, pol, el: _gpu_locality(cfg, alloc, gangs))


_POLICY_PLUGINS = frozenset({
    "heterogeneity-score", "tenant-fairness-sort", "tenant-quota-gate",
    "serving-headroom-gate"})


# the default enablement per extension point (mirrors default_profile);
# config blocks MERGE into this — listing only `score:` in YAML retunes
# scoring without silently disabling filtering/permit, matching
# KubeSchedulerConfiguration semantics where defaults stay enabled unless
# explicitly disabled
DEFAULT_ENABLED: dict[str, list[str]] = {
    "queueSort": ["priority-sort"],
    "filter": ["node-admission", "telemetry-filter"],
    "postFilter": ["priority-preemption"],
    "preScore": ["max-collection"],
    "score": ["telemetry-score", "topology-score", "node-admission"],
    "permit": ["gang-permit"],
}


def merge_enablement(user: dict[str, dict] | None) -> dict[str, list[str]]:
    """Merge a KubeSchedulerConfiguration `plugins:` block into the default
    enablement. Each point's `enabled` names are appended (deduped) and
    `disabled` names removed; `disabled: [{name: '*'}]` clears the point's
    defaults first."""
    merged = {k: list(v) for k, v in DEFAULT_ENABLED.items()}
    for point, block in (user or {}).items():
        if not isinstance(block, dict):
            continue
        current = merged.setdefault(point, [])
        disabled = [e.get("name") for e in block.get("disabled", [])]
        if "*" in disabled:
            current = []
        else:
            current = [n for n in current if n not in disabled]
        for e in block.get("enabled", []):
            if e.get("name") and e["name"] not in current:
                current.append(e["name"])
        merged[point] = current
    return merged


def build_profile(config: SchedulerConfig,
                  enabled: dict[str, list[str]] | None = None,
                  allocator: ChipAllocator | None = None,
                  gangs: GangCoordinator | None = None) -> Profile:
    """Build a Profile. `enabled` maps extension point -> plugin names (the
    KubeSchedulerConfiguration `plugins:` block); None = the default set.
    `allocator`/`gangs` may be shared across co-hosted profiles (multi.py)."""
    if enabled is None:
        profile, _, _ = default_profile(config, allocator, gangs)
        return profile
    alloc = allocator or ChipAllocator()
    gangs = gangs or GangCoordinator()
    # one shared PolicyEngine when the config's policy knobs OR an
    # explicitly-enabled policy plugin need it (the sort, gate, and
    # scorer must read the same DRF book)
    policy = None
    headroom_on = (config.slo_serving
                   and config.serving_headroom_pct > 0.0)
    if (config.policy_objective or config.drf_fairness
            or config.tenant_quotas or headroom_on
            or any(n in _POLICY_PLUGINS
                   for names in (enabled or {}).values() for n in names)):
        from .policy import PolicyEngine

        policy = PolicyEngine(config)
    # elastic-gang controller (scheduler/elastic/): the knob opts in;
    # shared by GangPermit and the engine (admission decisions + metrics)
    elastic = None
    if config.elastic_gangs:
        from .elastic import ElasticGangs

        elastic = ElasticGangs(config, policy=policy)
    built: dict[str, object] = {}

    def get(name: str):
        if name not in built:
            if name not in _REGISTRY:
                raise KeyError(f"unknown plugin {name!r}; known: {registered()}")
            built[name] = _REGISTRY[name](config, alloc, gangs, policy,
                                          elastic)
        return built[name]

    from .framework import PreFilterPlugin, PreScorePlugin, ReservePlugin

    qs = enabled.get("queueSort", ["priority-sort"])
    queue_sort = get(qs[0]) if qs else PrioritySort()
    filters = [get(n) for n in enabled.get("filter", [])]
    pre_filters = [get(n) for n in enabled.get("preFilter", [])]
    post_filters = [get(n) for n in enabled.get("postFilter", [])]
    pre_scores = [get(n) for n in enabled.get("preScore", [])]
    scores = [get(n) for n in enabled.get("score", [])]
    permits = [get(n) for n in enabled.get("permit", [])]
    # a Score plugin that is also a PreScore plugin (topology-score's
    # slice-usage pass) must run at both points or its score input is empty
    for p in scores:
        if isinstance(p, PreScorePlugin) and p not in pre_scores:
            pre_scores.append(p)
    explicit_reserves = [get(n) for n in enabled.get("reserve", [])]
    # the allocator always reserves; any enabled plugin that also implements
    # Reserve (e.g. gang-permit's slice choice) hooks in automatically
    reserves: list = [alloc]
    for p in list(built.values()) + explicit_reserves:
        if isinstance(p, ReservePlugin) and p not in reserves:
            reserves.append(p)
    # any enabled plugin that also implements PreFilter (gang-permit's
    # multi-slice planning pass) hooks in automatically
    for p in built.values():
        if isinstance(p, PreFilterPlugin) and p not in pre_filters:
            pre_filters.append(p)
    # the policy KNOBS enforce regardless of how the profile was
    # assembled: a deployment with a `plugins:` block (the shipped
    # ConfigMap has one) must behave exactly like default_profile when
    # the operator flips drfFairness/tenants/policyObjective — without
    # this, the knobs would silently build a PolicyEngine that nothing
    # consults. Explicit enablement still wins: an already-enabled
    # policy plugin (or a custom queue sort) is never stomped.
    if policy is not None:
        from .policy import (HeterogeneityScore, TenantFairnessSort,
                             TenantQuotaGate)

        drf_on = config.drf_fairness or config.tenant_quotas
        if drf_on and not any(isinstance(p, TenantQuotaGate)
                              for p in pre_filters):
            pre_filters.insert(0, get("tenant-quota-gate"))
        if headroom_on:
            from .policy.headroom import ServingHeadroomGate

            if not any(isinstance(p, ServingHeadroomGate)
                       for p in pre_filters):
                # same fold position as default_profile: after any quota
                # gate, before gang planning pays anything
                at = (1 if pre_filters
                      and isinstance(pre_filters[0], TenantQuotaGate)
                      else 0)
                pre_filters.insert(at, get("serving-headroom-gate"))
        if drf_on and type(queue_sort) is PrioritySort:
            # only the DEFAULT sort is upgraded; a custom comparator the
            # operator explicitly enabled keeps its ordering
            queue_sort = get("tenant-fairness-sort")
        if (config.policy_objective and config.heterogeneity_weight > 0
                and not any(isinstance(p, HeterogeneityScore)
                            for p in scores)):
            # same fold position as default_profile — BEFORE a trailing
            # admission scorer. Float addition is order-sensitive, and
            # the two construction paths must sum raws identically or
            # near-tie rankings could differ between them.
            at = next((i for i in range(len(scores) - 1, -1, -1)
                       if isinstance(scores[i], NodeAdmission)),
                      None)
            het = get("heterogeneity-score")
            if at is not None:
                scores.insert(at, het)
            else:
                scores.append(het)
    profile = Profile(
        queue_sort=queue_sort,
        pre_filter=pre_filters,
        filter=filters,
        post_filter=post_filters,
        pre_score=pre_scores,
        score=scores,
        reserve=reserves,
        permit=permits,
    )
    profile.policy = policy
    profile.elastic = elastic
    return profile
