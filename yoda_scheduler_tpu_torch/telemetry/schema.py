"""Telemetry schema: the TPU-native analogue of the reference's SCV CRD.

The reference consumes one ``Scv`` custom resource per node (named after the
node) with per-card fields ``FreeMemory/TotalMemory/Clock/Bandwidth/Core/
Power/Health`` and node-level ``CardNumber/FreeMemorySum/TotalMemorySum``
(use sites: reference pkg/yoda/filter/filter.go:13-57,
pkg/yoda/collection/collection.go:59-78, pkg/yoda/score/algorithm.go:57-87).

Here the unit of accounting is a TPU *chip*:

- ``FreeMemory``/``TotalMemory`` (MB)  -> HBM free/total (MB)
- ``Clock`` (MHz, graphics clock)      -> TensorCore/MXU clock (MHz)
- ``Bandwidth`` (PCIe GB/s)            -> ICI link bandwidth (GB/s)
- ``Core`` (CUDA core count)           -> MXU count (systolic arrays per chip)
- ``Power`` (W)                        -> TDP/board power (W)
- ``Health``                           -> chip health from libtpu runtime

plus TPU-only fields the GPU reference has no equivalent for and which the
topology-aware scorer and gang scheduler need: ICI coordinates of each chip in
its pod slice, the slice id/topology, and the node's host index within a
multi-host slice.

Everything is a plain frozen-ish dataclass (no k8s API machinery): the store
(`store.py`) is the watch-cache analogue, and `to_cr()`/`from_cr()` give the
CRD wire form for the real-cluster path (deploy/crd-tpunodemetrics.yaml).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, asdict
from typing import Iterable

from ..utils.memo import memo

HEALTHY = "Healthy"
TPU = "tpu"
GPU = "gpu"

# CRD identity for the real-cluster path (group renamed from the reference's
# core.run-linux.com, deploy/yoda-scheduler.yaml:206-208).
CRD_GROUP = "metrics.yoda.tpu"
CRD_VERSION = "v1"
CRD_PLURAL = "tpunodemetrics"


@dataclass
class Chip:
    """Telemetry for one accelerator chip (TPU chip or, in mixed clusters,
    one GPU card — the schema is accelerator-agnostic per the north star)."""

    index: int
    hbm_free_mb: int
    hbm_total_mb: int
    health: str = HEALTHY
    clock_mhz: int = 940          # TensorCore clock (v4: 940 MHz)
    ici_bandwidth_gbps: int = 100  # per-link ICI bandwidth
    core_count: int = 4            # MXUs per chip (v4 TensorCore: 4 MXUs)
    power_w: int = 170
    coords: tuple[int, int, int] = (0, 0, 0)  # position in the slice's ICI torus
    duty_cycle_pct: float = 0.0    # measured MXU duty cycle, 0..100

    @property
    def healthy(self) -> bool:
        return self.health == HEALTHY


@dataclass
class TpuNodeMetrics:
    """Per-node accelerator telemetry; one object per node, keyed by node name
    (the reference looks its Scv up by node name, pkg/yoda/scheduler.go:80)."""

    node: str
    chips: list[Chip] = field(default_factory=list)
    accelerator: str = TPU         # "tpu" | "gpu" — mixed-cluster partitioning
    tpu_generation: str = ""       # "v4", "v5e", ... ("" = unspecified)
    slice_id: str = ""             # "" = standalone node (no multi-host slice)
    topology: str = ""             # e.g. "2x2x1" (chips this host contributes)
    slice_topology: str = ""       # e.g. "2x2x4" (whole pod slice)
    host_index: int = 0            # this host's rank within the slice
    num_hosts: int = 1             # hosts in the slice
    generation: int = 0            # bumped by the publisher on every update
    heartbeat: float = field(default_factory=time.time)

    # -- node-level aggregates (the reference stores these materialized as
    # FreeMemorySum/TotalMemorySum; we derive them so they can never skew) --
    @property
    def chip_count(self) -> int:
        return len(self.chips)

    def _aggregates(self) -> tuple[int, int, list[Chip]]:
        """Aggregate memo keyed by `generation`: every publisher path bumps it
        via TelemetryStore.put, and the scheduler reads these on every
        (pod, node) hot-path visit. Do not mutate `chips` without re-putting."""
        def compute() -> tuple[int, int, list[Chip]]:
            free = total = 0
            healthy: list[Chip] = []
            for c in self.chips:
                free += c.hbm_free_mb
                total += c.hbm_total_mb
                if c.health == HEALTHY:
                    healthy.append(c)
            return free, total, healthy

        return memo(self, "_agg_memo", self.generation, compute)

    @property
    def hbm_free_sum(self) -> int:
        return self._aggregates()[0]

    @property
    def hbm_total_sum(self) -> int:
        return self._aggregates()[1]

    def healthy_chips(self) -> list[Chip]:
        """Healthy chips (shared memoised list — treat as read-only)."""
        return self._aggregates()[2]

    def healthy_coords(self) -> frozenset[tuple[int, int, int]]:
        """ICI coords of healthy chips (memoised like the other aggregates)."""
        return memo(
            self, "_coords_memo", self.generation,
            lambda: frozenset(c.coords for c in self._aggregates()[2]),
        )

    def stale(self, now: float | None = None, max_age_s: float = 60.0) -> bool:
        """Staleness gate — the reference has no heartbeat concept; a dead
        sniffer kept serving frozen numbers. Filter treats stale telemetry as
        unschedulable rather than trusting it."""
        return ((now if now is not None else time.time()) - self.heartbeat) > max_age_s

    # ------------------------------------------------------------------ wire
    def to_cr(self) -> dict:
        """Render as a Kubernetes custom-resource dict (status subresource)."""
        body = asdict(self)
        chips = body.pop("chips")
        name = body.pop("node")
        return {
            "apiVersion": f"{CRD_GROUP}/{CRD_VERSION}",
            "kind": "TpuNodeMetrics",
            "metadata": {"name": name},
            "status": {**body, "chips": chips},
        }

    @classmethod
    def from_cr(cls, cr: dict) -> "TpuNodeMetrics":
        status = dict(cr.get("status", {}))
        chips = [
            Chip(**{**c, "coords": tuple(c.get("coords", (0, 0, 0)))})
            for c in status.pop("chips", [])
        ]
        return cls(node=cr["metadata"]["name"], chips=chips, **status)


def aggregate_slice(nodes: Iterable[TpuNodeMetrics]) -> dict[str, list[TpuNodeMetrics]]:
    """Group nodes by slice id (standalone nodes land under their own name)."""
    out: dict[str, list[TpuNodeMetrics]] = {}
    for n in nodes:
        out.setdefault(n.slice_id or n.node, []).append(n)
    for members in out.values():
        members.sort(key=lambda m: m.host_index)
    return out
