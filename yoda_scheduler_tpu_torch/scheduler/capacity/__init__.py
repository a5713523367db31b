"""Closed-loop capacity: node provisioner + provider contract.

Off by default (``provisionerIntervalSeconds: 0`` never constructs the
loop; placements bit-identical). See provisioner.py for the control
loop and provider.py for how nodes enter/leave the fleet; the
fault-injected SimulatedProvider lives with the rest of the chaos
harness in yoda_scheduler_tpu_torch/chaos.py.
"""

from .provider import (
    FakeBackend,
    MANAGED_LABEL,
    NodeTemplate,
    POOL_LABEL,
    ProvisionRequest,
    ProvisionResult,
    WireBackend,
    build_metrics,
)
from .provisioner import CapacityProvisioner

__all__ = [
    "CapacityProvisioner",
    "FakeBackend",
    "MANAGED_LABEL",
    "NodeTemplate",
    "POOL_LABEL",
    "ProvisionRequest",
    "ProvisionResult",
    "WireBackend",
    "build_metrics",
]
