from .labels import (
    LabelError,
    WorkloadSpec,
    MEMORY_LABEL,
    NUMBER_LABEL,
    CLOCK_LABEL,
    PRIORITY_LABEL,
    ACCELERATOR_LABEL,
    TOPOLOGY_LABEL,
    GANG_NAME_LABEL,
    GANG_SIZE_LABEL,
)
from .pod import Pod, PodPhase

__all__ = [
    "LabelError",
    "WorkloadSpec",
    "Pod",
    "PodPhase",
    "MEMORY_LABEL",
    "NUMBER_LABEL",
    "CLOCK_LABEL",
    "PRIORITY_LABEL",
    "ACCELERATOR_LABEL",
    "TOPOLOGY_LABEL",
    "GANG_NAME_LABEL",
    "GANG_SIZE_LABEL",
]
