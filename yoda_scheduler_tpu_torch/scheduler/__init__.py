from .framework import (
    Status,
    Code,
    CycleState,
    NodeInfo,
    Snapshot,
    QueuedPodInfo,
    QueueSortPlugin,
    PreFilterPlugin,
    FilterPlugin,
    PostFilterPlugin,
    PreScorePlugin,
    ScorePlugin,
    ReservePlugin,
    PermitPlugin,
    BindPlugin,
)
from .config import SchedulerConfig, ScoreWeights
from .core import Scheduler
from .multi import MultiProfileScheduler
from .fleet import FleetCoordinator, LocalLeaseStore
from .heads import HeadSet
from .deschedule import Descheduler, DeschedulePlan
from .cluster import BindConflictError, FakeCluster
from .workload import Workload, WorkloadAdmission

__all__ = [
    "Status",
    "Code",
    "CycleState",
    "NodeInfo",
    "Snapshot",
    "QueuedPodInfo",
    "QueueSortPlugin",
    "PreFilterPlugin",
    "FilterPlugin",
    "PostFilterPlugin",
    "PreScorePlugin",
    "ScorePlugin",
    "ReservePlugin",
    "PermitPlugin",
    "BindPlugin",
    "SchedulerConfig",
    "ScoreWeights",
    "Scheduler",
    "MultiProfileScheduler",
    "FleetCoordinator",
    "HeadSet",
    "LocalLeaseStore",
    "Descheduler",
    "DeschedulePlan",
    "BindConflictError",
    "FakeCluster",
    "Workload",
    "WorkloadAdmission",
]
