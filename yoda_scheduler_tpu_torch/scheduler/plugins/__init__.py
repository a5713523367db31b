from .sort import PrioritySort
from .admission import NodeAdmission
from .filter import TelemetryFilter
from .prescore import MaxCollection, MAX_KEY, SPEC_KEY
from .score import FragmentationScore, TelemetryScore
from .topology import TopologyScore
from .allocator import ChipAllocator
from .gang import GangCoordinator, GangPermit
from .preempt import PriorityPreemption

__all__ = [
    "PrioritySort",
    "NodeAdmission",
    "TelemetryFilter",
    "FragmentationScore",
    "MaxCollection",
    "TelemetryScore",
    "TopologyScore",
    "ChipAllocator",
    "GangCoordinator",
    "GangPermit",
    "PriorityPreemption",
    "MAX_KEY",
    "SPEC_KEY",
]
