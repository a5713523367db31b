from .schema import Chip, TpuNodeMetrics, HEALTHY, GPU, TPU
from .store import TelemetryStore
from .fake import FakePublisher, make_tpu_node, make_gpu_node, make_slice, make_v4_slice
from .sniffer import local_node_metrics

__all__ = [
    "Chip",
    "TpuNodeMetrics",
    "HEALTHY",
    "GPU",
    "TPU",
    "TelemetryStore",
    "FakePublisher",
    "make_tpu_node",
    "make_gpu_node",
    "make_slice",
    "make_v4_slice",
    "local_node_metrics",
]
