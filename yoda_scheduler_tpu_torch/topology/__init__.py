from .torus import (
    parse_topology,
    format_topology,
    host_blocks,
    enumerate_subblocks,
    best_fit_block,
    contiguity_score,
    fragmentation_after,
)
from .generations import GENERATIONS, TpuGeneration, generation
from .gpus import GPUS, GpuModel, gpu_model, model_of_nvml_name

__all__ = [
    "parse_topology",
    "format_topology",
    "host_blocks",
    "enumerate_subblocks",
    "best_fit_block",
    "contiguity_score",
    "fragmentation_after",
    "GENERATIONS",
    "TpuGeneration",
    "generation",
    "GPUS",
    "GpuModel",
    "gpu_model",
    "model_of_nvml_name",
]
