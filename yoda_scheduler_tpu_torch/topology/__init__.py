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
]
