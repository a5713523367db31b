"""PyTorch and CUDA port of `yoda_scheduler_tpu`.

The workload layer: the Llama forward (`models.llama`) with its attention
as hand-written CUDA kernels for Hopper (`ops.attention`, `ops/csrc/`: the
forward, and the dQ and dK/dV backward), the MoE FFN (`models.moe`),
KV-cache serving (`models.generate`), ResNet-50 (`models.resnet`), the
training step on one device or sharded over a rank mesh, with ring or
Ulysses attention and the pipelined step (`parallel`), the gang
rendezvous (`parallel.multihost`) and checkpoint/resume
(`parallel.checkpoint`).

The scheduling system: the engine (`scheduler`), its Kubernetes layer
(`k8s`), the label contract and host utilities (`utils`), the ICI
topology (`topology`), the telemetry schema, store and publisher with the
card's own sniffer and duty source over NVML (`telemetry`), the CLI
(`cli`) and the fault-injection harness (`chaos`). These run on the host
and import no torch.

The JAX package is the reference the port is tested against; this
package imports nothing of it. Submodules load on first use (PEP 562), so
importing the engine, the CLI or the telemetry loads no torch.
"""

import importlib

_SUBMODULES = ("models", "ops", "parallel", "scheduler", "k8s", "utils", "topology",
               "telemetry", "cli", "chaos")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
