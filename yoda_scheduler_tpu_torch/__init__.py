"""PyTorch and CUDA port of the workload stack of `yoda_scheduler_tpu`.

The workload layer: the Llama forward (`models.llama`) with its attention
as hand-written CUDA kernels for Hopper (`ops.attention`, `ops/csrc/`: the
forward, and the dQ and dK/dV backward), the MoE FFN (`models.moe`),
KV-cache serving (`models.generate`), ResNet-50 (`models.resnet`), the
training step on one device or sharded over a rank mesh, with ring or
Ulysses attention and the pipelined step (`parallel`), the gang
rendezvous (`parallel.multihost`) and checkpoint/resume
(`parallel.checkpoint`). The JAX package is the reference the port is
tested against; this package imports nothing of it.
"""

from . import models, ops, parallel

__all__ = ["models", "ops", "parallel"]
