"""PyTorch and CUDA port of the workload stack of `yoda_scheduler_tpu`.

Ported so far: the Llama forward (`models.llama`) with its attention as a
hand-written CUDA kernel for Hopper (`ops.attention`, `ops/csrc/`), and
KV-cache serving (`models.generate`). The JAX package is the reference the
port is tested against; this package imports nothing of it.
"""

from . import models, ops

__all__ = ["models", "ops"]
