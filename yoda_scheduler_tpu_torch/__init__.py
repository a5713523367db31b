"""PyTorch and CUDA port of the workload stack of `yoda_scheduler_tpu`.

Ported so far: the Llama forward (`models.llama`) with its attention as
hand-written CUDA kernels for Hopper (`ops.attention`, `ops/csrc/`: the
forward, and the dQ and dK/dV backward), KV-cache serving
(`models.generate`), and the single-device training step with remat and
AdamW (`parallel.train`). The JAX package is the reference the port is
tested against; this package imports nothing of it.
"""

from . import models, ops, parallel

__all__ = ["models", "ops", "parallel"]
