"""Parameters of the JAX package's Llama, as numpy arrays, into the port's."""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .llama import LlamaConfig


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart for
        # from_numpy; widening to fp32 and narrowing back is exact
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(np_params: dict, config: LlamaConfig, device="cuda") -> dict:
    """The JAX params pytree (numpy leaves, layers stacked on a leading axis)
    as the port's parameter dict (a list of per-layer dicts), on `device`,
    each leaf keeping its dtype and owning its storage (not a view of the
    stacked array), so that an optimizer can update each leaf alone. MoE
    leaves split the same way: the stacked [L, E, ...] expert weights become
    one [E, ...] tensor per layer, and the router stays fp32."""
    dev = resolve_device(device)
    stacked = {name: _tensor(a, dev) for name, a in np_params["layers"].items()}
    layers = [{name: t[i].clone() for name, t in stacked.items()}
              for i in range(config.n_layers)]
    return {"embed": _tensor(np_params["embed"], dev), "layers": layers,
            "final_norm": _tensor(np_params["final_norm"], dev),
            "lm_head": _tensor(np_params["lm_head"], dev)}
