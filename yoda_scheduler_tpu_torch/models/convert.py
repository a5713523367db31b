"""Parameters of the JAX package's Llama and ResNet, as numpy arrays, into the
port's."""

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


# Flax's automatic names inside a Bottleneck, in creation order: the three
# convs and their BatchNorms, then the residual's projection
_BLOCK_NAMES = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
                "BatchNorm_1": "bn2", "Conv_2": "conv3", "BatchNorm_2": "bn3",
                "Conv_3": "proj_conv", "BatchNorm_3": "proj_bn"}
_TOP_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "fc"}
_LEAF_NAMES = {"kernel": "weight", "scale": "scale", "bias": "bias", "mean": "mean",
               "var": "var"}


def _resnet_leaves(tree: dict, device: torch.device) -> dict:
    """{port name: tensor} of a Flax ResNet collection (params or
    batch_stats): conv kernels HWIO -> OIHW, the Dense kernel [in, out] ->
    [out, in]."""
    out = {}
    for top, sub in tree.items():
        if top.startswith("Bottleneck_"):
            mods = {f"blocks.{top.split('_')[1]}.{_BLOCK_NAMES[n]}": leaves
                    for n, leaves in sub.items()}
        else:
            mods = {_TOP_NAMES[top]: sub}
        for mod, leaves in mods.items():
            for leaf, a in leaves.items():
                t = _tensor(a, device)
                if leaf == "kernel":
                    t = (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T).contiguous()
                out[f"{mod}.{_LEAF_NAMES[leaf]}"] = t
    return out


def resnet_params_from_jax(np_params: dict, np_batch_stats: dict, device="cuda") -> dict:
    """The Flax ResNet's `params` and `batch_stats` (numpy leaves) as the
    port's variables {"params": ..., "batch_stats": ...} for
    `models.resnet.resnet_forward_fn`'s apply_fn (the module's parameter
    and buffer names), on `device`, fp32 as Flax stores them."""
    dev = resolve_device(device)
    return {"params": _resnet_leaves(np_params, dev),
            "batch_stats": _resnet_leaves(np_batch_stats, dev)}
