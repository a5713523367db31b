"""Training step for the Llama workload on one device: the loss and its
gradient (through the flash attention kernels on CUDA), remat, and AdamW
with optax's defaults. The port of yoda_scheduler_tpu/parallel/train.py's
`build_llama_train_step` without a mesh; the sharded step, ring and Ulysses
attention are ROADMAP.md queue 1 items 7-10.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..models.llama import LlamaConfig, init_llama, llama_loss

# optax.adamw(learning_rate)'s defaults; torch's AdamW decays by 1e-2
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every tensor of a parameter dict, in a fixed order: embed, each
    layer's leaves, final_norm, lm_head."""
    return ([params["embed"]]
            + [t for layer in params["layers"] for t in layer.values()]
            + [params["final_norm"], params["lm_head"]])


def init_opt_state(params: dict, learning_rate: float = 3e-4):
    """AdamW over every leaf of `params` (norms and embedding decay too, as
    optax.adamw has no mask), with optax's defaults: b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4. Moments are kept in each leaf's dtype, as optax
    keeps them. Marks the leaves as requiring grad; each must own its
    storage (`params_from_jax` and `init_llama` give such leaves). On CUDA
    the update is one fused multi-tensor kernel with no temporary of the
    parameters' size."""
    leaves = param_leaves(params)
    for t in leaves:
        if t._base is not None:
            raise ValueError("every parameter must own its storage, not be a "
                             "view of another tensor")
        t.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(ADAM_B1, ADAM_B2),
                             eps=ADAM_EPS, weight_decay=WEIGHT_DECAY,
                             fused=all(t.is_cuda for t in leaves))


def build_llama_train_step(config: LlamaConfig, mesh=None,
                           learning_rate: float = 3e-4, remat: bool = True,
                           use_ring_attention: bool | None = None,
                           sp_attention: str | None = None, device="cuda"):
    """Returns (init_fn, step_fn, batch_device).

    - init_fn(seed) -> (params, opt_state): `init_llama` weights on the
      device, requiring grad, and `init_opt_state`'s AdamW
    - step_fn(params, opt_state, tokens) -> (params, opt_state, loss): the
      loss and its gradient, then AdamW applied in place; the loss is a 0-d
      tensor on the device (the step does not wait for the device)

    One device only: a `mesh`, or sequence-parallel attention ("ring",
    "ulysses"), raises NotImplementedError. The argument checks and their
    ValueErrors are the JAX package's."""
    if sp_attention not in (None, "none", "ring", "ulysses"):
        raise ValueError(
            f"sp_attention={sp_attention!r} — expected None, 'none', "
            "'ring' or 'ulysses'")
    if use_ring_attention is not None and sp_attention is not None:
        raise ValueError(
            "pass either sp_attention or the deprecated use_ring_attention,"
            " not both")
    if use_ring_attention:
        sp_attention = "ring"
    if mesh is not None or sp_attention in ("ring", "ulysses"):
        raise NotImplementedError(
            "the sharded train step (a mesh, ring or Ulysses attention) is "
            "not ported to PyTorch yet: ROADMAP.md queue 1 items 7-10")
    dev = resolve_device(device)

    def init_fn(seed: int = 0):
        params = init_llama(config, seed=seed, device=dev)
        return params, init_opt_state(params, learning_rate)

    def step_fn(params: dict, opt_state, tokens):
        loss = llama_loss(params, tokens.to(dev), config, remat=remat)
        loss.backward()
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss.detach()

    return init_fn, step_fn, dev
