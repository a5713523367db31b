"""Training step for the Llama workload: dp/fsdp/tp/ep (+ sp with ring or
Ulysses attention), remat and AdamW with optax's defaults, the loss and its
gradient through the flash attention kernels on CUDA. The port of
yoda_scheduler_tpu/parallel/train.py: on one device without a mesh, or on
one rank of a mesh (parallel/mesh.py), where each rank runs the same layers
on its shards (parallel/sharding.py:ShardPlan) and computes the loss and
the update the one-device step computes, up to the order of sums.
"""

from __future__ import annotations

import torch

from ..models.llama import LlamaConfig, init_llama, loss_terms
from .mesh import make_mesh, mesh_shape_for, one_device_mesh
from .ring import make_ring_attn
from .sharding import ShardPlan, shard_params
from .ulysses import make_ulysses_attn

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
    parameters' size. Over a rank's shards the update is the same
    elementwise update, so the moments are sharded like the parameters
    (the JAX package's `_shard_opt_state_like`)."""
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
    """Returns (init_fn, step_fn, batch_fn).

    - init_fn(seed) -> (params, opt_state): this rank's shards of the
      `init_llama(seed)` weights (all of them without a mesh), requiring
      grad, and `init_opt_state`'s AdamW over them
    - step_fn(params, opt_state, tokens) -> (params, opt_state, loss):
      `tokens` is this rank's piece of the step's batch; the loss and its
      gradient, the gradients summed over the ranks that hold other tokens,
      then AdamW applied in place; the loss (of the whole step) is a 0-d
      tensor on the device (the step does not wait for the device)
    - batch_fn(tokens) -> this rank's piece of the step's tokens [B, S] on
      the device (the twin of the JAX package's batch sharding)

    Sequence-parallel attention is one knob: `sp_attention` is None (auto:
    ring iff sp > 1), "ring", "ulysses" (parallel/ulysses.py) or "none" (the
    sequence gathered over sp); `use_ring_attention` is the deprecated
    boolean spelling; passing both raises. With a mesh the device is the
    mesh's. A mesh with pp > 1 does not pipeline here, as in the JAX
    package: no spec splits over pp, so every pp index runs the same step
    (parallel/pipeline.py pipelines)."""
    if sp_attention not in (None, "none", "ring", "ulysses"):
        raise ValueError(
            f"sp_attention={sp_attention!r} — expected None, 'none', "
            "'ring' or 'ulysses'")
    if use_ring_attention is not None and sp_attention is not None:
        raise ValueError(
            "pass either sp_attention or the deprecated use_ring_attention,"
            " not both")
    if mesh is None:
        mesh = one_device_mesh(device)
    dev = mesh.device
    sp = mesh.shape["sp"]
    if sp_attention is None:
        if use_ring_attention is None:
            sp_attention = "ring" if sp > 1 else "none"
        else:
            sp_attention = "ring" if use_ring_attention else "none"
    attn_impl = None
    if sp_attention == "ring":
        attn_impl = make_ring_attn(mesh)
    elif sp_attention == "ulysses":
        attn_impl = make_ulysses_attn(mesh)
    plan = ShardPlan(config, mesh)

    def init_fn(seed: int = 0):
        params = shard_params(init_llama(config, seed=seed, device=dev), mesh, config)
        return params, init_opt_state(params, learning_rate)

    def step_fn(params: dict, opt_state, tokens):
        ce, aux = loss_terms(params, tokens.to(dev), config, attn_impl, remat,
                             plan=plan)
        # each rank's share of the cross-entropy, and the aux loss (over the
        # whole step) once: its gradient reaches each rank's own tokens
        (ce + config.moe_aux_weight * aux).backward()
        plan.reduce_grads(params)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, (plan.data_sum(ce) + config.moe_aux_weight * aux).detach()

    def batch_fn(tokens):
        return plan.tokens(tokens.to(dev))

    return init_fn, step_fn, batch_fn


def quick_mesh_and_step(n_devices: int | None = None,
                        config: LlamaConfig | None = None, device="cuda"):
    """Tiny model over the richest mesh n ranks allow: tp always, sp when
    divisible, remaining split dp x fsdp (the JAX package's choice). Needs
    the process group initialised over n ranks (or none, for n = 1)."""
    n = n_devices or (torch.distributed.get_world_size()
                      if torch.distributed.is_initialized() else 1)
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 and n // tp >= 2 else 1
    rest = n // (tp * sp)
    dp = 2 if rest % 2 == 0 else 1
    shape = mesh_shape_for(n, tp=tp, sp=sp, dp=dp)
    mesh = make_mesh(shape, device=device)
    config = config or LlamaConfig.tiny()
    init_fn, step_fn, batch_fn = build_llama_train_step(config, mesh)
    return mesh, config, init_fn, step_fn, batch_fn
