"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_sharded.py), run by
`yoda_scheduler_tpu_torch.parallel.launch.run_ranks` with gloo on the CPU.

This module imports no JAX: each rank is a fresh interpreter that imports
only the port. The test process computes the JAX side, writes the inputs
as numpy arrays into a directory, and reads back what rank 0 writes."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yoda_scheduler_tpu_torch.models import LlamaConfig, params_from_jax
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step, gather_params,
                                               init_opt_state, make_mesh,
                                               param_leaves, quick_mesh_and_step,
                                               ring_attention, shard_params)
from yoda_scheduler_tpu_torch.parallel.sharding import ShardPlan


def flatten(params: dict) -> dict:
    """JAX-layout params (layers stacked) -> {"embed": ..., "layers.wq": ...}."""
    out = {n: params[n] for n in ("embed", "final_norm", "lm_head")}
    out.update({f"layers.{n}": a for n, a in params["layers"].items()})
    return out


def unflatten(flat) -> dict:
    layers = {k.split(".", 1)[1]: flat[k] for k in flat if k.startswith("layers.")}
    return {**{n: flat[n] for n in ("embed", "final_norm", "lm_head")}, "layers": layers}


def stacked(params: dict) -> dict:
    """The port's params (a list of layers) stacked as the JAX package's, numpy."""
    as_np = lambda t: t.detach().float().numpy()  # noqa: E731
    layers = {n: np.stack([as_np(layer[n]) for layer in params["layers"]])
              for n in params["layers"][0]}
    return {**{n: as_np(params[n]) for n in ("embed", "final_norm", "lm_head")},
            "layers": layers}


def ring_rank(rank: int, world: int, path: str) -> None:
    """q, k, v [B, H, S, D] from inputs.npz: this rank's sequence chunk
    through `ring_attention` over a world-sized sp axis, out and the
    gradients of sum(out * w); rank r writes ring_r.npz."""
    d = np.load(Path(path) / "inputs.npz")
    mesh = make_mesh({"sp": world}, device="cpu")
    q, k, v, w = (torch.from_numpy(d[n]).chunk(world, 2)[rank].contiguous()
                  for n in ("q", "k", "v", "w"))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ring_attention(q, k, v, mesh)
    (out * w).sum().backward()
    np.savez(Path(path) / f"ring_{rank}.npz", out=out.detach().numpy(),
             dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())


def sharded_rank(rank: int, world: int, path: str, legs: list) -> None:
    """Each leg (name, mesh shape or None for `quick_mesh_and_step`, config
    fields): the JAX weights from <name>_params.npz through
    `params_from_jax`, shard_params -> gather_params must give them back;
    then 2 steps on tokens.npy, the sharded step's losses and the
    parameters gathered after, written by rank 0 as <name>_out.npz."""
    tokens = torch.from_numpy(np.load(Path(path) / "tokens.npy"))
    for name, shape, fields in legs:
        cfg = LlamaConfig(**fields)
        if shape is None:
            mesh, _, _, step_fn, batch_fn = quick_mesh_and_step(world, cfg, device="cpu")
        else:
            mesh = make_mesh(shape, device="cpu")
            _, step_fn, batch_fn = build_llama_train_step(cfg, mesh)
        flat = dict(np.load(Path(path) / f"{name}_params.npz"))
        whole = params_from_jax(unflatten(flat), cfg, device="cpu")
        params = shard_params(whole, mesh, cfg)
        back = gather_params(params, mesh, cfg)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(param_leaves(back), param_leaves(whole)))
        opt = init_opt_state(params, 3e-4)
        losses = []
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, batch_fn(tokens))
            losses.append(float(loss))
        out = flatten(stacked(gather_params(params, mesh, cfg)))
        plan = ShardPlan(cfg, mesh)
        if rank == 0:
            np.savez(Path(path) / f"{name}_out.npz", losses=np.array(losses),
                     round_trip=np.array(round_trip), mesh=np.array(
                         [mesh.shape[a] for a in mesh.shape]),
                     local_tokens=np.array(plan.tokens(tokens).shape), **out)
