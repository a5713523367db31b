"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_sharded.py; the checkpoint's 8-rank save and restore),
run by
`yoda_scheduler_tpu_torch.parallel.launch.run_ranks` with gloo on the CPU.

This module imports no JAX: each rank is a fresh interpreter that imports
only the port. The test process computes the JAX side, writes the inputs
as numpy arrays into a directory, and reads back what rank 0 writes."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yoda_scheduler_tpu_torch.models import LlamaConfig, params_from_jax
from yoda_scheduler_tpu_torch.parallel import (TrainCheckpointer, build_llama_train_step,
                                               build_pipelined_llama_train_step,
                                               gather_params, init_opt_state,
                                               llama_pipeline_param_specs, make_mesh,
                                               param_leaves, quick_mesh_and_step,
                                               ring_attention, shard_params)


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


def sharded_rank(rank: int, world: int, path: str, legs: list,
                 checkpoint: dict | None = None) -> None:
    """Each leg (name, mesh shape or None for `quick_mesh_and_step`, config
    fields, builder options): the JAX weights from <name>_params.npz through
    `params_from_jax`, shard_params -> gather_params must give them back;
    then 2 steps on tokens.npy, the sharded step's losses and the
    parameters gathered after, written by rank 0 as <name>_out.npz. Options
    with "num_microbatches" build the pipelined step (its specs stage the
    layers over pp); the others go to `build_llama_train_step`
    (`sp_attention`). With `checkpoint` (config fields), then
    `checkpoint_rank`."""
    tokens = torch.from_numpy(np.load(Path(path) / "tokens.npy"))
    for name, shape, fields, opts in legs:
        cfg = LlamaConfig(**fields)
        specs = None
        if shape is None:
            mesh, _, _, step_fn, batch_fn = quick_mesh_and_step(world, cfg, device="cpu")
        elif "num_microbatches" in opts:
            mesh = make_mesh(shape, device="cpu")
            _, step_fn, batch_fn = build_pipelined_llama_train_step(cfg, mesh, **opts)
            specs = llama_pipeline_param_specs(cfg)
        else:
            mesh = make_mesh(shape, device="cpu")
            _, step_fn, batch_fn = build_llama_train_step(cfg, mesh, **opts)
        flat = dict(np.load(Path(path) / f"{name}_params.npz"))
        whole = params_from_jax(unflatten(flat), cfg, device="cpu")
        params = shard_params(whole, mesh, cfg, specs)
        back = gather_params(params, mesh, cfg, specs)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(param_leaves(back), param_leaves(whole)))
        opt = init_opt_state(params, 3e-4)
        losses = []
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, batch_fn(tokens))
            losses.append(float(loss))
        out = flatten(stacked(gather_params(params, mesh, cfg, specs)))
        if rank == 0:
            np.savez(Path(path) / f"{name}_out.npz", losses=np.array(losses),
                     round_trip=np.array(round_trip), mesh=np.array(
                         [mesh.shape[a] for a in mesh.shape]),
                     local_tokens=np.array(batch_fn(tokens).shape), **out)
    if checkpoint is not None:
        checkpoint_rank(rank, world, path, tokens, checkpoint)


def _moments(params: dict, opt, key: str) -> dict:
    """The optimizer's `key` state of each leaf, laid out as `params`."""
    return {**{n: opt.state[params[n]][key] for n in ("embed", "final_norm", "lm_head")},
            "layers": [{n: opt.state[t][key] for n, t in layer.items()}
                       for layer in params["layers"]]}


def checkpoint_rank(rank: int, world: int, path: str, tokens, fields: dict) -> None:
    """One step of the dp2 fsdp2 tp2 step, saved by every rank; then
    restored onto pp2 fsdp2 tp2 under the pipeline's specs (another layout
    of every leaf, the layers staged over pp). Rank 0 writes
    checkpoint_out.npz: whether the restored parameters and both AdamW
    moments, gathered, equal the saved ones gathered, the optimizer step
    counts, and the next step's loss on each mesh."""
    cfg = LlamaConfig(**fields)
    mesh = make_mesh({"dp": 2, "fsdp": 2, "tp": 2}, device="cpu")
    init_fn, step_fn, batch_fn = build_llama_train_step(cfg, mesh)
    params, opt = init_fn(0)
    params, opt, _ = step_fn(params, opt, batch_fn(tokens))
    TrainCheckpointer(Path(path) / "ckpt", mesh=mesh, device="cpu").save(1, params, opt)
    want = [gather_params(params, mesh, cfg)] + [
        gather_params(_moments(params, opt, k), mesh, cfg) for k in ("exp_avg", "exp_avg_sq")]

    mesh2 = make_mesh({"pp": 2, "fsdp": 2, "tp": 2}, device="cpu")
    specs2 = llama_pipeline_param_specs(cfg)
    init2, step2, batch2 = build_pipelined_llama_train_step(cfg, mesh2, num_microbatches=2)
    params2, opt2 = init2(5)
    step, params2, opt2 = TrainCheckpointer(Path(path) / "ckpt", mesh=mesh2, specs=specs2,
                                            device="cpu").restore((params2, opt2))
    got = [gather_params(params2, mesh2, cfg, specs2)] + [
        gather_params(_moments(params2, opt2, k), mesh2, cfg, specs2)
        for k in ("exp_avg", "exp_avg_sq")]
    equal = [all(torch.equal(a, b) for a, b in zip(param_leaves(g), param_leaves(w)))
             for g, w in zip(got, want)]
    steps = [float(opt.state[params["embed"]]["step"]),
             float(opt2.state[params2["embed"]]["step"])]
    holds_template = all(a is b for a, b in zip(opt2.param_groups[0]["params"],
                                                param_leaves(params2)))
    loss = float(step_fn(params, opt, batch_fn(tokens))[2])
    loss2 = float(step2(params2, opt2, batch2(tokens))[2])
    if rank == 0:
        np.savez(Path(path) / "checkpoint_out.npz", step=step, equal=np.array(equal),
                 opt_steps=np.array(steps), holds_template=holds_template,
                 losses=np.array([loss, loss2]))
