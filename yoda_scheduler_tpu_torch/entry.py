"""Entry points, the twins of the JAX package's `__graft_entry__.py`:
`entry()`, the tiny Llama forward with its example arguments, and
`dryrun_multichip(n)`, the sharded training step over an n-rank mesh."""

from __future__ import annotations

from functools import partial

import torch

from ._device import resolve_device
from .models import LlamaConfig, init_llama, llama_forward


def entry(device="cuda"):
    """-> (fn, (params, tokens)): `fn(params, tokens)` is the forward of
    `LlamaConfig.tiny()` with weights from seed 0 and tokens [2, 128] from
    seed 1, on `device`."""
    dev = resolve_device(device)
    config = LlamaConfig.tiny()
    params = init_llama(config, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (2, 128), generator=gen,
                           device=dev)
    return partial(llama_forward, config=config), (params, tokens)


def _dryrun_rank(rank: int, world: int, device: str) -> None:
    """One rank of `dryrun_multichip`: the main leg, then the pipeline, MoE
    and Ulysses legs, in the JAX package's order."""
    from .parallel import (build_llama_train_step, build_pipelined_llama_train_step,
                           make_mesh, mesh_shape_for)
    from .parallel.train import quick_mesh_and_step

    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)

    def step_once(config, init_fn, step_fn, batch_fn, batch):
        params, opt_state = init_fn(0)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, config.vocab_size, (batch, 128), generator=gen,
                               device=dev)
        _, _, loss = step_fn(params, opt_state, batch_fn(tokens))
        return float(loss)

    def leg(label, shape, config, build, batch, **kwargs):
        mesh = make_mesh(shape, device=dev)
        loss = step_once(config, *build(config, mesh, **kwargs), batch)
        if rank == 0:
            print(f"{label}: mesh={mesh.shape} loss={loss:.4f}", flush=True)

    mesh, config, init_fn, step_fn, batch_fn = quick_mesh_and_step(world, device=dev)
    shape = mesh.shape
    loss = step_once(config, init_fn, step_fn, batch_fn,
                     max(shape["dp"] * shape["fsdp"], 1) * 2)
    if rank == 0:
        print(f"dryrun_multichip ok: mesh={shape} loss={loss:.4f}", flush=True)
    if world % 2 == 0:
        tp = 2 if world % 4 == 0 else 1
        # the batch splits into 4 microbatches, each over dp x fsdp
        shape = mesh_shape_for(world, pp=2, tp=tp)
        leg("dryrun pipeline ok", shape, LlamaConfig.tiny(),
            build_pipelined_llama_train_step, 4 * shape["dp"] * shape["fsdp"],
            num_microbatches=4)
        shape = mesh_shape_for(world, ep=2, tp=tp)
        leg("dryrun moe ok", shape, LlamaConfig.tiny_moe(), build_llama_train_step,
            max(shape["dp"] * shape["fsdp"] * shape["ep"], 1) * 2)
    if world % 8 == 0:
        # tp=1: tiny's 2 kv heads split over sp=2, the grouped-KV exchange
        shape = mesh_shape_for(world, sp=2, tp=1, dp=2)
        leg("dryrun ulysses ok", shape, LlamaConfig.tiny(), build_llama_train_step,
            max(shape["dp"] * shape["fsdp"], 1) * 2, sp_attention="ulysses")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The sharded training step of `LlamaConfig.tiny()` over an n-rank mesh
    (`quick_mesh_and_step`: tp always, sp with ring attention when n
    allows, the rest dp x fsdp), one step on tokens [2 dp fsdp, 128]; then,
    for even n, the pipeline leg (pp=2, tp=2 when 4 divides n, 4
    microbatches of dp x fsdp rows) and the MoE leg (`tiny_moe` with ep=2,
    tp as the pipeline's), and for n a multiple of 8 the Ulysses leg (sp=2,
    dp=2, tp=1). Rank 0 prints the JAX package's lines. NCCL over n cards,
    one rank a card (fewer cards raise); gloo with device="cpu"."""
    from .parallel.launch import run_ranks

    run_ranks(_dryrun_rank, n_devices, device=device, args=(device,))


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype))
