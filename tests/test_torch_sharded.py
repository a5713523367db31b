"""The port's sharded training step (yoda_scheduler_tpu_torch/parallel/)
against the JAX package's on the same mesh, weights and tokens: losses over
two steps and every parameter gathered after them, fp32.

The port's ranks are spawned processes (gloo on the CPU, a FileStore under
tmp_path as the rendezvous, one thread each, no JAX: tests/torch_ranks.py);
the JAX step runs here on the 8 virtual CPU devices of tests/conftest.py,
and the two sides meet through numpy files. Rank r holds the shards that
device r holds (tests/test_torch_mesh.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
from yoda_scheduler_tpu.parallel import make_mesh, mesh_shape_for
from yoda_scheduler_tpu_torch.parallel.launch import run_ranks

DENSE = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
MOE = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32")
LR = 3e-4
# (mesh shape, None for quick_mesh_and_step(8); config)
LEGS = {
    "quick_8": (None, DENSE),                                   # tp2 sp2 dp2, ring
    "dp2_fsdp2_tp2": ({"dp": 2, "fsdp": 2, "tp": 2}, DENSE),
    "moe_ep2_tp2_dp2": (mesh_shape_for(8, ep=2, tp=2, dp=2), MOE),
}
SLOW_LEGS = {
    "fsdp2_sp2_tp2": ({"dp": 1, "fsdp": 2, "sp": 2, "tp": 2}, DENSE),  # test_sp_ring_step's
    "moe_fsdp2_ep2_sp2": ({"fsdp": 2, "ep": 2, "sp": 2}, MOE),         # the sp-wide queues
}


def _jax_quick_shape():
    """quick_mesh_and_step(8)'s axes, as the JAX package chooses them."""
    return mesh_shape_for(8, tp=2, sp=2, dp=2)


def _run(tmp_path, legs):
    """The JAX step on each leg's mesh, then the port's 8 ranks on the same
    weights and tokens: {leg: (JAX losses, JAX params, port's output)}."""
    tokens = np.random.default_rng(1).integers(0, DENSE.vocab_size, (8, 64))
    np.save(tmp_path / "tokens.npy", tokens)
    want, rank_legs = {}, []
    for name, (shape, cfg) in legs.items():
        mesh = make_mesh(shape or _jax_quick_shape())
        init_fn, step_fn, batch_sh = jax_build(cfg, mesh)
        params, opt = init_fn(jax.random.PRNGKey(0))
        np.savez(tmp_path / f"{name}_params.npz",
                 **torch_ranks.flatten(jax.tree.map(np.asarray, params)))
        losses = []
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, jax.device_put(
                jnp.asarray(tokens, jnp.int32), batch_sh))
            losses.append(float(loss))
        want[name] = (losses, torch_ranks.flatten(jax.tree.map(np.asarray, params)))
        rank_legs.append((name, shape, dataclasses.asdict(cfg)))
    run_ranks(torch_ranks.sharded_rank, 8, device="cpu",
              args=(str(tmp_path), rank_legs), timeout_s=300)
    return {name: (*want[name], np.load(tmp_path / f"{name}_out.npz")) for name in legs}


def _check(name, jlosses, jparams, got, shape):
    """Losses within 1e-5 relative (fp32, the order of sums; measured <=
    3.2e-7 over the five legs). Each leaf within rel. L2 2e-5 (measured <=
    2.8e-6) and each entry within 2 lr (measured <= 4.4e-5): AdamW's first
    step moves an entry by lr g / (|g| + eps), so an entry whose gradient is
    at rounding level moves by up to lr either way in either framework."""
    assert bool(got["round_trip"]), f"{name}: gather_params(shard_params(p)) != p"
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=0, err_msg=name)
    assert got["losses"][1] < got["losses"][0]
    if shape is not None:
        assert list(got["mesh"]) == [shape.get(a, 1) for a in
                                     ("pp", "dp", "fsdp", "ep", "sp", "tp")]
    for leaf, want in jparams.items():
        err = got[leaf] - want
        assert np.linalg.norm(err) / np.linalg.norm(want) < 2e-5, (name, leaf)
        assert np.abs(err).max() <= 2 * LR, (name, leaf)


def test_sharded_steps_match_jax(tmp_path):
    """One spawn of 8 ranks, three legs: quick_mesh_and_step(8) (tp2 sp2
    dp2, ring attention), dp2 fsdp2 tp2 dense, and ep2 tp2 dp2 tiny_moe."""
    results = _run(tmp_path, LEGS)
    assert list(results["quick_8"][2]["mesh"]) == [
        _jax_quick_shape()[a] for a in ("pp", "dp", "fsdp", "ep", "sp", "tp")]
    # quick_8's tokens [8, 64] over dp2 x sp2: [4, 32] a rank
    assert list(results["quick_8"][2]["local_tokens"]) == [4, 32]
    for name, (jlosses, jparams, got) in results.items():
        _check(name, jlosses, jparams, got, LEGS[name][0])


@pytest.mark.slow
def test_sharded_steps_with_sp_match_jax(tmp_path):
    """The other spawn: fsdp2 sp2 tp2 dense (the JAX package's
    test_sp_ring_step mesh) and MoE over sp2, whose queue positions scan
    each row across the sequence's chunks."""
    for name, (jlosses, jparams, got) in _run(tmp_path, SLOW_LEGS).items():
        _check(name, jlosses, jparams, got, SLOW_LEGS[name][0])


def test_dryrun_multichip_never_falls_back_to_the_cpu():
    """On the card it spawns one rank a card; without enough cards it
    raises, whatever the CPU could run."""
    import torch

    from yoda_scheduler_tpu_torch.entry import dryrun_multichip
    if torch.cuda.device_count() >= 8:
        pytest.skip("this host has 8 cards: the dryrun would run")
    with pytest.raises(RuntimeError, match="8 ranks need 8 CUDA devices"):
        dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_on_the_cpu(capfd):
    """dryrun_multichip(8, device="cpu"): the main leg (tp2 sp2 dp2, ring)
    and the MoE leg (ep2 tp2 fsdp2), one step each, rank 0 printing the
    JAX package's lines with finite losses."""
    from yoda_scheduler_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh={'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 1, 'sp': 2, " \
           "'tp': 2}" in out
    assert "dryrun moe ok: mesh={'pp': 1, 'dp': 1, 'fsdp': 2, 'ep': 2, 'sp': 1, " \
           "'tp': 2}" in out
    assert "nan" not in out
