"""The port's pipelined step (yoda_scheduler_tpu_torch/parallel/pipeline.py)
against the JAX package's `pipelined_llama_loss` on the 8 virtual CPU
devices of tests/conftest.py: the loss and every gradient, fp32 and bf16,
weights through `params_from_jax`, tokens from a numpy seed.

The port runs every stage in one process here (`pp=`): the same tick loop,
stage body and backward schedule as one rank a stage, the tensors handed on
in place. The point-to-point hand-over, the pp layout of the weights and
the gradient sums over pp run in the 8-rank steps of
tests/test_torch_sharded.py (legs `moe_pp2_dp2_tp2`, and the slow
`pp2_fsdp2_tp2` and `moe_pp2_ep2_tp2`), which also hold the
shard_params -> gather_params round trip over pp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
from yoda_scheduler_tpu.parallel import make_mesh
from yoda_scheduler_tpu.parallel import pipeline as jpipeline
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import params_from_jax
from yoda_scheduler_tpu_torch.parallel import mesh as tmesh
from yoda_scheduler_tpu_torch.parallel import pipeline as tpipeline
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step, init_opt_state,
                                               param_leaves, sharding as tsharding)

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
MESH = {"pp": 2, "dp": 2, "tp": 2}  # the JAX package's test_pipeline.py mesh
F32 = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
MOE_F32 = dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32")


def _twin(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


def _tokens(seed=1, shape=(8, 64)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _jax_loss(jcfg, jparams, tokens, microbatches=4, remat=False, grad=False):
    mesh = make_mesh(MESH)
    fn = lambda p, t: jpipeline.pipelined_llama_loss(  # noqa: E731
        p, t, jcfg, mesh, num_microbatches=microbatches, remat=remat)
    t = jnp.asarray(tokens, jnp.int32)
    if grad:
        return jax.jit(jax.value_and_grad(fn))(jparams, t)
    return jax.jit(fn)(jparams, t)


def _port_params(jcfg, jparams):
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg), device="cpu")
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    return tparams


def _port_loss(jcfg, tparams, tokens, microbatches=4, remat=False):
    return tpipeline.pipelined_llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg),
                                          pp=MESH["pp"], num_microbatches=microbatches,
                                          remat=remat)


def _grads(tparams):
    """{leaf name: gradient} in the JAX package's stacked layout, numpy."""
    g = {n: tparams[n].grad.numpy() for n in ("embed", "final_norm", "lm_head")}
    g.update({f"layers.{n}": np.stack([layer[n].grad.numpy() for layer in tparams["layers"]])
              for n in tparams["layers"][0]})
    return g


def _flat(jgrads):
    out = {n: np.asarray(jgrads[n], np.float32) for n in ("embed", "final_norm", "lm_head")}
    out.update({f"layers.{n}": np.asarray(a, np.float32)
                for n, a in jgrads["layers"].items()})
    return out


@pytest.fixture(scope="module")
def f32_params():
    return jllama.init_llama(F32, jax.random.PRNGKey(0))


@pytest.mark.parametrize("remat", [False, True])
def test_fp32_loss_and_gradients_match_jax(f32_params, remat):
    """fp32: the loss within 1e-5 relative and every gradient within rel. L2
    2e-5 (the order of sums only)."""
    tokens = _tokens()
    jloss, jgrads = _jax_loss(F32, f32_params, tokens, remat=remat, grad=True)
    tparams = _port_params(F32, f32_params)
    loss = _port_loss(F32, tparams, tokens, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=0)
    got = _grads(tparams)
    for name, want in _flat(jgrads).items():
        err = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert err < 2e-5, (name, err)


def test_bf16_loss_matches_jax():
    """bf16: within 5e-3, the JAX package's own bound against its plain
    model (test_loss_matches_plain_model)."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    tokens = _tokens()
    want = float(_jax_loss(jcfg, jparams, tokens))
    with torch.no_grad():
        got = float(_port_loss(jcfg, _port_params(jcfg, jparams), tokens))
    assert abs(got - want) < 5e-3, (got, want)


@pytest.mark.parametrize("microbatches", [2, 8])
def test_microbatch_counts_match_jax(f32_params, microbatches):
    tokens = _tokens()
    want = float(_jax_loss(F32, f32_params, tokens, microbatches))
    with torch.no_grad():
        got = float(_port_loss(F32, _port_params(F32, f32_params), tokens, microbatches))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_remat_equals_no_remat(f32_params):
    """Recomputing each layer in the backward gives the same gradients (the
    same operations on the same inputs, to 1e-6)."""
    tokens = _tokens()
    grads = []
    for remat in (False, True):
        tparams = _port_params(F32, f32_params)
        _port_loss(F32, tparams, tokens, remat=remat).backward()
        grads.append(_grads(tparams))
    for name in grads[0]:
        np.testing.assert_allclose(grads[1][name], grads[0][name], atol=1e-6, rtol=0,
                                   err_msg=name)


def _aux(loss_fn, jcfg):
    """The weighted aux term alone: the loss at aux weight 1 minus at 0."""
    return (loss_fn(dataclasses.replace(jcfg, moe_aux_weight=1.0))
            - loss_fn(dataclasses.replace(jcfg, moe_aux_weight=0.0)))


def test_moe_aux_is_per_microbatch_of_the_steps_rows():
    """tiny_moe: the aux term, sum over microbatches and layers / (L M),
    each microbatch's load-balance statistic over its own tokens, against
    JAX's within 1e-5 relative (fp32). Microbatch m is the step's rows
    [m B/M, (m + 1) B/M): grouping the rows otherwise (strided: m, m + M,
    ...) moves each microbatch's statistic, and the same bound rejects it."""
    jparams = jllama.init_llama(MOE_F32, jax.random.PRNGKey(0))
    tokens = _tokens(2)
    want = float(_aux(lambda c: float(_jax_loss(c, jparams, tokens)), MOE_F32))
    tparams = _port_params(MOE_F32, jparams)

    def port_aux(toks):
        with torch.no_grad():
            return float(_aux(lambda c: float(_port_loss(c, tparams, toks)), MOE_F32))

    assert abs(port_aux(tokens) - want) <= 1e-5 * abs(want), (port_aux(tokens), want)
    b, s = tokens.shape
    strided = tokens.reshape(b // 4, 4, s).transpose(1, 0, 2).reshape(b, s)
    assert abs(port_aux(strided) - want) > 1e-5 * abs(want)


def test_specs_stage_the_layer_list_over_pp():
    """The JAX package's pipeline specs put pp on the stacked-layer axis;
    the port's on the list of layers, every leaf's own spec unchanged."""
    for jcfg in (F32, MOE_F32):
        want = jpipeline.llama_pipeline_param_specs(jcfg)
        got = tpipeline.llama_pipeline_param_specs(_twin(jcfg))
        assert got["layer_list"] == "pp"
        assert tsharding.llama_param_specs(_twin(jcfg))["layer_list"] is None
        for name, spec in want["layers"].items():
            assert spec[0] == "pp"
            assert got["layers"][name] == tuple(
                tuple(e) if isinstance(e, (list, tuple)) else e for e in spec[1:]), name
        for name in ("embed", "final_norm", "lm_head"):
            assert "pp" not in str(want[name]) and got[name] == \
                tsharding.llama_param_specs(_twin(jcfg))[name]


def test_every_rank_holds_the_jax_devices_stage_and_rows(f32_params):
    """Rank r of {pp2, dp2, tp2}: shard_params under the pipeline's specs
    gives device r's shard of JAX's `llama_pipeline_shardings` (its stage's
    layers), and batch_fn gives, for each microbatch, device r's rows of
    the JAX pipeline's microbatch layout P(None, (dp, fsdp))."""
    jm = make_mesh(MESH)
    placed = jax.tree.map(jax.device_put, f32_params,
                          jpipeline.llama_pipeline_shardings(jm, F32))
    tokens = _tokens()
    jrows = jax.device_put(jnp.asarray(tokens.reshape(4, 2, 64)),
                           NamedSharding(jm, P(None, ("dp", "fsdp"), None)))

    def by_device(arr):
        return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}

    jshards, jrows = jax.tree.map(by_device, placed), by_device(jrows)
    cfg = _twin(F32)
    whole = params_from_jax(jax.tree.map(np.asarray, f32_params), cfg, device="cpu")
    grid = tmesh.rank_grid(MESH, 8)
    for rank in range(8):
        mesh = tmesh.Mesh(grid, CPU, rank=rank)
        local = tsharding.shard_params(whole, mesh, cfg,
                                       tpipeline.llama_pipeline_param_specs(cfg))
        for n in ("embed", "final_norm", "lm_head"):
            np.testing.assert_array_equal(local[n].numpy(), jshards[n][rank], err_msg=n)
        assert len(local["layers"]) == cfg.n_layers // 2
        for i, layer in enumerate(local["layers"]):
            for n, t in layer.items():
                np.testing.assert_array_equal(t.numpy(), jshards["layers"][n][rank][i],
                                              err_msg=f"rank {rank} layers.{i}.{n}")
        _, _, batch_fn = tpipeline.build_pipelined_llama_train_step(cfg, mesh,
                                                                    num_microbatches=4)
        np.testing.assert_array_equal(batch_fn(torch.from_numpy(tokens)).numpy(),
                                      jrows[rank].reshape(-1, 64))


def test_plain_step_on_a_pp_mesh_matches_jax():
    """build_llama_train_step on a pp=2 mesh does not pipeline, in either
    framework: no spec splits over pp, so each pp index runs the whole step.
    Each rank's view against JAX's step on the same mesh, two fp32 steps:
    losses within 1e-5 relative, every leaf within rel. L2 2e-5 and 2 lr."""
    lr = 3e-4
    shape = {"pp": 2}
    init_fn, step_fn, batch_sh = jax_build(F32, make_mesh(shape, devices=jax.devices()[:2]))
    jparams, jopt = init_fn(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jparams)
    tokens = _tokens(3, (2, 64))
    jlosses = []
    for _ in range(2):
        jparams, jopt, loss = step_fn(jparams, jopt, jax.device_put(
            jnp.asarray(tokens, jnp.int32), batch_sh))
        jlosses.append(float(loss))
    want = _flat(jax.tree.map(np.asarray, jparams))
    cfg = _twin(F32)
    for rank in range(2):
        mesh = tmesh.Mesh(tmesh.rank_grid(shape, 2), CPU, rank=rank)
        _, tstep, batch_fn = build_llama_train_step(cfg, mesh)
        params = tsharding.shard_params(params_from_jax(start, cfg, device="cpu"), mesh, cfg)
        opt = init_opt_state(params, lr)
        losses = []
        for _ in range(2):
            params, opt, loss = tstep(params, opt, batch_fn(torch.from_numpy(tokens)))
            losses.append(float(loss))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
        got = {n: params[n].detach().numpy() for n in ("embed", "final_norm", "lm_head")}
        got.update({f"layers.{n}": np.stack([layer[n].detach().numpy()
                                             for layer in params["layers"]])
                    for n in params["layers"][0]})
        for name, w in want.items():
            err = got[name] - w
            assert np.linalg.norm(err) / np.linalg.norm(w) < 2e-5, (rank, name)
            assert np.abs(err).max() <= 2 * lr, (rank, name)


# each refusal of the JAX package, in its words: (config, tokens shape,
# microbatches, mesh of the port's call: None for the one-process path)
REFUSALS = {
    "layers_by_pp": (dataclasses.replace(F32, n_layers=3), (8, 64), 4, None),
    "batch_by_microbatches": (F32, (6, 64), 4, None),
    "sp": (F32, (8, 64), 4, {"pp": 2, "sp": 2, "tp": 2}),
    "sliding_window": (dataclasses.replace(F32, sliding_window=16), (8, 64), 4, None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(f32_params, case):
    jcfg, shape, microbatches, port_mesh = REFUSALS[case]
    tokens = np.zeros(shape, np.int64)
    with pytest.raises(ValueError) as jerr:
        jpipeline.pipelined_llama_loss(f32_params, jnp.asarray(tokens, jnp.int32), jcfg,
                                       make_mesh(port_mesh or MESH),
                                       num_microbatches=microbatches)
    tparams = params_from_jax(jax.tree.map(np.asarray, f32_params), _twin(F32), device="cpu")
    if port_mesh is None:
        kwargs = dict(pp=MESH["pp"])
    else:
        kwargs = dict(mesh=tmesh.Mesh(tmesh.rank_grid(port_mesh, 8), CPU, rank=0))
    with pytest.raises(ValueError) as terr:
        tpipeline.pipelined_llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg),
                                       num_microbatches=microbatches, **kwargs)
    assert str(terr.value) == str(jerr.value)
    if case != "batch_by_microbatches":
        # the builder refuses the same configurations before any step
        with pytest.raises(ValueError) as berr:
            tpipeline.build_pipelined_llama_train_step(_twin(jcfg), device="cpu",
                                                       num_microbatches=microbatches,
                                                       **kwargs)
        assert str(berr.value) == str(jerr.value)


def test_one_process_step_trains():
    """The one-process pipelined step (every stage here): the loss falls on
    a fixed batch, the parameters stay the whole model's."""
    cfg = tllama.LlamaConfig.tiny()
    init_fn, step_fn, batch_fn = tpipeline.build_pipelined_llama_train_step(
        cfg, pp=2, num_microbatches=4, device="cpu")
    params, opt = init_fn(0)
    assert len(params["layers"]) == cfg.n_layers
    tokens = batch_fn(torch.from_numpy(_tokens(7)))
    losses = [float(step_fn(params, opt, tokens)[2]) for _ in range(3)]
    assert losses[2] < losses[0], losses
