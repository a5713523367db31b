"""The PyTorch port's training step (yoda_scheduler_tpu_torch/parallel/train.py)
and the model's gradient path, against the JAX package's on the same
weights and tokens.

The JAX side is `build_llama_train_step` on a one-device mesh (its Pallas
attention kernels, forward and backward, in interpret mode); the port's
weights come from the JAX init through `params_from_jax`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
from yoda_scheduler_tpu.parallel import make_mesh
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import params_from_jax
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step,
                                               init_opt_state, one_device_mesh,
                                               param_leaves)

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

STEPS = 4
CONFIGS = {
    "float32": dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32"),
    "bfloat16": jllama.LlamaConfig.tiny(),
}
# fp32: the frameworks differ in the order of their fp32 sums (losses
# agree to ~1e-6, leaves to ~2e-7 after 4 steps). bf16: both round every
# matmul output and the AdamW moments to bf16, at places that differ by
# an ulp (losses agree to ~3e-4, leaves to ~1.5e-3, one bf16 ulp near 0.3).
TOL = {"float32": dict(loss=dict(rtol=1e-5, atol=0), leaf=1e-5),
       "bfloat16": dict(loss=dict(rtol=0, atol=2e-3), leaf=1e-2)}


def _twin(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=list(CONFIGS))
def trained(request):
    """4 steps of each framework from the same weights and batch:
    (dtype, JAX losses, port losses, JAX final params as numpy, port params)."""
    jcfg = CONFIGS[request.param]
    mesh = make_mesh({}, devices=jax.devices()[:1])
    init_fn, step_fn, _ = jax_build(jcfg, mesh)
    jparams, jopt = init_fn(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg),
                              device="cpu")
    _, tstep, _ = build_llama_train_step(_twin(jcfg), device="cpu")
    topt = init_opt_state(tparams, 3e-4)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 64))
    jlosses, tlosses = [], []
    for _ in range(STEPS):  # one fixed batch, so that the loss falls
        jparams, jopt, jloss = step_fn(jparams, jopt, jnp.asarray(tokens, jnp.int32))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(tokens))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    return (request.param, jlosses, tlosses, jax.tree.map(np.asarray, jparams),
            tparams)


def test_train_losses_match_jax(trained):
    dtype, jlosses, tlosses, _, _ = trained
    np.testing.assert_allclose(tlosses, jlosses, **TOL[dtype]["loss"])
    assert all(b < a for a, b in zip(tlosses, tlosses[1:]))


def test_trained_weights_match_jax(trained):
    dtype, _, _, jparams, tparams = trained
    tol = TOL[dtype]["leaf"]
    for name in ("embed", "final_norm", "lm_head"):
        assert tparams[name].dtype == getattr(torch, str(jparams[name].dtype))
        np.testing.assert_allclose(_np(tparams[name]), jparams[name].astype(np.float32),
                                   atol=tol, rtol=0, err_msg=name)
    for i, layer in enumerate(tparams["layers"]):
        for name, t in layer.items():
            want = jparams["layers"][name][i]
            assert t.dtype == getattr(torch, str(want.dtype))
            np.testing.assert_allclose(_np(t), want.astype(np.float32), atol=tol,
                                       rtol=0, err_msg=f"layers.{i}.{name}")


@pytest.mark.parametrize("dtype", list(CONFIGS))
def test_adamw_state_follows_optax_defaults(dtype):
    """b1 0.9, b2 0.999, eps 1e-8, decay 1e-4 on every leaf; moments in the
    parameter's dtype, norm weights fp32."""
    init_fn, step_fn, _ = build_llama_train_step(_twin(CONFIGS[dtype]), device="cpu")
    tparams, opt = init_fn(0)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)
    assert len(group["params"]) == len(param_leaves(tparams))
    tparams, opt, _ = step_fn(tparams, opt, torch.zeros(1, 16, dtype=torch.int64))
    for t in param_leaves(tparams):
        assert opt.state[t]["exp_avg"].dtype == t.dtype == opt.state[t]["exp_avg_sq"].dtype
    assert tparams["layers"][0]["attn_norm"].dtype == torch.float32
    assert tparams["final_norm"].dtype == torch.float32


def test_decay_applies_to_norms_and_embedding():
    """optax.adamw has no mask: a leaf with a zero gradient still shrinks by
    lr * 1e-4 of itself."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype="float32")
    init_fn, step_fn, _ = build_llama_train_step(cfg, learning_rate=1e-1, device="cpu")
    params, opt = init_fn(0)
    unused = params["embed"][255].detach().clone()  # token 255 is not in the batch
    norm = params["final_norm"].detach().clone()
    params, opt, _ = step_fn(params, opt, torch.zeros(1, 16, dtype=torch.int64))
    torch.testing.assert_close(params["embed"][255].detach(), unused * (1 - 1e-1 * 1e-4))
    assert not torch.equal(params["final_norm"].detach(), norm)


def test_step_returns_a_0d_loss_and_updates_in_place():
    cfg = tllama.LlamaConfig.tiny()
    init_fn, step_fn, batch_fn = build_llama_train_step(cfg, device="cpu")
    tokens = torch.ones(2, 16, dtype=torch.int64)
    assert torch.equal(batch_fn(tokens), tokens)  # one device: the whole batch
    params, opt = init_fn(3)
    wq = params["layers"][0]["wq"]
    before = wq.detach().clone()
    out_params, out_opt, loss = step_fn(params, opt, torch.ones(2, 16, dtype=torch.int64))
    assert out_params is params and out_opt is opt
    assert loss.shape == () and not loss.requires_grad and bool(torch.isfinite(loss))
    assert out_params["layers"][0]["wq"] is wq and not torch.equal(wq.detach(), before)
    assert all(t.grad is None for t in param_leaves(params))


# (kwargs, exception, message): each raised as the JAX package raises it
BAD_ARGS = {
    "sp_attention_unknown": (dict(sp_attention="bogus"), ValueError, None),
    "both_spellings": (dict(sp_attention="none", use_ring_attention=True),
                       ValueError, None),
    "ulysses": (dict(sp_attention="ulysses", use_ring_attention=False), ValueError, None),
}


@pytest.mark.parametrize("bad", list(BAD_ARGS))
def test_train_step_refusals(bad):
    kwargs, exc, match = BAD_ARGS[bad]
    with pytest.raises(exc, match=match) as terr:
        build_llama_train_step(tllama.LlamaConfig.tiny(), device="cpu", **kwargs)
    if exc is ValueError:
        mesh = make_mesh({}, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as jerr:
            jax_build(jllama.LlamaConfig.tiny(), mesh, **kwargs)
        assert str(terr.value) == str(jerr.value)


# what the one-device step refused before the mesh and Ulysses were ported:
# a one-device mesh, and ring or Ulysses attention over sp=1 are the
# one-device step, to the bit
ONE_DEVICE_SPELLINGS = {"mesh": dict(mesh="one_device"), "ring": dict(sp_attention="ring"),
                        "use_ring_attention": dict(use_ring_attention=True),
                        "ulysses": dict(sp_attention="ulysses")}


@pytest.mark.parametrize("spelling", list(ONE_DEVICE_SPELLINGS))
def test_one_device_mesh_and_ring_are_the_one_device_step(spelling):
    kwargs = dict(ONE_DEVICE_SPELLINGS[spelling])
    if kwargs.get("mesh") == "one_device":
        kwargs["mesh"] = one_device_mesh("cpu")
    cfg = tllama.LlamaConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 32)))
    losses = []
    for kw in ({}, kwargs):
        init_fn, step_fn, _ = build_llama_train_step(cfg, device="cpu", **kw)
        params, opt = init_fn(0)
        losses.append([float(step_fn(params, opt, tokens)[2]) for _ in range(2)])
    assert losses[0] == losses[1]


def test_sp_attention_none_is_the_single_device_step():
    for kwargs in (dict(sp_attention="none"), dict(use_ring_attention=False)):
        build_llama_train_step(tllama.LlamaConfig.tiny(), device="cpu", **kwargs)


def test_init_opt_state_refuses_views():
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_llama(cfg, device="cpu")
    stacked = torch.stack([params["layers"][0]["wq"], params["layers"][1]["wq"]])
    params["layers"][0]["wq"] = stacked[0]
    with pytest.raises(ValueError, match="own its storage"):
        init_opt_state(params)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def tiny_f32():
    jcfg = CONFIGS["float32"]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(2))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 48))
    return jcfg, jparams, tokens


def test_loss_gradient_with_remat_matches_jax(tiny_f32):
    """jax.value_and_grad of llama_loss(remat=True) against the port's
    backward through checkpointed layers, every leaf (measured ~1e-8)."""
    jcfg, jparams, tokens = tiny_f32
    want_loss, want = jax.value_and_grad(jllama.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg, remat=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg),
                              device="cpu")
    leaves = param_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss = tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    want = jax.tree.map(np.asarray, want)
    np.testing.assert_allclose(_np(tparams["embed"].grad), want["embed"], atol=1e-6)
    np.testing.assert_allclose(_np(tparams["lm_head"].grad), want["lm_head"], atol=1e-6)
    for i, layer in enumerate(tparams["layers"]):
        for name, t in layer.items():
            np.testing.assert_allclose(_np(t.grad), want["layers"][name][i],
                                       atol=1e-6, err_msg=f"layers.{i}.{name}")


def test_remat_changes_no_gradient(tiny_f32):
    jcfg, jparams, tokens = tiny_f32
    grads = []
    for remat in (False, True):
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg),
                                  device="cpu")
        leaves = param_leaves(tparams)
        for t in leaves:
            t.requires_grad_(True)
        tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg),
                          remat=remat).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_forward_aux_and_moe_part_mirror_jax(tiny_f32):
    jcfg, jparams, tokens = tiny_f32
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg),
                              device="cpu")
    toks = torch.from_numpy(tokens)
    logits, aux = tllama.llama_forward(tparams, toks, _twin(jcfg), return_aux=True)
    _, jaux = jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg, return_aux=True)
    assert aux == float(jaux) == 0.0
    assert torch.equal(logits, tllama.llama_forward(tparams, toks, _twin(jcfg)))
    # the hook is given the table and its lookup, as the JAX package's is;
    # the identity hook changes nothing
    roles = []
    part = lambda t, role: roles.append(role) or t  # noqa: E731
    assert torch.equal(logits, tllama.llama_forward(tparams, toks, _twin(jcfg),
                                                    moe_part=part))
    assert roles == ["table", "combine"]
    assert torch.equal(tllama.llama_loss(tparams, toks, _twin(jcfg), moe_part=part),
                       tllama.llama_loss(tparams, toks, _twin(jcfg)))
