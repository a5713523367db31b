"""The PyTorch port's MoE FFN (yoda_scheduler_tpu_torch/models/moe.py) and the
MoE model through the port's forward, gradient, train step and KV-cache
serving, against the JAX package's on the same weights and inputs.

JAX weights come across through `params_from_jax`; inputs are made with
numpy from a seed. The JAX side's attention is its Pallas kernel in
interpret mode."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.models import moe as jmoe
from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
from yoda_scheduler_tpu.parallel import make_mesh
from yoda_scheduler_tpu_torch.models import llama as tllama
from yoda_scheduler_tpu_torch.models import moe as tmoe
from yoda_scheduler_tpu_torch.models import params_from_jax
from yoda_scheduler_tpu_torch.models.convert import _tensor
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step,
                                               init_opt_state, param_leaves)

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

jgen = importlib.import_module("yoda_scheduler_tpu.models.generate")
tgen = importlib.import_module("yoda_scheduler_tpu_torch.models.generate")

MOE = {"float32": dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32"),
       "bfloat16": jllama.LlamaConfig.tiny_moe()}
CPU = torch.device("cpu")


def _twin(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_params(jparams, jcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), _twin(jcfg),
                           device="cpu")


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("seq_len", [1, 48, 512, 2048])
@pytest.mark.parametrize("num_experts", [4, 8])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_expert_capacity_matches_jax(seq_len, num_experts, k, capacity_factor):
    got = tmoe.expert_capacity(seq_len, num_experts, k, capacity_factor)
    assert got == jmoe.expert_capacity(seq_len, num_experts, k, capacity_factor)
    assert got % 8 == 0 and got >= 8


def test_expert_capacity_at_the_mixtral_shapes():
    """8 experts, top-2, factor 1.25: prefill of 4 x 512, decode, S=2048."""
    assert [tmoe.expert_capacity(s, 8, 2, 1.25) for s in (512, 1, 2048)] == [168, 8, 648]


def _logits(case):
    """[B=2, S=40, E=4] fp32 router logits for each routing trap."""
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((2, 40, 4)).astype(np.float32)
    if case == "random":      # softmax over all experts, then top-k
        return noise
    if case == "zero":        # uniform probabilities: ties go to experts 0, 1
        return np.zeros((2, 40, 4), np.float32)
    if case == "overflow":    # expert 0 over capacity: drops after renormalising
        return noise * 0.1 + np.array([5.0, 1.0, 0.0, -1.0], np.float32)
    if case == "skewed":      # expert 0 first for most tokens, second for
        # others: slot-major queues per row decide who drops
        return noise + np.array([1.5, 1.0, 0.0, 0.0], np.float32)
    if case == "first_over":  # every first choice is expert 0 (40 > C=32),
        # the second choices spread over experts 1-3 and are all kept
        return noise * 0.5 + np.array([3.0, 0.0, 0.0, 0.0], np.float32)
    if case == "underflow":   # second choice's probability is 0 in fp32
        out = np.tile(np.array([0.0, -200.0, -300.0, -400.0], np.float32), (2, 40, 1))
        out[:, ::3] = out[:, ::3, ::-1]  # a third of the tokens prefer expert 3
        return out
    raise ValueError(case)


def _dense(expert, position, weight, capacity, num_experts):
    """The port's index form as the JAX package's combine [B, S, E, C]."""
    b, s, k = expert.shape
    combine = np.zeros((b, s, num_experts, capacity), np.float32)
    bi, si, ji = np.nonzero(weight.numpy() > 0)
    combine[bi, si, expert.numpy()[bi, si, ji], position.numpy()[bi, si, ji]] = \
        weight.numpy()[bi, si, ji]
    return combine


@pytest.mark.parametrize("case", ["random", "zero", "overflow", "skewed", "first_over",
                                  "underflow"])
def test_top_k_dispatch_matches_jax(case):
    """Dispatch (which token sits in which expert slot) is equal; combine
    weights agree to fp32 rounding of the two softmaxes (measured <= 6e-8);
    aux to 1e-6 relative."""
    logits = _logits(case)
    e, k = 4, 2
    cap = jmoe.expert_capacity(logits.shape[1], e, k, 1.25)
    jcombine, jdispatch, jaux = jmoe._top_k_dispatch(jnp.asarray(logits), e, k, cap)
    expert, position, weight, aux = tmoe._top_k_dispatch(torch.from_numpy(logits), e, k, cap)
    combine = _dense(expert, position, weight, cap, e)
    np.testing.assert_array_equal(combine > 0, np.asarray(jdispatch))
    np.testing.assert_allclose(combine, np.asarray(jcombine), atol=1e-6, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    if case == "zero":
        assert (expert.numpy() == [0, 1]).all()
    if case in ("overflow", "skewed", "first_over"):
        assert (weight.numpy() == 0).any()  # the trap is exercised: drops
    if case == "underflow":
        assert (weight.numpy()[..., 1] == 0).all() and (weight.numpy()[..., 0] == 1).all()


def test_renormalised_before_the_capacity_drop():
    """A dropped first choice leaves its partner's weight as it was,
    p2 / (p1 + p2), not 1."""
    logits = torch.from_numpy(_logits("first_over"))
    cap = tmoe.expert_capacity(40, 4, 2, 1.25)
    expert, position, weight, _ = tmoe._top_k_dispatch(logits, 4, 2, cap)
    p = torch.softmax(logits, -1).gather(-1, expert)
    dropped = (position[..., 0] >= cap) & (position[..., 1] < cap)
    assert dropped.any()
    want = (p[..., 1] / p.sum(-1))[dropped]
    torch.testing.assert_close(weight[..., 1][dropped], want, rtol=1e-6, atol=0)


def test_aux_loss_gradient_reaches_the_logits_through_probs_only():
    """The first-choice fraction carries no gradient: d aux / d logits is
    the gradient of E * sum_e f_e * mean_p_e with f_e held fixed."""
    logits = torch.from_numpy(_logits("random")).requires_grad_(True)
    _, _, _, aux = tmoe._top_k_dispatch(logits, 4, 2, 32)
    (got,) = torch.autograd.grad(aux, logits)
    jgrad = jax.grad(lambda lg: jmoe._top_k_dispatch(lg, 4, 2, 32)[2])(
        jnp.asarray(_logits("random")))
    np.testing.assert_allclose(_np(got), np.asarray(jgrad), atol=1e-7, rtol=0)


# -------------------------------------------------------------------- FFN
def _layer(dtype):
    jlayer = jax.tree.map(lambda a: a[0], jmoe.init_moe_layer(
        jax.random.PRNGKey(0), 1, 128, 256, 4, jnp.dtype(dtype)))
    return jlayer, {n: _tensor(np.asarray(a), CPU) for n, a in jlayer.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype):
    """fp32: summation order (measured 3e-7); bf16: the output is one bf16
    rounding of equal fp32 sums, so it differs by an ulp at most where the
    sums differ in their last fp32 bits (measured rel. L2 1e-6)."""
    jlayer, layer = _layer(dtype)
    x = np.random.default_rng(0).standard_normal((2, 48, 128)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x).astype(dtype), jlayer, 4, 2, 1.25)
    y, aux = tmoe.moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)), layer, 4, 2, 1.25)
    assert y.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=0)
    else:
        rel = np.linalg.norm(_np(y) - _np(jy)) / np.linalg.norm(_np(jy))
        assert rel < 4e-3, rel


def test_moe_ffn_gradient_matches_jax():
    """fp32, every input: x, router, we_gate, we_up, we_down, to summation
    order (the router's gradient, up to ~12, measured 1.2e-6 relative)."""
    jlayer, layer = _layer("float32")
    x = np.random.default_rng(1).standard_normal((2, 48, 128)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((2, 48, 128)).astype(np.float32)

    def jloss(x, layer):
        y, aux = jmoe.moe_ffn(x, layer, 4, 2, 1.25)
        return jnp.sum(y * w) + aux

    jgx, jglayer = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jlayer)
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in layer.values():
        t.requires_grad_(True)
    y, aux = tmoe.moe_ffn(xt, layer, 4, 2, 1.25)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    for name, t in layer.items():
        np.testing.assert_allclose(_np(t.grad), np.asarray(jglayer[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_moe_ffn_gradient_bf16_departure_from_jax():
    """bf16: gate and up's backward products take the fp32 cotangent and
    round each product once, as JAX does (`_BmmF32`, `bmm_fp32_cotangent`).
    Before that repair the port rounded the cotangent to bf16 first, and the
    gradients of we_gate, we_up and x read rel. L2 2.6e-3 to 3.7e-3; now
    every leaf reads <= 1.7e-4 over four seeds (this seed: x 1.6e-4, we_gate
    8.5e-5, we_up 2.9e-5, we_down 5.8e-5, router 8.3e-5), what bf16
    roundings at other places in the two frameworks leave: bound 1e-3 on
    every leaf."""
    jlayer, layer = _layer("bfloat16")
    x = np.random.default_rng(1).standard_normal((2, 48, 128)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((2, 48, 128)).astype(np.float32)

    def jloss(x, layer):
        y, aux = jmoe.moe_ffn(x, layer, 4, 2, 1.25)
        return jnp.sum(y.astype(jnp.float32) * w) + aux

    jgx, jglayer = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16), jlayer)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    for t in layer.values():
        t.requires_grad_(True)
    y, aux = tmoe.moe_ffn(xt, layer, 4, 2, 1.25)
    (torch.sum(y.float() * torch.from_numpy(w)) + aux).backward()
    bounds = {"x": 1e-3, "we_gate": 1e-3, "we_up": 1e-3, "we_down": 1e-3, "router": 1e-3}
    for name, got, want in [("x", xt.grad, jgx)] + [
            (n, t.grad, jglayer[n]) for n, t in layer.items()]:
        assert got.dtype == (torch.float32 if name == "router" else torch.bfloat16)
        rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))
        assert rel < bounds[name], (name, rel)


def test_identity_part_changes_nothing():
    _, layer = _layer("float32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, 128))
                         .astype(np.float32))
    roles = []
    y, aux = tmoe.moe_ffn(x, layer, 4, 2, 1.25,
                          part=lambda t, role: roles.append(role) or t)
    y0, aux0 = tmoe.moe_ffn(x, layer, 4, 2, 1.25)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    # JAX's hook sees the expert output as "dispatch" again; the port's
    # moves data, so the way out of the experts is its own role
    assert roles == ["dispatch", "hidden", "expert_out", "combine"]


# ------------------------------------------------------------------ model
def test_init_llama_moe_leaves_mirror_jax():
    jcfg = MOE["bfloat16"]
    want = jax.eval_shape(lambda k: jllama.init_llama(jcfg, k), jax.random.PRNGKey(0))
    a = tllama.init_llama(_twin(jcfg), seed=5, device="cpu")
    b = tllama.init_llama(_twin(jcfg), seed=5, device="cpu")
    assert set(a["layers"][0]) == set(want["layers"])
    assert not {"w_gate", "w_up", "w_down"} & set(a["layers"][0])
    for i, layer in enumerate(a["layers"]):
        for name, t in layer.items():
            assert tuple(t.shape) == want["layers"][name].shape[1:], name
            assert str(t.dtype).split(".")[1] == str(want["layers"][name].dtype), name
            assert torch.equal(t, b["layers"][i][name])
    layer = a["layers"][0]
    assert layer["router"].dtype == torch.float32
    assert layer["router"].std().item() == pytest.approx(0.02, rel=0.1)
    assert layer["we_gate"].float().std().item() == pytest.approx(jcfg.dim ** -0.5, rel=0.05)
    assert layer["we_down"].float().std().item() == pytest.approx(jcfg.ffn_dim ** -0.5,
                                                                  rel=0.05)


@pytest.fixture(scope="module", params=list(MOE))
def moe_model(request):
    jcfg = MOE[request.param]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 48))
    return request.param, jcfg, jparams, _port_params(jparams, jcfg), tokens


def test_forward_logits_and_aux_match_jax(moe_model):
    """fp32: summation order (logits measured 4e-7 relative). bf16: against
    the JAX forward run op by op (jax.disable_jit), which rounds where the
    port rounds; under jit XLA's fusions round bf16 intermediates elsewhere,
    and that moves one token's near-tie routing choice of the 96 here
    (rel. L2 3.4e-2, one token 0.34 off). Against the eager run the logits'
    rel. L2 is 5.9e-3 (bound 2e-2, the dense bf16 test's)."""
    name, jcfg, jparams, tparams, tokens = moe_model
    with jax.disable_jit(name == "bfloat16"):
        want, jaux = jllama.llama_forward(jparams, jnp.asarray(tokens), jcfg,
                                          return_aux=True)
    got, aux = tllama.llama_forward(tparams, torch.from_numpy(tokens), _twin(jcfg),
                                    return_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # bf16: the router's input moves by bf16 roundings, its mean
    # probabilities by ~1e-5 (measured)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5 if name == "float32" else 1e-4)
    if name == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    else:
        rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))
        assert rel < 2e-2, rel


def test_loss_matches_jax(moe_model):
    """The loss adds moe_aux_weight * aux, as the JAX package's does."""
    name, jcfg, jparams, tparams, tokens = moe_model
    with jax.disable_jit(name == "bfloat16"):
        want = float(jllama.llama_loss(jparams, jnp.asarray(tokens), jcfg))
    got = float(tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg)))
    assert got == pytest.approx(want, rel=1e-5 if name == "float32" else 2e-2)


def test_loss_gradient_with_remat_matches_jax():
    """jax.value_and_grad of llama_loss(remat=True) against the port's
    backward through checkpointed layers, fp32, every leaf, the router
    included (measured <= 1e-7)."""
    jcfg = MOE["float32"]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(2))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 48))
    want_loss, want = jax.value_and_grad(jllama.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg, remat=True)
    tparams = _port_params(jparams, jcfg)
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    loss = tllama.llama_loss(tparams, torch.from_numpy(tokens), _twin(jcfg), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    want = jax.tree.map(np.asarray, want)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(_np(tparams[name].grad), want[name], atol=1e-6,
                                   err_msg=name)
    for i, layer in enumerate(tparams["layers"]):
        for name, t in layer.items():
            np.testing.assert_allclose(_np(t.grad), want["layers"][name][i],
                                       atol=1e-6, err_msg=f"layers.{i}.{name}")
    assert float(tparams["layers"][0]["router"].grad.abs().max()) > 0


def test_train_steps_match_jax():
    """4 steps of each framework from the same weights on one fixed batch,
    fp32 (in bf16 the jitted JAX step moves near-tie routing choices, see
    test_forward_logits_and_aux_match_jax). Losses agree to 1e-5 relative
    (the dense fp32 bound). Each leaf's rel. L2 within 2e-5 (measured <=
    6.1e-6) and each entry within 2 lr: AdamW's first step moves an entry by
    lr g / (|g| + eps), so an entry whose gradient is at rounding level (|g|
    ~ eps) moves by up to lr either way in either framework (one lm_head
    entry of 32768 differs by 9.7e-5, every other by <= 1.2e-5)."""
    jcfg = MOE["float32"]
    mesh = make_mesh({}, devices=jax.devices()[:1])
    init_fn, step_fn, _ = jax_build(jcfg, mesh)
    jparams, jopt = init_fn(jax.random.PRNGKey(0))
    tparams = _port_params(jparams, jcfg)
    _, tstep, _ = build_llama_train_step(_twin(jcfg), device="cpu")
    topt = init_opt_state(tparams, 3e-4)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 64))
    jlosses, tlosses = [], []
    for _ in range(4):
        jparams, jopt, jloss = step_fn(jparams, jopt, jnp.asarray(tokens, jnp.int32))
        tparams, topt, tloss = tstep(tparams, topt, torch.from_numpy(tokens))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    assert all(b < a for a, b in zip(tlosses, tlosses[1:]))
    jparams = jax.tree.map(np.asarray, jparams)
    pairs = [(f"layers.{i}.{n}", t, jparams["layers"][n][i])
             for i, layer in enumerate(tparams["layers"]) for n, t in layer.items()]
    pairs += [(n, tparams[n], jparams[n]) for n in ("embed", "final_norm", "lm_head")]
    for name, t, want in pairs:
        assert t.dtype == getattr(torch, str(want.dtype)), name
        err = _np(t) - want
        assert np.linalg.norm(err) / np.linalg.norm(want) < 2e-5, name
        assert np.abs(err).max() <= 2 * 3e-4, name


def test_moe_train_step_router_stays_fp32():
    cfg = _twin(MOE["bfloat16"])
    init_fn, step_fn, _ = build_llama_train_step(cfg, device="cpu")
    params, opt = init_fn(0)
    assert len(opt.param_groups[0]["params"]) == len(param_leaves(params))
    params, opt, loss = step_fn(params, opt, torch.zeros(1, 16, dtype=torch.int64))
    router = params["layers"][0]["router"]
    assert router.dtype == torch.float32
    assert opt.state[router]["exp_avg"].dtype == torch.float32
    assert params["layers"][0]["we_gate"].dtype == torch.bfloat16
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------- serving
# fp32 models, so that bf16 near-ties cannot flip a greedy argmax or a
# routing choice between the frameworks; prompt 16 + 10 new tokens; the
# rolling model's window 8 < 26 folds the prefill into a ring of 8 slots
SERVE = {"linear": MOE["float32"],
         "rolling": dataclasses.replace(MOE["float32"], sliding_window=8)}


@pytest.mark.parametrize("cache", list(SERVE))
def test_greedy_tokens_equal_jax(cache):
    jcfg = SERVE[cache]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, 10, eager=True))
    got = tgen.generate(_port_params(jparams, jcfg), torch.from_numpy(prompt),
                        _twin(jcfg), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_and_decode_logits_match_jax():
    """Prefill (capacity from S=16) and three decode steps (capacity 8 from
    S=1) against the JAX package's, fp32: summation order."""
    jcfg = MOE["float32"]
    jparams = jllama.init_llama(jcfg, jax.random.PRNGKey(0))
    tparams = _port_params(jparams, jcfg)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    jcache = jgen.KVCache.zeros(jcfg, 2, 24)
    tcache = tgen.KVCache.zeros(_twin(jcfg), 2, 24, device="cpu")
    jl, jcache = jgen.prefill(jparams, jnp.asarray(prompt), jcache, jcfg)
    tl, tcache = tgen.prefill(tparams, torch.from_numpy(prompt), tcache, _twin(jcfg))
    for _ in range(3):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
        tok = np.array(jnp.argmax(jl, axis=-1))
        jl, jcache = jgen.decode_step(jparams, jnp.asarray(tok), jcache, jcfg)
        tl, tcache = tgen.decode_step(tparams, torch.from_numpy(tok), tcache, _twin(jcfg))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
