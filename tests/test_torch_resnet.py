"""The port's ResNet (yoda_scheduler_tpu_torch/models/resnet.py) against the
JAX package's Flax model on the same weights (`resnet_params_from_jax`) and
the same NHWC batch from a seed, at (2, 64, 64, 3), 10 classes: logits and
the updated batch_stats in train mode, logits in eval mode, and the
gradient of a softmax cross-entropy.

Most cases run the cheap ResNet(stage_sizes=(1, 1, 1, 1)) with its
BatchNorm scales, biases and running statistics drawn at random, so that
every conv reaches the output (Flax starts each block's last scale at
zero). Train mode at this size is ill-conditioned at depth: stage 4's
BatchNorm normalises 2 x 2 x 2 = 8 values a channel. With random scales a
1e-7 relative change of the input moves the Flax ResNet-50's own logits by
1.4e-4 (and jit against eager by 7.3e-5), so the one full ResNet-50 case
and the bf16 cases take Flax's init as it is. Each JAX function is
compiled once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yoda_scheduler_tpu.models.resnet import ResNet as JaxResNet
from yoda_scheduler_tpu_torch.models import resnet, resnet_forward_fn, resnet_params_from_jax

torch.set_num_threads(1)

SHAPE, CLASSES, SMALL = (2, 64, 64, 3), 10, (1, 1, 1, 1)
# fp32: summation order only (observed: small model logits 1.1e-5, eval
# 8.7e-7, stats 2.3e-6; ResNet-50 2.6e-6 and 5.3e-6)
LOGITS_FP32, STATS_FP32 = 1e-4, 1e-5
# bf16: conv outputs rounded to bf16 in another order flip roundings that
# the BatchNorms carry on; Flax's jit against its own eager run reads
# 1.2e-2 (logits) and 1.0e-2 (stats) here, the port 1.2e-2 and 1.0e-2
BF16 = 2e-2
GRAD_FP32 = 1e-4  # every leaf; observed 2.4e-5 (blocks.2.bn2.scale)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _randomised(variables, rng):
    """Flax variables with every BatchNorm leaf drawn at random."""
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s), "bias": lambda s: rng.normal(0, 0.1, s),
            "mean": lambda s: rng.normal(0, 0.1, s), "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def one(path, a):
        name = path[-1].key
        return draw[name](a.shape).astype(np.float32) if name in draw else np.asarray(a)

    return jax.tree_util.tree_map_with_path(one, jax.tree.map(np.asarray, variables))


def _flax_case(stages, dtype, randomise: bool, grad: bool = False) -> dict:
    """The Flax model's variables, batch and outputs (numpy)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    labels = rng.integers(0, CLASSES, SHAPE[0])
    model = JaxResNet(stage_sizes=stages, num_classes=CLASSES, dtype=dtype)
    xj = jnp.asarray(x, dtype)
    variables = model.init(jax.random.PRNGKey(1), xj, train=False)
    variables = (_randomised(variables, rng) if randomise
                 else jax.tree.map(np.asarray, variables))
    logits, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, xj)
    case = {"stages": stages, "variables": variables, "x": np.asarray(xj.astype(jnp.float32)),
            "labels": labels, "logits": np.asarray(logits),
            "stats": jax.tree.map(np.asarray, mutated["batch_stats"]),
            "eval": np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
                variables, xj))}
    if grad:
        def loss(params, stats, x):
            out, _ = model.apply({"params": params, "batch_stats": stats}, x, train=True,
                                 mutable=["batch_stats"])
            logp = jax.nn.log_softmax(out)
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

        g = jax.jit(jax.grad(loss))(variables["params"], variables["batch_stats"], xj)
        case["grads"] = jax.tree.map(np.asarray, g)
    return case


@pytest.fixture(scope="module")
def small_fp32():
    return _flax_case(SMALL, jnp.float32, randomise=True, grad=True)


@pytest.fixture(scope="module")
def small_bf16():
    return _flax_case(SMALL, jnp.bfloat16, randomise=False)


def _port(case, dtype, train: bool = True, grad: bool = False):
    """The port on the case's weights and batch: (logits, stats or None,
    grads or None), stats and grads keyed by the port's names."""
    model = resnet.ResNet(case["stages"], CLASSES, dtype, device="cpu")
    _, apply_fn = resnet_forward_fn(model=model)
    v = resnet_params_from_jax(case["variables"]["params"],
                               case["variables"]["batch_stats"], device="cpu")
    x = torch.from_numpy(np.array(case["x"])).to(dtype)
    for p in v["params"].values():
        p.requires_grad_(grad)
    if not train:
        with torch.no_grad():
            return apply_fn(v, x, train=False), None, None
    logits, mutated = apply_fn(v, x, train=True)
    grads = None
    if grad:
        F.cross_entropy(logits, torch.from_numpy(case["labels"])).backward()
        grads = {n: p.grad for n, p in v["params"].items()}
    return logits.detach(), mutated["batch_stats"], grads


def _flax_named(case, key: str) -> dict:
    """A Flax collection of the case under the port's names."""
    params = case["variables"]["params"] if key == "stats" else case[key]
    stats = case["stats"] if key == "stats" else case["variables"]["batch_stats"]
    out = resnet_params_from_jax(params, stats, device="cpu")
    return out["batch_stats" if key == "stats" else "params"]


def _stats_err(case, stats) -> float:
    want = _flax_named(case, "stats")
    assert sorted(want) == sorted(stats)
    return max(rel_l2(stats[n], want[n]) for n in want)


def test_small_fp32_train_logits_and_stats_match_flax(small_fp32):
    logits, stats, _ = _port(small_fp32, torch.float32)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, CLASSES)
    assert rel_l2(logits, small_fp32["logits"]) < LOGITS_FP32
    assert _stats_err(small_fp32, stats) < STATS_FP32


def test_small_fp32_eval_logits_match_flax(small_fp32):
    logits, _, _ = _port(small_fp32, torch.float32, train=False)
    assert rel_l2(logits, small_fp32["eval"]) < LOGITS_FP32


def test_small_fp32_gradient_matches_flax(small_fp32):
    """The BatchNorm's recomputing backward gives autograd's gradient of
    Flax's formula: every leaf within rel. L2 1e-4."""
    _, _, grads = _port(small_fp32, torch.float32, grad=True)
    want = _flax_named(small_fp32, "grads")
    assert sorted(want) == sorted(grads)
    errs = {n: rel_l2(grads[n], want[n]) for n in want}
    assert max(errs.values()) < GRAD_FP32, errs


@pytest.mark.parametrize("train", [True, False])
def test_small_bf16_matches_flax(small_bf16, train):
    logits, stats, _ = _port(small_bf16, torch.bfloat16, train=train)
    assert logits.dtype == torch.float32
    assert rel_l2(logits, small_bf16["logits" if train else "eval"]) < BF16
    if train:
        assert _stats_err(small_bf16, stats) < BF16


def test_resnet50_fp32_matches_flax():
    """The full ResNet-50 (Flax's init): every Flax leaf lands on a port
    parameter or buffer and back, and train-mode logits and stats agree."""
    case = _flax_case((3, 4, 6, 3), jnp.float32, randomise=False)
    model = resnet.ResNet50(CLASSES, torch.float32, device="cpu")
    v = resnet_params_from_jax(case["variables"]["params"],
                               case["variables"]["batch_stats"], device="cpu")
    assert sorted(v["params"]) == sorted(n for n, _ in model.named_parameters())
    assert sorted(v["batch_stats"]) == sorted(n for n, _ in model.named_buffers())
    assert all(v["params"][n].shape == p.shape for n, p in model.named_parameters())
    logits, stats, _ = _port(case, torch.float32)
    assert rel_l2(logits, case["logits"]) < LOGITS_FP32
    assert _stats_err(case, stats) < STATS_FP32


def _torch_batch_norm(self, x, train=True, relu=False):
    """torch's own batch norm: the running variance updated unbiased."""
    y = F.batch_norm(x.float(), self.mean, self.var, self.scale, self.bias, training=train,
                     momentum=1 - self.momentum, eps=resnet.BN_EPS)
    return y.relu() if relu else y


FAULTS = {
    "symmetric_padding": lambda mp: mp.setattr(
        resnet, "same_pads", lambda size, k, s: ((k - 1) // 2, (k - 1) // 2)),
    "unbiased_running_var": lambda mp: mp.setattr(resnet.BatchNorm, "forward",
                                                  _torch_batch_norm),
    "stem_momentum_torch_0.1": lambda mp: mp.setattr(resnet, "STEM_MOMENTUM", 0.9),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_breaks_a_bound(small_fp32, monkeypatch, fault):
    """Each parity trap, planted in the port, breaks the logits bound or the
    stats bound of test_small_fp32_train_logits_and_stats_match_flax
    (observed: symmetric padding 0.76 and 0.35; the unbiased running
    variance 9.9e-6 and 1.2e-2; the stem at momentum 0.9 1.1e-5 and
    9.0e-2)."""
    FAULTS[fault](monkeypatch)
    logits, stats, _ = _port(small_fp32, torch.float32)
    logits_err = rel_l2(logits, small_fp32["logits"])
    stats_err = _stats_err(small_fp32, stats)
    assert logits_err > LOGITS_FP32 or stats_err > STATS_FP32, (logits_err, stats_err)


@pytest.mark.parametrize("size,kernel,stride", [(224, 7, 2), (56, 3, 2), (56, 1, 2),
                                                (56, 3, 1), (7, 3, 2), (112, 3, 2)])
def test_same_pads_are_lax_same(size, kernel, stride):
    assert resnet.same_pads(size, kernel, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0])


def test_forward_fn_shapes_and_functional_stats():
    """The JAX package's TestResNet on the port's own init: fp32 logits,
    batch_stats returned in train mode (the given variables untouched)."""
    init_fn, apply_fn = resnet_forward_fn(
        model=resnet.ResNet(SMALL, CLASSES, device="cpu"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(SHAPE).astype(
        np.float32)).to(torch.bfloat16)
    variables = init_fn(1, x)
    before = {n: t.clone() for n, t in variables["batch_stats"].items()}
    logits, mutated = apply_fn(variables, x, train=True)
    assert tuple(logits.shape) == (2, CLASSES) and logits.dtype == torch.float32
    assert "batch_stats" in mutated
    assert all(torch.equal(before[n], variables["batch_stats"][n]) for n in before)
    assert any(not torch.equal(before[n], mutated["batch_stats"][n]) for n in before)
    assert tuple(apply_fn(variables, x, train=False).shape) == (2, CLASSES)
    with pytest.raises(ValueError, match="channels"):
        init_fn(0, x[..., :1])
