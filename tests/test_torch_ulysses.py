"""The port's Ulysses attention (yoda_scheduler_tpu_torch/parallel/ulysses.py)
against the JAX package's `ulysses_attention` on the 8 virtual CPU devices
of tests/conftest.py, output and gradients, fp32, inputs from numpy seeds.
The port runs in one process through the emulated exchange (the sp chunks
in a list); the process-group exchange runs in the 8-rank train step of
tests/test_torch_sharded.py (leg `ulysses_dp2_fsdp2_sp2`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.parallel import make_mesh
from yoda_scheduler_tpu.parallel.ulysses import ulysses_attention
from yoda_scheduler_tpu_torch.parallel import mesh as tmesh
from yoda_scheduler_tpu_torch.parallel import ring as tring
from yoda_scheduler_tpu_torch.parallel import ulysses as tulysses

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32))


def _jax(mesh_shape, q, k, v):
    """JAX ulysses_attention: out, and the gradients of sum(out ** 2) (the
    JAX package's own test_grads_match_reference)."""
    mesh = make_mesh(mesh_shape)
    out = jax.jit(lambda q, k, v: ulysses_attention(q, k, v, mesh))(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ulysses_attention(q, k, v, mesh) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(a) for a in (out, *grads)]


def _port(q, k, v, sp, tp=1):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tulysses.ulysses_attention_emulated(*ts, sp=sp, tp=tp)
    (out ** 2).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


# (mesh, q shape, kv shape, sp, tp, output bound, gradient bound): the JAX
# package's test_ulysses.py shapes and bounds (fp32: the order of sums)
CASES = {
    "mha_dp2_sp2_tp2": ({"dp": 2, "sp": 2, "tp": 2}, (4, 8, 64, 16), (4, 8, 64, 16), 2, 2,
                        1e-5, 1e-4),
    # kvh 4 over sp 2: K/V travel at their own head count
    "gqa_native_sp2": ({"sp": 2}, (1, 8, 64, 32), (1, 4, 64, 32), 2, 1, 2e-5, 1e-4),
    # kvh 2 does not split over sp 4: repeated to full heads first
    "gqa_broadcast_sp4": ({"sp": 4}, (1, 8, 64, 32), (1, 2, 64, 32), 4, 1, 2e-5, 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ulysses_matches_jax_output_and_gradients(case):
    mesh_shape, q_shape, kv_shape, sp, tp, out_tol, grad_tol = CASES[case]
    q, k, v = _inputs(0, q_shape, kv_shape)
    want = _jax(mesh_shape, q, k, v)
    got = _port(q, k, v, sp, tp)
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (out_tol, grad_tol, grad_tol, grad_tol)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case,kv_heads,broadcast", [
    ("gqa_native_sp2", 4, False), ("gqa_broadcast_sp4", 2, True)])
def test_ulysses_grouped_kv_branch(case, kv_heads, broadcast, monkeypatch):
    """Each rank's local attention gets the whole sequence and H/sp query
    heads; k and v their native kv heads / sp, or H/sp when they were
    repeated to full heads (they do not split over sp)."""
    _, q_shape, kv_shape, sp, tp, _, _ = CASES[case]
    seen = []
    orig = tulysses._attend

    def record(q, k, v):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v)

    monkeypatch.setattr(tulysses, "_attend", record)
    tulysses.ulysses_attention_emulated(*map(torch.from_numpy, _inputs(1, q_shape, kv_shape)),
                                        sp=sp, tp=tp)
    b, h, s, d = q_shape
    kv_local = (h if broadcast else kv_heads) // sp
    assert seen == [((b, h // sp, s, d), (b, kv_local, s, d))] * sp


def test_ulysses_matches_the_ring():
    """The two sequence-parallel schemes on one input: sp=2, tp=2 (the JAX
    package's test_matches_ring), within 1e-4."""
    q, k, v = map(torch.from_numpy, _inputs(3, (4, 8, 64, 16), (4, 8, 64, 16)))
    u = tulysses.ulysses_attention_emulated(q, k, v, sp=2, tp=2)
    r = tring.ring_attention_emulated(q, k, v, sp=2, tp=2)
    np.testing.assert_allclose(u.numpy(), r.numpy(), atol=1e-4, rtol=0)


# (mesh, q shape, kv shape): each refusal of the JAX package, in its words
REFUSALS = {
    "seq": ({"sp": 4}, (1, 4, 101, 16), (1, 4, 101, 16)),
    "heads_by_tp": ({"sp": 2, "tp": 4}, (1, 6, 64, 16), (1, 6, 64, 16)),
    "local_heads_by_sp": ({"dp": 2, "sp": 2, "tp": 2}, (4, 2, 64, 16), (4, 2, 64, 16)),
    "q_heads_by_kv_heads": ({"sp": 2}, (1, 8, 64, 16), (1, 3, 64, 16)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_ulysses_refusals_match_jax(case):
    mesh_shape, q_shape, kv_shape = REFUSALS[case]
    q, k, v = _inputs(4, q_shape, kv_shape)
    with pytest.raises(ValueError) as jerr:
        ulysses_attention(q, k, v, make_mesh(mesh_shape))
    with pytest.raises(ValueError) as terr:
        tulysses.ulysses_attention_emulated(*map(torch.from_numpy, (q, k, v)),
                                            sp=mesh_shape["sp"], tp=mesh_shape.get("tp", 1))
    assert str(terr.value) == str(jerr.value)
    if case in ("local_heads_by_sp", "q_heads_by_kv_heads"):
        # the rank's spelling: its chunk of the sequence, its tp rank's heads
        # (the checks before any exchange, so a rank's view of the mesh does)
        tp, sp = mesh_shape.get("tp", 1), mesh_shape["sp"]
        rank_mesh = tmesh.Mesh(tmesh.rank_grid(mesh_shape, 8), torch.device("cpu"), rank=0)
        local = [torch.from_numpy(a[:, :a.shape[1] // tp, :a.shape[2] // sp])
                 for a in (q, k, v)]
        with pytest.raises(ValueError) as rerr:
            tulysses.ulysses_attention(*local, rank_mesh)
        assert str(rerr.value) == str(jerr.value)


def test_ulysses_over_sp_1_is_flash_attention():
    """A size-1 axis skips both exchanges: the model's own attention, to
    the bit."""
    q, k, v = map(torch.from_numpy, _inputs(5, (2, 4, 32, 16), (2, 2, 32, 16)))
    got = tulysses.ulysses_attention(q, k, v, tmesh.one_device_mesh("cpu"))
    assert torch.equal(got, tulysses.flash_attention(q, k, v, causal=True))


def test_ulysses_adapters_handle_gqa():
    assert tulysses.ulysses_attention.handles_gqa
    assert tulysses.ulysses_attention_emulated.handles_gqa
    assert tulysses.make_ulysses_attn(object()).handles_gqa
