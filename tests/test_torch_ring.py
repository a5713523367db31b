"""The port's ring attention (yoda_scheduler_tpu_torch/parallel/ring.py)
against the JAX package's `ring_attention` on the 8 virtual CPU devices of
tests/conftest.py, output and gradients, fp32. The port's ring runs in one
process through the emulated rotation (each rank's body reading a list of
the sequence chunks), and at world 2 through the process-group rotation
(two spawned ranks, gloo, tests/torch_ranks.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from yoda_scheduler_tpu.ops import reference_attention
from yoda_scheduler_tpu.parallel import make_mesh, ring_attention
from yoda_scheduler_tpu_torch.ops import attention as tattn
from yoda_scheduler_tpu_torch.parallel import ring as tring
from yoda_scheduler_tpu_torch.parallel.launch import run_ranks

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape, dtype=np.float32)
    k = rng.standard_normal(kv_shape, dtype=np.float32)
    v = rng.standard_normal(kv_shape, dtype=np.float32)
    w = rng.standard_normal(q_shape, dtype=np.float32)
    return q, k, v, w


def _jax_ring(mesh_shape, q, k, v, w):
    """JAX ring_attention on the mesh: out, and the gradients of
    sum(out * w) with respect to q, k, v."""
    mesh = make_mesh(mesh_shape)

    def loss(q, k, v):
        return jnp.sum(ring_attention(q, k, v, mesh) * w)

    out = jax.jit(lambda q, k, v: ring_attention(q, k, v, mesh))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(a) for a in (out, *grads)]


def _port_ring(q, k, v, w, sp, tp=1):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tring.ring_attention_emulated(*ts, sp=sp, tp=tp)
    (out * torch.from_numpy(w)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


# (mesh, q shape, kv shape, sp, tp): the JAX package's own ring tests'
# shapes (tests/test_models_parallel.py)
CASES = {
    "mha_sp4_dp2": ({"sp": 4, "dp": 2}, (2, 4, 256, 32), (2, 4, 256, 32), 4, 1),
    "mha_sp4_grad": ({"sp": 4}, (1, 2, 128, 32), (1, 2, 128, 32), 4, 1),
    "gqa_sp4": ({"sp": 4}, (1, 4, 128, 32), (1, 2, 128, 32), 4, 1),
    "gqa_broadcast_tp4": ({"sp": 2, "tp": 4}, (1, 8, 64, 32), (1, 2, 64, 32), 2, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_output_and_gradients(case):
    """fp32, summation order only (the JAX package's own bounds against the
    whole-sequence reference: 2e-5 on the output, 5e-5 on gradients)."""
    mesh_shape, q_shape, kv_shape, sp, tp = CASES[case]
    q, k, v, w = _inputs(0, q_shape, kv_shape)
    want = _jax_ring(mesh_shape, q, k, v, w)
    got = _port_ring(q, k, v, w, sp, tp)
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (2e-5, 5e-5, 5e-5, 5e-5)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


def test_ring_matches_the_whole_sequence_reference():
    q, k, v, _ = _inputs(1, (1, 4, 256, 32), (1, 2, 256, 32))
    got = tring.ring_attention_emulated(*map(torch.from_numpy, (q, k, v)), sp=4)
    want = reference_attention(q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_ring_visits_each_visible_chunk_once(monkeypatch):
    """sp=4: 4 diagonal (causal) chunks and 6 full ones, 10 chunk calls; the
    6 chunks from a rank's future launch nothing."""
    calls = []
    orig = tring.flash_attention_with_lse

    def record(q, k, v, causal):
        calls.append(causal)
        return orig(q, k, v, causal=causal)

    monkeypatch.setattr(tring, "flash_attention_with_lse", record)
    q, k, v, _ = _inputs(2, (1, 2, 64, 32), (1, 2, 64, 32))
    tring.ring_attention_emulated(*map(torch.from_numpy, (q, k, v)), sp=4)
    assert sorted(calls) == [False] * 6 + [True] * 4


def test_ring_lse_cotangent_reaches_the_chunks(monkeypatch):
    """The merge is differentiated through each chunk's LSE: the chunks'
    backward gets a non-zero LSE cotangent (the kernels fold it into
    delta)."""
    seen = []
    orig = tattn.reference_attention_with_lse

    def record(q, k, v, causal=True, window=None):
        out, lse = orig(q, k, v, causal, window)
        if lse.requires_grad:
            lse.register_hook(lambda g: seen.append(float(g.abs().max())))
        return out, lse

    monkeypatch.setattr(tattn, "reference_attention_with_lse", record)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in _inputs(3, (1, 2, 64, 32), (1, 2, 64, 32))[:3]]
    tring.ring_attention_emulated(*ts, sp=2).sum().backward()
    assert len(seen) == 3 and max(seen) > 0


def test_ring_rejects_indivisible_seq():
    q, k, v, _ = _inputs(4, (1, 2, 101, 16), (1, 2, 101, 16))
    with pytest.raises(ValueError) as jerr:
        ring_attention(q, k, v, make_mesh({"sp": 4}))
    with pytest.raises(ValueError) as terr:
        tring.ring_attention_emulated(*map(torch.from_numpy, (q, k, v)), sp=4)
    assert str(terr.value) == str(jerr.value)


def test_ring_adapters_handle_gqa():
    assert tring.ring_attention.handles_gqa
    assert tring.ring_attention_emulated.handles_gqa
    assert tring.make_ring_attn(object()).handles_gqa


def test_process_group_ring_at_world_2_matches_jax(tmp_path):
    """Two spawned ranks (gloo), each holding half the sequence, the chunks
    and their gradients passed over the sp group: each rank's output and
    gradients are its half of the JAX ring's."""
    q, k, v, w = _inputs(5, (1, 4, 128, 32), (1, 2, 128, 32))
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, w=w)
    want = _jax_ring({"sp": 2}, q, k, v, w)
    run_ranks(torch_ranks.ring_rank, 2, device="cpu", args=(str(tmp_path),),
              timeout_s=300)
    for rank in range(2):
        got = np.load(tmp_path / f"ring_{rank}.npz")
        for name, b, tol in zip(("out", "dq", "dk", "dv"), want, (2e-5, 5e-5, 5e-5, 5e-5)):
            np.testing.assert_allclose(got[name], np.split(b, 2, axis=2)[rank],
                                       atol=tol, rtol=0, err_msg=f"rank {rank} {name}")
