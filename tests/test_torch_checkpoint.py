"""Checkpoint/resume of the port's train state (yoda_scheduler_tpu_torch/
parallel/checkpoint.py), the JAX package's tests/test_checkpoint.py on one
device: a round trip keeps every value, restoring with no checkpoint raises
FileNotFoundError, a non-increasing save raises, max_to_keep removes old
steps, and a resume continues bit-exact; the resumed run against the JAX
package's uninterrupted run from the same weights. The save on 8 ranks and
the restore onto another mesh ride the 8-rank spawn of
tests/test_torch_sharded.py (test_checkpoint_restores_onto_another_mesh)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.parallel import build_llama_train_step as jax_build
from yoda_scheduler_tpu.parallel import make_mesh as jax_mesh
from yoda_scheduler_tpu_torch.models import LlamaConfig, params_from_jax
from yoda_scheduler_tpu_torch.parallel import (TrainCheckpointer, build_llama_train_step,
                                               build_pipelined_llama_train_step,
                                               init_opt_state, param_leaves)

torch.set_num_threads(1)

CFG = LlamaConfig.tiny()


@pytest.fixture(scope="module")
def tokens():
    return torch.from_numpy(np.random.default_rng(5).integers(0, CFG.vocab_size, (8, 64)))


@pytest.fixture(scope="module")
def step_bits():
    return build_llama_train_step(CFG, device="cpu")


def _state_equal(a, b) -> bool:
    (pa, oa), (pb, ob) = a, b
    if not all(torch.equal(x, y) for x, y in zip(param_leaves(pa), param_leaves(pb))):
        return False
    for x, y in zip(param_leaves(pa), param_leaves(pb)):
        sx, sy = oa.state.get(x, {}), ob.state.get(y, {})
        if sorted(sx) != sorted(sy) or not all(torch.equal(sx[k], sy[k]) for k in sx):
            return False
    return True


class TestRoundTrip:
    def test_values_survive(self, tmp_path, step_bits, tokens):
        init_fn, step_fn, _ = step_bits
        params, opt = init_fn(0)
        params, opt, _ = step_fn(params, opt, tokens)
        with TrainCheckpointer(str(tmp_path / "ckpt"), device="cpu") as ckpt:
            ckpt.save(1, params, opt)
            fresh = init_fn(9)
            step, rp, ro = ckpt.restore(fresh)
        assert step == 1 and rp is fresh[0] and ro is fresh[1]
        assert _state_equal((params, opt), (rp, ro))
        # the template's optimizer steps the template's own tensors
        assert all(a is b for a, b in zip(ro.param_groups[0]["params"], param_leaves(rp)))
        assert rp["layers"][0]["wq"].dtype == torch.bfloat16

    def test_restore_without_checkpoint_raises(self, tmp_path, step_bits):
        init_fn, _, _ = step_bits
        with TrainCheckpointer(str(tmp_path / "empty"), device="cpu") as ckpt:
            with pytest.raises(FileNotFoundError):
                ckpt.restore(init_fn(0))

    def test_non_increasing_save_raises_not_silently_skips(self, tmp_path, step_bits):
        init_fn, _, _ = step_bits
        params, opt = init_fn(0)
        with TrainCheckpointer(str(tmp_path / "skip"), device="cpu") as ckpt:
            ckpt.save(3, params, opt)
            for step in (3, 2):
                with pytest.raises(ValueError, match="not saved"):
                    ckpt.save(step, params, opt)

    def test_max_to_keep_garbage_collects(self, tmp_path, step_bits):
        init_fn, _, _ = step_bits
        params, opt = init_fn(0)
        with TrainCheckpointer(str(tmp_path / "gc"), max_to_keep=2, device="cpu") as ckpt:
            for s in (1, 2, 3):
                ckpt.save(s, params, opt)
            assert ckpt.all_steps() == [2, 3]
            assert ckpt.latest_step() == 3
            assert sorted(p.name for p in (tmp_path / "gc").iterdir()) == ["2", "3"]

    def test_a_fresh_optimizer_restores_empty(self, tmp_path, step_bits):
        """Saved before any step: the restored AdamW starts from nothing, as
        the saved one would."""
        init_fn, _, _ = step_bits
        params, opt = init_fn(0)
        with TrainCheckpointer(str(tmp_path / "fresh"), device="cpu") as ckpt:
            ckpt.save(0, params, opt)
            _, rp, ro = ckpt.restore(init_fn(4))
        assert _state_equal((params, opt), (rp, ro)) and not ro.state

    def test_template_of_another_shape_raises(self, tmp_path, step_bits):
        init_fn, _, _ = step_bits
        with TrainCheckpointer(str(tmp_path / "shape"), device="cpu") as ckpt:
            ckpt.save(1, *init_fn(0))
            other = build_llama_train_step(LlamaConfig.tiny(vocab=512), device="cpu")[0]
            with pytest.raises(ValueError, match="whole"):
                ckpt.restore(other(0))

    @pytest.mark.parametrize("kind", ["moe", "pipelined"])
    def test_other_states_round_trip(self, tmp_path, tokens, kind):
        """The MoE state (expert-stacked leaves) and the pipelined step's
        (every stage in one process)."""
        if kind == "moe":
            init_fn, step_fn, _ = build_llama_train_step(LlamaConfig.tiny_moe(), device="cpu")
        else:
            init_fn, step_fn, _ = build_pipelined_llama_train_step(CFG, pp=2, device="cpu",
                                                                   num_microbatches=2)
        params, opt, _ = step_fn(*init_fn(0), tokens)
        with TrainCheckpointer(str(tmp_path / kind), device="cpu") as ckpt:
            ckpt.save(1, params, opt)
            _, rp, ro = ckpt.restore(init_fn(1))
        assert _state_equal((params, opt), (rp, ro))


class TestResume:
    def test_resume_is_bit_exact(self, tmp_path, step_bits, tokens):
        init_fn, step_fn, _ = step_bits
        with TrainCheckpointer(str(tmp_path / "resume"), device="cpu") as ckpt:
            # uninterrupted: 4 steps, checkpointing mid-run (the save must
            # finish before step_fn updates the tensors in place)
            params, opt = init_fn(0)
            for i in range(4):
                if i == 2:
                    ckpt.save(2, params, opt)
                params, opt, loss = step_fn(params, opt, tokens)
            want = float(loss)
            # "crash", restore at step 2 into a fresh process state, continue
            _, rp, ro = ckpt.restore(init_fn(3))
        for _ in range(2):
            rp, ro, loss = step_fn(rp, ro, tokens)
        assert float(loss) == want

    def test_resume_against_the_jax_run(self, tmp_path, tokens):
        """fp32, from the JAX init: the port saves after 2 steps, restores
        into its own fresh init and takes 2 more; its losses against the
        JAX package's 4 uninterrupted steps (test_torch_train's bound)."""
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
        cfg = dataclasses.replace(CFG, dtype="float32")
        init_j, step_j, _ = jax_build(jcfg, jax_mesh({}, devices=jax.devices()[:1]))
        jparams, jopt = init_j(jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, jparams)
        jtokens = jnp.asarray(tokens.numpy(), jnp.int32)
        want = []
        for _ in range(4):
            jparams, jopt, jloss = step_j(jparams, jopt, jtokens)
            want.append(float(jloss))

        init_fn, step_fn, _ = build_llama_train_step(cfg, device="cpu")
        params = params_from_jax(start, cfg, device="cpu")
        opt = init_opt_state(params)
        got = []
        with TrainCheckpointer(str(tmp_path / "jax"), device="cpu") as ckpt:
            for _ in range(2):
                params, opt, loss = step_fn(params, opt, tokens)
                got.append(float(loss))
            ckpt.save(2, params, opt)
            _, params, opt = ckpt.restore(init_fn(7))
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, tokens)
            got.append(float(loss))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_restore_onto_another_device_raises(tmp_path, step_bits):
    """The template's tensors must lie on the checkpointer's device: no
    silent move."""
    init_fn, _, _ = step_bits
    ckpt = TrainCheckpointer(str(tmp_path / "dev"), device="cpu")
    ckpt.save(1, *init_fn(0))
    ckpt.mesh.device = torch.device("meta")
    with pytest.raises(ValueError, match="is on cpu"):
        ckpt.restore(init_fn(1))
