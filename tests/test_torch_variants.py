"""`ops/variants.tile_rel_l2`, the per-tile bound that the backward kernels'
card checks use, on the CPU: it finds one wrong tile that an elementwise
bound and the whole tensor's relative error let through."""

import numpy as np
import pytest
import torch

from yoda_scheduler_tpu_torch.ops.variants import BWD_TILE_REL_L2, tile_rel_l2


def _late_keys_small(s=2048, seed=0):
    """[1, 2, s, 128] values whose size falls along the sequence as the dK
    and dV of a causal backward on normal inputs do (their spread at key j
    goes as sqrt(1/j - 1/s))."""
    rng = np.random.default_rng(seed)
    j = np.arange(1, s + 1)
    x = rng.standard_normal((1, 2, s, 128)) * np.sqrt(1 / j - 1 / (s + 1))[:, None]
    return torch.from_numpy((0.6 * x).astype(np.float32))


@pytest.mark.parametrize("s", [2048, 1100])
def test_one_late_tile_a_fifth_wrong_is_found(s):
    ref = _late_keys_small(s)
    got = ref.clone()
    got[0, 1, -64:] *= 0.8
    assert torch.allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert float((got - ref).norm() / ref.norm()) < BWD_TILE_REL_L2
    assert tile_rel_l2(got, ref) == pytest.approx(0.2, rel=1e-4)


def test_rounding_noise_reads_far_below_the_bound():
    ref = _late_keys_small()
    got = ref.to(torch.bfloat16)
    assert tile_rel_l2(got, ref) < BWD_TILE_REL_L2 / 2


def test_a_zero_tile_reads_zero_only_if_both_are_zero():
    ref = _late_keys_small(256)
    ref[0, 0, 64:128] = 0
    assert tile_rel_l2(ref.clone(), ref) == 0.0
    got = ref.clone()
    got[0, 0, 100, 5] = 1e-3
    assert tile_rel_l2(got, ref) == float("inf")
