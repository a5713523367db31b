"""`ops/variants.tile_rel_l2`, the per-tile bound that the backward kernels'
card checks use, on the CPU: it finds one wrong tile that an elementwise
bound and the whole tensor's relative error let through."""

import numpy as np
import pytest
import torch

from yoda_scheduler_tpu_torch.ops.variants import BWD_TILE_REL_L2, tile_rel_l2, unequal_share


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_unequal_share_reads_rounding_at_another_point(dtype):
    """Equal values read 0; every entry one step up (zero and subnormals
    among them) reads 1; a value rounded, then scaled by 1/sqrt(80) and
    rounded again, against the scaled value rounded once, reads a large
    share (the wgmma backward's dS before its repair, in small); tensors of
    two dtypes are refused."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    a = torch.cat([x.abs(), torch.zeros(8), torch.full((8,), 1e-42)]).to(dtype)
    assert unequal_share(a, a) == 0.0
    up = (a.view(torch.int16) + 1).view(dtype)
    assert unequal_share(up, a) == 1.0
    scale = 80 ** -0.5
    twice = (x.to(dtype).float() * scale).to(dtype)
    assert unequal_share(twice, (x * scale).to(dtype)) > 0.1
    with pytest.raises(ValueError):
        unequal_share(a, a.float())


def test_a_zero_tile_reads_zero_only_if_both_are_zero():
    ref = _late_keys_small(256)
    ref[0, 0, 64:128] = 0
    assert tile_rel_l2(ref.clone(), ref) == 0.0
    got = ref.clone()
    got[0, 0, 100, 5] = 1e-3
    assert tile_rel_l2(got, ref) == float("inf")


def test_fp16_bounds_and_shapes_are_the_smokes():
    """`--dtype float16` holds each launch to chip_smoke's fp16 bounds (the
    bf16 ones over 8) at SHAPES in fp16, fp16_main first, and probes three
    of them."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.ops import variants

    assert variants.BOUNDS[torch.float16] == (chip_smoke.TOL[torch.float16]["o"],
                                               chip_smoke.TILE_REL_L2_FP16)
    assert variants.BOUNDS[torch.bfloat16] == (2e-2, BWD_TILE_REL_L2)
    names = [name for name, *_ in variants.SHAPES_F16]
    assert names[0] == "fp16_main"
    assert [shape for _, *shape in variants.SHAPES_F16] == [
        shape for _, *shape in variants.SHAPES]
    assert {"fp16_main", "fp16_window_512", "fp16_ragged_300"} <= set(variants.PROBE)


@pytest.mark.parametrize("argv", [
    ["fwd", "--dtype", "float16", "--head-dim", "96", "cur"],
    ["fwd", "--head-dim", "96", "--dtype", "float16", "cur"],
    ["fwd", "--dtype", "float32", "cur"]])
def test_a_dtype_the_timer_lacks_is_refused(argv, capsys):
    """fp16 runs at head dims 64, 80, 100 and 128 alone (not at 96), and
    fp32 not at all: the usage and exit 1, before anything is built."""
    from yoda_scheduler_tpu_torch.ops import variants

    assert variants.main(argv) == 1
    assert "--dtype float16" in capsys.readouterr().err


def test_head_dim_80_shapes_are_the_smokes_stablelm_rows():
    """`--head-dim 80` takes SHAPES_80: StableLM-3B-4E1T's attention first
    (32 heads of 80, S=2048, as its model gives it), then GQA 32/8, a window
    and a ragged sequence, each the smoke's row of the same name, three of
    them probed."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.ops import variants

    assert variants.SHAPES_BY_DIM[80] is variants.SHAPES_80
    assert [name for name, *_ in variants.SHAPES_80] == [
        "d80_bshd", "gqa_d80", "window_d80", "ragged_d80"]
    rows = {row[0]: row for row in chip_smoke.SHAPES}
    for name, b, h, kvh, sq, sk, causal, window in variants.SHAPES_80:
        assert rows[name][1:9] == (b, h, kvh, sq, sk, 80, causal, window), name
        assert rows[name][9] == torch.bfloat16 and rows[name][-1] == "wgmma", name
    assert {"d80_bshd", "window_d80", "ragged_d80"} <= set(variants.PROBE)


@pytest.mark.parametrize("d", [80, 100])
def test_fp16_head_dims_80_and_100_shapes_are_the_smokes_rows(d):
    """`--dtype float16 --head-dim 80|100` takes SHAPES_F16_80 and
    SHAPES_F16_100: OPT-2.7B's attention and OpenLLaMA-3B's in fp16 first
    (32 heads, S=2048, as their models give them), then GQA 32/8, a window
    and a ragged sequence, each the smoke's fp16 row of the same name with
    the forward, dQ and dK/dV on wgmma, three of them probed."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.ops import variants

    shapes = variants.SHAPES_F16_BY_DIM[d]
    assert shapes is {80: variants.SHAPES_F16_80, 100: variants.SHAPES_F16_100}[d]
    first = "opt27b_d80_bshd" if d == 80 else "openllama3b_fp16_d100_bshd"
    assert [name for name, *_ in shapes] == [
        first, f"fp16_gqa_d{d}", f"fp16_window_d{d}", f"fp16_ragged_d{d}"]
    rows = {row[0]: row for row in chip_smoke.SHAPES}
    for name, b, h, kvh, sq, sk, causal, window in shapes:
        assert rows[name][1:9] == (b, h, kvh, sq, sk, d, causal, window), name
        assert rows[name][9] == torch.float16, name
        assert chip_smoke.shape_routes(rows[name][-1]) == {
            "flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}, name
    assert {first, f"fp16_window_d{d}", f"fp16_ragged_d{d}"} <= set(variants.PROBE)


@pytest.mark.parametrize("d", [96, 256])
def test_fp16_head_dims_96_and_256_shapes_are_the_smokes_rows(d):
    """`--dtype float16 --head-dim 96|256` takes SHAPES_F16_96 and
    SHAPES_F16_256: GPT-NeoX-20B's attention (64 heads of 96) and GPT-J-6B's
    (16 heads of 256) first, S=2048, as their models give them, then GQA, a
    window and a ragged sequence, each the smoke's fp16 row of the same name
    with the forward, dQ and dK/dV on wgmma at each, three of them
    probed."""
    import chip_smoke
    from yoda_scheduler_tpu_torch.ops import variants

    shapes = variants.SHAPES_F16_BY_DIM[d]
    assert shapes is {96: variants.SHAPES_F16_96, 256: variants.SHAPES_F16_256}[d]
    first = "neox20b_fp16_d96_bshd" if d == 96 else "gptj6b_fp16_d256_bshd"
    assert [name for name, *_ in shapes] == [
        first, f"fp16_gqa_d{d}", f"fp16_window_d{d}", f"fp16_ragged_d{d}"]
    assert shapes[0][1:4] == ((1, 64, 64) if d == 96 else (1, 16, 16))
    rows = {row[0]: row for row in chip_smoke.SHAPES}
    for name, b, h, kvh, sq, sk, causal, window in shapes:
        assert rows[name][1:9] == (b, h, kvh, sq, sk, d, causal, window), name
        assert rows[name][9] == torch.float16, name
        assert chip_smoke.shape_routes(rows[name][-1]) == {
            "flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}, name
    assert {first, f"fp16_window_d{d}", f"fp16_ragged_d{d}"} <= set(variants.PROBE)
