"""The port's mesh and sharding rules (yoda_scheduler_tpu_torch/parallel/
mesh.py, sharding.py) against the JAX package's, on the 8 virtual CPU
devices of tests/conftest.py: the same axis sizes and errors, rank r laid
out where device r lies, the same spec tables, and rank r holding exactly
the shard that device r holds. One process: a mesh built without a process
group is one rank's view of the layout (no collectives)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from yoda_scheduler_tpu.models import llama as jllama
from yoda_scheduler_tpu.parallel import make_hybrid_mesh as jax_hybrid
from yoda_scheduler_tpu.parallel import make_mesh as jax_mesh
from yoda_scheduler_tpu.parallel import mesh_shape_for as jax_shape_for
from yoda_scheduler_tpu.parallel import sharding as jsharding
from yoda_scheduler_tpu_torch.models import LlamaConfig, params_from_jax
from yoda_scheduler_tpu_torch.parallel import AXIS_ORDER, Mesh, mesh_shape_for
from yoda_scheduler_tpu_torch.parallel import mesh as tmesh
from yoda_scheduler_tpu_torch.parallel import sharding as tsharding

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


# ------------------------------------------------------------ axis sizes
SHAPE_CASES = {
    "default": (8, {}),
    "tp2_dp2": (8, dict(tp=2, dp=2)),
    "tp2_sp2_dp2": (8, dict(tp=2, sp=2, dp=2)),
    "ep2_tp2": (8, dict(ep=2, tp=2)),
    "pp2_tp2": (8, dict(pp=2, tp=2)),
    "fsdp_given": (8, dict(tp=2, fsdp=2)),
    "one": (1, {}),
    # errors, as tests/test_models_parallel.py's
    "tp3": (8, dict(tp=3)),
    "overfull": (8, dict(tp=2, dp=2, fsdp=4)),
}


@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_mesh_shape_for_matches_jax(case):
    n, kwargs = SHAPE_CASES[case]
    try:
        want = jax_shape_for(n, **kwargs)
    except ValueError as jerr:
        with pytest.raises(ValueError) as terr:
            mesh_shape_for(n, **kwargs)
        assert str(terr.value) == str(jerr)
        return
    assert mesh_shape_for(n, **kwargs) == want


GRIDS = {
    "tp2_dp2": {"tp": 2, "dp": 2, "fsdp": 2},
    "ring": {"sp": 4, "dp": 2},
    "sp_ring_step": {"dp": 1, "fsdp": 2, "sp": 2, "tp": 2},
    "quick_8": jax_shape_for(8, tp=2, sp=2, dp=2),
    "moe": jax_shape_for(8, ep=2, tp=2),
    "pp": jax_shape_for(8, pp=2, tp=2),
    "fsdp_only": {"fsdp": 8},
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_rank_grid_is_the_jax_device_grid(name):
    shape = GRIDS[name]
    jm = jax_mesh(shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(tmesh.rank_grid(shape, 8), ids)
    assert tuple(jm.axis_names) == AXIS_ORDER


def test_rank_grid_refusals_match_jax():
    for shape in ({"tp": 16}, {"seq": 2}):
        with pytest.raises(ValueError) as jerr:
            jax_mesh(shape)
        with pytest.raises(ValueError) as terr:
            tmesh.rank_grid(shape, 8)
        assert str(terr.value) == str(jerr.value)


class _FakeDev:
    """A device with the attributes jax's hybrid mesh reads: slice_index is
    the granule (here a node of ranks_per_node ranks)."""

    def __init__(self, node, i, per_node):
        self.slice_index = self.process_index = node
        self.id = node * per_node + i
        self.device_kind = "fake"
        self.coords = (i, 0, 0)
        self.core_on_chip = 0
        self.platform = "cpu"


HYBRID = {
    "tp4_in_pp2_dp2": ({"tp": 4}, {"pp": 2, "dp": 2}, 4),
    "sp2_tp4_in_dp2": ({"sp": 2, "tp": 4}, {"dp": 2}, 8),
    "fsdp2_tp2_in_dp2": ({"fsdp": 2, "tp": 2}, {"dp": 2}, 4),
    "dp_inside_fsdp_across": ({"dp": 2, "tp": 2}, {"fsdp": 2}, 4),
}


@pytest.mark.parametrize("name", list(HYBRID))
def test_hybrid_rank_grid_is_the_jax_hybrid_grid(name):
    ici, dcn, per_node = HYBRID[name]
    n_nodes = int(np.prod(list(dcn.values())))
    devs = [_FakeDev(g, i, per_node) for g in range(n_nodes) for i in range(per_node)]
    want = np.vectorize(lambda d: d.id)(jax_hybrid(ici, dcn, devices=devs).devices)
    got = tmesh.hybrid_rank_grid(ici, dcn, n_nodes * per_node, per_node)
    np.testing.assert_array_equal(got, want)
    # the ici axes never leave a node
    for a in ici:
        moved = np.moveaxis(got, AXIS_ORDER.index(a), -1).reshape(-1, got.shape[
            AXIS_ORDER.index(a)])
        assert all(len(set(row // per_node)) == 1 for row in moved)


def test_hybrid_mesh_compound_axis_keeps_index_order():
    """dp inside a node and fsdp across: the (dp, fsdp) axis's index order
    is not the ranks' order, and each Axis maps one to the other."""
    grid = tmesh.hybrid_rank_grid({"dp": 2, "tp": 2}, {"fsdp": 2}, 8, 4)
    mesh = Mesh(grid, CPU, rank=2)
    axis = mesh.axis(("dp", "fsdp"))
    assert axis.ranks == [0, 4, 2, 6] and axis.index == 2
    assert [sorted(axis.ranks)[p] for p in axis.perm] == axis.ranks


@pytest.mark.parametrize("args,match", [
    (({"tp": 2}, {"tp": 2}), "both tiers"),
    (({"tp": 2, "seq": 2}, None), "unknown mesh axes"),
    (({"tp": 4}, {"pp": 2}), "number of nodes"),
    (({"tp": 2}, None), "each node holds"),
])
def test_hybrid_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        tmesh.hybrid_rank_grid(*args, 4, 4)


# ------------------------------------------------------------ spec tables
def _as_port_spec(spec: P, stacked: bool) -> tuple:
    entries = tuple(spec)[1:] if stacked else tuple(spec)
    return tuple(e if not isinstance(e, (list, tuple)) else tuple(e) for e in entries)


@pytest.mark.parametrize("moe", [False, True])
def test_param_specs_match_jax(moe):
    cfg = LlamaConfig.tiny_moe() if moe else LlamaConfig.tiny()
    want = jsharding.llama_param_specs(cfg)
    got = tsharding.llama_param_specs(cfg)
    assert set(got["layers"]) == set(want["layers"])
    for name, spec in want["layers"].items():
        assert got["layers"][name] == _as_port_spec(spec, True), name
    for name in ("embed", "final_norm", "lm_head"):
        assert got[name] == _as_port_spec(want[name], False), name


@pytest.mark.parametrize("sp", [False, True])
def test_batch_spec_matches_jax(sp):
    assert tsharding.batch_spec(sp) == _as_port_spec(jsharding.batch_spec(sp), False)


@pytest.mark.parametrize("spec,axes", [
    ((None,), ("dp", "fsdp", "ep", "sp")),
    (("fsdp", "tp"), ("dp", "ep", "sp")),
    (("ep", "fsdp", "tp"), ("dp", "sp")),
])
def test_gradients_sum_over_the_data_axes_a_spec_does_not_split(spec, axes):
    assert tsharding.grad_axes(spec) == axes


# ------------------------------------------------- every rank's shards
LAYOUTS = {
    "dense_tp2_dp2_fsdp2": (jllama.LlamaConfig.tiny(), {"tp": 2, "dp": 2, "fsdp": 2}),
    "dense_quick_8": (jllama.LlamaConfig.tiny(), jax_shape_for(8, tp=2, sp=2, dp=2)),
    "moe_ep2_tp2_dp2": (jllama.LlamaConfig.tiny_moe(), jax_shape_for(8, ep=2, tp=2,
                                                                      dp=2)),
    "moe_fsdp2_ep2_sp2": (jllama.LlamaConfig.tiny_moe(), {"fsdp": 2, "ep": 2, "sp": 2}),
}


@pytest.fixture(scope="module")
def jax_params():
    cfgs = {False: dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32"),
            True: dataclasses.replace(jllama.LlamaConfig.tiny_moe(), dtype="float32")}
    return {moe: (c, jllama.init_llama(c, jax.random.PRNGKey(0))) for moe, c in cfgs.items()}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_rank_holds_the_jax_devices_shard(name, jax_params):
    """shard_params on rank r against the shard jax.device_put gives device
    r under the JAX package's shardings, every leaf and layer; and the
    tokens' piece (`ShardPlan.tokens`) against the batch sharding."""
    jcfg, shape = LAYOUTS[name]
    cfg, jparams = jax_params[jcfg.is_moe]
    jm = jax_mesh(shape)
    shardings = jsharding.llama_shardings(jm, cfg)
    placed = jax.tree.map(jax.device_put, jparams, shardings)
    tcfg = LlamaConfig(**dataclasses.asdict(cfg))
    whole = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens = np.arange(8 * 64).reshape(8, 64)
    sp = shape.get("sp", 1) > 1
    jtok = jax.device_put(jnp.asarray(tokens), NamedSharding(jm, jsharding.batch_spec(sp)))

    def by_device(arr):
        return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}

    jshards = jax.tree.map(by_device, placed)
    jtok = by_device(jtok)
    grid = tmesh.rank_grid(shape, 8)
    for rank in range(8):
        mesh = Mesh(grid, CPU, rank=rank)
        local = tsharding.shard_params(whole, mesh, tcfg)
        for n in ("embed", "final_norm", "lm_head"):
            np.testing.assert_array_equal(local[n].numpy(), jshards[n][rank], err_msg=n)
        for i, layer in enumerate(local["layers"]):
            for n, t in layer.items():
                np.testing.assert_array_equal(t.numpy(), jshards["layers"][n][rank][i],
                                              err_msg=f"rank {rank} layers.{i}.{n}")
                assert t._base is None  # each shard owns its storage
        got = tsharding.ShardPlan(tcfg, mesh).tokens(torch.from_numpy(tokens))
        np.testing.assert_array_equal(got.numpy(), jtok[rank])


def test_shard_refuses_an_uneven_split():
    mesh = Mesh(tmesh.rank_grid({"tp": 8}, 8), CPU, rank=0)
    with pytest.raises(ValueError, match="does not split"):
        tsharding.shard(torch.zeros(4, 12), ("tp", None), mesh)


def test_one_rank_mesh_shards_nothing():
    mesh = tmesh.one_device_mesh("cpu")
    t = torch.randn(4, 6)
    assert tsharding.shard(t, ("fsdp", "tp"), mesh) is t
    assert all(mesh.size(a) == 1 for a in AXIS_ORDER)
