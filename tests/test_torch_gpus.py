"""The port's GPU layer on the CPU: the GPU catalog, the sniffer naming a
host's model from NVML (the fake NVML library of test_torch_telemetry.py),
the label contract's wider `tpu/generation`, the heterogeneity ratios of
the GPU family, model-pinned pods on every filter plane, the gpu-locality
score (one IB leaf per gang, dented leaves first, neutral on TPU nodes) and
a catalogued fleet placed alike by both packages under the default
profile."""

import contextlib
import dataclasses
import importlib
import io
import json
import random
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_torch_engine import NEVER_STALE, PKGS, Pkg, end_state, record
from test_torch_telemetry import FakeCard, FakeNvml

from yoda_scheduler_tpu.scheduler.policy import heterogeneity as jax_het
from yoda_scheduler_tpu.telemetry import schema as jax_schema
from yoda_scheduler_tpu.utils.labels import WorkloadSpec as JaxWorkloadSpec
from yoda_scheduler_tpu_torch import cli, scheduler, telemetry
from yoda_scheduler_tpu_torch.scheduler.core import FakeClock
from yoda_scheduler_tpu_torch.scheduler.framework import NodeInfo
from yoda_scheduler_tpu_torch.scheduler.plugins.allocator import ChipAllocator
from yoda_scheduler_tpu_torch.scheduler.plugins import gpulocality
from yoda_scheduler_tpu_torch.scheduler.policy import heterogeneity as het
from yoda_scheduler_tpu_torch.scheduler.registry import build_profile, merge_enablement
from yoda_scheduler_tpu_torch.telemetry import nvml, sniffer
from yoda_scheduler_tpu_torch.topology import gpus
from yoda_scheduler_tpu_torch.topology.generations import GENERATIONS
from yoda_scheduler_tpu_torch.utils import Pod
from yoda_scheduler_tpu_torch.utils.labels import IB_LEAF_LABEL, LabelError, WorkloadSpec

LOCALITY = merge_enablement({"score": {"enabled": [{"name": "gpu-locality"}]}})


# ------------------------------------------------------------------ catalog
# (field values each row must hold; h100-sxm5's are an H100 SXM5's NVML
# readings: 81,559 MiB, 1,980 MHz, 16,896 cores, 18 links, 700 W)
ROWS = {
    "h100-sxm5": dict(nvml_names=("NVIDIA H100 80GB HBM3",), hbm_mb=81_559,
                      max_sm_clock_mhz=1_980, sms=132, cuda_cores=16_896, links=18,
                      nvlink_gbps=900, nvlink_domain=8, power_w=700,
                      bf16_dense_tflops=989.0, datasheet_only=False),
    "h100-pcie": dict(nvml_names=("NVIDIA H100 PCIe",), hbm_mb=81_559,
                      max_sm_clock_mhz=1_755, sms=114, cuda_cores=14_592, links=12,
                      nvlink_gbps=600, nvlink_domain=2, power_w=350,
                      bf16_dense_tflops=756.0, datasheet_only=True),
    "a100-sxm4-80gb": dict(nvml_names=("NVIDIA A100-SXM4-80GB",), hbm_mb=81_920,
                           max_sm_clock_mhz=1_410, sms=108, cuda_cores=6_912, links=12,
                           nvlink_gbps=600, nvlink_domain=8, power_w=400,
                           bf16_dense_tflops=312.0, datasheet_only=True),
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_catalog_row(name):
    g = gpus.gpu_model(name)
    assert {f.name: getattr(g, f.name) for f in dataclasses.fields(g)} == {
        "name": name, **ROWS[name]}
    # cores are SMs x 128 (Hopper) or x 64 (Ampere); links x 50 GB/s
    assert g.cuda_cores == g.sms * (64 if name.startswith("a100") else 128)
    assert g.nvlink_gbps == g.links * 50
    assert name not in GENERATIONS


def test_catalog_has_exactly_the_three_models():
    assert sorted(gpus.GPUS) == sorted(ROWS)


def test_unknown_model_raises_naming_the_known_ones():
    with pytest.raises(ValueError, match=r"unknown GPU model 'h200'.*a100-sxm4-80gb"):
        gpus.gpu_model("h200")


@pytest.mark.parametrize("product,model", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm5"), ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA A100-SXM4-80GB", "a100-sxm4-80gb"), ("NVIDIA H100", None),
    ("NVIDIA H100 80GB HBM3 ", None), ("nvidia h100 80gb hbm3", None),
    ("NVIDIA A100-SXM4-40GB", None), ("", None)])
def test_nvml_name_matches_exactly(product, model):
    assert gpus.model_of_nvml_name(product) == model


# ------------------------------------------------------------------ sniffer
def sniff(cards):
    return sniffer.local_node_metrics("node", devices=nvml.Nvml(FakeNvml(cards)).devices())


@pytest.mark.parametrize("names,model", [
    (["NVIDIA H100 80GB HBM3"] * 8, "h100-sxm5"),
    (["NVIDIA A100-SXM4-80GB"] * 4, "a100-sxm4-80gb"),
    (["NVIDIA H100 PCIe"] * 2, "h100-pcie"),
    (["NVIDIA H200"], ""),                                        # unknown product
    (["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"], ""),     # mixed host
    (["NVIDIA H100 80GB HBM3", "NVIDIA H20"], ""),                # one unknown card
    ([], "")])
def test_sniffer_names_the_host_model(names, model):
    m = sniff([FakeCard(name=n) for n in names])
    assert m.tpu_generation == model and m.chip_count == len(names)


def test_sniffed_h100_row_equals_its_catalog_row():
    """The fake card carries an H100 SXM5's readings: the sniffed chip's
    fields are the catalog row's."""
    chip = sniff([FakeCard()]).chips[0]
    g = gpus.gpu_model("h100-sxm5")
    assert (chip.hbm_total_mb, chip.clock_mhz, chip.core_count, chip.ici_bandwidth_gbps,
            chip.power_w) == (g.hbm_mb, g.max_sm_clock_mhz, g.cuda_cores, g.nvlink_gbps,
                              g.power_w)


def test_fabric_rides_the_slice_fields():
    m = sniffer.local_node_metrics("n", devices=nvml.Nvml(FakeNvml([FakeCard()])).devices(),
                                   fabric="pod-a", fabric_hosts=512)
    assert (m.slice_id, m.num_hosts, m.host_index) == ("pod-a", 512, 0)


@pytest.mark.parametrize("source", ["sniffer", "fake"])
def test_jax_schema_reads_a_catalogued_cr(source):
    """The model rides tpu_generation: the JAX package's from_cr reads the
    port's CR of a catalogued node unchanged."""
    if source == "sniffer":
        src = sniff([FakeCard()] * 2)
    else:
        src = telemetry.make_gpu_node("g", cards=8, model="a100-sxm4-80gb",
                                      slice_id="fab", num_hosts=4, host_index=2)
    dst = jax_schema.TpuNodeMetrics.from_cr(src.to_cr())
    assert dst.tpu_generation == src.tpu_generation != ""
    assert dataclasses.asdict(dst) == dataclasses.asdict(src)
    assert dst.to_cr() == src.to_cr()


def test_fake_gpu_node_without_a_model_is_unchanged():
    from yoda_scheduler_tpu.telemetry import fake as jax_fake

    for kw in ({}, {"cards": 4, "mem_free_mb": 20_000}, {"clock_mhz": 1000}):
        assert (telemetry.make_gpu_node("g", **kw).to_cr()["status"]["chips"]
                == jax_fake.make_gpu_node("g", **kw).to_cr()["status"]["chips"])
    m = telemetry.make_gpu_node("g", model="h100-pcie", mem_free_mb=1_000)
    assert m.tpu_generation == "h100-pcie" and m.accelerator == "gpu"
    assert {(c.hbm_free_mb, c.hbm_total_mb, c.clock_mhz, c.core_count, c.power_w)
            for c in m.chips} == {(1_000, 81_559, 1_755, 14_592, 350)}


# ------------------------------------------------------------------- labels
def test_generation_label_takes_a_gpu_model():
    spec = WorkloadSpec.from_labels({"tpu/generation": "h100-sxm5", "tpu/accelerator": "gpu",
                                     "scv/number": "8"})
    assert spec.tpu_generation == "h100-sxm5"
    assert WorkloadSpec.from_labels({"tpu/generation": "v5e"}).tpu_generation == "v5e"


@pytest.mark.parametrize("labels,key", [
    ({"tpu/generation": "h100-sxm5", "tpu/topology": "2x2"}, "tpu/topology"),
    ({"tpu/generation": "a100-sxm4-80gb", "tpu/topology": "1x1x1"}, "tpu/topology"),
    ({"tpu/generation": "h100-pcie", "tpu/accelerator": "tpu"}, "tpu/generation"),
    ({"tpu/generation": "h200"}, "tpu/generation")])
def test_generation_label_rejects(labels, key):
    with pytest.raises(LabelError) as e:
        WorkloadSpec.from_labels(labels)
    assert e.value.label == key


# ----------------------------------------------------------- heterogeneity
CLASSES = {"light": {"v4": 0.9, "v5e": 2.0}, "gpuish": {"gpu": 0.5, "v4": 1.2},
           "pinned": {"gpu": 0.5, "h100-pcie": 3.0}, "low": {"v6e": 0.3, "v5p": 0.4}}


@pytest.mark.parametrize("wclass", ["light", "gpuish", "pinned", "low", "single", "gpu"])
def test_tpu_ratios_and_best_unchanged(wclass):
    """Every TPU generation's ratio, and the TPU family's best, are the JAX
    package's, except that a row's GPU-model entry ("pinned": h100-pcie
    3.0) no longer counts in the TPU family's best."""
    port, ref = het.ThroughputModel(CLASSES), jax_het.ThroughputModel(CLASSES)
    for gen in [*GENERATIONS, "gpu", "unknown"]:
        assert port.ratio(wclass, gen) == ref.ratio(wclass, gen)
        assert port.best(wclass, gen) == port.best(wclass)
    if wclass == "pinned":
        assert port.best(wclass) == max(ref.ratio(wclass, g) for g in GENERATIONS) < 3.0
        assert ref.best(wclass) == 3.0
    else:
        assert port.best(wclass) == ref.best(wclass)


def test_gpu_family_ratios():
    model = het.ThroughputModel(CLASSES)
    # the catalog: bf16 dense peak against h100-sxm5's
    assert model.ratio("single", "h100-sxm5") == 1.0
    assert model.ratio("single", "a100-sxm4-80gb") == 312.0 / 989.0
    assert model.ratio("single", "h100-pcie") == 756.0 / 989.0
    # a "gpu" row applies to every model the row does not name
    assert model.ratio("gpuish", "a100-sxm4-80gb") == model.ratio("gpuish", "h100-sxm5") == 0.5
    assert model.ratio("pinned", "h100-pcie") == 3.0
    assert model.ratio("pinned", "h100-sxm5") == 0.5
    # normalised within the family
    assert model.best("single", "a100-sxm4-80gb") == 1.0
    assert model.best("pinned", "h100-sxm5") == 3.0
    assert model.best("gpuish", "h100-sxm5") == 0.5


def test_generation_key_of_catalogued_gpu_node():
    assert het.generation_key(telemetry.make_gpu_node("g", model="h100-sxm5")) == "h100-sxm5"
    assert het.generation_key(telemetry.make_gpu_node("g")) == "gpu"


# ---------------------------------------------------- pinned pods, planes
def fleet(leaves=3, per_leaf=4, dent=(), extra=()):
    """A cluster of catalogued pools (h100-sxm5 on `leaves` leaves, a100 on
    one, h100-pcie on one), three v4 hosts and two catalog-less GPU
    nodes. -> (store, cluster)."""
    nodes, leaf_of = telemetry.make_gpu_pool("h100-sxm5", leaves, per_leaf)
    for model in ("a100-sxm4-80gb", "h100-pcie"):
        more, lo = telemetry.make_gpu_pool(model, 1, per_leaf)
        nodes += more
        leaf_of.update(lo)
    nodes += [telemetry.make_tpu_node(f"t{i}", chips=4) for i in range(3)]
    nodes += [telemetry.make_gpu_node(f"plain{i}", cards=8) for i in range(2)]
    nodes += list(extra)
    store = telemetry.TelemetryStore()
    for m in nodes:
        m.heartbeat = 1000.0
        store.put(m)
    cluster = scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    for name, leaf in leaf_of.items():
        cluster.set_node_meta(name, labels={IB_LEAF_LABEL: leaf})
    for i, name in enumerate(dent):
        cluster.bind(Pod(f"dent{i}", labels={"scv/number": "1"}), name, [(0, 0, 0)])
    return cluster, leaf_of


def run(cluster, pods, enabled=None, **cfg):
    config = scheduler.SchedulerConfig(telemetry_max_age_s=NEVER_STALE, max_attempts=4,
                                       percentage_of_nodes_to_score=100, **cfg)
    profile = build_profile(config, enabled) if enabled is not None else None
    sched = scheduler.Scheduler(cluster, config, clock=FakeClock(start=1000.0),
                                **({"profile": profile} if profile else {}))
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return sched


def pinned_specs(seed, n=60):
    rng = random.Random(seed)
    specs = []
    for i in range(n):
        model = rng.choice(sorted(gpus.GPUS) + [None])
        labels = {"scv/number": str(rng.choice((1, 2, 4, 8))), "tpu/accelerator": "gpu",
                  "scv/memory": str(rng.choice((1000, 30000, 60000)))}
        if model:
            labels["tpu/generation"] = model
        specs.append((f"p{i}", labels))
    return specs


@pytest.mark.parametrize("plane", ["scalar", "numpy", "native"])
def test_pinned_pods_land_on_their_model_alike_on_every_plane(plane):
    """Model-pinned pods: the same verdicts (the same binds) on the scalar,
    numpy and native filter planes, each pod only on its model."""
    planes = {"scalar": dict(columnar=False), "numpy": dict(native_plane=False),
              "native": dict(native_plane=True)}
    logs = {}
    for name in ("scalar", plane):
        cluster, _ = fleet()
        log = []
        record(cluster, log)
        pods = [Pod(n, labels=dict(lab)) for n, lab in pinned_specs(7)]
        sched = run(cluster, pods, **planes[name])
        logs[name] = (log, end_state(pods))
        for p in pods:
            want = p.labels.get("tpu/generation")
            if p.phase.value == "Bound" and want:
                assert cluster.telemetry.get(p.node).tpu_generation == want, p.name
        used = {dict(k).get("plane") for k in
                sched.metrics.labeled_counters.get("cycle_plane_total", {})}
        if name == "native":
            assert "native" in used
            assert sched.metrics.gauges.get("native_plane_active") == 1.0
    assert logs[plane] == logs["scalar"]
    assert sum(e[0] == "bind" for e in logs[plane][0]) > 20


# ---------------------------------------------------------- gpu-locality
def gang(name, size, model="h100-sxm5", chips=8):
    return [Pod(f"{name}-w{i}", labels={
        "tpu/gang-name": name, "tpu/gang-size": str(size), "scv/number": str(chips),
        "tpu/accelerator": "gpu", "tpu/generation": model}) for i in range(size)]


def leaves_of(pods, leaf_of):
    return {leaf_of[p.node] for p in pods if p.phase.value == "Bound"}


def case_one_leaf_per_gang(enabled):
    """Three gangs (3, 2, 4 nodes) and eight whole-node pods on 3 leaves
    x 4 nodes: each gang on one leaf."""
    cluster, leaf_of = fleet()
    gangs = [gang("a", 3), gang("b", 2), gang("c", 4)]
    pods = [p for g in gangs for p in g]
    run(cluster, pods, enabled)
    return all(p.phase.value == "Bound" for p in pods) and all(
        len(leaves_of(g, leaf_of)) == 1 for g in gangs)


def case_dented_leaf_first(enabled):
    """Leaf 1 holds a one-card pod: a 2-node gang goes there, not to the
    pristine leaves 0 and 2."""
    cluster, leaf_of = fleet(dent=["h100-sxm5-l1-n3"])
    g = gang("d", 2)
    run(cluster, g, enabled)
    return leaves_of(g, leaf_of) == {"h100-sxm5-leaf-1"}


def case_gang_follows_its_anchor(enabled):
    """Two leaves dented alike; the gang's members all join the leaf the
    first member took, although both could take them."""
    cluster, leaf_of = fleet(dent=["h100-sxm5-l0-n0", "h100-sxm5-l2-n0"])
    g = gang("e", 3)
    run(cluster, g, enabled)
    return len(leaves_of(g, leaf_of)) == 1 and all(p.phase.value == "Bound" for p in g)


def case_singles_pack_dented_leaves(enabled):
    """One-card pods pinned to h100-sxm5 fill the dented leaf before
    touching a pristine one."""
    cluster, leaf_of = fleet(dent=["h100-sxm5-l2-n1"])
    pods = [Pod(f"s{i}", labels={"scv/number": "1", "tpu/generation": "h100-sxm5"})
            for i in range(6)]
    run(cluster, pods, enabled)
    return leaves_of(pods, leaf_of) == {"h100-sxm5-leaf-2"}


def case_pcie_pair_inside_one_domain(enabled):
    """H100 PCIe cards pair over a bridge, (0, 1), (2, 3), ...: three nodes
    have four free cards but no free pair, one has two free cards that are
    a pair. A 2-card pod goes to the pair, though the others have more
    free cards."""
    cluster, _ = fleet()
    for i, (node, taken) in enumerate((("h100-pcie-l0-n0", (0, 1, 4, 5, 6, 7)),
                                       ("h100-pcie-l0-n1", (0, 2, 4, 6)),
                                       ("h100-pcie-l0-n2", (1, 3, 5, 6)),
                                       ("h100-pcie-l0-n3", (0, 3, 4, 7)))):
        cluster.bind(Pod(f"hold{i}", labels={"scv/number": str(len(taken))}), node,
                     [(c, 0, 0) for c in taken])
    p = Pod("pair", labels={"scv/number": "2", "tpu/generation": "h100-pcie"})
    run(cluster, [p], enabled)
    return p.node == "h100-pcie-l0-n0" and sorted(p.assigned_chips()) == [(2, 0, 0),
                                                                        (3, 0, 0)]


LOCALITY_CASES = {"one_leaf_per_gang": case_one_leaf_per_gang,
                  "dented_leaf_first": case_dented_leaf_first,
                  "gang_follows_its_anchor": case_gang_follows_its_anchor,
                  "singles_pack_dented_leaves": case_singles_pack_dented_leaves,
                  "pcie_pair_inside_one_domain": case_pcie_pair_inside_one_domain}


@pytest.mark.parametrize("case", list(LOCALITY_CASES))
def test_gpu_locality(case):
    assert LOCALITY_CASES[case](LOCALITY)


def test_gpu_locality_sign_mutant_breaks_every_case(monkeypatch):
    """The score with its sign turned fails all five cases (a reversed
    anchor term scatters a gang's members: the anchor leaf becomes the
    least wanted)."""
    real, real_batch = gpulocality.GpuLocalityScore.score, gpulocality.GpuLocalityScore.score_batch

    def mutant(self, state, pod, node):
        s, st = real(self, state, pod, node)
        return -s, st

    def mutant_batch(self, state, pod, table, rows):
        return -real_batch(self, state, pod, table, rows)

    monkeypatch.setattr(gpulocality.GpuLocalityScore, "score", mutant)
    monkeypatch.setattr(gpulocality.GpuLocalityScore, "score_batch", mutant_batch)
    held = {name: case(LOCALITY) for name, case in LOCALITY_CASES.items()}
    assert not any(held.values()), held


@pytest.mark.parametrize("enabled", ["default_profile", "default_enablement"])
def test_every_locality_case_fails_without_the_plugin(enabled):
    """The cases test the plugin: without it, none of them holds."""
    enabled = None if enabled == "default_profile" else merge_enablement({})
    held = {name: case(enabled) for name, case in LOCALITY_CASES.items()}
    assert not any(held.values()), held


def test_gpu_locality_is_neutral_on_tpu_nodes():
    """On a TPU fleet the plugin scores every node 0: the same binds with it
    on as with the default enablement it is added to."""
    logs = []
    for enabled in (merge_enablement({}), LOCALITY):
        t = telemetry
        nodes = (t.make_v4_slice("s0", "2x2x4") + t.make_v4_slice("s1", "2x2x2")
                 + [t.make_tpu_node(f"t{i}", chips=4) for i in range(3)])
        store = t.TelemetryStore()
        for m in nodes:
            m.heartbeat = 1000.0
            store.put(m)
        cluster = scheduler.FakeCluster(store)
        cluster.add_nodes_from_telemetry()
        log = []
        record(cluster, log)
        rng = random.Random(3)
        pods = [Pod(f"p{i}", labels={"scv/number": str(rng.choice((1, 2, 4))),
                                     "tpu/accelerator": "tpu"}) for i in range(30)]
        pods += [Pod(f"g-w{i}", labels={"tpu/gang-name": "g", "tpu/gang-size": "2",
                                        "scv/number": "4"}) for i in range(2)]
        run(cluster, pods, enabled)
        logs.append(log)
    assert logs[0] == logs[1] and any(e[0] == "bind" for e in logs[0])


def test_gpu_locality_score_batch_equals_score(monkeypatch):
    """The columnar score against the per-node one, bit for bit, on every
    batch-scored cycle of pinned pods, gangs and partly used H100 PCIe
    nodes; and the same binds on the scalar, numpy and native planes."""
    real = gpulocality.GpuLocalityScore.score_batch
    checked = []

    def checking(self, state, pod, table, rows):
        out = real(self, state, pod, table, rows)
        snap = state.read("snapshot")
        want = [self.score(state, pod, snap.get(table.name_at(r)))[0] for r in rows]
        assert out.tolist() == want
        checked.append(len(want))
        return out

    monkeypatch.setattr(gpulocality.GpuLocalityScore, "score_batch", checking)
    logs = []
    for planes in (dict(columnar=False), dict(native_plane=False), dict(native_plane=True)):
        cluster, _ = fleet(dent=["h100-pcie-l0-n1", "h100-sxm5-l1-n0"])
        log = []
        record(cluster, log)
        pods = [Pod(n, labels=dict(lab)) for n, lab in pinned_specs(9, n=40)]
        pods += gang("x", 3) + gang("y", 2)
        run(cluster, pods, LOCALITY, **planes)
        logs.append(log)
    assert logs[0] == logs[1] == logs[2]
    assert sum(checked) > 100


def test_gpu_locality_is_not_in_the_default_profile():
    from yoda_scheduler_tpu_torch.scheduler.registry import DEFAULT_ENABLED

    assert "gpu-locality" in scheduler.registry.registered()
    assert all("gpu-locality" not in names for names in DEFAULT_ENABLED.values())


# ------------------------------------------- the cards of a pick (F1)
def node_with_taken(model, taken, cards=8, pkg="port"):
    """(NodeInfo, ChipAllocator) of `pkg` for a GPU node (`model` None: the
    catalog-less one) or, for model "tpu", a 4-chip TPU host, whose
    `taken` cards are unhealthy (neither pick nor score takes them)."""
    m = (telemetry.make_tpu_node("n", chips=4) if model == "tpu"
         else telemetry.make_gpu_node("n", cards=cards, model=model))
    for c in m.chips:
        if c.coords[0] in taken:
            c.health = "Unhealthy"
    if pkg == "jax":
        from yoda_scheduler_tpu.scheduler.framework import NodeInfo as JNodeInfo
        from yoda_scheduler_tpu.scheduler.plugins.allocator import ChipAllocator as JAlloc

        return JNodeInfo("n", jax_schema.TpuNodeMetrics.from_cr(m.to_cr())), JAlloc()
    return NodeInfo("n", m), ChipAllocator()


def pick(model, taken, chips, pkg="port"):
    ni, alloc = node_with_taken(model, taken, pkg=pkg)
    spec = (JaxWorkloadSpec if pkg == "jax" else WorkloadSpec)(chips=chips)
    got = alloc.pick_chips(spec, ni)
    return None if got is None else sorted(got)


@pytest.mark.parametrize("taken,want", [
    ((0,), [(2, 0, 0), (3, 0, 0)]),            # the reproduced picks: (1, 2)
    ((0, 2, 4), [(6, 0, 0), (7, 0, 0)]),       # and (5, 6)
    ((0, 1, 3), [(4, 0, 0), (5, 0, 0)]),       # best fit: pair 1 holds one card
    ((), [(0, 0, 0), (1, 0, 0)]),
])
def test_pcie_pod_takes_a_whole_free_pair(taken, want):
    """Departure 3: on an H100 PCIe node (bridged pairs) a 2-card pod takes
    both cards of one pair whenever a whole pair is free, the pair with
    the fewest free cards first, the lowest on ties."""
    assert pick("h100-pcie", taken, 2) == want


def test_pcie_one_card_pod_fills_a_broken_pair_first():
    assert pick("h100-pcie", (0, 2), 1) == [(1, 0, 0)]
    assert pick("h100-pcie", (5,), 1) == [(4, 0, 0)]


@pytest.mark.parametrize("taken", [(0, 2, 4, 6), (1, 2, 5, 6), (0, 3, 4, 7, 1)])
def test_pcie_node_without_a_whole_pair_picks_as_before(taken):
    """No pair has room: the pick is the JAX package's, the line's."""
    assert pick("h100-pcie", taken, 2) == pick("h100-pcie", taken, 2, pkg="jax")
    assert pick("h100-pcie", taken, 2) is not None


@pytest.mark.parametrize("model", ["h100-sxm5", "a100-sxm4-80gb", None, "tpu"])
def test_pick_equals_the_jax_package_off_the_pcie_domains(model):
    """HGX (one domain of 8), A100, catalog-less GPU and TPU nodes: the
    port picks the JAX package's cards on every free set, for 1-4 cards."""
    n = 4 if model == "tpu" else 8
    for mask in range(1 << n):
        taken = tuple(i for i in range(n) if mask >> i & 1)
        for chips in (1, 2, 3, 4):
            assert pick(model, taken, chips) == pick(model, taken, chips, pkg="jax"), \
                (model, taken, chips)


@pytest.mark.parametrize("chips", [1, 2, 3])
def test_domain_score_agrees_with_the_pick_on_every_free_set(chips):
    """gpu-locality's NVLink term, in its per-node and its columnar form,
    and the allocator read a card's domain from one helper
    (`gpus.card_domain`): on all 256 free sets of an 8-card H100 PCIe node,
    both forms find the pod's cards a domain exactly when the pick takes
    them inside one."""
    from yoda_scheduler_tpu_torch.scheduler.columnar import ColumnarTable
    from yoda_scheduler_tpu_torch.scheduler.framework import CycleState, Snapshot

    spec = WorkloadSpec(chips=chips)
    model = gpus.gpu_model("h100-pcie")
    for mask in range(256):
        taken = tuple(i for i in range(8) if mask >> i & 1)
        ni, alloc = node_with_taken("h100-pcie", taken)
        plugin = gpulocality.GpuLocalityScore(alloc, None)
        fits = plugin._domain_fits(spec, ni)
        got = alloc.pick_chips(spec, ni)
        inside = got is not None and len({gpus.card_domain(model, c) for c in got}) == 1
        assert fits == (inside or chips == 1), (taken, got)
        table = ColumnarTable(alloc)
        assert table.sync(Snapshot({"n": ni}), (0, 0, 0), None)
        state = CycleState()
        state.write(gpulocality.LEAF_VIEW_KEY, gpulocality._LeafView({"n": 0.0}, set()))
        state.write("workload_spec", spec)
        (batch,) = plugin.score_batch(state, None, table, np.array([0])).tolist()
        assert batch == (0.0 if fits else gpulocality.SPLIT_DOMAIN), (taken, batch)
        assert batch == plugin.score(state, None, ni)[0]


# ------------------------------------------------------ manifests, CLI
PORT = Path(__file__).resolve().parent.parent / "yoda_scheduler_tpu_torch"


def test_configmap_carries_the_gpu_profile():
    docs = list(yaml.safe_load_all((PORT / "deploy" / "yoda-gpu-scheduler.yaml").read_text()))
    (cm,) = [d for d in docs if d["kind"] == "ConfigMap"]
    profile = yaml.safe_load((PORT / "deploy" / "gpu-profile.yaml").read_text())
    assert yaml.safe_load(cm["data"]["config.yaml"]) == profile
    ((cfg, enabled),) = cli.load_profiles(str(PORT / "deploy" / "gpu-profile.yaml"))
    assert "gpu-locality" in enabled["score"] and cfg.percentage_of_nodes_to_score == 100
    (deploy,) = [d for d in docs if d["kind"] == "Deployment"]
    assert deploy["spec"]["template"]["spec"]["containers"][0]["command"][:4] == [
        "python3", "-m", "yoda_scheduler_tpu_torch.cli", "serve"]


def test_sniffer_daemonset_mounts_nvml_and_runs_the_port():
    (ds, *_) = yaml.safe_load_all((PORT / "deploy" / "gpu-sniffer-daemonset.yaml").read_text())
    spec = ds["spec"]["template"]["spec"]
    (c,) = spec["containers"]
    assert c["command"][:5] == ["python3", "-m", "yoda_scheduler_tpu_torch.cli", "sniff",
                                "--publish"]
    assert any(a.startswith("--fabric=") for a in c["command"])
    (vol,) = spec["volumes"]
    assert vol["hostPath"]["path"].endswith("/libnvidia-ml.so.1")
    assert c["volumeMounts"][0]["mountPath"] == vol["hostPath"]["path"]
    assert "nvidia.com/gpu.present" in spec["nodeSelector"]


@pytest.mark.parametrize("profile", ["gpu_profile", "default_profile"])
def test_cli_simulate_places_the_gpu_examples_on_their_models(profile):
    """`cli simulate --gpu-models` over the port's GPU examples: each pod on
    its model; under the GPU profile each gang on one IB leaf."""
    out = io.StringIO()
    argv = ["simulate", "--gpu-models", "h100-sxm5,a100-sxm4-80gb",
            *sorted(str(p) for p in (PORT / "example").glob("*.yaml"))]
    if profile == "gpu_profile":
        argv += ["--config", str(PORT / "deploy" / "gpu-profile.yaml")]
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    res = json.loads(out.getvalue())
    # the serving example's two replicas ask for a pool=serving node, which
    # `simulate` does not label: they stay pending (tests/test_torch_deploy.py
    # places them on a labelled cluster) and the run exits 1; every other
    # pod binds, its unpinned batch pod on any GPU node
    pending = sorted(k for k, p in res["pods"].items() if p["phase"] != "Bound")
    assert pending == ["default/serve-0", "default/serve-1"]
    assert rc == 1 and res["bound"] == len(res["pods"]) - 2 == 14
    assert res["pods"]["default/batch-leaner"]["phase"] == "Bound"
    model = {"llama2-7b-h100": "h100-sxm5", "mixtral-h100": "h100-sxm5",
             "resnet50-train-a100": "a100-sxm4-80gb"}
    leaves: dict[str, set] = {}
    for key, p in res["pods"].items():
        name = key.split("/", 1)[1]
        job = next((j for j in model if name.startswith(j)), None)
        if job is None:
            assert key in pending or name == "batch-leaner", key
            continue
        assert p["node"].startswith(model[job] + "-"), (name, p["node"])
        leaves.setdefault(job, set()).add(p["node"].rsplit("-n", 1)[0])
    if profile == "gpu_profile":
        assert len(leaves["llama2-7b-h100"]) == len(leaves["mixtral-h100"]) == 1


# ----------------------------------------------------------------- parity
def catalogued_case(P, port_nodes, leaf_of):
    """Both packages over the same catalogued fleet (the JAX package's
    nodes read from the port's CRs), unpinned GPU, TPU and plain pods and
    a GPU gang, the default profile."""
    schema = importlib.import_module(f"{P.name}.telemetry.schema")
    nodes = [schema.TpuNodeMetrics.from_cr(m.to_cr()) for m in port_nodes]
    store = P.telemetry.TelemetryStore()
    for m in nodes:
        m.heartbeat = 1000.0
        store.put(m)
    cluster = P.scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    for name, leaf in leaf_of.items():
        cluster.set_node_meta(name, labels={IB_LEAF_LABEL: leaf})
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        telemetry_max_age_s=NEVER_STALE, max_attempts=4), clock=P.core.FakeClock(start=1000.0))
    rng = random.Random(11)
    specs = []
    for i in range(50):
        r = rng.random()
        if r < 0.5:
            labels = {"tpu/accelerator": "gpu", "scv/number": str(rng.choice((1, 2, 4, 8))),
                      "scv/memory": str(rng.choice((10_000, 50_000, 80_000)))}
        elif r < 0.75:
            labels = {"tpu/accelerator": "tpu", "scv/number": str(rng.choice((1, 2)))}
        else:
            labels = {"scv/memory": str(rng.randrange(0, 16_000, 2_000))}
        specs.append((f"p{i}", labels))
    specs += [(f"gg-w{i}", {"tpu/gang-name": "gg", "tpu/gang-size": "3", "scv/number": "8",
                            "tpu/accelerator": "gpu"}) for i in range(3)]
    rng.shuffle(specs)
    pods = P.pods(specs)
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return log, end_state(pods)


def test_catalogued_fleet_places_alike_in_both_packages():
    nodes, leaf_of = telemetry.make_gpu_pool("h100-sxm5", 2, 3)
    more, lo = telemetry.make_gpu_pool("a100-sxm4-80gb", 1, 3)
    nodes += more + [telemetry.make_tpu_node(f"t{i}", chips=4) for i in range(2)]
    leaf_of.update(lo)
    jax_log, jax_end = catalogued_case(Pkg(PKGS[0]), nodes, leaf_of)
    port_log, port_end = catalogued_case(Pkg(PKGS[1]), nodes, leaf_of)
    assert any(e[0] == "bind" and e[1].startswith("gg-") for e in jax_log)
    assert port_log == jax_log
    assert port_end == jax_end
