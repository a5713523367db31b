"""The port builds its own native planes (`yoda_scheduler_tpu_torch/native/
*.cc`, g++ at first use into build/native/) and they place as the numpy
plane does: a 1,000-node trace binds the same pods, on the same nodes and
chips, with the native plane deciding cycles."""

import random
import shutil
from pathlib import Path

import pytest

from yoda_scheduler_tpu_torch import scheduler, telemetry
from yoda_scheduler_tpu_torch.scheduler.core import FakeClock
from yoda_scheduler_tpu_torch.utils import Pod, nativeloader

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on this host to build the native planes")


@needs_gxx
def test_build_is_keyed_and_in_build_dir():
    path = Path(nativeloader.build())
    assert path.exists() and path.parent == nativeloader.BUILD_DIR
    assert path.name.startswith("libyodaplace-") and path == nativeloader._target()
    assert nativeloader.build() == str(path)  # built once per source hash
    assert nativeloader.load_library() is not None


def test_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("int f( {\n")
    monkeypatch.setattr(nativeloader, "SRC_DIR", tmp_path)
    monkeypatch.setattr(nativeloader, "BUILD_DIR", tmp_path / "out")
    if shutil.which("g++") is None:
        with pytest.raises(RuntimeError, match="no g\\+\\+"):
            nativeloader.build()
    else:
        with pytest.raises(RuntimeError, match="failed to build the native planes"):
            nativeloader.build()
    assert not list((tmp_path / "out").glob("*.so"))


def trace(native: bool, units: int = 200, pods_per_node: int = 2, seed: int = 5):
    """`units` x (one 4-host v4-32 slice, 2 v4-8 hosts, 2 eight-card GPU
    nodes) = 1,000 nodes at 200, and a seeded burst of one- and two-chip
    TPU pods, one-card GPU pods and plain pods."""
    store = telemetry.TelemetryStore()
    for i in range(units):
        nodes = telemetry.make_v4_slice(f"s{i}", "2x2x4")
        for j in range(2):
            nodes.append(telemetry.make_tpu_node(f"t{i}-{j}", chips=4))
            nodes.append(telemetry.make_gpu_node(f"g{i}-{j}", cards=8))
        for m in nodes:
            m.heartbeat = 1000.0
            store.put(m)
    cluster = scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    sched = scheduler.Scheduler(cluster, scheduler.SchedulerConfig(
        telemetry_max_age_s=1e18, max_attempts=2, native_plane=native),
        clock=FakeClock(start=1000.0))
    kinds = [{"scv/number": "1", "tpu/accelerator": "tpu"},
             {"scv/number": "2", "tpu/accelerator": "tpu", "scv/memory": "4000"},
             {"scv/number": "1", "tpu/accelerator": "gpu", "scv/memory": "10000"},
             {"scv/memory": "1000"}]
    n = pods_per_node * len(cluster.node_names())
    pods = [Pod(f"p{i}", labels=dict(kinds[i % 4])) for i in range(n)]
    random.Random(seed).shuffle(pods)
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=4 * n)
    planes = {dict(k).get("plane"): v for k, v in
              sched.metrics.labeled_counters.get("cycle_plane_total", {}).items()}
    return ({p.name: (p.phase.value, p.node, sorted(p.assigned_chips())) for p in pods},
            planes, sched.metrics.gauges.get("native_plane_active"))


@needs_gxx
def test_native_plane_binds_as_numpy_at_1000_nodes():
    native, native_planes, active = trace(True)
    numpy, numpy_planes, numpy_active = trace(False)
    assert active == 1.0 and numpy_active == 0.0
    assert native_planes.get("native", 0) > 0 and "native" not in numpy_planes
    assert sum(v[0] == "Bound" for v in native.values()) > 1000
    assert native == numpy
