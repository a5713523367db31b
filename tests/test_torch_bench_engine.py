"""The port's engine bench (yoda_scheduler_tpu_torch/bench.py) beside the
JAX package's bench.py at small sizes: each tier's outcome fields equal,
the wire tiers holding their invariants, and the twin's departures (the
live card through a fake NVML, `--cpu`, non-zero exits, its own output
directory).

Parity is about outcomes. Left out everywhere, because they vary between
two runs of the JAX bench itself on one host: every latency and wall-time
field (`*_ms`, `wall_s`, `e2e_breakdown`, `jct_p50_ms`, rates and their
ratios), `cycles` and `batch_sizes` (the HybridClock mixes real time into
the batched pass, so the cycle mix moves), and the resident-memory
readings (a process's high-water mark). Fields only the twin has
(`native_*` and `prefetch_*` on the port's native planes, `on_live_node`,
`placement_faults`) are held on their own."""

import json
import threading
from pathlib import Path

import pytest

import bench as jax_bench  # the repository's bench.py, as tests/test_obs.py imports it
from test_torch_telemetry import FakeCard, FakeNvml
from yoda_scheduler_tpu_torch import bench
from yoda_scheduler_tpu_torch.telemetry import nvml

REPO = Path(__file__).resolve().parent.parent

# the JAX package's burst outcome fields (run_burst)
BURST_FIELDS = ("bound", "failed", "per_class_bound", "gangs_complete", "bin_pack_util_pct",
                "overcommitted_binds", "requeue_events", "cycle_crashes", "pods_quarantined",
                "breaker_opens", "degraded_cycles", "reconcile_adopted",
                "reconcile_requeued", "requeue_events_dropped")
# run_scale's: placement outcomes and the leftover capacity; the recovery
# counters but degraded_cycles, which counts cycles (the blackout variant
# holds it above 0 on both sides instead)
SCALE_FIELDS = ("nodes", "pods", "bound", "per_kind", "free_tpu_chips_end",
                "free_gpu_cards_end", "cycle_crashes", "pods_quarantined", "breaker_opens",
                "ambiguous_bind_recoveries", "reconcile_adopted", "reconcile_requeued",
                "requeue_events_dropped")
# the defrag variant's: migrations and who moved; defrag_passes and
# defrag_skips count the controller's timer on the HybridClock (real time)
DEFRAG_FIELDS = ("defrag_migrations", "defrag_by_strategy", "unique_migrated_pods")
# keys dropped at any depth: timings, rates and memory readings (see above)
TIMING = {"wall_s", "jct_p50_ms", "scalar_us_per_carve", "park_wall_s", "drain_wall_s",
          "decision_p50_ms", "decision_p99_ms", "decision_p99_ratio_10k_vs_1k",
          "ttfb_pods", "ttfb_workloads", "ttfb_speedup", "parked_rss_mb",
          "parked_bytes_per_workload", "binds_per_s"}


def outcomes(result, drop=TIMING):
    """`result` without the keys in `drop`, at any depth."""
    if isinstance(result, dict):
        return {k: outcomes(v, drop) for k, v in result.items() if k not in drop}
    return result


def pick(result, fields):
    return {k: result[k] for k in fields}


@pytest.fixture
def fake_card(monkeypatch):
    """One H100 SXM5 through a fake NVML library, as the sniffer reads it."""
    monkeypatch.setattr(nvml, "_default", nvml.Nvml(FakeNvml([FakeCard()])))


@pytest.fixture
def no_nvml(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    monkeypatch.setattr(nvml, "_default", nvml.Nvml())


@pytest.mark.parametrize("profile", ["yoda-tpu", "reference"])
def test_burst_matches_jax(profile):
    """The 200-pod mixed burst under both profiles, at full size."""
    jax_run, port_run = jax_bench.run_burst(profile), bench.run_burst(profile)
    assert pick(port_run, BURST_FIELDS) == pick(jax_run, BURST_FIELDS)
    assert port_run["placement_faults"] == [] and port_run["on_live_node"] == 0
    # the twin's native planes serve the yoda-tpu profile's scans (the
    # JAX engine's do not build here, so it has no such fields)
    assert port_run["native_plane_active"] == (profile == "yoda-tpu")


@pytest.mark.parametrize("variant", [
    {}, {"diverse": True, "pods_per_node": 2}, {"batch": False}, {"defrag": True},
    {"blackout": True}])
def test_scale_matches_jax(variant):
    """run_scale(13): 104 nodes, on the port's numpy plane as the JAX
    engine runs (its native planes do not build with this host's g++)."""
    jax_run = jax_bench.run_scale(13, **variant)
    port_run = bench.run_scale(13, native=False, **variant)
    fields = SCALE_FIELDS + (DEFRAG_FIELDS if variant.get("defrag") else ())
    assert pick(port_run, fields) == pick(jax_run, fields)
    assert port_run["placement_faults"] == []
    if variant.get("blackout"):
        assert port_run["degraded_cycles"] > 0 and jax_run["degraded_cycles"] > 0


def test_scale_native_places_as_numpy():
    """Inside the port: the native planes bind what the numpy plane binds."""
    native, numpy_run = bench.run_scale(13), bench.run_scale(13, native=False)
    assert native["native_plane_active"] and native["native_scans"] > 0
    assert not numpy_run["native_plane_active"]
    assert pick(native, SCALE_FIELDS) == pick(numpy_run, SCALE_FIELDS)
    assert native["placement_faults"] == []


@pytest.mark.parametrize("tier, args", [
    ("run_fairness_tier", (2,)), ("run_elastic_tier", (4,)), ("run_diurnal_tier", ()),
    ("run_slo_tier", ())])
def test_tier_matches_jax(tier, args):
    """Every field but the timings: the fairness tier's DRF shares, quota
    rejections and per-tenant and per-class counts; the elastic gang's and
    defrag legs' counts; the capacity loop's and SLO guard's outcomes (on
    a virtual clock)."""
    jax_run, port_run = getattr(jax_bench, tier)(*args), getattr(bench, tier)(*args)
    assert outcomes(port_run) == outcomes(jax_run)


def test_torus_tier_matches_jax():
    """Everything but the carve microbench, which times the scalar search
    and, where the native planes load (the port's), the native one."""
    jax_run, port_run = jax_bench.run_torus_tier(), bench.run_torus_tier()
    drop = TIMING | {"carve_kernel"}
    assert outcomes(port_run, drop) == outcomes(jax_run, drop)
    assert port_run["carve_kernel"]["native_available"]
    assert port_run["carve_kernel"]["trials"] == jax_run["carve_kernel"]["trials"]


def test_admission_tier_matches_jax():
    """Cut to 200 workloads of 10 pods (the depth legs keep their 1k and
    10k workloads, the time-to-first-bind legs their 100k pods)."""
    jax_run, port_run = jax_bench.run_admission_tier(200, 10), bench.run_admission_tier(200, 10)
    assert outcomes(port_run) == outcomes(jax_run)
    assert port_run["bound"] == 200 and port_run["still_parked"] > 0


@pytest.mark.parametrize("mode", ["sharded", "free-for-all"])
def test_fleet_invariants(mode):
    """run_fleet(2) at 10 units: everything bound, no pod or chip twice,
    in both packages (conflicts and retries follow thread timing)."""
    for run in (jax_bench.run_fleet(2, mode, 10), bench.run_fleet(2, mode, 10)):
        assert run["bound"] == run["pods"] and run["failed"] == 0
        assert run["double_bound"] == 0 and run["chip_double_booked"] == 0


def test_serve_scale_invariants():
    """The wire tier against the package's own fake API server: every pod
    bound over HTTP (batched binds, events and recovery counts follow wire
    timing and differ between the packages)."""
    for run in (jax_bench.run_serve_scale(50, 200), bench.run_serve_scale(50, 200)):
        assert run["bound"] == run["pods"] == 200
        assert run["p50_ms"] is not None
        assert not {k: v for k, v in run["recovery"].items()
                    if k != "reconcile_requeued" and v}


def test_serve_steady_invariants_and_leak_fence():
    """A short steady-state leg: no pod or chip twice, and the leak fence
    passes after it in both packages."""
    for pkg in (jax_bench, bench):
        baseline = threading.active_count()
        run = pkg.run_serve_steady(n_replicas=2, units=4, arrival_per_s=200.0,
                                   warmup_s=0.3, measure_s=1.0, seed=0)
        assert run["double_bound"] == 0 and run["chip_double_booked"] == 0
        assert run["window_commits"] > 0
        assert pkg.serve_leak_fence(baseline, grace_s=5.0)["leg_objects_alive"] == 0


def test_serve_procs_spawns_a_fleet():
    """Two spawned scheduler processes against the package's fake API
    server bind every pod with no pod or chip twice (judged from the
    server's book)."""
    run = bench.run_serve_procs(procs=2, units=4, n_pods=40, timeout_s=120.0)
    assert run["bound"] == 40 and run["restarts"] == 0
    assert run["double_bound"] == 0 and run["chip_double_booked"] == 0
    assert sum(run["per_proc_binds"]) >= 40


def test_live_node_joins_the_burst_and_scale_clusters(fake_card, monkeypatch):
    """The sniffed card joins the burst's cluster (both profiles) and the
    scale cluster, with the other nodes' heartbeat; a blackout ages it with
    the rest; the scale burst keeps the JAX cluster's pod count."""
    clusters = []

    class Recording(bench.FakeCluster):
        def __init__(self, store, *a, **kw):
            super().__init__(store, *a, **kw)
            clusters.append(self)

    monkeypatch.setattr(bench, "FakeCluster", Recording)
    live = bench.live_node()
    assert (live.node, live.tpu_generation, len(live.chips)) == (bench.LIVE_NODE, "h100-sxm5", 1)
    runs = {kind: bench.run_burst(kind, live) for kind in ("yoda-tpu", "reference")}
    for cluster in clusters:
        store = cluster.telemetry
        assert bench.LIVE_NODE in cluster.node_names()
        assert store.get(bench.LIVE_NODE).heartbeat == store.get("gpu-0").heartbeat
    assert runs["yoda-tpu"]["on_live_node"] >= 1 and runs["yoda-tpu"]["bound"] == 200
    assert all(r["placement_faults"] == [] for r in runs.values())
    clusters.clear()
    scale = bench.run_scale(13, live=live, native=False)
    assert (scale["nodes"], scale["pods"]) == (105, 520)
    assert clusters[0].telemetry.get(bench.LIVE_NODE).heartbeat > live.heartbeat + 1e7
    clusters.clear()
    black = bench.run_scale(13, live=live, native=False, blackout=True)
    store = clusters[0].telemetry
    assert store.get(bench.LIVE_NODE).heartbeat == store.get("t0-0").heartbeat < live.heartbeat
    assert black["degraded_cycles"] > 0 and black["placement_faults"] == []


def test_cpu_leaves_the_live_node_out(monkeypatch):
    """`--cpu` reads no card and builds exactly the JAX package's clusters."""
    def unread(*a, **kw):
        raise AssertionError("--cpu must not read NVML")

    monkeypatch.setattr(bench, "local_node_metrics", unread)
    assert bench.live_node(cpu=True) is None
    assert [n.node for n in bench.build_nodes()] == [n.node for n in jax_bench.build_nodes()]
    assert bench.build_scale_nodes(2).nodes() == jax_bench.build_scale_nodes(2).nodes()


def test_without_nvml_the_twin_raises(no_nvml):
    with pytest.raises(RuntimeError, match="no NVML on this host.*--cpu"):
        bench.live_node()
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main(["--out", "unused"])


def test_a_host_without_cards_raises(monkeypatch):
    monkeypatch.setattr(nvml, "_default", nvml.Nvml(FakeNvml([])))
    with pytest.raises(RuntimeError, match="no card"):
        bench.live_node()


ALL_OFF = ("SCALE", "SERVE", "FLEET", "FAIRNESS", "ELASTIC", "TORUS", "ADMISSION",
           "CAPACITY", "SLO")


def test_a_failing_tier_exits_nonzero_after_the_headline(monkeypatch, tmp_path, capsys):
    for tier in ALL_OFF:
        monkeypatch.setenv(f"YODA_BENCH_NO_{tier}", "1")

    def planted(live=None):
        raise RuntimeError("planted")

    monkeypatch.setattr(bench, "run_gpu_fleet", planted)
    assert bench.main(["--cpu", "--out", str(tmp_path)]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    detail, headline = json.loads(lines[-2]), json.loads(lines[-1])
    assert detail["detail"]["gpu_fleet"] == {"error": "RuntimeError('planted')"}
    assert headline["errors"] == ["gpu_fleet"] and headline["bound"] == "200/200"
    assert headline["full_detail"] is None and not list(tmp_path.iterdir())


def test_a_full_run_writes_only_under_out(monkeypatch, tmp_path, capsys):
    """Every tier stubbed small: exit 0, BENCH_FULL.json under `--out`, the
    repository's BENCH_FULL.json untouched."""
    real_scale = bench.run_scale
    monkeypatch.setattr(bench, "run_scale",
                        lambda units, **kw: real_scale(2 if units > 13 else 1, **kw))
    for tier in ("run_serve_fleet", "run_full_fleet", "run_serve_scale", "run_fairness_tier",
                 "run_elastic_tier", "run_torus_tier", "run_admission_tier",
                 "run_diurnal_tier", "run_slo_tier", "run_gpu_fleet"):
        monkeypatch.setattr(bench, tier, lambda *a, _t=tier, **kw: {"stub": _t})
    root_artifact = (REPO / "BENCH_FULL.json").read_bytes()
    assert bench.main(["--cpu", "--out", str(tmp_path / "engine")]) == 0
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = tmp_path / "engine" / "BENCH_FULL.json"
    assert headline["full_detail"] == str(written) and headline["errors"] == []
    assert headline["native_plane_active"] and headline["placement_faults"] == 0
    assert json.loads(written.read_text())["slo"] == {"stub": "run_slo_tier"}
    assert (REPO / "BENCH_FULL.json").read_bytes() == root_artifact
    assert bench.parse_args([]).out == str(REPO / "chiprun_out" / "engine")


def test_gpu_fleet_places_as_the_smoke_expects():
    """run_gpu_fleet with a catalogued live node: 879 of 879 bound twice
    under gpu-locality, placing alike, no gang across leaves while one leaf
    had room, the live-card pod on the live node, every pinned pod on its
    model; 844 bound under the default profile, 37 gangs across leaves
    (the counts the card's smoke run reads)."""
    live = bench.make_gpu_node(bench.LIVE_NODE, cards=1, model="h100-sxm5", mem_free_mb=79_922)
    fleet = bench.run_gpu_fleet(live)
    on, on2, off = fleet["runs"]
    assert fleet["locality_runs_place_alike"]
    assert [r["bound"] for r in fleet["runs"]] == [879, 879, 844]
    assert not on["gangs_spanning_leaves"] and not on2["spanning_with_room"]
    assert len(off["gangs_spanning_leaves"]) == 37
    for r in fleet["runs"]:
        assert r["live"] == ("Bound", bench.LIVE_NODE) and not r["off_model"]
        assert not r["faults"] and r["native_plane_active"] and r["planes"].get("native")
