"""The engine tools' twins (yoda_scheduler_tpu_torch/tools/scale5k.py,
scale50k.py, serve50k.py) with their tiers cut to tiny ones: each writes
its artifact under `--out` (by default the checkout's chiprun_out/engine/)
and never the repository's BENCH_*.json or CHURN_FENCE.json, reads the
host's card unless given `--cpu`, and raises without NVML."""

import json
from pathlib import Path

import pytest

from test_torch_telemetry import FakeCard, FakeNvml
from yoda_scheduler_tpu_torch import bench
from yoda_scheduler_tpu_torch.telemetry import nvml
from yoda_scheduler_tpu_torch.tools import scale5k, scale50k, serve50k

REPO = Path(__file__).resolve().parent.parent
ROOT_ARTIFACTS = ("BENCH_SCALE5K.json", "BENCH_SCALE50K.json", "BENCH_SCALE50K_SMOKE.json",
                  "BENCH_SERVE50K.json", "BENCH_SERVE50K_SMOKE.json", "CHURN_FENCE.json")
TOOLS = {"scale5k": scale5k, "scale50k": scale50k, "serve50k": serve50k}


@pytest.fixture
def root_untouched():
    """The repository's artifacts are the same bytes after the test."""
    before = {name: (REPO / name).read_bytes() for name in ROOT_ARTIFACTS}
    yield
    assert {name: (REPO / name).read_bytes() for name in ROOT_ARTIFACTS} == before
    assert not (REPO / "churn_fence_flight.json").exists()


@pytest.fixture
def tiny_scale(monkeypatch):
    """run_scale at 1-3 units (8-24 nodes) whatever the tool asks for."""
    sizes = {125: 1, 625: 2, 1563: 3, 6250: 3}
    for tool in (scale5k, scale50k):
        monkeypatch.setattr(tool, "run_scale",
                            lambda units, **kw: bench.run_scale(sizes[units], **kw))


@pytest.fixture
def tiny_serve(monkeypatch):
    """Every steady-state leg at 2 units for 0.2 s + 0.4 s, and the process
    fleet stubbed (bench's own test spawns it)."""
    def steady(**kw):
        kw.update(units=2, warmup_s=0.2, measure_s=0.4)
        return bench.run_serve_steady(**kw)

    def procs(procs, heads, units, n_pods):
        return {"procs": procs, "schedule_heads": heads, "binds_per_s": 1.0,
                "binds_per_s_window": None, "double_bound": 0, "chip_double_booked": 0}

    monkeypatch.setattr(serve50k, "run_serve_steady", steady)
    monkeypatch.setattr(serve50k, "run_serve_procs", procs)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_scale5k_writes_under_out(tiny_scale, root_untouched, tmp_path, capsys):
    assert scale5k.main(["--cpu", "--out", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "BENCH_SCALE5K.json").read_text())
    assert last_json(capsys)["metric"] == out["metric"]
    assert len(out["huge_5000"]["wall_s_runs"]) == 3 and out["live_node"] is None
    assert out["huge_5000"]["placement_faults"] == []
    assert "defrag_migrations" in out["huge_5000_defrag"]


@pytest.mark.parametrize("smoke", [False, True])
def test_scale50k_writes_under_out(smoke, tiny_scale, root_untouched, tmp_path, capsys):
    args = ["--cpu", "--out", str(tmp_path)] + (["--smoke"] if smoke else [])
    assert scale50k.main(args) == 0
    name = "BENCH_SCALE50K_SMOKE.json" if smoke else "BENCH_SCALE50K.json"
    out = json.loads((tmp_path / name).read_text())
    assert out["smoke"] is smoke and out["tier"]["bound"] == out["pods"] == 24
    assert last_json(capsys)["nodes"] == out["nodes"] == 24


def test_scale50k_with_the_live_card(tiny_scale, monkeypatch, tmp_path):
    """The sniffed card joins both clusters and the artifact names it."""
    monkeypatch.setattr(nvml, "_default", nvml.Nvml(FakeNvml([FakeCard()])))
    assert scale50k.main(["--smoke", "--out", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "BENCH_SCALE50K_SMOKE.json").read_text())
    assert out["nodes"] == 25 and out["ref_5k"]["nodes"] == 17
    assert out["live_node"]["model"] == "h100-sxm5" and out["live_node"]["power_limit_w"] == [700]


def test_serve50k_smoke_writes_under_out(tiny_serve, root_untouched, tmp_path, capsys):
    assert serve50k.main(["--smoke", "--cpu", "--out", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "BENCH_SERVE50K_SMOKE.json").read_text())
    # 5 ceiling legs, 2 equilibrium legs, 6 head-curve legs, 4 process legs
    assert out["leak_fence"]["legs_fenced"] == 17
    assert out["process_fleet"]["invariants_clean"]
    assert all(leg["double_bound"] == 0 for leg in out["legs"].values())
    assert last_json(capsys)["legs_fenced"] == 17


def test_serve50k_churn_fence_writes_under_out(tiny_serve, root_untouched, tmp_path, capsys):
    """Exit 1 and the flight dump on a missed fence, as the reference; at
    these sizes the fence may pass or miss, and the exit says which."""
    rc = serve50k.main(["--churn-fence", "--cpu", "--out", str(tmp_path)])
    out = json.loads((tmp_path / "CHURN_FENCE.json").read_text())
    assert rc == (0 if out["ok"] else 1)
    assert (tmp_path / "churn_fence_flight.json").exists() == (not out["ok"])
    assert out["legs_fenced"] == 6 and out["invariants_clean"]
    assert last_json(capsys)["speedup"] == out["speedup"]


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_without_nvml_each_tool_raises(tool, monkeypatch, root_untouched):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    monkeypatch.setattr(nvml, "_default", nvml.Nvml())
    with pytest.raises(RuntimeError, match="no NVML on this host.*--cpu"):
        TOOLS[tool].main(["--smoke"] if tool != "scale5k" else [])


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_default_out_is_the_checkouts_chiprun_out(tool):
    ap = bench.engine_args(tool)
    assert ap.parse_args([]).out == str(REPO / "chiprun_out" / "engine")
    assert bench.OUT_DIR == REPO / "chiprun_out" / "engine"


def test_engine_pairs_names_both_sides():
    """Each pair's twin module and reference script exist in the checkout;
    the 5,000-node leg runs in a child on each side."""
    import engine_pairs

    for port_args, jax_args, artifact in engine_pairs.PAIRS.values():
        if artifact is None:  # scale5k's leg alone, through huge_5000
            assert port_args == engine_pairs.huge_leg("port")
            assert jax_args == engine_pairs.huge_leg("jax")
            continue
        assert (REPO / (port_args[1].replace(".", "/") + ".py")).is_file()
        assert (REPO / jax_args[0]).is_file() and (REPO / artifact).is_file()


def test_engine_pairs_huge_leg_is_scale5ks(monkeypatch, capsys):
    """The port's side of the 5,000-node leg is the scale5k twin's own
    huge_5000, given the host's card."""
    import engine_pairs

    monkeypatch.setattr(nvml, "_default", nvml.Nvml(FakeNvml([FakeCard()])))
    monkeypatch.setattr(bench, "build_native_planes", lambda: None)
    seen = []
    monkeypatch.setattr(scale5k, "huge_5000", lambda live: seen.append(live) or dict(
        {k: 1 for k in engine_pairs.HUGE_KEYS}, extra=2))
    engine_pairs.huge_5000("port")
    assert [live.node for live in seen] == ["h100-live"]
    assert last_json(capsys) == {k: 1 for k in engine_pairs.HUGE_KEYS}


def test_engine_pairs_copies_and_runs(tmp_path):
    """The reference's copy leaves out outputs, builds and the git store;
    a run's record holds its exit code and its last line, parsed."""
    import sys

    import engine_pairs

    tree = tmp_path / "tree"
    for rel in ("bench.py", "tools/scale5k.py", "chiprun_out/x.json", "build/y.so", ".git/HEAD"):
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text("print('{\"ok\": 1}')" if rel == "bench.py" else "")
    copy = engine_pairs.copy_checkout(tree, tmp_path / "copy")
    assert sorted(str(p.relative_to(copy)) for p in copy.rglob("*") if p.is_file()) == [
        "bench.py", "tools/scale5k.py"]
    rec = engine_pairs.run([sys.executable, "bench.py"], copy, tmp_path / "b.log", 60.0)
    assert rec["rc"] == 0 and rec["last_line"] == {"ok": 1}
    assert "--- stderr ---" in (tmp_path / "b.log").read_text()
