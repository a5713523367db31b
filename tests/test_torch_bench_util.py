"""The port's bench harness (yoda_scheduler_tpu_torch/bench_util.py), the
twin of the JAX package's bench_util.py.

The checkpoint contract of tests/test_bench_harness.py, run on the port's
`make_checkpoint`: section persistence across runs, context binding,
corruption tolerance, atomic writes and the off switch. Then what the twin
changes: a watchdog that exits non-zero, a fence that reads a scalar, a
budget from its own start, and `detect_card`, which refuses a host without
CUDA unless the CPU was asked for. This file imports no JAX."""

import json
import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from yoda_scheduler_tpu_torch import bench_util
from yoda_scheduler_tpu_torch.bench_util import make_checkpoint
from yoda_scheduler_tpu_torch.topology.gpus import GPUS


def _noop(msg):
    pass


def _make(tmp_path, monkeypatch, name="ck.json", env=None):
    path = str(tmp_path / name)
    monkeypatch.setenv("TEST_CKPT", path if env is None else env)
    return path, make_checkpoint("TEST_CKPT", path, _noop)


CTX = dict(card="NVIDIA H100 80GB HBM3", package="yoda_scheduler_tpu_torch")


# ------------------------------------------------ the checkpoint contract
def test_sections_survive_process_loss(tmp_path, monkeypatch):
    # the first run saves two sections, then dies (a new object = a new run)
    path, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**CTX)
    ck.put("train.a", {"mfu": 25.9})
    ck.put("attn.S2048", {"fwd_speedup": 43.0})

    _, resumed = _make(tmp_path, monkeypatch)
    resumed.bind_context(**CTX)
    assert resumed.get("train.a") == {"mfu": 25.9}
    assert resumed.get("attn.S2048") == {"fwd_speedup": 43.0}
    assert resumed.get("attn.S4096") is None  # the section in flight is lost


def test_context_mismatch_discards_sections(tmp_path, monkeypatch):
    path, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**CTX)
    ck.put("train.a", {"mfu": 25.9})

    _, other = _make(tmp_path, monkeypatch)
    other.bind_context(**{**CTX, "card": "NVIDIA H100 PCIe"})  # another card
    assert other.get("train.a") is None


def test_another_package_never_reuses_sections(tmp_path, monkeypatch):
    """The JAX package's numbers never feed the port's run: the package is
    part of the context."""
    path, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**{**CTX, "package": "yoda_scheduler_tpu"})
    ck.put("train.a", {"mfu": 54.25})

    _, port = _make(tmp_path, monkeypatch)
    port.bind_context(**CTX)
    assert port.get("train.a") is None


def test_clear_removes_file(tmp_path, monkeypatch):
    path, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**CTX)
    ck.put("train.a", {"mfu": 25.9})
    assert os.path.exists(path)
    ck.clear()
    assert not os.path.exists(path)
    assert ck.get("train.a") is None


def test_corrupt_file_starts_fresh(tmp_path, monkeypatch):
    path, _ = _make(tmp_path, monkeypatch)
    with open(path, "w") as f:
        f.write('{"truncated mid-wri')
    _, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**CTX)
    assert ck.get("train.a") is None
    ck.put("train.a", {"mfu": 1.0})  # and it can still save
    assert json.load(open(path))["train.a"] == {"mfu": 1.0}


def test_off_switch_never_touches_disk(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path, ck = _make(tmp_path, monkeypatch, env="off")
    ck.bind_context(**CTX)
    ck.put("train.a", {"mfu": 25.9})
    assert ck.get("train.a") == {"mfu": 25.9}  # in memory it still works
    assert not os.path.exists("off")
    assert not os.path.exists(path)
    ck.clear()
    assert os.listdir(tmp_path) == []


def test_writes_are_atomic_json(tmp_path, monkeypatch):
    path, ck = _make(tmp_path, monkeypatch)
    ck.bind_context(**CTX)
    ck.put("a", {"x": 1})
    ck.put("b", {"y": [1, 2, 3]})
    on_disk = json.load(open(path))
    assert on_disk["a"] == {"x": 1}
    assert on_disk["b"] == {"y": [1, 2, 3]}
    assert on_disk["__ctx__"] == CTX
    assert not os.path.exists(path + ".tmp")


def test_default_paths_differ_from_the_references():
    """The twins never read or clear the JAX benches' checkpoints."""
    from yoda_scheduler_tpu_torch import bench_generate, bench_mfu

    assert bench_mfu.CKPT_DEFAULT == "BENCH_MFU_TORCH.ckpt.json"
    assert bench_generate.CKPT_DEFAULT == "BENCH_GENERATE_TORCH.ckpt.json"


# ----------------------------------------------- progress, budget, fence
def test_progress_names_the_bench(capsys):
    bench_util.make_progress("bench_x")("hello")
    err = capsys.readouterr().err
    assert err.startswith("[bench_x] +") and err.rstrip().endswith("s hello")


def test_budget_reads_its_env_var_and_counts_from_its_start(monkeypatch):
    monkeypatch.setenv("TEST_BUDGET_S", "30")
    budget, remaining = bench_util.make_budget("TEST_BUDGET_S", 480)
    assert budget == 30.0
    assert 29.0 < remaining() <= 30.0
    monkeypatch.delenv("TEST_BUDGET_S")
    assert bench_util.make_budget("TEST_BUDGET_S", 480)[0] == 480.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_sync_reads_a_scalar_of_the_result(dtype):
    bench_util.make_sync()(torch.ones(3, dtype=dtype))
    bench_util.make_sync()(torch.zeros((), dtype=dtype, requires_grad=dtype != torch.int64))


# ---------------------------------------------------------------- watchdog
def test_watchdog_prints_its_diagnostic_and_exits_non_zero(capsys):
    codes, fired = [], threading.Event()

    def exit_fn(code):
        codes.append(code)
        fired.set()

    dog = bench_util.start_watchdog("llama_train_mfu", "%", 0.0, grace_s=0.05,
                                    exit_fn=exit_fn)
    assert fired.wait(10), "the watchdog never fired"
    dog.join(10)
    assert not dog.is_alive()
    assert codes == [bench_util.WATCHDOG_EXIT] and bench_util.WATCHDOG_EXIT != 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "llama_train_mfu" and line["value"] is None
    assert "hard budget exceeded" in line["error"]


def test_cancelled_watchdog_never_exits():
    codes = []
    dog = bench_util.start_watchdog("m", "u", 0.0, grace_s=0.2, exit_fn=codes.append)
    dog.cancel()
    time.sleep(0.4)
    assert codes == []


# -------------------------------------------------------------- the card
class FakeDevice:
    def __init__(self, uuid, name):
        self._uuid, self._name = uuid, name

    def uuid(self):
        return self._uuid

    def name(self):
        return self._name


def test_detect_card_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_util.detect_card()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_util.detect_card("cuda")


def test_detect_card_on_the_cpu_is_none():
    assert bench_util.detect_card("cpu") is None


UUID = "6f3c9a2e-1d4b-4c6f-9e8a-0b1c2d3e4f50"


@pytest.mark.parametrize("product,model", [("NVIDIA H100 80GB HBM3", "h100-sxm5"),
                                           ("NVIDIA H100 PCIe", "h100-pcie"),
                                           ("NVIDIA L4", None)])
def test_detect_card_names_the_card_by_uuid(monkeypatch, product, model):
    """NVML's card is the one whose UUID is CUDA's (NVML adds "GPU-"); its
    catalog row, or None for a product the catalog lacks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(uuid=UUID))
    devices = [FakeDevice("GPU-00000000-0000-0000-0000-000000000000", "NVIDIA A100-SXM4-80GB"),
               FakeDevice("GPU-" + UUID, product)]
    card = bench_util.detect_card("cuda", nvml_devices=devices)
    assert card.name == product
    assert card.model == (GPUS[model] if model else None)


def test_a_card_nvml_does_not_list_is_refused():
    with pytest.raises(RuntimeError, match="no NVML device"):
        bench_util.nvml_name_of(UUID, [FakeDevice("GPU-other", "NVIDIA H100 PCIe")])
