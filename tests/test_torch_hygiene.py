"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
calls no library attention or compiler in place of its kernels, and its
entry points run on CUDA unless the caller asks for the CPU."""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import yoda_scheduler_tpu_torch as port
from yoda_scheduler_tpu_torch.entry import entry
from yoda_scheduler_tpu_torch.models import (KVCache, LlamaConfig, init_llama,
                                             params_from_jax, resnet_forward_fn)
from yoda_scheduler_tpu_torch.parallel import (TrainCheckpointer, build_llama_train_step,
                                               build_pipelined_llama_train_step,
                                               initialize_multihost, make_mesh,
                                               quick_mesh_and_step)

# tiny shapes: one intra-op thread, so that the other test workers keep
# their cores
torch.set_num_threads(1)

PKG = Path(port.__file__).parent


def test_import_loads_no_jax():
    code = ("import sys, yoda_scheduler_tpu_torch, yoda_scheduler_tpu_torch.entry\n"
            "import yoda_scheduler_tpu_torch.models.moe\n"
            "import yoda_scheduler_tpu_torch.parallel.mesh, "
            "yoda_scheduler_tpu_torch.parallel.sharding, "
            "yoda_scheduler_tpu_torch.parallel.collectives, "
            "yoda_scheduler_tpu_torch.parallel.ring, "
            "yoda_scheduler_tpu_torch.parallel.launch, "
            "yoda_scheduler_tpu_torch.parallel.multihost, "
            "yoda_scheduler_tpu_torch.parallel.checkpoint, "
            "yoda_scheduler_tpu_torch.models.resnet, "
            "yoda_scheduler_tpu_torch.ops.bounds, "
            "yoda_scheduler_tpu_torch.tools.tune_attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'yoda_scheduler_tpu' or m.startswith('yoda_scheduler_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_bench_twins_import_neither_jax_nor_the_reference():
    """The bench twins load no JAX, nothing of the JAX package and none of
    its top-level benches (bench_util, bench_mfu, bench_generate, bench)."""
    code = ("import sys\n"
            "import yoda_scheduler_tpu_torch.bench_util, "
            "yoda_scheduler_tpu_torch.bench_mfu, "
            "yoda_scheduler_tpu_torch.bench_generate\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'yoda_scheduler_tpu', 'bench_util', 'bench_mfu', "
            "'bench_generate', 'bench'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_imports_load_neither_torch_nor_jax():
    """The scheduling system runs on hosts: importing the engine, the k8s
    layer, the CLI, the chaos harness, the telemetry, the topology and the
    engine bench twins (bench.py, tools/scale5k.py, scale50k.py,
    serve50k.py and the package's own fake API server) and the CRD checker
    loads no torch, no
    jax, nothing of the JAX package and nothing of the repository's tests/
    or top-level benches."""
    code = ("import sys\n"
            "import yoda_scheduler_tpu_torch.scheduler.core, "
            "yoda_scheduler_tpu_torch.k8s.client, yoda_scheduler_tpu_torch.k8s.webhook, "
            "yoda_scheduler_tpu_torch.cli, yoda_scheduler_tpu_torch.chaos, "
            "yoda_scheduler_tpu_torch.telemetry, yoda_scheduler_tpu_torch.topology, "
            "yoda_scheduler_tpu_torch.telemetry.duty, "
            "yoda_scheduler_tpu_torch.telemetry.publisher, "
            "yoda_scheduler_tpu_torch.topology.gpus, "
            "yoda_scheduler_tpu_torch.scheduler.plugins.gpulocality, "
            "yoda_scheduler_tpu_torch.utils.nativeloader, "
            "yoda_scheduler_tpu_torch.bench, "
            "yoda_scheduler_tpu_torch.k8s.fake_apiserver, "
            "yoda_scheduler_tpu_torch.k8s.crdcheck, "
            "yoda_scheduler_tpu_torch.tools.scale5k, "
            "yoda_scheduler_tpu_torch.tools.scale50k, "
            "yoda_scheduler_tpu_torch.tools.serve50k\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'torch', 'yoda_scheduler_tpu', 'fake_apiserver', 'bench', "
            "'bench_util', 'tests'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_sniffer_raises_without_libnvidia_ml(monkeypatch):
    """A host whose NVML cannot be loaded is never reported as a host
    without cards: the snapshot raises."""
    from yoda_scheduler_tpu_torch.telemetry import nvml, sniffer

    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    monkeypatch.setattr(nvml, "_default", nvml.Nvml())
    with pytest.raises(nvml.NvmlError, match="libnvidia-ml-absent.so.1"):
        sniffer.local_node_metrics("node")


@pytest.mark.parametrize("suffix", [".yaml", ".cc"])
def test_manifests_and_native_copy_never_name_the_jax_package(suffix):
    """The GPU manifests (deploy/, example/) and the native planes' copy
    (native/*.cc) name the port alone."""
    files = sorted(PKG.rglob(f"*{suffix}"))
    assert len(files) >= (6 if suffix == ".yaml" else 5)
    hits = [str(p.relative_to(PKG)) for p in files
            if re.search(r"yoda_scheduler_tpu(?!_torch)|\bjax\b", p.read_text())]
    assert hits == []


def test_engine_import_builds_nothing():
    """Importing the engine compiles no native plane: the build runs when a
    scheduler first asks for the library."""
    code = ("import sys\n"
            "from yoda_scheduler_tpu_torch.utils import nativeloader\n"
            "calls = []\n"
            "nativeloader.build = lambda: calls.append(1)\n"
            "import yoda_scheduler_tpu_torch.scheduler.core, yoda_scheduler_tpu_torch.cli\n"
            "import yoda_scheduler_tpu_torch.scheduler.nativeplane\n"
            "import yoda_scheduler_tpu_torch.topology.native\n"
            "sys.exit(1 if calls or nativeloader._cached else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


# the route sweep and the attention bench time the library's attention
# beside the kernels, as the yardstick, and nothing else of the package may
# name it (test_no_module_imports_the_tools: no path of the port runs them)
YARDSTICKS = {"scaled_dot_product_attention": ["bench_mfu.py", "tools/tune_attention.py"]}
# the workload benches, entry points a user runs as the tools are
BENCHES = ("bench_mfu.py", "bench_generate.py")
# the top-level benches and tools/ are the JAX package's: a module that
# imports one, names one in a child's code (`python -c "import bench"`) or
# hands one's path to a child process runs the reference, not the port
REFERENCE_RUNS = re.compile(
    r"\bimport (bench|bench_util|bench_mfu|bench_generate|tools)\b"
    r"|^\s*from (bench|bench_util|bench_mfu|bench_generate|tools)\b"
    r"|[\"'](tools/)?\w+\.py[\"']|[\"']make[\"']", re.M)


@pytest.mark.parametrize("needle", ["import jax", "from jax",
                                    "scaled_dot_product_attention",
                                    "torch.compile", "yoda_scheduler_tpu."])
def test_package_source_never_mentions(needle):
    hits = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*")
                  if p.suffix in (".py", ".cu", ".cuh") and needle in p.read_text())
    assert hits == YARDSTICKS.get(needle, [])


def test_package_never_runs_the_reference_benches():
    hits = sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
                  if REFERENCE_RUNS.search(p.read_text()))
    assert hits == []


def test_no_module_imports_the_tools():
    """tools/ holds entry points a user runs; no module of the port's
    models, steps or engine imports them (the benches, entry points
    themselves, share the sweep's checks)."""
    hits = [str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
            if p.parent.name != "tools" and str(p.relative_to(PKG)) not in BENCHES
            and re.search(r"from \.+tools\b|yoda_scheduler_tpu_torch\.tools", p.read_text())]
    assert hits == []


@pytest.mark.parametrize("call", ["init_llama", "init_llama_moe", "entry", "kv_cache",
                                  "params_from_jax", "build_llama_train_step",
                                  "build_llama_train_step_ulysses",
                                  "build_pipelined_llama_train_step",
                                  "make_mesh", "quick_mesh_and_step",
                                  "initialize_multihost", "resnet_forward_fn",
                                  "checkpoint_restore"])
def test_entry_points_need_cuda_unless_asked_for_cpu(call):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = LlamaConfig.tiny()
    calls = {
        "init_llama": lambda **kw: init_llama(cfg, **kw),
        "init_llama_moe": lambda **kw: init_llama(LlamaConfig.tiny_moe(), **kw),
        "entry": lambda **kw: entry(**kw),
        "kv_cache": lambda **kw: KVCache.zeros(cfg, 1, 8, **kw),
        "params_from_jax": lambda **kw: params_from_jax(
            _numpy_params(cfg), cfg, **kw),
        "build_llama_train_step": lambda **kw: build_llama_train_step(cfg, **kw),
        "build_llama_train_step_ulysses": lambda **kw: build_llama_train_step(
            cfg, sp_attention="ulysses", **kw),
        "build_pipelined_llama_train_step": lambda **kw: build_pipelined_llama_train_step(
            cfg, pp=2, **kw),
        "make_mesh": lambda **kw: make_mesh({}, **kw),
        "quick_mesh_and_step": lambda **kw: quick_mesh_and_step(1, **kw),
        "initialize_multihost": lambda **kw: initialize_multihost(**kw),
        "resnet_forward_fn": lambda **kw: resnet_forward_fn(10, **kw),
        "checkpoint_restore": lambda **kw: _save_and_restore(cfg, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()
    calls[call](device="cpu")


def _save_and_restore(cfg, **kw):
    """TrainCheckpointer.restore onto its device (the one-device layout)."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = TrainCheckpointer(tmp, **kw)
        init_fn = build_llama_train_step(cfg, device="cpu")[0]
        ckpt.save(1, *init_fn(0))
        return ckpt.restore(init_fn(1))


def _numpy_params(cfg):
    """A JAX-layout params pytree as numpy arrays (stacked layers)."""
    params = init_llama(cfg, device="cpu")
    stacked = {name: torch.stack([layer[name] for layer in params["layers"]])
               for name in params["layers"][0]}
    as_np = lambda t: t.float().numpy()  # noqa: E731
    return {"embed": as_np(params["embed"]),
            "layers": {n: as_np(t) for n, t in stacked.items()},
            "final_norm": as_np(params["final_norm"]),
            "lm_head": as_np(params["lm_head"])}


def test_entry_on_cpu_runs_the_tiny_forward():
    fn, (params, tokens) = entry(device="cpu")
    logits = fn(params, tokens)
    assert tuple(logits.shape) == (2, 128, LlamaConfig.tiny().vocab_size)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
