"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
calls no library attention or compiler in place of its kernels, and its
entry points run on CUDA unless the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import yoda_scheduler_tpu_torch as port
from yoda_scheduler_tpu_torch.entry import entry
from yoda_scheduler_tpu_torch.models import (KVCache, LlamaConfig, init_llama,
                                             params_from_jax)
from yoda_scheduler_tpu_torch.parallel import (build_llama_train_step, make_mesh,
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
            "yoda_scheduler_tpu_torch.parallel.launch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'yoda_scheduler_tpu' or m.startswith('yoda_scheduler_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("needle", ["import jax", "from jax",
                                    "scaled_dot_product_attention",
                                    "torch.compile", "yoda_scheduler_tpu."])
def test_package_source_never_mentions(needle):
    hits = [str(p.relative_to(PKG)) for p in PKG.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh") and needle in p.read_text()]
    assert hits == []


@pytest.mark.parametrize("call", ["init_llama", "init_llama_moe", "entry", "kv_cache",
                                  "params_from_jax", "build_llama_train_step",
                                  "make_mesh", "quick_mesh_and_step"])
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
        "make_mesh": lambda **kw: make_mesh({}, **kw),
        "quick_mesh_and_step": lambda **kw: quick_mesh_and_step(1, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()
    calls[call](device="cpu")


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
