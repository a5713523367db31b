"""Shared harness for the port's workload benches (bench_mfu.py,
bench_generate.py): the twin of the JAX package's bench_util.py.

Kept as they are: `make_progress` (a stderr line with the elapsed time),
`make_budget` (a wall-clock budget read from an environment variable, the
same contract) and `make_checkpoint` (sections saved by name the moment
they finish, reused only under the same context, atomic writes, `off` to
keep them in memory only, `clear` after a clean run).

Changed, and why:

- `make_budget`'s clock starts when it is called, not when this module is
  imported: a bench run from another program (chip_smoke.py) gets its
  whole budget from its own start.
- `make_sync` is a full completion fence on the card:
  `torch.cuda.synchronize()` and then a host read of one scalar of the
  result.
- `start_watchdog` prints its diagnostic line and exits non-zero (the
  reference exits 0, which reads as a clean run).
- `detect_card` takes the place of `detect_tpu` and `probe_devices`: the
  card's NVML product name and its row of the GPU catalog
  (`topology/gpus.py`), or None for a card the catalog lacks. It raises
  when CUDA is absent unless the caller asked for the CPU.
- `honor_cpu_platform` and the JAX compilation-cache variables have no
  counterpart: nothing here selects a platform behind the caller's back,
  the device is an argument, and the CUDA kernels are built once per
  checkout (`ops/_build.py`).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time
from dataclasses import dataclass

import torch

from ._device import resolve_device
from .topology.gpus import GPUS, GpuModel, model_of_nvml_name

_T0 = time.time()


def make_progress(tag: str):
    """Stderr progress line with elapsed time, named per bench."""

    def _progress(msg: str) -> None:
        print(f"[{tag}] +{time.time() - _T0:.1f}s {msg}", file=sys.stderr,
              flush=True)

    return _progress


def make_budget(env_var: str, default_s: float):
    """(budget_s, remaining_fn): wall-clock budget for the WHOLE bench from
    this call on; candidates stop escalating once it is spent."""
    budget = float(os.environ.get(env_var, str(default_s)))
    t0 = time.time()

    def _remaining() -> float:
        return budget - (time.time() - t0)

    return budget, _remaining


def unbounded() -> float:
    """The remaining-budget function of a run without a budget."""
    return float("inf")


def make_sync():
    """Full-completion fence: on the card `torch.cuda.synchronize()`, then a
    host read of a scalar reduction of the result, which cannot finish
    before the computation has."""

    def _sync(x: torch.Tensor) -> None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        x.detach().float().sum().item()

    return _sync


def free_memory() -> None:
    """Return what earlier sections left to the card's allocator, so that a
    later, larger section does not run out for their sake."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def make_checkpoint(env_var: str, default_path: str, progress):
    """Cross-run measurement checkpoint: each completed section is saved,
    keyed by name, the moment it finishes, so a run that dies loses only
    the section in flight and the next run resumes from what survived.
    Sections are reused only under the context (card, shapes, package)
    they were recorded under. Set <env_var>=off to keep them in memory
    only."""
    path = os.environ.get(env_var, default_path)

    class _Checkpoint:
        def __init__(self) -> None:
            self.data: dict = {}
            if path != "off" and os.path.exists(path):
                try:
                    with open(path) as f:
                        self.data = json.load(f)
                except (OSError, ValueError):  # unreadable or torn: start fresh
                    self.data = {}

        def bind_context(self, **ctx) -> None:
            """Discard saved sections recorded under a different context."""
            if self.data.get("__ctx__") != ctx:
                if len(self.data) > (1 if "__ctx__" in self.data else 0):
                    progress(f"checkpoint context changed; discarding {path}")
                self.data = {"__ctx__": ctx}

        def get(self, key: str):
            return self.data.get(key)

        def put(self, key: str, value) -> None:
            self.data[key] = value
            if path != "off":
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self.data, f)
                os.replace(tmp, path)

        def clear(self) -> None:
            """Called on a fully successful run: the printed result now owns
            the numbers; a lingering checkpoint would feed stale sections
            into a much later run."""
            self.data = {}
            if path != "off" and os.path.exists(path):
                os.remove(path)

    return _Checkpoint()


WATCHDOG_EXIT = 3


def start_watchdog(metric: str, unit: str, budget_s: float,
                   grace_s: float = 120.0, exit_fn=os._exit):
    """Hard ceiling: a launch that never returns hangs where no cooperative
    budget check runs. A thread timer (a signal handler would wait for the
    main thread's hung call) prints a diagnostic JSON line and exits with
    WATCHDOG_EXIT through `exit_fn`."""

    def _on_deadline():
        print(json.dumps({
            "metric": metric, "value": None, "unit": unit,
            "vs_baseline": None,
            "error": f"hard budget exceeded ({budget_s + grace_s:.0f}s): "
                     "device hung mid-run",
        }), flush=True)
        exit_fn(WATCHDOG_EXIT)

    watchdog = threading.Timer(budget_s + grace_s, _on_deadline)
    watchdog.daemon = True
    watchdog.start()
    return watchdog


@dataclass(frozen=True)
class Card:
    """The card a bench runs on: NVML's product name and its catalog row
    (None for a card the catalog lacks)."""
    name: str
    model: GpuModel | None


def nvml_name_of(uuid: str, devices) -> str:
    """The NVML product name of the card whose UUID is `uuid` (CUDA's form,
    with or without NVML's "GPU-" prefix)."""
    bare = lambda u: str(u).removeprefix("GPU-")  # noqa: E731
    for dev in devices:
        if bare(dev.uuid()) == bare(uuid):
            return dev.name()
    raise RuntimeError(f"no NVML device has CUDA's UUID {uuid}")


def detect_card(device="cuda", nvml_devices=None) -> Card | None:
    """The card `device` names, found in NVML by UUID; None when the caller
    asked for the CPU. Raises when CUDA is absent and the CPU was not asked
    for. `nvml_devices` defaults to the port's NVML binding."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    if nvml_devices is None:
        from .telemetry import nvml
        nvml_devices = nvml.devices()
    name = nvml_name_of(torch.cuda.get_device_properties(dev).uuid, nvml_devices)
    model = model_of_nvml_name(name)
    return Card(name=name, model=GPUS[model] if model else None)
