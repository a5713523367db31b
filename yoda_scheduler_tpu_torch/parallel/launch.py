"""Run a function on n ranks of one host, each its own process.

The rendezvous is a FileStore in a fresh temporary directory (no port, no
network). NCCL on n cards, one rank a card; gloo on the CPU. A rank that
raises, or a run that outlasts its time limit, ends every rank and raises
here.
"""

from __future__ import annotations

import datetime
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world: int, device: str, store: str, timeout_s: float,
               args: tuple) -> None:
    torch.set_num_threads(1)
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device: str = "cuda", args: tuple = (),
              timeout_s: float = 600.0) -> None:
    """Call fn(rank, world, *args) on `world` spawned ranks with the process
    group initialised. `fn` must be importable (a module-level function):
    the ranks start from a fresh interpreter. With device="cuda" each rank
    takes its own card and fewer cards than ranks raise; nothing falls
    back to the CPU."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        ctx = mp.start_processes(_rank_main, args=(fn, world, device, store, timeout_s,
                                                   args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
