"""Multi-host runtime bring-up for gang-scheduled jobs.

The port of yoda_scheduler_tpu/parallel/multihost.py. The scheduler places
a gang's members one per host (plugins/gang.py); what runs inside those
pods is the same program on every host, joined into one
`torch.distributed` process group by `initialize_multihost`. The
rendezvous contract is the one the gang placement publishes:

- ``YODA_COORDINATOR`` (host:port of member 0: in k8s, the gang's
  headless-Service DNS name), ``YODA_NUM_PROCESSES`` (= tpu/gang-size) and
  ``YODA_PROCESS_ID`` (the member's index), with a StatefulSet's ordinal in
  the hostname as the process id when the explicit variable is absent;
- without a coordinator, torchrun's contract (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the counterpart of a TPU pod's
  self-configuring runtime.

A JAX process owns every chip of its host; here a rank owns one card. A
gang member (a process of the contract) runs `ranks_per_process`
consecutive ranks: global rank = process_id * ranks_per_process +
local_rank, world = num_processes * ranks_per_process, so node g holds
ranks [g r, (g + 1) r), the granule `mesh.make_hybrid_mesh` assumes.

Data feeding: each process holds only the rows of the step's batch that
its ranks need; `global_batch` cuts this rank's piece of the step's tokens
from them, the piece the train step's `batch_fn` would cut from the whole
batch.

The cards: the scheduler publishes the cards it assigned a pod on its
``tpu/assigned-chips`` annotation ("x,y,z;x,y,z", a card's x its NVML
index), and the pod passes it in as ``YODA_ASSIGNED_CHIPS`` through the
downward API. `bind_assigned_cards` (which `initialize_multihost` calls
before CUDA starts) makes exactly those cards visible, by UUID, in the
annotation's order: ``cuda:i`` is the i-th assigned card. A departure from
the JAX package, which leaves the annotation unread (a TPU process owns
every chip of its host).
"""

from __future__ import annotations

import ctypes
import os
import re
import socket

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..telemetry import nvml

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
ASSIGNED_ENV = "YODA_ASSIGNED_CHIPS"
CUDA_ERROR_NOT_INITIALIZED = 3  # cuda.h: a libcuda call before cuInit


def parse_assigned_cards(raw: str) -> list[int]:
    """The NVML indices of a ``tpu/assigned-chips`` value ("x,y,z;x,y,z"),
    in its order. Raises ValueError for a malformed value, a repeated card
    or a coordinate with a non-zero y or z (a TPU chip's, not a card's)."""
    cards = []
    for part in raw.split(";"):
        try:
            x, y, z = (int(f) for f in part.split(","))
        except ValueError:
            raise ValueError(f"{ASSIGNED_ENV}={raw!r} is malformed: each card is "
                             f"'x,y,z' and cards are joined by ';'") from None
        if y or z:
            raise ValueError(f"{ASSIGNED_ENV}={raw!r} holds the TPU coordinate "
                             f"({x}, {y}, {z}): a GPU card's is (NVML index, 0, 0)")
        if x < 0 or x in cards:
            raise ValueError(f"{ASSIGNED_ENV}={raw!r} is malformed: card {x} "
                             f"is negative or named twice")
        cards.append(x)
    return cards


def _cuda_started() -> bool:
    """Whether this process has started CUDA, after which CUDA has read
    CUDA_VISIBLE_DEVICES for good: torch's own initialisation, or libcuda's
    cuInit alone (`torch.cuda.is_available()` runs it), which
    cuDeviceGetCount reveals by answering CUDA_ERROR_NOT_INITIALIZED until
    then. A host without libcuda has started nothing."""
    if torch.cuda.is_initialized():
        return True
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return False
    count = ctypes.c_int(0)
    return lib.cuDeviceGetCount(ctypes.byref(count)) != CUDA_ERROR_NOT_INITIALIZED


def bind_assigned_cards(env=os.environ) -> str | None:
    """Make the cards the scheduler assigned this pod the process's CUDA
    devices: `env`'s YODA_ASSIGNED_CHIPS (the pod's ``tpu/assigned-chips``
    annotation) becomes CUDA_VISIBLE_DEVICES, the assigned cards' NVML
    UUIDs in the annotation's order, so that neither CUDA's index order nor
    CUDA_DEVICE_ORDER can put another card in their place. Returns the
    value set; None, changing nothing, when the variable is unset or empty.
    Raises RuntimeError once CUDA has started in this process (CUDA
    reads the variable once, at cuInit), ValueError for a value `parse_assigned_cards`
    refuses or an index past NVML's count."""
    raw = env.get(ASSIGNED_ENV, "").strip()
    if not raw:
        return None
    cards = parse_assigned_cards(raw)
    if _cuda_started():
        raise RuntimeError(f"{ASSIGNED_ENV} must be applied before CUDA starts in "
                           f"this process: call bind_assigned_cards (or "
                           f"initialize_multihost) before any torch.cuda call")
    devices = nvml.devices()
    past = [i for i in cards if i >= len(devices)]
    if past:
        raise ValueError(f"{ASSIGNED_ENV}={raw!r} names card {past[0]}, but NVML "
                         f"counts {len(devices)} card(s) on this host")
    env["CUDA_VISIBLE_DEVICES"] = ",".join(devices[i].uuid() for i in cards)
    return env["CUDA_VISIBLE_DEVICES"]


def gang_process_env() -> tuple[str | None, int, int]:
    """(coordinator, num_processes, process_id) from the environment.

    Explicit YODA_* vars win; a StatefulSet-style ``name-<ordinal>``
    hostname supplies the process id when unset. coordinator None means
    'no gang coordinator' (torchrun's env, or a single process)."""
    coord = os.environ.get("YODA_COORDINATOR") or None
    n = int(os.environ.get("YODA_NUM_PROCESSES", "0") or 0)
    pid_raw = os.environ.get("YODA_PROCESS_ID")
    if pid_raw is not None and pid_raw != "":
        pid = int(pid_raw)
    else:
        # trailing ordinal, with or without a letter prefix: a
        # StatefulSet's "name-3" and the worker idiom "name-w3" both
        # resolve; anything else is process 0
        m = re.search(r"-[a-z]?(\d+)$", socket.gethostname())
        pid = int(m.group(1)) if m else 0
    return coord, n, pid


def _bind_card(device: torch.device, local_rank: int) -> dict:
    """The backend and the card of this rank: NCCL on its own card, gloo on
    the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        return {"backend": "nccl", "device_id": torch.device("cuda", local_rank)}
    return {"backend": "gloo"}


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device="cuda",
                         ranks_per_process: int = 1, local_rank: int = 0) -> bool:
    """Bring this rank into the job's process group. Returns True when a
    coordinated process group was initialised, False for the single-process
    case (no coordinator configured and not launched by torchrun) —
    callers can run on one card unchanged.

    Safe to call twice (the second call is a no-op that returns whether
    the group holds more than one rank), and arguments override the
    environment for tests and bespoke launchers. With a coordinator, the
    rendezvous is ``tcp://<coordinator>``, rank process_id *
    ranks_per_process + local_rank of num_processes * ranks_per_process
    (one rank a process by default). NCCL with each rank on its own card
    (`local_rank`) on "cuda"; gloo on "cpu". Under torchrun's env the
    rendezvous is ``env://`` and a failure raises when WORLD_SIZE > 1.
    On "cuda" the process first takes the cards the scheduler assigned
    (`bind_assigned_cards`), and `local_rank` indexes them."""
    if torch.device(device).type == "cuda" and not dist.is_initialized():
        bind_assigned_cards()
    dev = resolve_device(device)
    env_coord, env_n, env_pid = gang_process_env()
    coordinator = coordinator if coordinator is not None else env_coord
    num_processes = num_processes if num_processes is not None else env_n
    process_id = process_id if process_id is not None else env_pid

    if dist.is_initialized():  # already up: no-op
        return dist.get_world_size() > 1

    if coordinator:
        # fail HERE with a clear message, not after every gang member
        # spends the rendezvous timeout on an impossible configuration
        if num_processes < 1:
            raise ValueError(
                "YODA_COORDINATOR is set but YODA_NUM_PROCESSES is not "
                "(or < 1) — a coordinated gang needs its process count")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} outside [0, {num_processes})")
        if not 0 <= local_rank < ranks_per_process:
            raise ValueError(
                f"local_rank {local_rank} outside [0, {ranks_per_process})")
        dist.init_process_group(init_method=f"tcp://{coordinator}",
                                rank=process_id * ranks_per_process + local_rank,
                                world_size=num_processes * ranks_per_process,
                                **_bind_card(dev, local_rank))
        return True
    if all(k in os.environ for k in TORCHRUN_ENV):
        try:
            dist.init_process_group(init_method="env://", **_bind_card(
                dev, int(os.environ.get("LOCAL_RANK", "0"))))
            return dist.get_world_size() > 1
        except (RuntimeError, ValueError, TimeoutError):
            # a provably multi-rank job must not silently downgrade to a
            # single process (collectives would hang far from the real
            # cause); only a one-rank launch falls back
            if int(os.environ["WORLD_SIZE"]) > 1:
                raise
    return False


def _piece(local_batch, batch_fn, process_id: int, num_processes: int,
           ranks_per_process: int, gather):
    """This rank's piece of the step's tokens, with the process's rows laid
    out as ``make_array_from_process_local_data`` lays them: `gather(mask)`
    -> [world, rows], the rows each rank of the world needs (its `batch_fn`
    on a batch of `rows` rows); the processes that need the same rows are
    replicas, and the step's batch has b rows for each distinct set (b =
    local_batch's rows). A process's rows are those its ranks need, in
    global order."""
    b, s = local_batch.shape

    def needs(rows: int):
        index = batch_fn(torch.arange(rows * s).view(rows, s))
        mask = torch.zeros(rows, dtype=torch.uint8, device=index.device)
        mask[index.reshape(-1) // s] = 1
        return index, gather(mask).view(num_processes, ranks_per_process, rows).amax(1)

    index, held = needs(b * num_processes)
    distinct = len(torch.unique(held, dim=0))
    if distinct != num_processes:
        index, held = needs(b * distinct)
    mine = held[process_id].bool()
    if int(mine.sum()) != b:
        raise ValueError(
            f"process {process_id} feeds {b} rows, but its ranks need "
            f"{int(mine.sum())} of the step's {held.shape[1]} rows (the batch "
            f"does not split evenly over the {num_processes} processes)")
    position = mine.long().cumsum(0) - 1  # global row -> row of local_batch
    return local_batch.to(index.device)[position[index // s], index % s]


def _all_gather(mask):
    out = [torch.empty_like(mask) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mask)
    return torch.stack(out)


def global_batch(local_batch, batch_fn, ranks_per_process: int = 1):
    """This rank's piece of the step's tokens from this process's rows.

    The twin of the JAX package's ``global_batch(local_batch,
    batch_sharding)``: the port has no NamedSharding, so it takes the train
    step's `batch_fn` (or a ShardPlan's `tokens`) in its place and returns
    this rank's piece, equal to ``batch_fn(global_tokens)``. `local_batch`
    [b, S] holds whole rows: those this process's ranks need, in global
    order, as ``make_array_from_process_local_data`` takes them (for a
    batch split over processes in order, process p of P feeds rows [p b,
    (p + 1) b) of P b; processes that need the same rows, such as pp
    stages, feed the same b rows). Every rank calls it (one all-gather of a
    row mask, or two where processes are replicas); a process whose ranks
    need another number of rows than `local_batch` holds raises ValueError.
    With one process it is `batch_fn(local_batch)`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world <= ranks_per_process:
        return batch_fn(local_batch)
    return _piece(local_batch, batch_fn, dist.get_rank() // ranks_per_process,
                  world // ranks_per_process, ranks_per_process, _all_gather)
