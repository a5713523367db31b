"""The port's multi-host bring-up (yoda_scheduler_tpu_torch/parallel/
multihost.py) against the JAX package's (tests/test_multihost.py): the env
contract, the single-process fallback, the no-op second call, the same
error texts, the rank numbering of processes with several ranks, the
torchrun branch, `global_batch` against `batch_fn` on every rank of
emulated meshes, and one real rendezvous of two processes (gloo) that
agree on an all-reduce."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from yoda_scheduler_tpu.parallel import multihost as jax_multihost
from yoda_scheduler_tpu_torch.models import LlamaConfig
from yoda_scheduler_tpu_torch.parallel import (ShardPlan, build_pipelined_llama_train_step,
                                               gang_process_env, global_batch,
                                               initialize_multihost, multihost)
from yoda_scheduler_tpu_torch.parallel.mesh import Mesh, rank_grid

torch.set_num_threads(1)

YODA_ENV = ("YODA_COORDINATOR", "YODA_NUM_PROCESSES", "YODA_PROCESS_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for v in YODA_ENV + multihost.TORCHRUN_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.fixture
def fake_init(clean_env):
    """Records init_process_group's arguments instead of meeting anyone."""
    calls = []
    clean_env.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def _setenv(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


class TestEnvContract:
    def test_explicit_vars_win(self, monkeypatch):
        monkeypatch.setenv("YODA_COORDINATOR", "gang-svc:1234")
        monkeypatch.setenv("YODA_NUM_PROCESSES", "4")
        monkeypatch.setenv("YODA_PROCESS_ID", "2")
        assert gang_process_env() == ("gang-svc:1234", 4, 2)
        assert gang_process_env() == jax_multihost.gang_process_env()

    @pytest.mark.parametrize("host,pid", [("llama-w-3", 3), ("llama2-7b-w3", 3),
                                          ("devbox", 0), ("name-12", 12)])
    def test_hostname_ordinal(self, clean_env, host, pid):
        clean_env.setattr("socket.gethostname", lambda: host)
        assert gang_process_env() == (None, 0, pid) == jax_multihost.gang_process_env()


class TestInitialize:
    def test_single_process_fallback_on_cpu(self, clean_env):
        assert initialize_multihost(device="cpu") is False
        assert not dist.is_initialized()

    def test_arguments_override_env(self, clean_env, fake_init):
        _setenv(clean_env, YODA_COORDINATOR="env:9", YODA_NUM_PROCESSES="2",
                YODA_PROCESS_ID="0")
        assert initialize_multihost("c:1", 4, 1, device="cpu") is True
        assert fake_init == [{"init_method": "tcp://c:1", "rank": 1, "world_size": 4,
                              "backend": "gloo"}]

    def test_env_contract_reaches_the_rendezvous(self, clean_env, fake_init):
        _setenv(clean_env, YODA_COORDINATOR="gang-svc:8476", YODA_NUM_PROCESSES="4",
                YODA_PROCESS_ID="3")
        assert initialize_multihost(device="cpu") is True
        assert fake_init == [{"init_method": "tcp://gang-svc:8476", "rank": 3,
                              "world_size": 4, "backend": "gloo"}]

    def test_two_processes_of_two_ranks_number_ranks_by_node(self, fake_init):
        """Process g runs ranks [2 g, 2 g + 2): the granule of
        make_hybrid_mesh."""
        for pid in (0, 1):
            for local in (0, 1):
                initialize_multihost("c:1", 2, pid, device="cpu", ranks_per_process=2,
                                     local_rank=local)
        assert [(c["rank"], c["world_size"]) for c in fake_init] == [
            (0, 4), (1, 4), (2, 4), (3, 4)]
        with pytest.raises(ValueError, match="local_rank 2 outside"):
            initialize_multihost("c:1", 2, 0, device="cpu", ranks_per_process=2,
                                 local_rank=2)

    @pytest.mark.parametrize("world", [1, 3])
    def test_second_call_is_a_no_op(self, clean_env, world):
        clean_env.setattr(dist, "is_initialized", lambda: True)
        clean_env.setattr(dist, "get_world_size", lambda: world)
        clean_env.setattr(dist, "init_process_group", lambda **kw: pytest.fail("re-init"))
        assert initialize_multihost("c:1", 4, 1, device="cpu") is (world > 1)

    def test_torchrun_env(self, clean_env, fake_init):
        _setenv(clean_env, MASTER_ADDR="127.0.0.1", MASTER_PORT="29500", WORLD_SIZE="1",
                RANK="0")
        initialize_multihost(device="cpu")
        assert fake_init == [{"init_method": "env://", "backend": "gloo"}]

    @pytest.mark.parametrize("world", ["1", "2"])
    def test_torchrun_failure_raises_when_provably_multi_rank(self, clean_env, world):
        def refuse(**kw):
            raise RuntimeError("rendezvous refused")

        clean_env.setattr(dist, "init_process_group", refuse)
        _setenv(clean_env, MASTER_ADDR="127.0.0.1", MASTER_PORT="29500", WORLD_SIZE=world,
                RANK="0")
        if world == "1":
            assert initialize_multihost(device="cpu") is False
        else:
            with pytest.raises(RuntimeError, match="refused"):
                initialize_multihost(device="cpu")


class TestValidation:
    """The JAX function's refusals, word for word."""

    @pytest.mark.parametrize("args", [("c:1",), ("c:1", 4, 4), ("c:1", 4, -1)])
    def test_same_error_as_jax(self, clean_env, args):
        with pytest.raises(ValueError) as jax_err:
            jax_multihost.initialize_multihost(*args)
        with pytest.raises(ValueError) as port_err:
            initialize_multihost(*args, device="cpu")
        assert str(port_err.value) == str(jax_err.value)
        assert ("NUM_PROCESSES" if len(args) == 1 else "outside") in str(port_err.value)


# (mesh shape, ranks per process, step kind): the emulated gangs of 8 ranks
GANGS = {
    "dp2_fsdp2_tp2_procs4": ({"dp": 2, "fsdp": 2, "tp": 2}, 2, "plan"),
    "dp2_fsdp2_tp2_procs2": ({"dp": 2, "fsdp": 2, "tp": 2}, 4, "plan"),
    "dp2_fsdp2_tp2_procs8": ({"dp": 2, "fsdp": 2, "tp": 2}, 1, "plan"),  # tp replicas
    "dp2_sp2_tp2_procs2": ({"dp": 2, "sp": 2, "tp": 2}, 4, "plan"),
    "pp2_dp2_tp2_procs4": ({"pp": 2, "dp": 2, "tp": 2}, 2, "pipeline"),  # strided rows
}


def _batch_fns(shape: dict, world: int, kind: str) -> list:
    """batch_fn of every rank of `shape`, each rank's own layout alone."""
    cfg = LlamaConfig.tiny()
    fns = []
    for r in range(world):
        mesh = Mesh(rank_grid(shape, world), torch.device("cpu"), rank=r)
        if kind == "plan":
            fns.append(ShardPlan(cfg, mesh).tokens)
        else:
            fns.append(build_pipelined_llama_train_step(cfg, mesh, num_microbatches=2)[2])
    return fns


def _emulated_gather(fns, s: int):
    """What the all-gather of `global_batch` returns: every rank's row mask."""
    def gather(mask):
        rows = mask.numel()
        out = torch.zeros(len(fns), rows, dtype=mask.dtype)
        for q, fn in enumerate(fns):
            out[q, fn(torch.arange(rows * s).view(rows, s)).reshape(-1) // s] = 1
        return out
    return gather


@pytest.mark.parametrize("gang", list(GANGS))
def test_global_batch_is_batch_fn_on_every_rank(gang):
    """Each process feeds the rows its ranks need, in global order; every
    rank's piece equals its batch_fn on the whole batch."""
    shape, rpp, kind = GANGS[gang]
    world, s = 8, 16
    fns = _batch_fns(shape, world, kind)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, s)))
    gather = _emulated_gather(fns, s)
    for r, fn in enumerate(fns):
        p = r // rpp
        rows = sorted({int(i) // s for q in range(p * rpp, (p + 1) * rpp)
                       for i in fns[q](torch.arange(8 * s).view(8, s)).reshape(-1)})
        piece = multihost._piece(tokens[rows], fn, p, world // rpp, rpp, gather)
        assert torch.equal(piece, fn(tokens)), (gang, r)


def test_global_batch_refuses_a_split_the_processes_cannot_feed():
    """dp3 x tp2 in processes of 3 ranks: each process needs 2 of the 3 dp
    blocks, so no batch splits evenly over the processes."""
    fns = _batch_fns({"dp": 3, "tp": 2}, 6, "plan")
    with pytest.raises(ValueError, match="do(es)? not split evenly"):
        multihost._piece(torch.zeros(3, 4, dtype=torch.long), fns[0], 0, 2, 3,
                         _emulated_gather(fns, 4))


def test_global_batch_one_process_is_batch_fn(clean_env):
    fn = ShardPlan(LlamaConfig.tiny(), Mesh(rank_grid({}, 1), torch.device("cpu"),
                                             rank=0)).tokens
    tokens = torch.arange(32).view(4, 8)
    assert torch.equal(global_batch(tokens, fn), fn(tokens))


_WORKER = r'''
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, sys.argv[3])  # repo root (the script runs from a tmp dir)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from yoda_scheduler_tpu_torch.models import LlamaConfig
from yoda_scheduler_tpu_torch.parallel import ShardPlan, make_mesh
from yoda_scheduler_tpu_torch.parallel.multihost import global_batch, initialize_multihost

ok = initialize_multihost(coordinator=f"localhost:{port}", num_processes=2,
                          process_id=pid, device="cpu")
assert ok is True and dist.get_world_size() == 2, dist.get_world_size()
mesh = make_mesh({"dp": 2}, device="cpu")
# each process feeds its 2 rows of the global [4, 4] batch
local = torch.full((2, 4), float(pid + 1))
piece = global_batch(local, ShardPlan(LlamaConfig.tiny(), mesh).tokens)
assert tuple(piece.shape) == (2, 4), piece.shape
psum = piece.sum()
dist.all_reduce(psum)
pieces = [torch.empty_like(piece) for _ in range(2)]
dist.all_gather(pieces, piece)
# rows: 2*4 ones + 2*4 twos = 24
print("RESULT", pid, float(torch.cat(pieces).sum()), float(psum), flush=True)
dist.destroy_process_group()
'''


def test_two_process_rendezvous_all_reduce_and_global_batch(tmp_path):
    """The twin of the JAX package's two-process test: two OS processes meet
    through initialize_multihost(coordinator=localhost:<port>), assemble
    the batch from process-local rows and agree on an all-reduce (gloo)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port), root],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
    results = {}
    for out, _ in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, total, psum = line.split()
                results[int(pid)] = (float(total), float(psum))
    assert results == {0: (24.0, 24.0), 1: (24.0, 24.0)}, results
