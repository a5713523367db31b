"""Fake telemetry publisher — synthetic TpuNodeMetrics for tests and benches.

The reference has no test fixtures of any kind (zero *_test.go files); its
telemetry comes only from a live NVML sniffer DaemonSet. This module is the
well-specified fake that SURVEY.md §5 calls for: it can build single-host TPU
nodes, multi-host v4-style pod slices with real ICI coordinates, GPU nodes for
the mixed-cluster scenario, and inject faults (stale heartbeats, unhealthy
chips, missing telemetry) to test the failure-detection path.
"""

from __future__ import annotations

import copy
import random
import threading
import time

from .schema import Chip, TpuNodeMetrics, GPU, TPU, HEALTHY
from .store import TelemetryStore
from ..topology.generations import generation as tpu_generation
from ..topology.gpus import gpu_model
from ..topology.torus import host_blocks

# v4 chip defaults, kept as module constants for existing callers
# (canonical per-generation numbers live in topology/generations.py).
V4_HBM_MB = 32_768
V4_CLOCK_MHZ = 940
V4_ICI_GBPS = 100
V4_MXUS = 4
V4_POWER_W = 170


def make_tpu_node(
    name: str,
    chips: int = 4,
    hbm_free_mb: int | None = None,
    hbm_total_mb: int | None = None,
    clock_mhz: int | None = None,
    unhealthy: int = 0,
    generation: str = "v4",
    **kw,
) -> TpuNodeMetrics:
    """A standalone single-host TPU node (e.g. one v4-8 host: 4 chips).
    Chip attributes default to the generation's catalog entry; explicit
    keyword values override per-field."""
    gen = tpu_generation(generation)
    total = hbm_total_mb if hbm_total_mb is not None else gen.hbm_mb
    free = hbm_free_mb if hbm_free_mb is not None else total
    chip_list = [
        Chip(
            index=i,
            hbm_free_mb=free,
            hbm_total_mb=total,
            clock_mhz=clock_mhz if clock_mhz is not None else gen.clock_mhz,
            ici_bandwidth_gbps=gen.ici_gbps,
            core_count=gen.mxus,
            power_w=gen.power_w,
            coords=(i % 2, i // 2, 0),
            health=("Unhealthy" if i < unhealthy else HEALTHY),
        )
        for i in range(chips)
    ]
    return TpuNodeMetrics(node=name, chips=chip_list, accelerator=TPU,
                          tpu_generation=gen.name, **kw)


def make_gpu_node(
    name: str,
    cards: int = 8,
    mem_free_mb: int | None = None,
    mem_total_mb: int | None = None,
    clock_mhz: int | None = None,
    model: str | None = None,
    **kw,
) -> TpuNodeMetrics:
    """A GPU node for the mixed-cluster scenario (BASELINE config #5); the
    schema is accelerator-agnostic, only `accelerator` differs.

    With `model` (a key of topology/gpus.py's catalog) the cards carry the
    model's totals as the NVML sniffer reads them (memory, maximum SM
    clock, CUDA cores, NVLink bandwidth, power limit) and the node's
    `tpu_generation` is the model; explicit keyword values override
    per-field. Without it the node is the catalog-less one of 40,000 MB
    cards the mixed-cluster scenarios have always used."""
    if model is None:
        total = 40_000 if mem_total_mb is None else mem_total_mb
        clock = 1410 if clock_mhz is None else clock_mhz
        bw, cores, power = 64, 108, 400  # NVLink-ish
    else:
        g = gpu_model(model)
        total = g.hbm_mb if mem_total_mb is None else mem_total_mb
        clock = g.max_sm_clock_mhz if clock_mhz is None else clock_mhz
        bw, cores, power = g.nvlink_gbps, g.cuda_cores, g.power_w
        kw.setdefault("tpu_generation", g.name)
    free = (40_000 if model is None else total) if mem_free_mb is None else mem_free_mb
    chip_list = [
        Chip(
            index=i,
            hbm_free_mb=free,
            hbm_total_mb=total,
            clock_mhz=clock,
            ici_bandwidth_gbps=bw,
            core_count=cores,
            power_w=power,
            coords=(i, 0, 0),
        )
        for i in range(cards)
    ]
    return TpuNodeMetrics(node=name, chips=chip_list, accelerator=GPU, **kw)


def make_gpu_pool(
    model: str,
    leaves: int,
    nodes_per_leaf: int,
    mem_free_mb: int | None = None,
) -> tuple[list[TpuNodeMetrics], dict[str, str]]:
    """One InfiniBand fabric of catalogued 8-card GPU nodes of `model`:
    `leaves` leaf switches of `nodes_per_leaf` nodes. The fabric is the
    nodes' slice (`<model>-fabric`, every node a host of it), so a gang may
    span its nodes and no other fabric's. -> the nodes and each node's
    leaf, the value of the Node label utils.labels.IB_LEAF_LABEL that the
    caller puts on the Node object. `mem_free_mb`: each card's free memory
    (default: all of it)."""
    hosts = leaves * nodes_per_leaf
    nodes: list[TpuNodeMetrics] = []
    leaf_of: dict[str, str] = {}
    for leaf in range(leaves):
        for j in range(nodes_per_leaf):
            name = f"{model}-l{leaf}-n{j}"
            nodes.append(make_gpu_node(name, cards=8, model=model,
                                       mem_free_mb=mem_free_mb,
                                       slice_id=f"{model}-fabric",
                                       host_index=leaf * nodes_per_leaf + j,
                                       num_hosts=hosts))
            leaf_of[name] = f"{model}-leaf-{leaf}"
    return nodes, leaf_of


def make_slice(
    slice_id: str,
    slice_topology: str,
    generation: str = "v4",
    node_prefix: str | None = None,
    hbm_free_mb: int | None = None,
) -> list[TpuNodeMetrics]:
    """A multi-host pod slice of any generation: one node per host, chips
    carrying real ICI coordinates that tile the slice torus.

    Packaging follows the generation catalog: v4/v5p hosts contribute a
    2x2x1 block of 4 chips to a 3-D torus (a v4-32 slice is 2x2x4 = 16 chips
    over 4 hosts); v5e/v6e hosts contribute a 2x4 block of 8 chips to a 2-D
    torus (a v5e-256 slice is 16x16 over 32 hosts). The topology string is
    validated against what the generation can form.
    """
    gen = tpu_generation(generation)
    shape = gen.validate_slice_topology(slice_topology)
    prefix = node_prefix or slice_id
    nodes: list[TpuNodeMetrics] = []
    blocks = host_blocks(shape, gen.host_block)
    for host_index, coords_block in enumerate(blocks):
        chips = [
            Chip(
                index=i,
                hbm_free_mb=hbm_free_mb if hbm_free_mb is not None else gen.hbm_mb,
                hbm_total_mb=gen.hbm_mb,
                clock_mhz=gen.clock_mhz,
                ici_bandwidth_gbps=gen.ici_gbps,
                core_count=gen.mxus,
                power_w=gen.power_w,
                coords=coords,
            )
            for i, coords in enumerate(coords_block)
        ]
        nodes.append(
            TpuNodeMetrics(
                node=f"{prefix}-host-{host_index}",
                chips=chips,
                accelerator=TPU,
                tpu_generation=gen.name,
                slice_id=slice_id,
                topology="x".join(str(d) for d in gen.host_block),
                slice_topology=slice_topology,
                host_index=host_index,
                num_hosts=len(blocks),
            )
        )
    return nodes


def make_v4_slice(
    slice_id: str,
    slice_topology: str = "2x2x4",
    node_prefix: str | None = None,
    hbm_free_mb: int = V4_HBM_MB,
) -> list[TpuNodeMetrics]:
    """A multi-host v4 pod slice (kept for existing callers; see make_slice)."""
    return make_slice(slice_id, slice_topology, generation="v4",
                      node_prefix=node_prefix, hbm_free_mb=hbm_free_mb)


class FakePublisher:
    """Continuously (or on demand) publishes synthetic telemetry to a store,
    with fault-injection hooks. Stands in for the per-node sniffer DaemonSet."""

    def __init__(self, store: TelemetryStore, seed: int = 0) -> None:
        self.store = store
        self.rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._frozen: set[str] = set()  # nodes whose heartbeat we stop (stale)

    # ----------------------------------------------------------- one-shot API
    def publish(self, *nodes: TpuNodeMetrics) -> None:
        for n in nodes:
            n.heartbeat = time.time()
            self.store.put(n)

    # -------------------------------------------------------- fault injection
    def freeze(self, node: str) -> None:
        """Stop heartbeating a node — its telemetry goes stale."""
        self._frozen.add(node)

    def unfreeze(self, node: str) -> None:
        self._frozen.discard(node)

    def set_duty(self, node: str, pct: float) -> None:
        """Report a measured MXU duty cycle on every chip of a node (a
        noisy-neighbour / busy-chip scenario for utilisation-aware scoring)."""
        m = self.store.get(node)
        if m is None:
            raise KeyError(node)
        m = copy.deepcopy(m)
        for c in m.chips:
            c.duty_cycle_pct = pct
        self.publish(m)

    def fail_chip(self, node: str, chip_index: int, health: str = "Unhealthy") -> None:
        m = self.store.get(node)
        if m is None:
            raise KeyError(node)
        # publish a mutated COPY: the store-held object may be mid-read by the
        # scheduler thread, and its aggregate memos key on generation — an
        # in-place edit would be a torn read pinned until the next publish
        m = copy.deepcopy(m)
        m.chips[chip_index].health = health
        self.publish(m)

    def drop(self, node: str) -> None:
        """Remove a node's telemetry entirely (sniffer crash)."""
        self.store.delete(node)

    # ------------------------------------------------------------- background
    def start(self, interval_s: float = 1.0, jitter_hbm_mb: int = 0) -> None:
        def loop() -> None:
            while not self._stop.wait(interval_s):
                for m in self.store.list():
                    if m.node in self._frozen:
                        continue
                    # snapshot semantics (a real sniffer builds a fresh reading
                    # each poll): never mutate the store-held object in place
                    m = copy.deepcopy(m)
                    if jitter_hbm_mb:
                        for c in m.chips:
                            delta = self.rng.randint(-jitter_hbm_mb, jitter_hbm_mb)
                            c.hbm_free_mb = max(0, min(c.hbm_total_mb, c.hbm_free_mb + delta))
                    self.publish(m)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
