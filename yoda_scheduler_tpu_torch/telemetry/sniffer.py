"""Live telemetry sniffer: reads this host's NVIDIA cards through NVML.

The reference's telemetry daemon reads NVML on each node and publishes an
SCV CR (out-of-repo; consumed via the SCV dependency, reference
go.mod:6). The JAX package read its TPUs through JAX's device API; this
one reads the cards through NVML (`nvml.py`, ctypes over the NVIDIA driver's
`libnvidia-ml.so.1`) and opens no CUDA context, so it takes no memory
from the workloads on the cards it watches. A host whose NVML cannot be
loaded raises `nvml.NvmlError`: it is never reported as a host without
cards. A host whose NVML reports no card is a zero-chip node.

The node's `tpu_generation` names its GPU model from the catalog
(`topology/gpus.py`) when every card's NVML product name is one the
catalog lists under the same model; a host of an unlisted product, or of
mixed models, keeps `""`. The model rides that field so that the CR keeps
its wire form (the JAX package's schema reads it unchanged), and the
filter's generation predicate pins a pod to a model on every plane.
"""

from __future__ import annotations

import socket
import time

from . import nvml
from .schema import Chip, TpuNodeMetrics, GPU, HEALTHY
from ..topology.gpus import model_of_nvml_name

# NVLink rate a link, GB/s both directions: NVIDIA's data sheets give 900
# GB/s over 18 NVLink4 links (H100 SXM5), 600 over 12 NVLink3 links (A100
# SXM4), 300 over 6 NVLink2 links (V100 SXM2); NVML reads link states,
# not their rate.
NVLINK_GBPS_PER_LINK = 50
# PCIe rate a lane, GB/s one direction after line encoding, by generation
# (PCI-SIG: 2.5, 5, 8, 16, 32, 64 GT/s; 8b/10b to gen 2, 128b/130b from
# gen 3; gen 6's FLIT mode taken at its raw rate). Used for a card with
# no active NVLink.
PCIE_GBPS_PER_LANE = {1: 0.25, 2: 0.5, 3: 0.985, 4: 1.969, 5: 3.938, 6: 8.0}


def _mb(nbytes: int | None) -> int:
    return int((nbytes or 0) // (1024 * 1024))


def link_bandwidth_gbps(device) -> int:
    """The card's interconnect rate for the schema's `ici_bandwidth_gbps`:
    its active NVLink links times the rate a link, or its PCIe link's rate
    when no NVLink link is active."""
    links = device.nvlink_active_links()
    if links:
        return links * NVLINK_GBPS_PER_LINK
    gen, lanes = device.max_pcie_link()
    return int(round(PCIE_GBPS_PER_LANE.get(gen, 0.0) * lanes))


def host_model(devices) -> str:
    """The catalog model of every card on the host, or "" when there is no
    card, a card's product is not in the catalog, or the cards differ."""
    models = {model_of_nvml_name(d.name()) for d in devices}
    if len(models) != 1 or None in models:
        return ""
    return models.pop()


def local_node_metrics(node_name: str | None = None, duty_of=None,
                       devices=None, fabric: str = "",
                       fabric_hosts: int = 1) -> TpuNodeMetrics:
    """Snapshot this host's accelerator telemetry as a TpuNodeMetrics.

    `duty_of(device) -> float` supplies the duty cycle (0..100) per card
    — the long-running entry points (run_daemon, run_publisher) pass
    `DutySamplerPool.duty_of` (telemetry/duty.py, NVML's utilization);
    one-shot snapshots default to 0 (the score term treats unmeasured as
    neutral). `devices` overrides the card inventory (dependency
    injection: `nvml.NvmlDevice`s over a fake library in the tests);
    default is every card NVML enumerates on this host.

    `fabric` names the InfiniBand fabric the host is on and `fabric_hosts`
    its size; they ride the CR's `slice_id` and `num_hosts`, the unit a
    gang is placed within (a gang pod needs a node of a multi-host slice).
    NVML cannot see the fabric: the operator passes it (`cli sniff
    --fabric`). "" keeps the host standalone.
    """
    name = node_name or socket.gethostname()
    if devices is None:
        devices = nvml.devices()
    chips: list[Chip] = []
    for d in devices:
        mem = d.memory()
        chips.append(
            Chip(
                index=d.index,
                hbm_free_mb=_mb(mem.free),
                hbm_total_mb=_mb(mem.total),
                health=HEALTHY,
                clock_mhz=d.max_sm_clock_mhz(),
                ici_bandwidth_gbps=link_bandwidth_gbps(d),
                core_count=d.gpu_cores(),
                power_w=d.power_limit_mw() // 1000,
                coords=(d.index, 0, 0),
                duty_cycle_pct=float(duty_of(d)) if duty_of is not None
                else 0.0,
            )
        )
    return TpuNodeMetrics(
        node=name,
        chips=chips,
        accelerator=GPU,
        tpu_generation=host_model(devices),
        slice_id=fabric,
        host_index=0,
        num_hosts=fabric_hosts if fabric else 1,
        heartbeat=time.time(),
    )


def run_daemon(store, node_name: str | None = None, interval_s: float = 5.0,
               stop_event=None, devices=None):
    """Publish local metrics into a TelemetryStore on an interval — the
    in-process stand-in for the per-node sniffer DaemonSet. Long-running,
    so it reads each card's duty through a DutySamplerPool
    (telemetry/duty.py): the utilisation term in scoring works from the
    card's own counters, not fake data. `devices` narrows/overrides the
    probed inventory (same injection as local_node_metrics)."""
    import threading

    from .duty import DutySamplerPool

    stop = stop_event or threading.Event()
    pool = DutySamplerPool()

    def loop() -> None:
        while not stop.wait(interval_s):
            store.put(local_node_metrics(node_name, duty_of=pool.duty_of,
                                         devices=devices))
        pool.stop()

    store.put(local_node_metrics(node_name, duty_of=pool.duty_of,
                                 devices=devices))
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return stop
