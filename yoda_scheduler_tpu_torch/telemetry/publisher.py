"""Conflict-aware publication of TpuNodeMetrics CRs to the API server.

The reference's running system had a live SCV publisher feeding the
scheduler (the SCV dependency, reference go.mod:6; RBAC for `scvs` at
reference deploy/yoda-scheduler.yaml:205-216) but kept its code out of
repo. This is the first-party equivalent the sniffer DaemonSet invokes
(`cli sniff --publish`): create-or-update with optimistic concurrency done
right — a PUT without the current resourceVersion is rejected by a real
API server, which is exactly the defect of an
inline-YAML publisher (it created once and then went permanently
stale).

Protocol per publish:
- GET the CR; 404 -> POST (a lost create race, 409, restarts the loop)
- carry the GET's resourceVersion into the PUT; 409 (someone else wrote
  between our GET and PUT) -> re-GET and retry, bounded.
"""

from __future__ import annotations

import logging
import threading
import time

from .schema import TpuNodeMetrics
from ..k8s.client import ApiError, KubeClient, METRICS_PATH

log = logging.getLogger("yoda-tpu.publisher")


class CrPublisher:
    def __init__(self, client: KubeClient, max_conflict_retries: int = 4) -> None:
        self.client = client
        self.max_conflict_retries = max_conflict_retries

    def publish(self, metrics: TpuNodeMetrics) -> None:
        """Create-or-update the node's CR; raises ApiError when conflicts
        persist past the retry budget (the next interval tick re-publishes
        fresher data anyway — per-node CRs have a single writer in steady
        state, so persistent conflicts mean a misconfigured second sniffer)."""
        path = f"{METRICS_PATH}/{metrics.node}"
        body = metrics.to_cr()
        last: ApiError | None = None
        for _ in range(self.max_conflict_retries + 1):
            try:
                current = self.client.request("GET", path)
            except ApiError as e:
                if e.status != 404:
                    raise
                # creates must NOT carry a resourceVersion (a previous PUT
                # attempt in this loop may have stamped one; the API server
                # rejects such creates)
                body.get("metadata", {}).pop("resourceVersion", None)
                try:
                    self.client.request("POST", METRICS_PATH, body)
                    return
                except ApiError as e2:
                    if e2.status != 409:  # 409: lost the create race; re-GET
                        raise
                    last = e2
                    continue
            rv = current.get("metadata", {}).get("resourceVersion")
            body.setdefault("metadata", {})["resourceVersion"] = rv
            try:
                self.client.request("PUT", path, body)
                return
            except ApiError as e:
                if e.status != 409:
                    raise
                last = e  # concurrent writer bumped the rv; re-GET
        raise ApiError("PUT", path, 409,
                       f"persistent conflicts: {last}".encode())


def run_publisher(client: KubeClient, node_name: str | None = None,
                  interval_s: float = 5.0,
                  stop_event: threading.Event | None = None,
                  once: bool = False, fabric: str = "",
                  fabric_hosts: int = 1) -> int:
    """The sniffer daemon's main loop: snapshot local telemetry, publish,
    sleep. Publish errors are logged and retried next tick — a transient
    API outage must not kill the DaemonSet pod (the staleness gate already
    protects the scheduler from frozen data). `fabric`/`fabric_hosts`:
    the InfiniBand fabric the host is on (sniffer.local_node_metrics)."""
    from .duty import DutySamplerPool
    from .sniffer import local_node_metrics

    pub = CrPublisher(client)
    stop = stop_event or threading.Event()
    # long-running publisher: measure duty cycles with the probe sampler
    # pool so the scheduler's utilisation term sees real busyness (a
    # --once snapshot has no sampling window; its duty reads 0 = neutral)
    pool = None if once else DutySamplerPool()
    duty_of = pool.duty_of if pool is not None else None
    published = 0
    try:
        while True:
            try:
                pub.publish(local_node_metrics(node_name, duty_of=duty_of, fabric=fabric,
                                               fabric_hosts=fabric_hosts))
                published += 1
            except Exception as e:
                log.warning("publish failed (next tick retries): %s", e)
            if once:
                return 0 if published else 1
            if stop.wait(interval_s):
                return 0
    finally:
        if pool is not None:
            pool.stop()
