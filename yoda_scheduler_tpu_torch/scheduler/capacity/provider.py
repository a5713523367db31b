"""Capacity provider contract: how nodes enter and leave the fleet.

The provisioner control loop (provisioner.py) never touches the cluster
backend directly — every node add/remove goes through a *provider* (the
cloud API analogue) speaking three verbs:

- ``request(pool, template, now) -> ProvisionRequest``: ask for one
  node of a pool's shape (the PROVIDER assigns the request id, so two
  fleet replicas sharing a provider can never collide). Asynchronous by
  nature: providers take seconds-to-minutes, answer out of order, deny
  (stockout / quota), or lose the response entirely.
- ``poll(now)``: completed results since the last poll, on the engine's
  injectable clock. A result references its request id; an arriving node
  that matches NO live request (the request was written off, or another
  fleet replica issued it before crashing) is the ADOPTION case the
  provisioner reconciles by membership, never by response.
- ``release(node, pool)``: return an (empty) node to the provider.

The only production-shaped implementation today is chaos.py's
``SimulatedProvider`` (seeded latency + the four provider fault kinds);
it composes with the two *backend adapters* here, which own the
mechanics of making a node real:

- ``FakeBackend``: in-memory FakeCluster — telemetry put + node-meta
  set, publishing NODE_ADDED through the ordinary subscribe surface.
- ``WireBackend``: a real/fake apiserver via KubeClient — the node
  object and its TpuNodeMetrics CR are POSTed and the REFLECTOR brings
  them back through the same watch intake every other node uses, so
  columnar shard rebuilds and NODE_ADDED queue hints fire for free.

Either way, a provisioned node is indistinguishable from a hand-added
one by the time the scheduler sees it — the provisioner's whole state
about it is the two node labels below.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# node labels stamped on every provisioned node: the pool it belongs to
# and the managed marker membership reconciliation keys on. Pod-side
# scv/* labels are workload contract; these two live on NODE objects.
POOL_LABEL = "scv/pool"
MANAGED_LABEL = "scv/provisioned"


@dataclass(frozen=True)
class NodeTemplate:
    """The shape one pool provisions: every node the provider creates
    for the pool is a clone of this. ``pool`` doubles as the node-name
    prefix (names are ``<pool>-<seq>``, so columnar.pool_of groups them
    with hand-built members of the same pool).

    ``hosts`` > 1 makes this a SLICE pool: one capacity request
    provisions a whole multi-host ICI slice (``slice_topology``
    required, validated against the generation catalog) — the unit TPU
    clouds actually sell, and the only thing that can satisfy a parked
    gang (gangs pin to one slice). Slice pools serve gang demand;
    single-host pools serve everything else."""

    pool: str
    generation: str = "v4"
    chips: int = 4
    accelerator: str = "tpu"
    hbm_mb: int | None = None      # per-chip override; None = catalog
    clock_mhz: int | None = None
    min_nodes: int = 0
    max_nodes: int = 64
    hosts: int = 1
    slice_topology: str | None = None

    def satisfies(self, spec) -> bool:
        """Can ONE provisioning unit of this shape host a pod of
        `spec`? The demand router uses this to map an unschedulable
        shape onto a pool. Gang members route to slice pools whose
        host count covers the gang; everything else routes to
        single-host pools."""
        if spec.is_gang:
            if self.hosts < max(spec.gang_size, 2):
                return False
        elif self.hosts > 1:
            return False  # whole slices are never provisioned for singles
        if spec.accelerator is not None \
                and spec.accelerator != self.accelerator:
            return False
        if spec.tpu_generation is not None \
                and spec.tpu_generation != self.generation:
            return False
        if spec.chips > self.chips:
            return False
        if spec.topology is not None:
            from ...topology.torus import parse_topology

            dims = parse_topology(spec.topology)
            vol = 1
            for d in dims:
                vol *= d
            if vol > self.chips:
                return False
        if spec.min_free_mb or spec.min_clock_mhz:
            from ...topology.generations import generation as gen_of

            cat = gen_of(self.generation)
            hbm = self.hbm_mb if self.hbm_mb is not None else cat.hbm_mb
            clock = (self.clock_mhz if self.clock_mhz is not None
                     else cat.clock_mhz)
            if spec.min_free_mb > hbm or spec.min_clock_mhz > clock:
                return False
        return True


@dataclass
class ProvisionRequest:
    id: int
    pool: str
    template: NodeTemplate
    requested_at: float


@dataclass
class ProvisionResult:
    request_id: int
    pool: str
    outcome: str                  # "ready" | "stockout" | "quota-denied"
    node: str | None = None       # primary name when outcome == "ready"
    nodes: tuple = ()             # every host (== (node,) for hosts=1)
    detail: str = ""


def build_metrics(template: NodeTemplate, name: str, now: float) -> list:
    """TpuNodeMetrics for one freshly provisioned unit of this shape —
    a single standalone host, or every host of one slice (hosts > 1)."""
    from ...telemetry.fake import make_gpu_node, make_slice, make_tpu_node

    if template.hosts > 1:
        if not template.slice_topology:
            raise ValueError(
                f"pool {template.pool}: hosts={template.hosts} needs a "
                "slice_topology")
        out = make_slice(name, template.slice_topology,
                         generation=template.generation,
                         hbm_free_mb=template.hbm_mb)
        for m in out:
            m.heartbeat = now
        return out
    if template.accelerator == "gpu":
        m = make_gpu_node(name, cards=template.chips)
    else:
        m = make_tpu_node(
            name, chips=template.chips,
            generation=template.generation,
            hbm_total_mb=template.hbm_mb,
            clock_mhz=template.clock_mhz)
    m.heartbeat = now
    return [m]


class FakeBackend:
    """Node add/remove against the in-memory FakeCluster family:
    telemetry first (so the node is schedulable the instant NODE_ADDED
    fires), then node meta carrying the pool/managed labels. Removal
    routes any orphaned pods back through ``orphan_router`` (the engine
    or fleet submit) so a yanked node never loses a pod."""

    def __init__(self, cluster, orphan_router=None) -> None:
        self.cluster = cluster
        self.orphan_router = orphan_router

    def create(self, name: str, template: NodeTemplate,
               now: float) -> list[str]:
        names = []
        for m in build_metrics(template, name, now):
            self.cluster.telemetry.put(m)
            self.cluster.set_node_meta(
                m.node,
                labels={POOL_LABEL: template.pool, MANAGED_LABEL: "1"})
            names.append(m.node)
        return names

    def destroy(self, name: str) -> list:
        orphans = self.cluster.remove_node(name)
        self.cluster.telemetry.delete(name)
        if self.orphan_router is not None:
            for p in orphans:
                p.labels.pop("tpu/assigned-chips", None)
                self.orphan_router(p)
        return orphans

    def heartbeat(self, name: str, now: float) -> None:
        """Refresh a provisioned node's telemetry heartbeat (the fake
        backend has no sniffer DaemonSet to do it)."""
        m = self.cluster.telemetry.get(name)
        if m is not None:
            m.heartbeat = now
            self.cluster.telemetry.put(m)


class WireBackend:
    """Node add/remove over the apiserver wire (KubeClient): POST the
    node object + its TpuNodeMetrics CR, DELETE both on destroy. The
    scheduler never sees these writes directly — its reflector watch
    delivers them through the ordinary intake (the whole point of the
    wire path: provisioned nodes exercise the same change-log/columnar/
    queue-hint machinery as any other membership change)."""

    def __init__(self, client) -> None:
        from ...telemetry.publisher import CrPublisher

        self.client = client
        self._publisher = CrPublisher(client)

    def create(self, name: str, template: NodeTemplate,
               now: float) -> list[str]:
        names = []
        for m in build_metrics(template, name, now):
            self.client.create_node(
                m.node,
                labels={POOL_LABEL: template.pool, MANAGED_LABEL: "1"})
            self._publisher.publish(m)
            names.append(m.node)
        return names

    def destroy(self, name: str) -> list:
        # apiserver semantics: pods on a deleted node are the node
        # controller's problem (they go Pending and re-enter through
        # the pod watch) — no local orphan routing
        self.client.delete_node(name)
        try:
            from ...k8s.client import METRICS_PATH

            self.client.request("DELETE", f"{METRICS_PATH}/{name}")
        except Exception:
            pass  # CR cleanup is best-effort; a stale CR ages out
        return []

    def heartbeat(self, name: str, now: float) -> None:
        return None  # a real fleet's sniffer owns wire heartbeats
