"""GPU locality score: InfiniBand leaves and NVLink domains.

The GPU counterpart of the topology score's slice conservation
(plugins/topology.py). A GPU fleet has no ICI torus: the cards of one HGX
node reach each other over NVLink/NVSwitch, and nodes reach each other
over InfiniBand, where the nodes of one leaf switch talk without crossing
the spine. A gang's collectives are as fast as its slowest hop, so:

1. a gang member goes to the IB leaf of the members already placed or
   reserved (the anchor leaf);
2. the first member goes to a leaf that can hold the whole gang, and
   among those to a dented one before a pristine one, the more dented
   (used cards / cards) the better, so whole leaves stay free for large
   gangs; leaves that cannot hold it rank below, by how much of it they
   can hold. Pods that are not gang members pack into dented leaves the
   same way;
3. a multi-GPU pod prefers nodes where its cards fit inside one NVLink
   domain of free cards (topology/gpus.py: 8 cards on an HGX board, so
   always on an empty one; a bridged pair on H100 PCIe);
4. while a gang assembles (members reserved, waiting at Permit for the
   rest), its leaf's nodes that could take its outstanding members are
   promised to it when the leaf has none to spare: every other pod scores
   them lowest, and another gang counts that leaf's room without them.
   Otherwise the pods that pack into the dented leaf the gang chose would
   take the nodes its last members need, and the gang would spill.

The leaf is the Node label ``tpu/ib-leaf`` (utils/labels.IB_LEAF_LABEL);
a node without it is a leaf of its own. A node whose telemetry is not a
GPU node scores 0, so the plugin never reorders TPU nodes among
themselves. Scores are absolute (identity normalisation), in bands wide
enough that the leaf choice of a gang member outweighs the default
scorers: anchor leaf 100, a leaf that holds the rest of the gang 60-70,
any other leaf 0-20; outside gangs 0 (pristine leaf) or 15-30 (dented);
-20 for cards split across NVLink domains; -100 on a node promised to
another gang; times the plugin's weight.

Not in the default profile: a KubeSchedulerConfiguration enables it with
``plugins.score.enabled: [{name: gpu-locality}]``. Its scores read every
leaf's usage, so the pre-score pass walks every node each cycle and the
scores are recomputed (no score memo; a columnar `score_batch` on the
numpy plane's scoring, the scalar `score` on native cycles), and the
profile should score every feasible node (``percentageOfNodesToScore:
100``): the early-stop sample of 100 nodes may hold no node of the anchor
leaf.
"""

from __future__ import annotations

import time

try:  # the columnar score only; the scalar path needs no numpy
    import numpy as np
except Exception:  # pragma: no cover - numpy-less install
    np = None

from ..framework import CycleState, NodeInfo, PreScorePlugin, ScorePlugin, Status
from ...telemetry.schema import GPU, HEALTHY
from ...topology.gpus import GPUS, card_domain, cards_by_domain
from ...utils.labels import GANG_NAME_LABEL, IB_LEAF_LABEL, WorkloadSpec
from .allocator import ChipAllocator
from .gang import GangCoordinator

LEAF_VIEW_KEY = "gpu_leaf_view"

ANCHOR = 100.0          # the anchor leaf of a gang
FITS = 60.0             # a leaf that holds the rest of the gang ...
FITS_PACK = 10.0        # ... plus this times its packing term
PARTIAL = 20.0          # a leaf that holds part of it, times that part
SINGLE_PACK = 30.0      # a pod outside a gang: this times the packing term
SPLIT_DOMAIN = -20.0    # a multi-GPU pod whose cards cannot share a domain
HELD = -100.0           # a node promised to another gang's members


def packing(dent: float) -> float:
    """0 for a pristine leaf; 0.5-1 for a dented one, rising with its
    dent (used cards / cards): any dent outranks none, so a lightly used
    leaf still fills before a pristine one is opened."""
    return 0.0 if dent <= 0.0 else 0.5 + 0.5 * dent


def leaf_of(node: NodeInfo) -> str:
    """The node's IB leaf; a node without the label is a leaf of its own."""
    return node.labels.get(IB_LEAF_LABEL) or "node/" + node.name


class _LeafView:
    """One cycle's reading of the GPU leaves for one pod: each GPU node's
    leaf term (HELD for a node promised to another gang); the NVLink term
    is added per node at score time."""

    __slots__ = ("value", "held")

    def __init__(self, value: dict[str, float], held: set[str]):
        self.value = value
        self.held = held


class GpuLocalityScore(ScorePlugin, PreScorePlugin):
    name = "gpu-locality"
    normalize_kind = "identity"
    weight = 10

    def __init__(self, allocator: ChipAllocator, gangs: GangCoordinator | None,
                 max_age_s: float = 60.0) -> None:
        self.allocator = allocator
        self.gangs = gangs
        self.max_age = max_age_s
        # gang -> the spec of its members, for gangs whose members this
        # plugin has scored; dropped once none of its members waits
        self._gang_specs: dict[str, WorkloadSpec] = {}

    def equivalence_key(self, pod):
        """Batch-cycle contract: outside gangs (GangPermit votes NO_BATCH
        for those) the score reads only the spec and cluster state."""
        return ()

    @staticmethod
    def _relevant(spec: WorkloadSpec) -> bool:
        """Whether the pod can land on a GPU node at all."""
        if spec.accelerator == "tpu":
            return False
        return spec.tpu_generation is None or spec.tpu_generation in GPUS

    def _can_take(self, spec: WorkloadSpec, ni: NodeInfo, pod_key: str, now: float,
                  degraded) -> bool:
        """Whether the node can take one member of a gang of `spec` now
        (the filter's per-node predicates, as GangPermit plans with them)."""
        m = ni.metrics
        if spec.accelerator is not None and m.accelerator != spec.accelerator:
            return False
        if spec.tpu_generation is not None and m.tpu_generation != spec.tpu_generation:
            return False
        if m.stale(now=now, max_age_s=self.max_age) and not degraded:
            return False
        stats = self.allocator.class_stats(ni, spec.min_free_mb, spec.min_clock_mhz)
        return stats.count - self.allocator.holds_for(spec, ni, pod_key, now=now) >= spec.chips

    def _waiting_nodes(self, gang: str) -> tuple[int, set[str]]:
        """(members waiting at Permit, the nodes they reserved)."""
        keys = self.gangs.waiting_members(gang) if self.gangs is not None else set()
        nodes = {self.allocator.pending_node_of(k) for k in keys}
        nodes.discard(None)
        return len(keys), nodes

    def pre_score(self, state: CycleState, pod, feasible: list[NodeInfo]) -> Status:
        spec: WorkloadSpec = state.read("workload_spec")
        gang = spec.gang_name if spec.is_gang else None
        if gang is not None:
            self._gang_specs[gang] = spec
        if not self._relevant(spec) or not any(
                ni.metrics is not None and ni.metrics.accelerator == GPU
                for ni in feasible):
            state.write(LEAF_VIEW_KEY, None)
            return Status.success()
        snapshot = state.read_or("snapshot")
        nodes = snapshot.list() if snapshot is not None else feasible
        now = state.read_or("now")
        if now is None:
            now = time.time()
        degraded = state.read_or("degraded")
        # gangs other than this pod's that are assembling: members wait at
        # Permit on the nodes they reserved, the rest are still to place
        others: dict[str, tuple[WorkloadSpec, int, set[str]]] = {}
        for g in list(self._gang_specs):
            if g == gang:
                continue
            waiting, on = self._waiting_nodes(g)
            if not waiting:
                del self._gang_specs[g]
                continue
            others[g] = (self._gang_specs[g], waiting, on)
        reserved_on = self._waiting_nodes(gang)[1] if gang is not None else set()
        tracked = set(others) | ({gang} if gang is not None else set())
        # each other gang's anchor: the leaf of most of its reserved members
        anchor_of: dict[str, str] = {}
        for g, (_, _, on) in others.items():
            count: dict[str, int] = {}
            for name in on:
                ni = snapshot.get(name) if snapshot is not None else None
                if ni is not None:
                    lf = leaf_of(ni)
                    count[lf] = count.get(lf, 0) + 1
            if count:
                anchor_of[g] = max(count, key=lambda lf: (count[lf], lf))
        anchored: dict[str, list[str]] = {}  # leaf -> gangs anchored there
        for g, lf in anchor_of.items():
            anchored.setdefault(lf, []).append(g)
        used: dict[str, int] = {}
        total: dict[str, int] = {}
        leaf_by_node: dict[str, str] = {}
        fits: dict[str, int] = {}
        anchor: set[str] = set()
        bound: dict[str, int] = {}
        capable: dict[str, list[str]] = {}  # gang -> its anchor leaf's free nodes
        for ni in nodes:
            m = ni.metrics
            if m is None or m.accelerator != GPU:
                continue
            leaf = leaf_by_node[ni.name] = leaf_of(ni)
            n = len(m.chips)
            total[leaf] = total.get(leaf, 0) + n
            used[leaf] = used.get(leaf, 0) + n - len(self.allocator.free_coords(ni))
            if not tracked:
                continue
            for p in ni.pods:
                g = p.labels.get(GANG_NAME_LABEL)
                if g in tracked and not p.terminating:
                    bound[g] = bound.get(g, 0) + 1
                    if g == gang:
                        anchor.add(leaf)
            for g in anchored.get(leaf, ()):
                gspec, _, on = others[g]
                if ni.name not in on and self._can_take(gspec, ni, pod.key, now, degraded):
                    capable.setdefault(g, []).append(ni.name)
            if gang is None:
                continue
            if ni.name in reserved_on:
                anchor.add(leaf)
            if self._can_take(spec, ni, pod.key, now, degraded):
                fits[leaf] = fits.get(leaf, 0) + 1
        # another gang's outstanding members go to its anchor leaf: where
        # that leaf has no node to spare, its capable nodes are promised
        held: set[str] = set()
        for g, leaf in anchor_of.items():
            gspec, waiting, _ = others[g]
            need_g = gspec.gang_size - waiting - bound.get(g, 0)
            if need_g <= 0:
                continue
            spare = capable.get(g, [])
            if len(spare) <= need_g:
                held.update(spare)
            if leaf in fits:
                fits[leaf] = max(fits[leaf] - need_g, 0)
        need = 0  # members of this pod's gang still to place (1 at least)
        if gang is not None:
            need = max(spec.gang_size - bound.get(gang, 0) - len(reserved_on), 1)
        by_leaf: dict[str, float] = {}
        for leaf, t in total.items():
            pack = packing(used[leaf] / t if t else 0.0)
            if not need:
                by_leaf[leaf] = SINGLE_PACK * pack
            elif leaf in anchor:
                by_leaf[leaf] = ANCHOR
            elif fits.get(leaf, 0) >= need:
                by_leaf[leaf] = FITS + FITS_PACK * pack
            else:
                by_leaf[leaf] = PARTIAL * fits.get(leaf, 0) / need
        value = {name: (HELD if name in held else by_leaf[leaf])
                 for name, leaf in leaf_by_node.items()}
        state.write(LEAF_VIEW_KEY, _LeafView(value, held))
        return Status.success()

    def _domain_fits(self, spec: WorkloadSpec, node: NodeInfo) -> bool:
        """Whether the pod's cards fit inside one NVLink domain of the
        node's free cards (`gpus.card_domain`, as the allocator's pick). A
        node of no catalogued model is not judged."""
        m = node.metrics
        model = GPUS.get(m.tpu_generation)
        if model is None or spec.chips <= 1:
            return True
        if spec.chips > model.nvlink_domain:
            return False
        free = self.allocator.free_coords(node)
        groups = cards_by_domain(model, (c.coords for c in m.chips
                                         if c.health == HEALTHY and c.coords in free))
        return max(map(len, groups.values()), default=0) >= spec.chips

    def score(self, state: CycleState, pod, node: NodeInfo) -> tuple[float, Status]:
        view: _LeafView | None = state.read_or(LEAF_VIEW_KEY)
        if view is None or node.name not in view.value:
            return 0.0, Status.success()  # not a GPU node
        if node.name in view.held:
            return HELD, Status.success()
        spec: WorkloadSpec = state.read("workload_spec")
        # EDIT IN LOCKSTEP with score_batch: the same sum, so the columnar
        # form agrees bit for bit
        split = SPLIT_DOMAIN if not self._domain_fits(spec, node) else 0.0
        return view.value[node.name] + split, Status.success()

    def score_batch(self, state: CycleState, pod, table, rows):
        """Columnar form: the leaf terms gathered by row, the NVLink term
        from the free-card columns (`chip_free`, healthy and unclaimed, one
        column a card in NVML's order, so column i is the card at (i, 0, 0))
        summed by `gpus.card_domain`, the helper `_domain_fits` and the
        allocator's pick read."""
        if np is None:
            return None
        view: _LeafView | None = state.read_or(LEAF_VIEW_KEY)
        if view is None:
            return np.zeros(len(rows), dtype=np.float64)
        spec: WorkloadSpec = state.read("workload_spec")
        names = [table.name_at(r) for r in rows.tolist()]
        value = view.value
        base = np.fromiter((value.get(n, 0.0) for n in names), dtype=np.float64,
                           count=len(names))
        split = np.zeros(len(rows), dtype=np.float64)
        if spec.chips > 1:
            gen = table.gen[rows]
            for model_name, gid in table.intern_table().items():
                model = GPUS.get(model_name)
                sel = gen == gid
                if model is None or not sel.any():
                    continue
                if spec.chips > model.nvlink_domain:
                    fits = np.zeros(int(sel.sum()), dtype=bool)
                else:
                    free = table.chip_free[rows[sel]]
                    domain = np.array([card_domain(model, (i, 0, 0))
                                       for i in range(free.shape[1])])
                    one_hot = domain[:, None] == np.arange(domain.max() + 1)
                    per_domain = free.astype(np.int64) @ one_hot
                    fits = per_domain.max(axis=1) >= spec.chips
                split[np.flatnonzero(sel)[~fits]] = SPLIT_DOMAIN
        # non-GPU rows carry no value and no catalogued model: 0.0 + 0.0
        out = base + split
        if view.held:
            out[[i for i, n in enumerate(names) if n in view.held]] = HELD
        return out

    def normalize(self, state: CycleState, pod, scores) -> None:
        return None  # absolute semantics (module docstring)
