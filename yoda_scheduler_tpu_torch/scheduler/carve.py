"""TorusCarver: gang demand -> contiguous host blocks on slice tori.

The geometry lives in topology/carve.py (pure integer functions over the
wrapped host grid); this module is the scheduler-side bridge. Per
pending gang it rebuilds each eligible slice's free-host coordinate set
from the cycle snapshot — the SAME eligibility gates as
GangPermit._maybe_plan (staleness waived under degraded mode,
accelerator/generation match, class-capacity minus foreign holds) so the
carve never claims a host the legacy planner would reject — and carves:

- single-slice: every slice with >= gang_size eligible hosts gets a
  carve of exactly gang_size; the winner maximises ICI bisection links
  (ties break on slice id, deterministic across processes).
- multi-slice: when no single slice can host the gang, one carve per
  slice. The anchor is the largest-carvable slice (fewest slices,
  largest chunks — the same DCN-hop minimisation as the legacy
  fewest-slices plan, but each chunk is a contiguous block instead of
  an arbitrary host set); every SUBSEQUENT slice is ranked by DCN
  distance to the already-chosen set first, carvable volume second —
  a gang split across slices pays its all-reduce over the data-center
  network, and two slices a rack apart beat two across the hall.
  Distance is a topology-free proxy derived from slice ids (see
  ``dcn_distance``): same pool prefix -> numeric suffix gap (slices
  are provisioned in adjacency order), different pools -> far. When
  every candidate is equidistant the order degenerates to exactly the
  legacy largest-carvable-first (the parity fence in
  tests/test_torus_carve.py).

The result is advisory narrowing, not a reservation: GangPermit
intersects its candidate nodes with the carved hosts and the ordinary
filter/score/reserve machinery still validates every bind. A carve that
cannot be satisfied (host lost mid-assembly) degrades to the legacy
behaviour instead of wedging the gang. Only built when the
torusPlacement knob is on — the off path constructs the exact legacy
plugin set, placements bit-identical (tests/test_torus_carve.py).
"""

from __future__ import annotations

from functools import lru_cache

from ..topology.carve import (
    bisection_gbps,
    carve_block,
    host_coord,
    host_grid,
    largest_carvable,
    wrap_of,
)
from ..topology.generations import generation
from ..topology.torus import parse_topology


@lru_cache(maxsize=1024)
def _grid_of(slice_topology: str, tpu_generation: str):
    """(host grid, wrap) for a slice's chip topology under its
    generation's host block, or None when the metadata cannot describe a
    torus (unknown generation, unparsable/indivisible shape)."""
    try:
        gen = generation(tpu_generation)
        grid = host_grid(parse_topology(slice_topology), gen.host_block)
    except (ValueError, KeyError):
        return None
    return grid, wrap_of(grid)


def slice_grid(m):
    """Host-grid view of a node's slice metadata, or None."""
    if not m.slice_topology or not m.tpu_generation:
        return None
    return _grid_of(m.slice_topology, m.tpu_generation)


def slice_host_coord(m, grid):
    """This host's coordinate on its slice's host grid (host_index is
    assigned in host_blocks enumeration order — telemetry/fake.py and
    the provisioner both derive it from the same tiling)."""
    return host_coord(m.host_index, grid)


# inter-pool hops dominate intra-pool ones by orders of magnitude on a
# DCN fabric; any finite suffix gap must still rank below a pool cross
_DCN_FAR = 1 << 20


def dcn_distance(sid_a: str, sid_b: str) -> int:
    """Inter-slice DCN distance PROXY. Telemetry carries no fabric
    coordinates (telemetry/schema.py), but slice ids encode provisioning
    adjacency: the capacity loop names a pool's slices with a shared
    pool prefix and a monotone numeric suffix, and consecutively
    provisioned slices land on adjacent fabric attachment points. Same
    prefix -> absolute suffix gap; anything else (foreign pools,
    non-numeric ids) -> ``_DCN_FAR``. Zero for identical ids."""
    if sid_a == sid_b:
        return 0
    pa, _, na = sid_a.rpartition("-")
    pb, _, nb = sid_b.rpartition("-")
    if pa and pa == pb and na.isdigit() and nb.isdigit():
        return abs(int(na) - int(nb))
    return _DCN_FAR


class TorusCarver:
    """Per-gang carve search over the snapshot's slice free-host grids."""

    def __init__(self, allocator) -> None:
        self.allocator = allocator
        self.metrics = None  # wired by Scheduler.__init__ when available

    # ------------------------------------------------------------ observability
    def _note(self, sid: str, grid, wrap, block, gen_name: str) -> None:
        if self.metrics is None:
            return
        try:
            gbps = bisection_gbps(block, grid, wrap,
                                  generation(gen_name).ici_gbps)
        except ValueError:
            gbps = 0.0
        self.metrics.inc("torus_carves_total")
        self.metrics.inc("torus_carve_bisection_gbps_sum", by=gbps)

    # ------------------------------------------------------------------ carve
    def carve_gang(self, state, pod, snapshot, spec, now, degraded):
        """{slice_id: frozenset(node names)} covering exactly gang_size
        hosts, every slice's share a contiguous block — or None when no
        geometric placement exists (the legacy planner then decides)."""
        slices = self._eligible_slices(state, pod, snapshot, spec, now,
                                       degraded)
        if not slices:
            return None
        single = self._carve_single(slices, spec)
        if single is not None:
            return single
        return self._carve_multi(slices, spec)

    def _eligible_slices(self, state, pod, snapshot, spec, now, degraded):
        """slice id -> (grid, wrap, generation, {coord: node name}) for
        hosts a gang member could land on. Mirrors _maybe_plan's gates
        exactly; additionally requires coherent torus metadata (every
        host of a slice reporting the same grid, unique host indices) —
        incoherent slices drop out and fall to the legacy path."""
        per_slice: dict = {}
        dead: set = set()
        for ni in snapshot.list():
            m = ni.metrics
            if m is None or not m.slice_id or m.slice_id in dead:
                continue
            if (now is not None and m.stale(now=now) and not degraded):
                continue
            if (spec.accelerator is not None
                    and m.accelerator != spec.accelerator):
                continue
            if (spec.tpu_generation is not None
                    and m.tpu_generation != spec.tpu_generation):
                continue
            gw = slice_grid(m)
            if gw is None:
                dead.add(m.slice_id)
                per_slice.pop(m.slice_id, None)
                continue
            grid, wrap = gw
            stats = self.allocator.class_stats(ni, spec.min_free_mb,
                                               spec.min_clock_mhz)
            hold = self.allocator.holds_for(spec, ni, pod.key, now=now)
            if stats.count - hold < spec.chips:
                continue
            entry = per_slice.setdefault(
                m.slice_id, (grid, wrap, m.tpu_generation, {}))
            coord = slice_host_coord(m, grid)
            if (entry[0] != grid or entry[2] != m.tpu_generation
                    or coord in entry[3]):
                dead.add(m.slice_id)
                per_slice.pop(m.slice_id, None)
                continue
            entry[3][coord] = ni.name
        return per_slice

    def _carve_single(self, slices, spec):
        best = None  # (neg links, sid, names, grid, wrap, block, gen)
        for sid in sorted(slices):
            grid, wrap, gen_name, hosts = slices[sid]
            if len(hosts) < spec.gang_size:
                continue
            out = carve_block(grid, frozenset(hosts), spec.gang_size,
                              wrap=wrap)
            if out is None:
                continue
            _, block, coords, links = out
            key = (-links, sid)
            if best is None or key < best[0]:
                names = frozenset(hosts[c] for c in coords)
                best = (key, sid, names, grid, wrap, block, gen_name)
        if best is None:
            return None
        _, sid, names, grid, wrap, block, gen_name = best
        self._note(sid, grid, wrap, block, gen_name)
        return {sid: names}

    def _carve_multi(self, slices, spec):
        """Greedy DCN-aware partition; every chunk an exact carve. The
        anchor slice is the largest carvable (ties on id); each further
        slice minimises (distance to the chosen set, -carvable, id) —
        the gang's cross-slice all-reduce spans the narrowest stretch
        of DCN fabric that still covers it. None unless >1 slice covers
        the gang completely."""
        caps = {sid: largest_carvable(grid, frozenset(hosts), wrap=wrap)
                for sid, (grid, wrap, _, hosts) in slices.items()}
        candidates = {sid for sid, cap in caps.items() if cap > 0}
        remaining = spec.gang_size
        result: dict = {}
        noted = []
        chosen: list = []
        while remaining > 0 and candidates:
            if not chosen:
                sid = min(candidates, key=lambda s: (-caps[s], s))
            else:
                sid = min(candidates,
                          key=lambda s: (min(dcn_distance(s, c)
                                             for c in chosen),
                                         -caps[s], s))
            candidates.discard(sid)
            grid, wrap, gen_name, hosts = slices[sid]
            free = frozenset(hosts)
            n = min(caps[sid], remaining)
            out = None
            # n below the largest carvable volume may have no fitting
            # factor shape (3 hosts on a 2x2 grid) — shrink to the
            # largest n that carves
            while n > 0 and out is None:
                out = carve_block(grid, free, n, wrap=wrap)
                if out is None:
                    n -= 1
            if out is None:
                continue
            _, block, coords, _ = out
            result[sid] = frozenset(hosts[c] for c in coords)
            noted.append((sid, grid, wrap, block, gen_name))
            chosen.append(sid)
            remaining -= len(coords)
        if remaining > 0 or len(result) <= 1:
            return None
        for sid, grid, wrap, block, gen_name in noted:
            self._note(sid, grid, wrap, block, gen_name)
        if self.metrics is not None:
            self.metrics.inc("torus_multislice_plans_total")
            self.metrics.observe(
                "torus_multislice_dcn_span",
                float(max(dcn_distance(a, b)
                          for a in result for b in result)))
        return result
