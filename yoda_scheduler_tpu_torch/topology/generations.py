"""TPU generation catalog: per-generation chip specs and slice packaging.

The GPU reference treats every card as interchangeable (an unordered
CardList, reference pkg/yoda/filter/filter.go:22); TPU fleets are not like
that — v4/v5p slices are 3-D ICI tori built from 4-chip host boards, while
v5e/v6e slices are 2-D tori built from 8-chip hosts, and HBM/clock/ICI
numbers differ per generation. The scheduler needs this catalog to

- build faithful synthetic telemetry per generation (telemetry/fake.py),
- validate a slice topology string against what the generation can form,
- route pods that pin a generation (``tpu/generation`` label) in
  heterogeneous fleets, the TPU analogue of the mixed GPU+TPU partition
  (BASELINE config #5).

Numbers are public-spec approximations (HBM size is what placement
accounting needs to be exact about; clocks/power are representative): the
point is the *structure* — torus rank, host block shape, chips per host —
which is what placement quality depends on.
"""

from __future__ import annotations

from dataclasses import dataclass

from .torus import Shape, chips_in, parse_topology


@dataclass(frozen=True)
class TpuGeneration:
    name: str                 # "v4", "v5e", ...
    hbm_mb: int               # HBM per chip
    clock_mhz: int            # TensorCore clock (representative)
    ici_gbps: int             # per-link ICI bandwidth (GB/s, representative)
    mxus: int                 # systolic arrays per chip
    power_w: int              # per-chip TDP (representative)
    host_block: Shape         # chips one host contributes, as a torus block
    torus_rank: int           # 2 = flat torus (z always 1), 3 = cube torus
    max_chips: int            # largest pod slice

    @property
    def chips_per_host(self) -> int:
        return chips_in(self.host_block)

    def validate_slice_topology(self, topology: str | Shape) -> Shape:
        """Check a slice topology is one this generation can actually form:
        right torus rank, divisible into host blocks, within pod size.
        Returns the parsed shape; raises ValueError with the reason."""
        shape = parse_topology(topology) if isinstance(topology, str) else topology
        if self.torus_rank == 2 and shape[2] != 1:
            raise ValueError(
                f"{self.name} slices are 2-D tori; {shape} has z={shape[2]}"
            )
        if chips_in(shape) > self.max_chips:
            raise ValueError(
                f"{self.name} pods max out at {self.max_chips} chips; "
                f"{shape} has {chips_in(shape)}"
            )
        for dim, (s, h) in enumerate(zip(shape, self.host_block)):
            if s % h:
                raise ValueError(
                    f"{self.name} hosts contribute {self.host_block} blocks; "
                    f"slice {shape} axis {dim} ({s}) is not divisible by {h}"
                )
        return shape


# One entry per generation a GKE TPU fleet can contain today. Host blocks
# match the GKE machine shapes (ct4p-hightpu-4t topology 2x2x1,
# ct5p-hightpu-4t 2x2x1, ct5lp-hightpu-8t 2x4, ct6e-standard-8t 2x4).
GENERATIONS: dict[str, TpuGeneration] = {
    g.name: g
    for g in (
        TpuGeneration("v2", hbm_mb=8_192, clock_mhz=700, ici_gbps=62, mxus=1,
                      power_w=280, host_block=(2, 2, 1), torus_rank=2,
                      max_chips=256),
        TpuGeneration("v3", hbm_mb=16_384, clock_mhz=940, ici_gbps=81, mxus=2,
                      power_w=220, host_block=(2, 2, 1), torus_rank=2,
                      max_chips=1024),
        TpuGeneration("v4", hbm_mb=32_768, clock_mhz=940, ici_gbps=100, mxus=4,
                      power_w=170, host_block=(2, 2, 1), torus_rank=3,
                      max_chips=4096),
        TpuGeneration("v5e", hbm_mb=16_384, clock_mhz=940, ici_gbps=200, mxus=4,
                      power_w=140, host_block=(2, 4, 1), torus_rank=2,
                      max_chips=256),
        TpuGeneration("v5p", hbm_mb=97_280, clock_mhz=1100, ici_gbps=300, mxus=4,
                      power_w=350, host_block=(2, 2, 1), torus_rank=3,
                      max_chips=8960),
        TpuGeneration("v6e", hbm_mb=32_768, clock_mhz=1200, ici_gbps=400, mxus=4,
                      power_w=200, host_block=(2, 4, 1), torus_rank=2,
                      max_chips=256),
    )
}


def generation(name: str) -> TpuGeneration:
    """Look up a generation; raises ValueError naming the known ones."""
    try:
        return GENERATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown TPU generation {name!r}; known: {sorted(GENERATIONS)}"
        ) from None
