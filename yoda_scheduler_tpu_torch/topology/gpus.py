"""GPU catalog: the NVIDIA models a GPU fleet is built from.

The TPU catalog (`generations.py`) describes torus slices; a GPU fleet has
no torus. What placement needs from a GPU model is its identity (a pod may
pin one through ``tpu/generation``, and the sniffer names a host's model
from NVML's product name), its card totals, and its NVLink domain: the set
of cards that reach each other over NVLink/NVSwitch without PCIe. On an
HGX board that is all 8 cards (NVSwitch); an H100 PCIe card reaches one
other card over its NVLink bridge.

Sources, NVIDIA's public data sheets:

- H100 Tensor Core GPU data sheet (SXM5 and PCIe columns): 80 GB HBM3 /
  HBM2e, 132 / 114 SMs (128 FP32 CUDA cores an SM), NVLink 900 GB/s (18
  NVLink4 links) / 600 GB/s over the bridge, TDP up to 700 W / 350 W, BF16
  Tensor Core 1,979 / 1,513 TFLOPS with sparsity (the dense rate is half,
  taken here to the whole TF/s below it).
- A100 Tensor Core GPU data sheet (80 GB SXM4 column): 108 SMs (64 FP32
  CUDA cores an SM), NVLink 600 GB/s (12 NVLink3 links), 400 W, BF16
  Tensor Core 312 TFLOPS dense.

The `h100-sxm5` row equals an H100 SXM5's own NVML readings: total memory
81,559 MiB, maximum SM clock 1,980 MHz, 16,896 CUDA cores, 18 active
NVLink links, a 700 W power limit. The other two rows are data-sheet
values that no card of ours has read: `hbm_mb` is what NVML reports for
80 GB on those boards, and their clocks are the data sheets' boost clocks.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GpuModel:
    name: str                    # the catalog's key, the node's tpu_generation
    nvml_names: tuple[str, ...]  # NVML product names (nvmlDeviceGetName)
    hbm_mb: int                  # a card's total memory as NVML reports it, MiB
    max_sm_clock_mhz: int        # NVML's maximum SM clock
    sms: int                     # streaming multiprocessors
    cuda_cores: int              # NVML's nvmlDeviceGetNumGpuCores
    links: int                   # NVLink links
    nvlink_gbps: int             # NVLink bandwidth a card, GB/s both directions
    nvlink_domain: int           # cards that reach each other over NVLink
    power_w: int                 # power limit at the board's maximum
    bf16_dense_tflops: float     # tensor-core peak, dense
    datasheet_only: bool = True  # False once a live card's NVML equals the row


GPUS: dict[str, GpuModel] = {
    g.name: g
    for g in (
        GpuModel("h100-sxm5", nvml_names=("NVIDIA H100 80GB HBM3",), hbm_mb=81_559,
                 max_sm_clock_mhz=1_980, sms=132, cuda_cores=16_896, links=18,
                 nvlink_gbps=900, nvlink_domain=8, power_w=700,
                 bf16_dense_tflops=989.0, datasheet_only=False),
        GpuModel("h100-pcie", nvml_names=("NVIDIA H100 PCIe",), hbm_mb=81_559,
                 max_sm_clock_mhz=1_755, sms=114, cuda_cores=14_592, links=12,
                 nvlink_gbps=600, nvlink_domain=2, power_w=350,
                 bf16_dense_tflops=756.0),
        GpuModel("a100-sxm4-80gb", nvml_names=("NVIDIA A100-SXM4-80GB",), hbm_mb=81_920,
                 max_sm_clock_mhz=1_410, sms=108, cuda_cores=6_912, links=12,
                 nvlink_gbps=600, nvlink_domain=8, power_w=400,
                 bf16_dense_tflops=312.0),
    )
}

_BY_NVML_NAME = {n: g.name for g in GPUS.values() for n in g.nvml_names}


def gpu_model(name: str) -> GpuModel:
    """Look up a model; raises ValueError naming the known ones."""
    try:
        return GPUS[name]
    except KeyError:
        raise ValueError(
            f"unknown GPU model {name!r}; known: {sorted(GPUS)}"
        ) from None


def model_of_nvml_name(product: str) -> str | None:
    """The catalog model NVML's product name belongs to, matched exactly;
    None for a product the catalog does not list (never a guess)."""
    return _BY_NVML_NAME.get(product)


def card_domain(model: GpuModel, coords) -> int:
    """The NVLink domain of the card at `coords` on its host. A card's
    coordinate is (NVML index, 0, 0), as the sniffer and telemetry.fake
    set it, and cards [k * nvlink_domain, (k + 1) * nvlink_domain) form
    domain k."""
    return coords[0] // model.nvlink_domain


def cards_by_domain(model: GpuModel, coords) -> dict[int, list]:
    """`coords` grouped by `card_domain`, each group sorted."""
    groups: dict[int, list] = {}
    for c in sorted(coords):
        groups.setdefault(card_domain(model, c), []).append(c)
    return groups
