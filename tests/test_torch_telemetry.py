"""The port's card telemetry on the CPU: the NVML sniffer and the duty
sources, over a fake NVML library written in Python (two H100-like cards,
the second with its NVLink down), against the JAX package's schema and
duty sampler."""

import dataclasses
import random
import threading

import pytest
import torch

from yoda_scheduler_tpu.telemetry import duty as jax_duty
from yoda_scheduler_tpu.telemetry import fake as jax_fake
from yoda_scheduler_tpu.telemetry import schema as jax_schema
from yoda_scheduler_tpu_torch.telemetry import duty, nvml, schema, sniffer

MIB = 1 << 20
H100_TOTAL = 81_559 * MIB  # nvidia-smi's memory.total of an H100 80GB HBM3


@dataclasses.dataclass
class FakeCard:
    total: int = H100_TOTAL
    free: int = H100_TOTAL - 535 * MIB - 123
    max_sm_mhz: int = 1980
    current_sm_mhz: int = 345       # an idle card's clock: never reported
    cores: int = 16_896
    power_limit_mw: int = 700_000
    nvlink: tuple = (1,) * 18       # link states; () = no NVLink at all
    pcie: tuple = (5, 16)
    util_gpu: int = 0


class FakeNvml:
    """The NVML entry points the binding calls, filling their ctypes
    pointers as the NVIDIA driver's library would. `fail` maps an entry point to
    the NVML code it returns."""

    def __init__(self, cards, fail=None):
        self.cards = list(cards)
        self.fail = dict(fail or {})
        self.calls = []

    def _card(self, handle):
        return self.cards[handle.value - 1]

    def _ret(self, name):
        self.calls.append(name)
        return self.fail.get(name, nvml.NVML_SUCCESS)

    def nvmlInit_v2(self):
        return self._ret("nvmlInit_v2")

    def nvmlErrorString(self, code):
        return {999: b"Unknown Error"}.get(code, b"error")

    def nvmlDeviceGetCount_v2(self, n):
        n.contents.value = len(self.cards)
        return self._ret("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle.contents.value = index + 1
        return self._ret("nvmlDeviceGetHandleByIndex_v2")

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        c = self._card(handle)
        mem.contents.total, mem.contents.free = c.total, c.free
        mem.contents.used = c.total - c.free
        return self._ret("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetClockInfo(self, handle, kind, out):
        out.contents.value = self._card(handle).current_sm_mhz
        return self._ret("nvmlDeviceGetClockInfo")

    def nvmlDeviceGetMaxClockInfo(self, handle, kind, out):
        assert kind == nvml.NVML_CLOCK_SM
        out.contents.value = self._card(handle).max_sm_mhz
        return self._ret("nvmlDeviceGetMaxClockInfo")

    def nvmlDeviceGetNumGpuCores(self, handle, out):
        out.contents.value = self._card(handle).cores
        return self._ret("nvmlDeviceGetNumGpuCores")

    def nvmlDeviceGetPowerManagementLimit(self, handle, out):
        out.contents.value = self._card(handle).power_limit_mw
        return self._ret("nvmlDeviceGetPowerManagementLimit")

    def nvmlDeviceGetNvLinkState(self, handle, link, out):
        links = self._card(handle).nvlink
        if not links:
            return nvml.NVML_ERROR_NOT_SUPPORTED
        if link >= len(links):
            return nvml.NVML_ERROR_INVALID_ARGUMENT
        out.contents.value = links[link]
        return self._ret("nvmlDeviceGetNvLinkState")

    def nvmlDeviceGetMaxPcieLinkGeneration(self, handle, out):
        out.contents.value = self._card(handle).pcie[0]
        return self._ret("nvmlDeviceGetMaxPcieLinkGeneration")

    def nvmlDeviceGetMaxPcieLinkWidth(self, handle, out):
        out.contents.value = self._card(handle).pcie[1]
        return self._ret("nvmlDeviceGetMaxPcieLinkWidth")

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util.contents.gpu = self._card(handle).util_gpu
        util.contents.memory = 3
        return self._ret("nvmlDeviceGetUtilizationRates")


def two_cards():
    """Card 0: all 18 links up, 37% busy. Card 1: its NVLink down (every
    link inactive), a 350 W limit, on PCIe gen 5 x16."""
    return [FakeCard(util_gpu=37),
            FakeCard(free=40_000 * MIB, power_limit_mw=350_000, nvlink=(0,) * 18,
                     util_gpu=92)]


def sniff(cards, **kw):
    lib = FakeNvml(cards)
    return sniffer.local_node_metrics("h100-node", devices=nvml.Nvml(lib).devices(), **kw), lib


def test_each_field_maps_from_nvml():
    pool = duty.DutySamplerPool()
    m, lib = sniff(two_cards(), duty_of=pool.duty_of)
    assert (m.node, m.accelerator, m.tpu_generation, m.host_index, m.num_hosts) == (
        "h100-node", schema.GPU, "", 0, 1)
    c0, c1 = m.chips
    assert (c0.index, c0.coords, c1.index, c1.coords) == (0, (0, 0, 0), 1, (1, 0, 0))
    # MiB, floored, as nvidia-smi reports them
    assert (c0.hbm_total_mb, c0.hbm_free_mb) == (81_559, 81_559 - 536)
    assert (c1.hbm_total_mb, c1.hbm_free_mb) == (81_559, 40_000)
    # the maximum SM clock, not the idle card's current one
    assert c0.clock_mhz == c1.clock_mhz == 1980
    assert "nvmlDeviceGetClockInfo" not in lib.calls
    assert c0.core_count == 16_896
    assert (c0.power_w, c1.power_w) == (700, 350)  # mW -> W
    # 18 active links x 50 GB/s; card 1 falls back to PCIe gen 5 x16
    assert c0.ici_bandwidth_gbps == 900
    assert c1.ici_bandwidth_gbps == round(3.938 * 16) == 63
    assert c0.health == c1.health == schema.HEALTHY
    assert (c0.duty_cycle_pct, c1.duty_cycle_pct) == (37.0, 92.0)
    assert m.hbm_total_sum == 2 * 81_559 and m.chip_count == 2


def test_one_shot_snapshot_reads_no_duty():
    m, lib = sniff(two_cards())
    assert [c.duty_cycle_pct for c in m.chips] == [0.0, 0.0]
    assert "nvmlDeviceGetUtilizationRates" not in lib.calls


def test_partial_nvlink_and_no_nvlink():
    m, _ = sniff([FakeCard(nvlink=(1, 0) * 9), FakeCard(nvlink=(), pcie=(4, 8))])
    assert m.chips[0].ici_bandwidth_gbps == 9 * 50
    assert m.chips[1].ici_bandwidth_gbps == round(1.969 * 8)


@pytest.mark.parametrize("to_jax", [True, False])
def test_cr_round_trips_between_packages(to_jax):
    """A CR the port's sniffer publishes is one the JAX scheduler reads,
    and the other way round: same CRD identity, same fields."""
    assert (schema.CRD_GROUP, schema.CRD_VERSION, schema.CRD_PLURAL) == (
        jax_schema.CRD_GROUP, jax_schema.CRD_VERSION, jax_schema.CRD_PLURAL)
    if to_jax:
        src = sniff(two_cards(), duty_of=duty.DutySamplerPool().duty_of)[0]
        dst = jax_schema.TpuNodeMetrics.from_cr(src.to_cr())
    else:
        src = jax_fake.make_gpu_node("gpu-0", cards=8, mem_free_mb=12_345)
        dst = schema.TpuNodeMetrics.from_cr(src.to_cr())
    assert dataclasses.asdict(dst) == dataclasses.asdict(src)
    assert dst.to_cr() == src.to_cr()


def test_zero_cards_is_a_zero_chip_node():
    m, _ = sniff([])
    assert m.chips == [] and m.accelerator == schema.GPU and m.chip_count == 0


def test_missing_library_raises(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    with pytest.raises(nvml.NvmlError, match="cannot load libnvidia-ml-absent"):
        nvml.Nvml().devices()


def test_failed_call_raises_with_nvml_text():
    lib = FakeNvml([FakeCard()], fail={"nvmlDeviceGetMemoryInfo": 999})
    with pytest.raises(nvml.NvmlError, match=r"nvmlDeviceGetMemoryInfo: Unknown Error \(NVML 999\)"):
        sniffer.local_node_metrics("n", devices=nvml.Nvml(lib).devices())
    with pytest.raises(nvml.NvmlError, match="nvmlInit_v2"):
        nvml.Nvml(FakeNvml([], fail={"nvmlInit_v2": 999})).device_count()


def test_nvlink_error_other_than_absent_raises():
    lib = FakeNvml([FakeCard()], fail={"nvmlDeviceGetNvLinkState": 999})
    (card,) = nvml.Nvml(lib).devices()
    with pytest.raises(nvml.NvmlError, match="nvmlDeviceGetNvLinkState"):
        card.nvlink_active_links()


def test_fold_sample_matches_the_jax_sampler():
    """The estimator is the JAX package's, float for float, over one
    seeded sequence of probe latencies and clock times (idle stretches,
    busy bursts, window rotations)."""
    rng = random.Random(11)
    port, ref = duty.DutyCycleSampler(0, baseline_window_s=5.0), jax_duty.DutyCycleSampler(
        None, baseline_window_s=5.0)
    now = 100.0
    for i in range(2_000):
        busy = (i // 50) % 3 == 1
        dt = rng.uniform(2e-3, 40e-3) if busy else rng.uniform(40e-6, 90e-6)
        now += rng.uniform(0.05, 0.4)
        assert port.fold_sample(dt, now) == ref.fold_sample(dt, now)
        assert port.duty_pct == ref.duty_pct
        assert port._baseline_s == ref._baseline_s
    assert 0.0 < port.duty_pct < 100.0


def test_sampler_thread_joins_on_stop(monkeypatch):
    """start() runs the probe loop on a thread; stop() joins it and the
    sampler can start again. The probe is swapped for a CPU one here."""
    probes = []

    def cpu_probe(self):
        x = torch.zeros(())
        return (lambda v: probes.append(float(v + 1.0))), x

    monkeypatch.setattr(duty.DutyCycleSampler, "_make_probe", cpu_probe)
    s = duty.DutyCycleSampler(0, period_s=0.005)
    s.start()
    t = s._thread
    assert s.start()._thread is t  # a second start is a no-op
    deadline = threading.Event()
    while len(probes) < 3 and not deadline.wait(0.01):
        pass
    assert s.stop(timeout=5.0)
    assert not t.is_alive() and s._thread is None
    s.start()
    assert s.stop(timeout=5.0) and s._thread is None


def test_pool_reads_nvml_and_starts_no_thread():
    before = set(threading.enumerate())
    pool = duty.DutySamplerPool()
    cards = nvml.Nvml(FakeNvml(two_cards())).devices()
    assert [pool.duty_of(c) for c in cards] == [37.0, 92.0]
    assert pool.stop(timeout=1.0)
    assert set(threading.enumerate()) == before


def test_run_daemon_publishes_into_the_store():
    from yoda_scheduler_tpu_torch.telemetry import TelemetryStore

    store = TelemetryStore()
    cards = nvml.Nvml(FakeNvml(two_cards())).devices()
    stop = sniffer.run_daemon(store, "h100-node", interval_s=0.01, devices=cards)
    try:
        m = store.get("h100-node")
        assert m is not None and [c.duty_cycle_pct for c in m.chips] == [37.0, 92.0]
    finally:
        stop.set()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sniffer_reads_the_card(card):
    """On a card's host: one chip a card, totals as CUDA reports them (the
    GPU driver's reservation apart), the probe sampler's add on cuda:0."""
    m = sniffer.local_node_metrics()
    assert m.chip_count == torch.cuda.device_count()
    free, total = torch.cuda.mem_get_info(card)
    chip = m.chips[0]
    assert 0 <= chip.hbm_total_mb - total // MIB <= 1024
    assert chip.clock_mhz > 1000 and chip.power_w > 0 and chip.core_count > 0
    dt = duty.DutyCycleSampler(card.index).sample_once()
    assert 0.0 < dt < 1.0

