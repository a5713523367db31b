"""The cards the scheduler assigns reach the workload, in the port's own
image: `tpu/assigned-chips` through YODA_ASSIGNED_CHIPS to
CUDA_VISIBLE_DEVICES by NVML UUID (the fake NVML library of
test_torch_telemetry.py), the example pods passing the annotation in, and
every manifest of the port naming the image that `make build-gpu` builds
from the port's Dockerfile."""

import re
from pathlib import Path

import pytest
import torch
import yaml

from test_torch_telemetry import FakeCard, FakeNvml

from yoda_scheduler_tpu_torch.parallel import multihost
from yoda_scheduler_tpu_torch.telemetry import nvml
from yoda_scheduler_tpu_torch.utils.pod import ASSIGNED_CHIPS_LABEL, format_assigned_chips

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "yoda_scheduler_tpu_torch"
UUIDS = [f"GPU-{i:08x}-1111-2222-3333-44445555666{i}" for i in range(4)]


@pytest.fixture
def cards(monkeypatch):
    """A host of four cards behind the fake NVML, CUDA not started."""
    lib = FakeNvml([FakeCard(uuid=u) for u in UUIDS])
    monkeypatch.setattr(nvml, "_default", nvml.Nvml(lib))
    monkeypatch.setattr(multihost, "_cuda_started", lambda: False)
    return lib


# ------------------------------------------------------------ the helper
@pytest.mark.parametrize("raw,want", [
    ("0,0,0", [0]),
    ("3,0,0;1,0,0", [3, 1]),
    ("2,0,0;0,0,0;3,0,0", [2, 0, 3]),
])
def test_assigned_cards_become_visible_by_uuid_in_order(cards, raw, want):
    env = {multihost.ASSIGNED_ENV: raw}
    value = multihost.bind_assigned_cards(env)
    assert value == env["CUDA_VISIBLE_DEVICES"] == ",".join(UUIDS[i] for i in want)


def test_annotation_round_trips_through_the_binders_format(cards):
    """What the binder writes (`format_assigned_chips`) the helper reads in
    the same order."""
    raw = format_assigned_chips([(2, 0, 0), (1, 0, 0)])
    assert multihost.parse_assigned_cards(raw) == [2, 1]
    env = {multihost.ASSIGNED_ENV: raw}
    assert multihost.bind_assigned_cards(env) == f"{UUIDS[2]},{UUIDS[1]}"


@pytest.mark.parametrize("raw", [None, "", "  "])
def test_no_assignment_changes_nothing(cards, raw):
    env = {} if raw is None else {multihost.ASSIGNED_ENV: raw}
    before = dict(env)
    assert multihost.bind_assigned_cards(env) is None
    assert env == before and cards.calls == []


@pytest.mark.parametrize("raw", ["0,0", "a,0,0", "0,0,0;", "0,0,0,0", "-1,0,0",
                                 "1,0,0;1,0,0", "0;1;2"])
def test_malformed_annotation_raises(cards, raw):
    env = {multihost.ASSIGNED_ENV: raw}
    with pytest.raises(ValueError, match="malformed"):
        multihost.bind_assigned_cards(env)
    assert "CUDA_VISIBLE_DEVICES" not in env


@pytest.mark.parametrize("raw", ["0,1,0", "1,0,0;2,0,3"])
def test_tpu_coordinate_raises(cards, raw):
    with pytest.raises(ValueError, match="TPU coordinate"):
        multihost.bind_assigned_cards({multihost.ASSIGNED_ENV: raw})


@pytest.mark.parametrize("raw", ["4,0,0", "0,0,0;7,0,0"])
def test_card_past_nvmls_count_raises(cards, raw):
    env = {multihost.ASSIGNED_ENV: raw}
    with pytest.raises(ValueError, match="NVML counts 4 card"):
        multihost.bind_assigned_cards(env)
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_refused_once_cuda_has_started(cards, monkeypatch):
    monkeypatch.setattr(multihost, "_cuda_started", lambda: True)
    env = {multihost.ASSIGNED_ENV: "0,0,0"}
    with pytest.raises(RuntimeError, match="before CUDA starts"):
        multihost.bind_assigned_cards(env)
    assert "CUDA_VISIBLE_DEVICES" not in env


class _Libcuda:
    """libcuda's cuDeviceGetCount answering `code`."""

    def __init__(self, code):
        self.code = code

    def cuDeviceGetCount(self, count):
        return self.code


@pytest.mark.parametrize("lib,started", [
    (None, False),                                             # no libcuda on the host
    (_Libcuda(multihost.CUDA_ERROR_NOT_INITIALIZED), False),   # loaded, cuInit not run
    (_Libcuda(0), True),                                       # cuInit has run
])
def test_cuda_started_reads_libcuda(monkeypatch, lib, started):
    """torch.cuda.is_available() runs libcuda's cuInit without starting
    torch's CUDA state: the helper asks libcuda too."""
    def load(name):
        assert name == "libcuda.so.1"
        if lib is None:
            raise OSError(name)
        return lib

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.ctypes, "CDLL", load)
    assert multihost._cuda_started() is started


@pytest.mark.parametrize("device,binds", [("cuda", True), ("cpu", False)])
def test_initialize_multihost_binds_the_cards_before_cuda(monkeypatch, device, binds):
    calls = []
    monkeypatch.setattr(multihost, "bind_assigned_cards", lambda: calls.append(1))
    monkeypatch.setattr(multihost, "resolve_device", lambda d: calls.append(2) or
                        torch.device(d if d == "cpu" else "cpu"))
    for k in ("YODA_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_multihost(device=device) is False
    assert calls == ([1, 2] if binds else [2])


# ----------------------------------------------------------- manifests
def _containers(doc):
    spec = doc.get("spec", {})
    spec = spec.get("template", {}).get("spec", spec)
    return spec.get("containers", [])


def _docs(folder):
    return [(p.name, d) for p in sorted((PORT / folder).glob("*.yaml"))
            for d in yaml.safe_load_all(p.read_text()) if d]


def test_every_example_container_takes_the_annotation():
    seen = 0
    for name, doc in _docs("example"):
        for c in _containers(doc):
            env = {e["name"]: e for e in c.get("env", [])}
            ref = env[multihost.ASSIGNED_ENV]["valueFrom"]["fieldRef"]["fieldPath"]
            assert ref == f"metadata.annotations['{ASSIGNED_CHIPS_LABEL}']", name
            seen += 1
    # four llama members, the mixtral template, resnet, the two serving
    # containers (the Deployment's template and the batch pod)
    assert seen == 8


def build_gpu_tag() -> str:
    """The tag `make build-gpu` builds, with the Makefile's TAG."""
    make = (ROOT / "Makefile").read_text()
    tag = re.search(r"^TAG \?= (\S+)$", make, re.M).group(1)
    recipe = re.search(r"^build-gpu:\n\t(.+)$", make, re.M).group(1)
    assert "-f yoda_scheduler_tpu_torch/deploy/Dockerfile" in recipe
    return re.search(r"-t (\S+)", recipe).group(1).replace("$(TAG)", tag)


def test_every_manifest_names_the_ports_image():
    want = build_gpu_tag()
    assert want == "yoda-gpu-scheduler:0.1.0"
    images = [c["image"] for folder in ("deploy", "example")
              for _, doc in _docs(folder) for c in _containers(doc)]
    assert len(images) == 11 and set(images) == {want}


def test_ports_dockerfile_holds_the_port_and_no_jax():
    text = (PORT / "deploy" / "Dockerfile").read_text()
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert "jax" not in text.lower()
    copies = [ln.split()[1] for ln in lines if ln.startswith("COPY")]
    assert copies == ["yoda_scheduler_tpu_torch"]
    assert lines[0].startswith("FROM nvcr.io/nvidia/pytorch:")
    assert 'ENTRYPOINT ["python3", "-m", "yoda_scheduler_tpu_torch.cli"]' in lines
    # the kernels and the native planes build under the package's parent
    assert "WORKDIR /app" in lines and any("/app/build" in ln for ln in lines)
