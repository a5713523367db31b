"""The port's kernel build (`ops/_build.py`) with a stand-in for nvcc on the
CPU: nvcc's output is kept beside each library and read back when the
library is found built, and a library without its output is built again."""

import sys

import pytest

from yoda_scheduler_tpu_torch.ops import _build, variants

FAKE_NVCC = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
Path(args[args.index("-o") + 1]).write_text("lib")
with open(sys.argv[0] + ".calls", "a") as f:
    f.write("x")
print("ptxas info    : Compiling entry function '_Z20flash_bwd_dq_wgmma_kernelv' for 'sm_90a'")
print("ptxas info    : Used 168 registers")
print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc.py"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_FLAGS", [])
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_info", {})
    return nvcc.with_name("nvcc.py.calls")


def _fresh_process(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_info", {})


def test_a_cached_build_reads_back_its_ptxas_output(fake_build, monkeypatch):
    (lib,) = _build.load("k")
    first = _build.build_info["k"]
    assert isinstance(first["seconds"], float)
    assert "0 bytes spill stores" in first["log"]
    _fresh_process(monkeypatch)
    assert _build.load("k") == [lib]
    assert _build.build_info["k"] == {"seconds": None, "log": first["log"]}
    assert fake_build.read_text() == "x"  # nvcc ran once


def test_a_library_without_its_output_is_built_again(fake_build, monkeypatch):
    (lib,) = _build.load("k")
    _fresh_process(monkeypatch)
    _build._target("k").with_suffix(".log").unlink()
    assert _build.load("k") == [lib]
    assert isinstance(_build.build_info["k"]["seconds"], float)
    assert fake_build.read_text() == "xx"
    assert "Used 168 registers" in "".join(variants.wgmma_ptxas(
        _build.build_info["k"]["log"]))
