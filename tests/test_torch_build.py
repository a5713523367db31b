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


def _ptxas_log(kernels):
    """nvcc's -Xptxas -v lines for `kernels` as it names them in the
    anonymous namespace of csrc/*.cu."""
    lines = []
    for name in kernels:
        lines += [f"ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__d1b3ab8b_12_"
                  f"flash_bwd_cu_5c3f8a45{len(name)}{name}E14CUtensorMap_stS0_S0_S0_PKfS2_"
                  "P13__nv_bfloat16iiiiiiif' for 'sm_90a'",
                  "ptxas info    : Used 128 registers, used 1 barriers",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]
    return "\n".join(lines)


def test_every_wgmma_kernel_is_read_from_ptxas():
    """The smoke's phase 1 and `ops.variants` both find each wgmma kernel
    of chip_smoke.WGMMA_KERNELS in ptxas's output, the head-dim-64,
    head-dim-96, head-dim-80, head-dim-100 and head-dim-256 ones (the
    forward, dQ and dK/dV at each) and the eighteen fp16 kernels (every
    kernel at head dims 128, 100, 64, 256, 96 and 80) among them; variants
    leaves out the other kernels."""
    import chip_smoke

    log = _ptxas_log(chip_smoke.WGMMA_KERNELS + ("flash_bwd_dq_mma_kernel",))
    summary = chip_smoke.ptxas_summary(log)
    assert {k for k in summary if "wgmma" in k} == set(chip_smoke.WGMMA_KERNELS)
    assert {"flash_bwd_dq_wgmma64_kernel", "flash_fwd_wgmma96_kernel",
            "flash_bwd_dkv_wgmma96_kernel", "flash_bwd_dq_wgmma96_kernel",
            "flash_fwd_wgmma_f16_kernel", "flash_bwd_dq_wgmma_f16_kernel",
            "flash_bwd_dkv_wgmma_f16_kernel", "flash_fwd_wgmma80_kernel",
            "flash_fwd_wgmma100_kernel", "flash_bwd_dq_wgmma100_kernel",
            "flash_bwd_dkv_wgmma100_kernel", "flash_fwd_wgmma256_kernel",
            "flash_fwd_wgmma64_f16_kernel", "flash_bwd_dq_wgmma80_kernel",
            "flash_bwd_dkv_wgmma80_kernel", "flash_bwd_dq_wgmma256_kernel",
            "flash_bwd_dkv_wgmma256_kernel", "flash_bwd_dq_wgmma64_f16_kernel",
            "flash_bwd_dkv_wgmma64_f16_kernel", "flash_fwd_wgmma80_f16_kernel",
            "flash_fwd_wgmma100_f16_kernel", "flash_bwd_dq_wgmma100_f16_kernel",
            "flash_bwd_dkv_wgmma100_f16_kernel", "flash_fwd_wgmma96_f16_kernel",
            "flash_fwd_wgmma256_f16_kernel", "flash_bwd_dq_wgmma256_f16_kernel",
            "flash_bwd_dkv_wgmma256_f16_kernel", "flash_bwd_dq_wgmma96_f16_kernel",
            "flash_bwd_dkv_wgmma96_f16_kernel", "flash_bwd_dq_wgmma80_f16_kernel",
            "flash_bwd_dkv_wgmma80_f16_kernel"} <= set(chip_smoke.WGMMA_KERNELS)
    assert len(chip_smoke.WGMMA_KERNELS) == 36
    kept = variants.wgmma_ptxas(log)
    for name in chip_smoke.WGMMA_KERNELS:
        assert any(name in ln for ln in kept), name
    assert not any("mma_kernel" in ln and "wgmma" not in ln for ln in kept)
    assert sum("spill" in ln for ln in kept) == len(chip_smoke.WGMMA_KERNELS)
