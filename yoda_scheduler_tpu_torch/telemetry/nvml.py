"""NVML, the NVIDIA driver's management library, through ctypes.

Only the calls the sniffer (`sniffer.py`) and the duty source (`duty.py`)
read. `libnvidia-ml.so.1` ships with the NVIDIA driver, so nothing is installed
for it. The library is loaded, and NVML initialised, on the first call
that needs it, never at import. A library that cannot be loaded raises
`NvmlError`: the caller must not read a host whose GPU driver it cannot see
as a host without cards.

Every output argument is passed as a `ctypes.pointer` (never `byref`), or,
for a string, as a `ctypes.create_string_buffer`, so that a fake library
written in Python (the tests') can fill it.
"""

from __future__ import annotations

import ctypes
import threading

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_INVALID_ARGUMENT = 2
NVML_ERROR_NOT_SUPPORTED = 3
NVML_CLOCK_SM = 1                # nvmlClockType_t
NVML_NVLINK_MAX_LINKS = 18       # nvml.h; an H100 SXM5 has all 18
NVML_FEATURE_ENABLED = 1         # nvmlEnableState_t
NVML_DEVICE_NAME_V2_BUFFER_SIZE = 96  # nvml.h: the longest product name + NUL
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96  # nvml.h: the longest UUID string + NUL


class NvmlError(RuntimeError):
    """An NVML call failed, or the library could not be loaded."""

    def __init__(self, call: str, code: int | None, text: str) -> None:
        super().__init__(f"{call}: {text}" + ("" if code is None else f" (NVML {code})"))
        self.call = call
        self.code = code


class Memory(ctypes.Structure):
    """nvmlMemory_t: bytes."""

    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period (1/6 s to 1 s,
    by product) in which a kernel ran (`gpu`) or memory was read or
    written (`memory`)."""

    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


_UINT_P = ctypes.POINTER(ctypes.c_uint)
_HANDLE = ctypes.c_void_p
# name -> (restype, argtypes), declared on the real library when it loads
_SIGNATURES = {
    "nvmlInit_v2": (ctypes.c_int, []),
    "nvmlErrorString": (ctypes.c_char_p, [ctypes.c_int]),
    "nvmlDeviceGetCount_v2": (ctypes.c_int, [_UINT_P]),
    "nvmlDeviceGetHandleByIndex_v2": (ctypes.c_int, [ctypes.c_uint,
                                                     ctypes.POINTER(_HANDLE)]),
    "nvmlDeviceGetName": (ctypes.c_int, [_HANDLE, ctypes.c_char_p, ctypes.c_uint]),
    "nvmlDeviceGetUUID": (ctypes.c_int, [_HANDLE, ctypes.c_char_p, ctypes.c_uint]),
    "nvmlDeviceGetMemoryInfo": (ctypes.c_int, [_HANDLE, ctypes.POINTER(Memory)]),
    "nvmlDeviceGetMaxClockInfo": (ctypes.c_int, [_HANDLE, ctypes.c_int, _UINT_P]),
    "nvmlDeviceGetNumGpuCores": (ctypes.c_int, [_HANDLE, _UINT_P]),
    "nvmlDeviceGetPowerManagementLimit": (ctypes.c_int, [_HANDLE, _UINT_P]),
    "nvmlDeviceGetNvLinkState": (ctypes.c_int, [_HANDLE, ctypes.c_uint, _UINT_P]),
    "nvmlDeviceGetMaxPcieLinkGeneration": (ctypes.c_int, [_HANDLE, _UINT_P]),
    "nvmlDeviceGetMaxPcieLinkWidth": (ctypes.c_int, [_HANDLE, _UINT_P]),
    "nvmlDeviceGetUtilizationRates": (ctypes.c_int, [_HANDLE, ctypes.POINTER(Utilization)]),
}


class Nvml:
    """One NVML library. `lib` injects a library object (the tests' fake);
    by default `LIBRARY` is loaded on the first call."""

    def __init__(self, lib=None) -> None:
        self._lib = lib
        self._ready = False
        self._lock = threading.Lock()

    def _library(self):
        with self._lock:
            if not self._ready:
                if self._lib is None:
                    try:
                        lib = ctypes.CDLL(LIBRARY)
                    except OSError as e:
                        raise NvmlError("dlopen", None,
                                        f"cannot load {LIBRARY} ({e}): the NVIDIA driver's "
                                        f"management library is not on this host") from None
                    for name, (restype, argtypes) in _SIGNATURES.items():
                        fn = getattr(lib, name)
                        fn.restype, fn.argtypes = restype, argtypes
                    self._lib = lib
                self._check("nvmlInit_v2", self._lib.nvmlInit_v2())
                self._ready = True
            return self._lib

    def _check(self, call: str, code: int) -> None:
        if code != NVML_SUCCESS:
            text = self._lib.nvmlErrorString(code)
            raise NvmlError(call, code, text.decode() if isinstance(text, bytes) else str(text))

    def call(self, name: str, *args) -> int:
        """Call `name`; raises NvmlError on any result but success."""
        code = getattr(self._library(), name)(*args)
        self._check(name, code)
        return code

    def call_status(self, name: str, *args) -> int:
        """Call `name` and return its result code (the caller decides)."""
        return getattr(self._library(), name)(*args)

    def device_count(self) -> int:
        n = ctypes.c_uint(0)
        self.call("nvmlDeviceGetCount_v2", ctypes.pointer(n))
        return n.value

    def devices(self) -> list["NvmlDevice"]:
        """Every card NVML enumerates, in NVML's index order."""
        return [NvmlDevice(self, i) for i in range(self.device_count())]


class NvmlDevice:
    """One card, by its NVML index. Each method is one NVML read."""

    def __init__(self, nvml: Nvml, index: int) -> None:
        self.nvml = nvml
        self.index = index
        handle = _HANDLE()
        nvml.call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.pointer(handle))
        self.handle = handle

    def _uint(self, name: str, *args) -> int:
        out = ctypes.c_uint(0)
        self.nvml.call(name, self.handle, *args, ctypes.pointer(out))
        return out.value

    def name(self) -> str:
        """The product name, e.g. "NVIDIA H100 80GB HBM3"."""
        buf = ctypes.create_string_buffer(NVML_DEVICE_NAME_V2_BUFFER_SIZE)
        self.nvml.call("nvmlDeviceGetName", self.handle, buf,
                       NVML_DEVICE_NAME_V2_BUFFER_SIZE)
        return buf.value.decode()

    def uuid(self) -> str:
        """The card's UUID, "GPU-" and 32 hex digits in five groups: the
        name CUDA_VISIBLE_DEVICES takes for the card, whatever CUDA's own
        index order."""
        buf = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        self.nvml.call("nvmlDeviceGetUUID", self.handle, buf,
                       NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        return buf.value.decode()

    def memory(self) -> Memory:
        mem = Memory()
        self.nvml.call("nvmlDeviceGetMemoryInfo", self.handle, ctypes.pointer(mem))
        return mem

    def max_sm_clock_mhz(self) -> int:
        """The SM clock's maximum, not its current value: an idle card
        clocks down to a few hundred MHz."""
        return self._uint("nvmlDeviceGetMaxClockInfo", NVML_CLOCK_SM)

    def gpu_cores(self) -> int:
        """CUDA cores (the reference's `Core` field)."""
        return self._uint("nvmlDeviceGetNumGpuCores")

    def power_limit_mw(self) -> int:
        return self._uint("nvmlDeviceGetPowerManagementLimit")

    def nvlink_active_links(self) -> int:
        """Links of the NVML_NVLINK_MAX_LINKS whose state is active. A card
        without NVLink, or a link index the card lacks, answers NOT_SUPPORTED
        or INVALID_ARGUMENT: counted as not active."""
        active = 0
        for link in range(NVML_NVLINK_MAX_LINKS):
            state = ctypes.c_uint(0)
            code = self.nvml.call_status("nvmlDeviceGetNvLinkState", self.handle, link,
                                         ctypes.pointer(state))
            if code in (NVML_ERROR_NOT_SUPPORTED, NVML_ERROR_INVALID_ARGUMENT):
                continue
            self.nvml._check("nvmlDeviceGetNvLinkState", code)
            active += state.value == NVML_FEATURE_ENABLED
        return active

    def max_pcie_link(self) -> tuple[int, int]:
        """(generation, lanes) the card's PCIe link can run at."""
        return (self._uint("nvmlDeviceGetMaxPcieLinkGeneration"),
                self._uint("nvmlDeviceGetMaxPcieLinkWidth"))

    def utilization_gpu(self) -> int:
        util = Utilization()
        self.nvml.call("nvmlDeviceGetUtilizationRates", self.handle, ctypes.pointer(util))
        return util.gpu


_default = Nvml()


def devices() -> list[NvmlDevice]:
    """This host's cards through the process's one NVML library."""
    return _default.devices()
