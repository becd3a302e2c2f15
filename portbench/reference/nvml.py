"""The benchmark's own reading of the card: a small NVML reader over
ctypes and one ``nvidia-smi`` query, kept apart from the program's reader
so that the labels are held against a second witness. NVML's init loads
the driver but makes no CUDA context, so reading it holds no device
memory. Imports nothing of the program.
"""

import ctypes
import subprocess
from dataclasses import dataclass
from typing import List, Optional, Tuple

NVML_LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


@dataclass(frozen=True)
class Gpu:
    name: str
    memory_total_bytes: int
    compute_capability: Tuple[int, int]
    mig_capable: bool


@dataclass(frozen=True)
class Node:
    driver_version: str
    cuda_driver_version: int  # 1000 * major + 10 * minor
    gpus: Tuple[Gpu, ...]


class NvmlError(RuntimeError):
    pass


class Nvml:
    """One NVML session: ``with Nvml() as n: ...``."""

    def __init__(self):
        self._lib = ctypes.CDLL(NVML_LIBRARY)

    def _call(self, name: str, *args) -> int:
        return int(getattr(self._lib, name)(*args))

    def _check(self, name: str, *args) -> None:
        rc = self._call(name, *args)
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{name} returned {rc}")

    def __enter__(self):
        self._check("nvmlInit_v2")
        return self

    def __exit__(self, *exc):
        self._call("nvmlShutdown")
        return False

    def _handle(self, index: int):
        handle = ctypes.c_void_p()
        self._check("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index), ctypes.byref(handle))
        return handle

    def count(self) -> int:
        n = ctypes.c_uint(0)
        self._check("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def memory(self, index: int) -> _Memory:
        mem = _Memory()
        self._check("nvmlDeviceGetMemoryInfo", self._handle(index), ctypes.byref(mem))
        return mem

    def used_bytes(self) -> List[int]:
        """Each GPU's used memory, device-wide: every process's share."""
        return [self.memory(i).used for i in range(self.count())]

    def node(self) -> Node:
        buf = ctypes.create_string_buffer(96)
        self._check("nvmlSystemGetDriverVersion", buf, ctypes.c_uint(len(buf)))
        driver = buf.value.decode()
        cuda = ctypes.c_int(0)
        self._check("nvmlSystemGetCudaDriverVersion_v2", ctypes.byref(cuda))
        gpus = []
        for i in range(self.count()):
            h = self._handle(i)
            name = ctypes.create_string_buffer(96)
            self._check("nvmlDeviceGetName", h, name, ctypes.c_uint(len(name)))
            major, minor = ctypes.c_int(0), ctypes.c_int(0)
            self._check("nvmlDeviceGetCudaComputeCapability", h,
                        ctypes.byref(major), ctypes.byref(minor))
            current, pending = ctypes.c_uint(0), ctypes.c_uint(0)
            rc = self._call("nvmlDeviceGetMigMode", h, ctypes.byref(current), ctypes.byref(pending))
            if rc not in (NVML_SUCCESS, NVML_ERROR_NOT_SUPPORTED):
                raise NvmlError(f"nvmlDeviceGetMigMode returned {rc}")
            gpus.append(Gpu(name.value.decode(), self.memory(i).total,
                            (major.value, minor.value), rc == NVML_SUCCESS))
        return Node(driver, cuda.value, tuple(gpus))


def smi_query(fields: str) -> List[List[str]]:
    """``nvidia-smi --query-gpu=<fields>``, one list of values per GPU."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [[v.strip() for v in line.split(",")] for line in out.strip().splitlines()]


def power_line() -> Optional[str]:
    """The card's name and power limit, as every number kept beside it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
