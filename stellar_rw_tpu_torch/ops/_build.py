"""Build and load the port's CUDA kernels.

Each kernel source csrc/<name>.cu exposes a plain C entry point (shared
__device__ code lives in csrc/*.cuh). On first use it is compiled by nvcc
for sm_90a into build/kernels/ of the checkout,
keyed by a hash of its source and flags, and loaded with ctypes. A plain C
interface keeps each build to seconds: sources that include PyTorch's headers
take minutes.

Each entry point returns cudaGetLastError() after its launches;
`Kernel.launch` raises KernelLaunchError on a non-zero code. Nothing here falls back to a
plain version: a build that fails raises KernelBuildError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel's entry point reported a CUDA error."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                               "PATH); the CUDA kernels cannot be built")
    return found


class Kernel:
    """One kernel source: builds lazily, binds its C entry point, and counts
    the launches its wrapper makes (`launches`)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""      # ptxas -v: registers, shared memory, spills
        self._fn = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def _build(self) -> Path:
        # the headers a source may include are part of its key
        src = self.path.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"lib{self.path.stem}-{tag[:16]}.so"
        if so.exists():
            return so
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.path)]
        try:
            done = subprocess.run(cmd, check=True, capture_output=True,
                                  text=True, timeout=600)
            self.build_log = done.stderr
        except subprocess.CalledProcessError as e:
            raise KernelBuildError(
                f"nvcc failed on {self.source}:\n{e.stderr}") from e
        except subprocess.TimeoutExpired as e:
            raise KernelBuildError(f"nvcc timed out on {self.source}") from e
        os.replace(tmp, so)
        return so

    def fn(self):
        """The bound C entry point, building the library on first use."""
        with self._lock:
            if self._fn is None:
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(self._build()))
                self.build_seconds = time.perf_counter() - t0
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the entry point, count the launch and raise on a CUDA error."""
        code = self.fn()(*args)
        self.launches += 1
        if code != 0:
            raise KernelLaunchError(
                f"{self.symbol} ({self.source}) returned CUDA error {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device, asked once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def require_cuda(name: str, *tensors) -> None:
    """A kernel wrapper's check: every tensor lies on one CUDA device and is
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
