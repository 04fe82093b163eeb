"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launch functions that return
``cudaGetLastError()``; it compiles on first use into its own shared library
under ``build/repro_torch/`` at the repository root, named by a hash of its
source and flags, so an edited source rebuilds and an unchanged one loads.
:func:`build` compiles several sources at once, one ``nvcc`` process each.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile each named source that is not built yet, all in parallel.

    Returns ``{name: {"seconds": wall time, "log": ptxas resource report}}``
    for the sources compiled now; raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


class CudaKernel:
    """One C launch function of a CUDA source, with its launch count.

    ``launches`` counts the launches this wrapper made (a plain int that a
    caller may reset); a non-zero return from the C function, which is
    ``cudaGetLastError()`` right after the launch, raises.  It launches on
    the device's current stream, read raw per call (a cached handle would
    miss a caller's ``torch.cuda.stream`` context), and switches the current
    device only when ``device`` is not already current."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        current = torch.cuda.current_device()
        if device.index not in (None, current):
            with torch.cuda.device(device):
                return self(device, *args)
        rc = self._fn(*args, torch._C._cuda_getCurrentRawStream(current))
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape
    (on ``device`` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
