"""Build, load and count the port's CUDA kernels.

Every kernel source under `csrc/` has a plain C interface.  A `Library`
compiles one source with `nvcc` for `sm_90a` at first use into
`build/repro_torch/` at the root of the checkout, named by a hash of the
source so that an edited kernel is rebuilt, and loads it with `ctypes`.
Nothing is built when a module is imported: the CPU never needs `nvcc`.
Several libraries may build at once (one `nvcc` each, from threads).

`Launches` is the launch counter a wrapper keeps: it adds one where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class Library:
    """One CUDA source, compiled at first use and loaded once.

    `declare(lib)` sets the `argtypes` / `restype` of the C entry points
    and checks any constants the wrapper shares with the source.
    `info` holds the build's path, seconds and ptxas log."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.info: Dict[str, object] = {}

    def build(self) -> Path:
        """Compile the shared library unless a build of this exact source
        exists; returns its path."""
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        out = BUILD_DIR / f"lib{self.source.stem}_{digest}.so"
        if out.exists():
            self.info.update(path=str(out), seconds=0.0, log="(cached)")
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
        self.info.update(path=str(out), seconds=time.perf_counter() - t0,
                         log=proc.stdout + proc.stderr)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


class Launches(dict):
    """Kernel name -> launches since the last `reset()`, thread-safe."""

    def __init__(self, *names: str):
        super().__init__({n: 0 for n in names})
        self._lock = threading.Lock()

    def count(self, name: str) -> None:
        with self._lock:
            self[name] += 1

    def reset(self) -> None:
        with self._lock:
            for k in self:
                self[k] = 0


def check_cuda(name: str, t: torch.Tensor, ndim: int, dtypes) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `ndim` dims whose
    dtype is one of `dtypes`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}"
                         f", got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted({str(t.device) for t in ts})}")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def refuse_grad(name: str, *operands, reason: str) -> None:
    """Raise where a kernel wrapper would be asked to record a gradient
    that its output cannot carry: with no `grad_fn`, the gradient upstream
    of it would be dropped without a word.  `reason` says where the
    gradient goes instead.  The plain versions (CPU tensors) differentiate
    through autograd."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise NotImplementedError(f"{name} records no gradient: {reason}")
