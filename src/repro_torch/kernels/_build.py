"""Build, load and count the port's CUDA kernels.

Every kernel source under `csrc/` has a plain C interface.  A `Library`
compiles one source with `nvcc` for `sm_90a` at first use into
`build/repro_torch/` at the root of the checkout, named by a hash of the
source so that an edited kernel is rebuilt, and loads it with `ctypes`.
Nothing is built when a module is imported: the CPU never needs `nvcc`.
Several libraries may build at once (one `nvcc` each, from threads).

`Launches` is the launch counter a wrapper keeps: it adds one where it
launches its kernel, and nowhere else.

The LM kernels' wrappers also take `meta` tensors (`check_operand`), for
the dry run (`repro_torch.launch.cost`): with the card's checks, they
allocate on `meta` what they allocate on the card, hand the call's cost
to every active recorder (`record`) and launch nothing.  A recorder is
installed with `recording`; `scope` marks the ops of a kernel's plain
version on the CPU, forward and backward, for the same recorders.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

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
    _check_layout(name, t, ndim, dtypes)


def check_operand(name: str, t: torch.Tensor, ndim: int, dtypes) -> None:
    """`check_cuda`, where a `meta` tensor (the dry run's) passes as a
    CUDA one does."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: expected a CUDA or meta tensor, got "
                         f"{t.device}")
    _check_layout(name, t, ndim, dtypes)


def _check_layout(name: str, t: torch.Tensor, ndim: int, dtypes) -> None:
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


# the active cost recorders, innermost last (`repro_torch.launch.cost`)
_RECORDERS: List = []


@contextlib.contextmanager
def recording(recorder):
    """Within the block, hand `recorder` every kernel call made on `meta`
    tensors (`recorder.kernel(name, cost, operands)`) and every
    `scope`."""
    _RECORDERS.append(recorder)
    try:
        yield recorder
    finally:
        _RECORDERS.remove(recorder)


def on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def record(name: str, cost: dict, *operands) -> None:
    """One call of kernel `name` on the `meta` tensors `operands` (those
    that fix its shapes), with its cost ({"flops": {dtype name: n},
    "bytes": n}), to every active recorder."""
    for r in list(_RECORDERS):
        r.kernel(name, cost, operands)


def recorders_active() -> bool:
    return bool(_RECORDERS)


@contextlib.contextmanager
def scope(name: str):
    """Mark the ops run within the block as one call of kernel `name`'s
    plain version for every active recorder (`recorder.enter(name,
    new_call=True)` / `leave(name)`)."""
    rs = list(_RECORDERS)
    for r in rs:
        r.enter(name, new_call=True)
    try:
        yield
    finally:
        for r in rs:
            r.leave(name)


def scope_backward(name: str, outputs, inputs) -> None:
    """Mark the autograd nodes that lie between `outputs` and `inputs`
    (tensors, or None) as one call of kernel `name`'s plain version for
    the active recorders: each node enters the scope before it runs in the
    backward (the first to run starts the call) and leaves it after.  A
    no-op where no recorder is active or nothing is being
    differentiated."""
    if not _RECORDERS:
        return
    stop = {t.grad_fn for t in inputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None}
    todo = [t.grad_fn for t in outputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    rs = list(_RECORDERS)
    started = []

    def enter(*_):
        for r in rs:
            r.enter(name, new_call=not started)
        started.append(True)

    def leave(*_):
        for r in rs:
            r.leave(name)

    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad":
            continue
        node.register_prehook(enter)
        node.register_hook(leave)
        todo.extend(n for n, _ in node.next_functions)
