"""Cost analysis of one call of a step function (the port of
`repro/launch/hlo_cost.py` and `hlo_stats.py`).

The reference lowers and compiles a step to HLO and walks the optimized
text.  The port runs the step once, eagerly, under a `TorchDispatchMode`
(`Analysis`), on `meta` tensors (the dry run: nothing is allocated, no
card and no `nvcc` are needed) or on the CPU (the tests, which hold the
count to the reference's walker).  For every aten op it counts:

  * flops, by the type of the product's operands: 2 x |out| x the
    contraction for every product (`torch.utils.flop_counter`'s formulas,
    and one of its own for the `out_dtype` overloads `aten.mm.dtype` /
    `aten.bmm.dtype` that the MoE runs on the card, where the library's
    raises).  Only products count, as the reference's walker counts only
    `dot`s; a product it has no formula for raises, it never counts 0;
  * bytes: each op's tensor operands and outputs, views and ops that move
    no data skipped (the analogue of `_SKIP_BYTES`); an in-place op counts
    its operand read and written.  Eager PyTorch fuses nothing, so this is
    what the step moves op by op, not what XLA's fusions move;
  * the peak of device memory: the largest sum of live storages (views
    share theirs) during the call, plus what the arguments held when it
    started;
  * an op histogram (`hlo_stats.op_histogram`).

The LM kernels' wrappers take `meta` operands and record each call with
its cost (`kernels._build.record`); on the CPU their plain versions run
under the kernel's scope, forward and backward (`kernels._build.scope`),
so `kernels` says what ran inside each kernel either way.  One device has
no collectives: `collective_bytes` is 0 and `collectives` empty, and the
fields stay so that `obs.calib.hlo_runtime_prior` takes the result
unchanged (`OpCost`).

The card's constants are those of `chip_smoke.py`'s bounds (NVIDIA's data
sheet for the H100 SXM at its 700 W limit): 989 TFLOP/s in bf16 and fp16
on the tensor cores, 67 TFLOP/s in f32 on the CUDA cores (the port allows
no TF32), 3.35 TB/s of HBM, 80 GiB.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from collections import Counter, defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80 * 2 ** 30
TOP_OPS = 12              # ops by bytes in `bytes_by_opcode`, as the reference

_aten = torch.ops.aten
# ops that move no data: allocations and metadata (views are skipped by
# `OpOverload.is_view`)
_SKIP_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten.detach,
               _aten.lift_fresh, _aten._local_scalar_dense,
               _aten.is_same_size, _aten.set_, _aten.resize_,
               _aten.sym_size, _aten.sym_stride, _aten.sym_numel}
# products that reach the dispatcher (matmul, einsum and the like
# decompose into these first): counted by a formula, or the analysis
# raises
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
             "vdot", "addr", "_int_mm"}
# products whose first operand is an addend: the type is the second's
_ADDEND_FIRST = {"addmm", "baddbmm", "addbmm", "addmv", "addr"}


def type_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _is_product(name: str) -> bool:
    return (name in _PRODUCTS or "conv" in name or "attention" in name
            or name.endswith("_mm"))


def _dtype_mm_flops(name: str, args) -> int:
    """flops of the `out_dtype` overloads: a [.., m, k] @ [.., k, n]."""
    a, b = (args[1], args[2]) if name in _ADDEND_FIRST else args[:2]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def op_flops(func, args, kwargs, out) -> Optional[tuple]:
    """(type name, flops) of one aten op, None where it is no product;
    raises for a product with no formula."""
    packet = func.overloadpacket
    name = packet.__name__
    if not _is_product(name):
        return None
    if func._overloadname == "dtype" and name in ("mm", "bmm", "addmm",
                                                  "baddbmm"):
        flops = _dtype_mm_flops(name, args)
    elif packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
    else:
        raise NotImplementedError(f"no flop formula for the product {func}")
    operand = args[1] if name in _ADDEND_FIRST else args[0]
    return type_name(operand.dtype), int(flops)


def roofline_s(flops_by_type: Dict[str, float], n_bytes: float) -> tuple:
    """(compute seconds, memory seconds) of work on the card: the flops of
    each type over that type's peak, summed, and the bytes over HBM's
    rate."""
    compute = 0.0
    for t, f in flops_by_type.items():
        if f and t not in PEAK_FLOPS:
            raise ValueError(f"no peak rate for {t} products")
        compute += f / PEAK_FLOPS[t] if f else 0.0
    return compute, n_bytes / HBM_BYTES_PER_S


@dataclasses.dataclass
class OpCost:
    """`repro.launch.hlo_cost.OpCost`'s fields, which
    `obs.calib.hlo_runtime_prior` reads."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: Optional[Dict[str, float]] = None
    by_opcode: Optional[Dict[str, float]] = None   # bytes per opcode


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in nested dicts, lists and tuples, and every parameter
    and buffer of a module."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class Analysis(TorchDispatchMode):
    """Counts the aten ops run while it is entered (see the module's
    docstring), and the LM kernels' calls: it is the cost recorder of
    `kernels._build` meanwhile.  `live_at_start` are the call's arguments:
    their storages count as live from the start."""

    def __init__(self, live_at_start=()):
        super().__init__()
        self.flops_by_type: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.histogram: Counter = Counter()
        self.kernels: Dict[str, dict] = {}
        self.op_roofline_s = 0.0
        self._scopes: list = []            # innermost kernel scope last
        self._live: Dict[int, tuple] = {}  # id(storage) -> (weakref, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in _tensors(live_at_start):
            self._track(t)
        self.start_bytes = self.live_bytes

    # -- device memory ----------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, functools.partial(self._freed,
                                                             key)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    # -- the kernels' recorder ----------------------------------------------
    def _kernel_entry(self, name: str) -> dict:
        return self.kernels.setdefault(
            name, {"calls": 0, "flops": defaultdict(int), "bytes": 0,
                   "operands": Counter()})

    def kernel(self, name: str, cost: dict, operands=()) -> None:
        """One call of a kernel on `meta` operands, with its cost; the
        calls are counted by the operands' shapes and types too."""
        k = self._kernel_entry(name)
        k["calls"] += 1
        k["operands"][tuple((tuple(t.shape), type_name(t.dtype))
                            for t in operands)] += 1
        self._add(k, cost["flops"], cost["bytes"])

    def enter(self, name: str, new_call: bool = False) -> None:
        """The ops that follow are kernel `name`'s plain version (`new_call`:
        the start of one call of it)."""
        if new_call:
            self._kernel_entry(name)["calls"] += 1
        self._scopes.append(name)

    def leave(self, name: str) -> None:
        for i in range(len(self._scopes) - 1, -1, -1):
            if self._scopes[i] == name:
                del self._scopes[i]
                return

    def _add(self, kernel: Optional[dict], flops: Dict[str, int],
             n_bytes: int) -> None:
        for t, f in flops.items():
            self.flops_by_type[t] += f
            if kernel is not None:
                kernel["flops"][t] += f
        self.bytes += n_bytes
        if kernel is not None:
            kernel["bytes"] += n_bytes
        self.op_roofline_s += max(roofline_s(flops, n_bytes))

    # -- every aten op --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        self.histogram[name] += 1
        counted = op_flops(func, args, kwargs, out)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n_bytes = 0
        if not (func.is_view or func.overloadpacket in _SKIP_BYTES):
            n_bytes = sum(t.numel() * t.element_size() for t in ins + outs)
            self.bytes_by_op[name] += n_bytes
        scope = (self._kernel_entry(self._scopes[-1]) if self._scopes
                 else None)
        self._add(scope, dict([counted]) if counted else {}, n_bytes)
        if not func.is_view:
            held = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                if id(t.untyped_storage()) not in held:
                    self._track(t)
        return out

    def result(self) -> dict:
        """The reference's `analyze` keys, and the port's own."""
        by = sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])
        kernels = {n: {"calls": k["calls"], "flops": sum(k["flops"].values()),
                       "flops_by_type": dict(k["flops"]),
                       "bytes": k["bytes"],
                       # the calls by their operands' [[shape, type], ...]
                       "operands": [{"operands": [[list(sh), t]
                                                  for sh, t in op],
                                     "calls": n}
                                    for op, n in sorted(
                                        k["operands"].items())]}
                   for n, k in sorted(self.kernels.items())}
        flops = sum(self.flops_by_type.values())
        return {"flops": flops, "bytes": self.bytes,
                "collective_bytes": 0, "collectives": {},
                "bytes_by_opcode": dict(by[:TOP_OPS]),
                "flops_by_type": dict(self.flops_by_type),
                "flops_outside_kernels": flops - sum(
                    k["flops"] for k in kernels.values()),
                "kernels": kernels,
                "start_bytes": self.start_bytes,
                "peak_bytes": self.peak_bytes,
                "op_roofline_s": self.op_roofline_s,
                "op_histogram": dict(self.histogram.most_common(20))}


def analyze(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under an `Analysis` and return its
    `result`; the arguments' storages count as live from the start."""
    analysis = Analysis((args, kwargs))
    with _build.recording(analysis), analysis:
        fn(*args, **kwargs)
    return analysis.result()


def op_cost(result: dict) -> OpCost:
    """An `analyze` result as the reference's `OpCost`."""
    return OpCost(flops=float(result["flops"]), bytes=float(result["bytes"]),
                  coll_bytes=float(result["collective_bytes"]),
                  coll_counts=dict(result["collectives"]),
                  by_opcode=dict(result["bytes_by_opcode"]))


def prior_peak_flops(result: dict) -> float:
    """The one peak rate under which `hlo_runtime_prior`'s flops / peak
    is the compute term of `roofline_s`: the flops over the sum, over
    types, of each type's flops over its peak (any rate where there are
    no flops)."""
    compute, _ = roofline_s(result["flops_by_type"], 0)
    return result["flops"] / compute if compute else PEAK_FLOPS["bfloat16"]

