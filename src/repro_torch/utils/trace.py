"""One step's costs and collectives, from PyTorch (the port's counterpart
of ``repro.utils.hlo``, which reads them from compiled HLO text).

* :class:`StepCosts` counts what a step does while it is active: for each
  aten op, its FLOPs by ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention) and its bytes, the op's tensor inputs
  plus its outputs, views, bare allocations and ``prim`` queries (a fake
  tensor's ``.device``) excluded.  Eager PyTorch
  fuses nothing, so every op round-trips HBM: this is the analogue of
  XLA's ``bytes accessed``.  The port's own kernels are ctypes launches
  that the dispatcher never sees; each wrapper adds its operations and
  bytes itself (:func:`count_kernel`), with the counts of the kernel's
  bound (each kernel module's ``*_costs``).  ``cost_analysis()`` gives
  them in the reference's shape, ``{"flops", "bytes accessed"}``, for
  :func:`repro_torch.utils.roofline.derive`.
* :func:`parse_collectives` reads the c10d collectives of a
  ``torch.profiler`` run (``record_shapes=True``) into the reference's
  :class:`CollectiveOp`: kind (one of its five), result bytes from the
  recorded shapes and types, and group size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# StepCosts that are counting; global, not per thread, so that the backward
# (autograd's device thread) reaches them.
_ACTIVE: List["StepCosts"] = []
_LOCK = threading.Lock()

_aten = torch.ops.aten
# Ops that allocate or re-describe memory without moving it.
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.detach.default, _aten.lift_fresh.default, _aten.alias.default,
}


def _nbytes(objs) -> int:
    seen, total = set(), 0
    for t in tree_leaves(objs):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class StepCosts(TorchDispatchMode):
    """Context that counts the operations and bytes of what runs inside it
    (see the module's docstring).  ``aten_flops``/``aten_bytes`` and
    ``kernel_flops``/``kernel_bytes`` are kept apart; ``by_kernel`` holds
    each kernel's calls, FLOPs and bytes.  Counting costs a Python call
    per aten op: time a step outside it."""

    def __init__(self):
        super().__init__()
        self.aten_flops = 0.0
        self.aten_bytes = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0
        self.aten_ops = 0
        self.by_kernel: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0})
        self._paused = 0

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self.aten_bytes + self.kernel_bytes

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.aten_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or func in _NO_TRAFFIC or func.namespace == "prim"):
            self.aten_ops += 1
            self.aten_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def __enter__(self):
        with _LOCK:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        with _LOCK:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _add_kernel(self, name: str, flops: float, nbytes: int) -> None:
        k = self.by_kernel[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.kernel_flops += flops
        self.kernel_bytes += nbytes


def counting() -> bool:
    """Whether a :class:`StepCosts` is active (a kernel wrapper then counts
    its launch)."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def uncounted():
    """Ops run inside are not counted (a wrapper computing its own counts)."""
    for s in _ACTIVE:
        s._paused += 1
    try:
        yield
    finally:
        for s in _ACTIVE:
            s._paused -= 1


def count_kernel(name: str, flops: float, nbytes: int) -> None:
    """Add one launch of the port's kernel ``name`` to every active
    :class:`StepCosts`."""
    with _LOCK:
        for s in _ACTIVE:
            s._add_kernel(name, float(flops), int(nbytes))


# ------------------------------------------------------------ collectives


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int          # result bytes (per device)
    group_size: int
    in_entry: bool = True  # the reference's ENTRY-vs-loop flag; a trace lists each call


# backend events ("gloo:all_reduce", "nccl:_all_gather_base", ...); the
# c10d:: ops around them are not counted again
_EVENT = re.compile(r"^(?:gloo|nccl|ucc|mpi):_?(?P<op>[a-z_]+?)(?:_base|_coalesced)?$")
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send": "collective-permute"}
_TYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "int": 4,
    "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
}


def _event_bytes(e) -> int:
    shapes = e.input_shapes or []
    types = getattr(e, "input_dtypes", None) or []
    total = 0
    for shape, typ in zip(shapes, types):
        if not isinstance(shape, (list, tuple)) or typ not in _TYPE_BYTES:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        total += n * _TYPE_BYTES[typ]
    return total


def _default_group_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def parse_collectives(prof_or_events, group_size: Optional[int] = None) -> List[CollectiveOp]:
    """The collectives of a ``torch.profiler.profile`` (or its
    ``events()``), recorded with ``record_shapes=True``: each backend
    event once, in order.  Result bytes: the input's for all-reduce,
    all-to-all and send; P times it for all-gather; 1/P of it for
    reduce-scatter (P the group size: ``group_size``, by default the
    default process group's)."""
    events: Iterable = (prof_or_events.events() if hasattr(prof_or_events, "events")
                        else prof_or_events)
    p = group_size or _default_group_size()
    ops: List[CollectiveOp] = []
    for e in events:
        m = _EVENT.match(e.name)
        if not m or m.group("op") not in _KIND:
            continue
        kind = _KIND[m.group("op")]
        b = _event_bytes(e)
        if kind == "all-gather":
            b *= p
        elif kind == "reduce-scatter":
            b //= p
        if b == 0:
            continue
        ops.append(CollectiveOp(kind=kind, bytes=b, group_size=p))
    return ops


def collective_summary(prof_or_events, group_size: Optional[int] = None
                       ) -> Dict[str, Dict[str, float]]:
    """{kind: {count, bytes}} over the whole trace."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for op in parse_collectives(prof_or_events, group_size):
        out[op.kind]["count"] += 1
        out[op.kind]["bytes"] += op.bytes
    return dict(out)
