"""Collective, operation and byte accounting of an eager step (counterpart of
the JAX package's ``utils/hlo.py``, which parses the same figures out of a
compiled HLO module).

``Accounting`` is a ``TorchDispatchMode``.  Inside it (usually with a
``FakeTensorMode`` below it, so that nothing is computed, and a ``fake``
process group, so that no rank is needed) a step runs eagerly and every
operation one rank executes passes through it:

* every collective, from ``torch.distributed``'s c10d calls, the functional
  collectives that ``DTensor`` redistributions send and
  ``models/moe.py::apply_moe_sharded``'s own calls alike, is recorded as
  (kind, result bytes, group size), with the reference's five kind names;
* the floating-point operations of each matrix-product-family op
  (``torch.utils.flop_counter``'s formulas) and the bytes of every op's
  tensor inputs and outputs, before any fusion, are summed;
* ``op_census`` counts the matrix-product-family ops and each kernel
  wrapper's twin call (``kernels/ops.py``) by name, the counterpart of the
  HLO's ``custom-call`` count; a twin adds its kernel's least work
  (``kernels/counts.py``) to the FLOPs and bytes.

A ``DTensor`` op is left to ``DTensor`` (the mode returns
``NotImplemented``), which runs the op on its local shards and sends its
collectives through the mode again: so every figure is one device's, at its
local shapes.  The shape inference ``DTensor`` runs on the global shapes is
not counted.  An eager trace runs every loop iteration, so no trip count is
inferred.

Traffic is modelled from result bytes with ring multipliers over the group
size g, as the reference does: all-gather (g-1)/g x result, all-reduce
2(g-1)/g, reduce-scatter (g-1) x result (the result is the scattered
shard), all-to-all (g-1)/g, collective-permute 1x.
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import counts

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: each collective op (by its schema name) and the kind it is recorded as;
#: point-to-point copies and broadcasts move their result once, as a permute
_KIND_OF = {
    **{f"c10d::{n}": "all-reduce" for n in ("allreduce_", "allreduce_coalesced_", "reduce_")},
    **{f"c10d::{n}": "all-gather" for n in ("allgather_", "_allgather_base_",
                                             "allgather_coalesced_",
                                             "allgather_into_tensor_coalesced_", "gather_")},
    **{f"c10d::{n}": "reduce-scatter" for n in ("reduce_scatter_", "_reduce_scatter_base_",
                                                 "reduce_scatter_tensor_coalesced_")},
    **{f"c10d::{n}": "all-to-all" for n in ("alltoall_", "alltoall_base_")},
    **{f"c10d::{n}": "collective-permute" for n in ("broadcast_", "scatter_", "send",
                                                     "recv_", "recv_any_source_")},
    **{f"_c10d_functional::{n}": "all-reduce" for n in ("all_reduce", "all_reduce_",
                                                         "all_reduce_coalesced",
                                                         "all_reduce_coalesced_")},
    **{f"{ns}::{n}": "all-gather" for ns in ("_c10d_functional", "_c10d_functional_autograd")
       for n in ("all_gather_into_tensor", "all_gather_into_tensor_out",
                 "all_gather_into_tensor_coalesced")},
    **{f"{ns}::{n}": "reduce-scatter" for ns in ("_c10d_functional", "_c10d_functional_autograd")
       for n in ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    **{f"{ns}::all_to_all_single": "all-to-all"
       for ns in ("_c10d_functional", "_c10d_functional_autograd")},
    "_dtensor::shard_dim_alltoall": "all-to-all",
    **{f"_c10d_functional::{n}": "collective-permute" for n in ("broadcast", "broadcast_")},
}

#: ops counted by ``op_census`` beside the kernel twins (the HLO's "dot" and
#: "convolution")
CENSUS_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution")

_FREE = ("aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
         "aten::new_empty_strided", "aten::detach", "aten::alias", "aten::lift_fresh",
         "prim::device")
_LOCAL = threading.local()


def _traffic(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args) -> int:
    """The size of the process group among a collective's arguments: a
    ``ProcessGroup`` (boxed, as the c10d ops take it), or the functional
    collectives' group name."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
        if isinstance(a, ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    raise ValueError(f"no process group among a collective's arguments {args!r}")


class Accounting(TorchDispatchMode):
    """One device's figures of everything run inside it (see the module's
    docstring): ``collectives`` [(kind, result bytes, group size)],
    ``flops``, ``bytes`` (inputs and outputs of every op but views and
    allocations), ``census`` (op and kernel-twin counts by name), and the
    live bytes of the tensors it saw made or was given (``track``):
    ``peak_bytes`` at most, ``live_bytes`` now."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Tuple[str, int, int]] = []
        self.flops = 0.0
        self.bytes = 0.0
        self.census: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, weakref.ref] = {}

    # ------------------------------------------------------------ memory
    def track(self, tree) -> None:
        """Count the storages of the tensors of ``tree`` (a ``DTensor``'s
        local shard) as live from now until they are freed."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._seen[key] = weakref.ref(st)
        weakref.finalize(st, self._release, key, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _release(self, key: int, n: int) -> None:
        self.live_bytes -= n
        self._seen.pop(key, None)

    # ----------------------------------------------------------- kernels
    def _kernel(self, name: str, nbytes: float, nops: float) -> None:
        self.census[name] += 1
        self.flops += nops
        self.bytes += nbytes

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        _patch_propagation()
        counts._ACTIVE.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        counts._ACTIVE.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops and collectives through us
        out = func(*args, **kwargs)
        if getattr(_LOCAL, "propagating", 0):
            return out  # DTensor's shape inference on global shapes: no device work
        name = func._schema.name
        kind = _KIND_OF.get(name)
        if kind is not None:
            res = _tensors(out) or _tensors(args[:1])
            self.collectives.append((kind, _nbytes(res), _group_size((args, kwargs))))
            return out
        outs = _tensors(out)
        for t in outs:  # a view shares a storage already held
            self._hold(t)
        if name in _FREE or func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if packet.__name__ in CENSUS_OPS:
                self.census[packet.__name__] += 1
        self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        return out


def _patch_propagation() -> None:
    """Mark DTensor's fake run of an op on its global shapes (its sharding
    propagation), so that ``Accounting`` leaves it out: it is no device's
    work.  Done once, for every ``Accounting``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    meth = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(meth, "_accounted", False):
        return

    def marked(self, op_schema):
        _LOCAL.propagating = getattr(_LOCAL, "propagating", 0) + 1
        try:
            return meth(self, op_schema)
        finally:
            _LOCAL.propagating -= 1

    marked._accounted = True
    ShardingPropagator._propagate_tensor_meta_non_cached = marked


def collective_stats(acc: "Accounting | List[Tuple[str, int, int]]"
                     ) -> Dict[str, Dict[str, float]]:
    """Per-kind {count, result_bytes, traffic_bytes} of an ``Accounting``
    (or of its ``collectives`` list)."""
    events = acc.collectives if isinstance(acc, Accounting) else acc
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0.0, "traffic_bytes": 0.0}
    )
    for kind, rb, g in events:
        s = stats[kind]
        s["count"] += 1
        s["result_bytes"] += rb
        s["traffic_bytes"] += _traffic(kind, rb, g)
    return dict(stats)


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> Tuple[float, float]:
    traffic = sum(s["traffic_bytes"] for s in stats.values())
    result = sum(s["result_bytes"] for s in stats.values())
    return traffic, result


def op_census(acc: Accounting) -> Dict[str, int]:
    """Calls by name: the matrix-product-family ops (``CENSUS_OPS``) and the
    kernel twins (``kernels/ops.py``'s wrapper names)."""
    return dict(acc.census)
