"""Activation-sharding context (counterpart of the JAX package's
``sharding/ctx.py``).

Model code annotates activations with *logical* axis names:

    x = shard(x, ("batch", "seq", "embed"))

Outside any context this is the identity.  Inside ``use_rules(mesh, rules)``
the logical names resolve to mesh axes: a ``DTensor`` is redistributed to
the resolved placements, and a plain tensor, which every rank holds whole
(the replicated placement), is returned as it is.  The launcher switches
sharding plans through this one hook without touching model code.

A spec is one entry per tensor dim: ``None``, a mesh axis name, or a tuple
of names, exactly what a JAX ``PartitionSpec`` holds.  ``to_placements``
turns it into the ``Shard``/``Replicate`` placement of each mesh dim of a
``torch.distributed`` ``DeviceMesh``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

_STATE = threading.local()

Spec = Tuple[object, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (from ``mesh_dim_names``
    and its shape), or of any object whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    raise TypeError(f"{type(mesh).__name__} has no named axes")


def _resolve(names: Sequence[Optional[str]], rules: Dict[str, tuple], mesh, shape) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the logical
    ``names``: each dim takes the mesh axes its rule lists, skipping an axis
    the mesh lacks or an earlier dim took, and only if the dim divides by
    their product (else ``None``)."""
    sizes = mesh_sizes(mesh)
    used = set()
    spec = []
    for dim, name in enumerate(names):
        axes = rules.get(name, ()) if name else ()
        picked = []
        size = 1
        for ax in axes:
            if ax in used or ax not in sizes:
                continue
            size *= sizes[ax]
            picked.append(ax)
        # divisibility guard: drop the whole assignment if the dim can't split
        if picked and (shape[dim] % size == 0) and shape[dim] > 0:
            used.update(picked)
            spec.append(tuple(picked) if len(picked) > 1 else picked[0])
        else:
            spec.append(None)
    return tuple(spec)


def to_placements(spec: Spec, mesh) -> list:
    """The placement of each mesh dim of a ``DeviceMesh`` for ``spec``:
    ``Shard(d)`` where tensor dim ``d`` is split over that axis, else
    ``Replicate()``.  A dim split over several axes is split over them in
    the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    on = {}
    for dim, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                on[ax] = dim
    return [Shard(on[ax]) if ax in on else Replicate() for ax in mesh.mesh_dim_names]


def shard(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or x.ndim != len(names):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x  # held whole on every rank: the replicated placement
    mesh, rules, _ = ctx
    return x.redistribute(mesh, to_placements(_resolve(names, rules, mesh, x.shape), mesh))


def sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def reduce_partial(t):
    """A ``DTensor`` whose partial placements (a vocab-parallel lookup's
    masked partial sums) are reduced to replicated, once, where they were
    made; other placements kept."""
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate() if pl.is_partial() else pl
                                          for pl in t.placements])


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., H, P) as (..., H * P).  A ``DTensor`` whose last two dims
    are whole on every rank is reshaped on its local shards, so that its
    gradient comes back placed as it is: a gradient split over the merged
    dim where the heads do not split evenly cannot be unmerged."""
    if sharded(t) and not any(pl.is_shard() and pl.dim >= t.ndim - 2 for pl in t.placements):
        from torch.distributed.tensor.experimental import local_map

        return local_map(lambda loc: loc.reshape(*loc.shape[:-2], -1), (t.placements,),
                         in_placements=(t.placements,), device_mesh=t.device_mesh)(t)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def write_rows(cache, rows, pos, new) -> None:
    """``cache[rows, pos] = new`` in place (a decode step's new K/V row at
    each batch row's position).  For a ``DTensor`` cache (its batch over the
    data axes, its sequence over "model") each rank writes into its own
    shard: ``new`` placed as the cache's rows and heads are, each row's
    position taken relative to the rank's slice of the sequence, and kept
    where it falls outside it (no data-dependent shape, no host sync)."""
    if not sharded(cache):
        cache[rows, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    # the cache's placements on new, which lacks the sequence dim (dim 1)
    want = [Replicate() if not pl.is_shard() or pl.dim == 1 else Shard(max(pl.dim - 1, 0))
            for pl in cache.placements]
    if not sharded(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    new = new.redistribute(mesh, want).to_local().to(cache.dtype)
    shape, offset = list(cache.shape), [0] * cache.ndim  # this rank's slice (even splits)
    for i, pl in enumerate(cache.placements):
        if pl.is_shard():
            shape[pl.dim] //= mesh.size(i)
            offset[pl.dim] += mesh.get_local_rank(i) * shape[pl.dim]
    pos = pos.full_tensor() if sharded(pos) else pos
    local = pos[offset[0]:offset[0] + shape[0]] - offset[1]
    hit = ((local >= 0) & (local < shape[1])).reshape(-1, *[1] * (new.ndim - 1))
    local = local.clamp(0, shape[1] - 1)
    loc = cache.to_local()
    r = torch.arange(shape[0], device=loc.device)
    loc[r, local] = torch.where(hit, new, loc[r, local])


class _HoldGrad(torch.autograd.Function):
    """Identity; the gradient placed as the tensor is (replicated where the
    tensor is a partial sum: each part's gradient is the whole's)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate

        ctx.placements = [Replicate() if pl.is_partial() else pl for pl in t.placements]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if sharded(g) and list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def hold_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``; a ``DTensor``'s gradient is placed as ``t`` is before it
    flows on (``DTensor`` may otherwise hand a projection's weight gradient
    activations split over the sequence as well as the batch, which its
    matrix product cannot take).  A plain tensor is returned as it is."""
    if not sharded(t) or not t.requires_grad:
        return t
    return _HoldGrad.apply(t)


def model_size(*tensors) -> int:
    """The size of the "model" axis of the first ``DTensor``'s mesh (1
    when it has none)."""
    from torch.distributed.tensor import DTensor

    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    return mesh_sizes(mesh).get("model", 1)


def on_local_shards(fn, tensors, dims, out_dims, heads_split: bool):
    """``fn(*local tensors)`` on each rank's shards of ``tensors`` (at least
    one a ``DTensor``; a plain tensor is every rank's whole, as
    replicated), each given its (batch dim, head dim) in ``dims`` (either
    None): the batch dim split over the data axes ("pod", "data") where
    the batch divides by them, the head dim over "model" when
    ``heads_split`` (the caller's check that each rank then holds whole
    groups of what the heads share); replicated over every other axis, the
    inputs redistributed to that (``local_map``).  The outputs are
    ``DTensor``s placed by ``out_dims`` alike.  An input replicated over an
    axis that splits the work (a data axis, or "model" with the heads) gets
    its gradient as a partial sum over that axis: each rank's part comes
    from its own rows or heads."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    sizes = mesh_sizes(mesh)
    data = [a for a in ("pod", "data") if a in sizes]
    batch = next(t.shape[b] for t, (b, _) in zip(tensors, dims) if b is not None)
    split_batch = batch % math.prod(sizes[a] for a in data) == 0
    heads_split = heads_split and "model" in sizes

    def placements(bdim, hdim):
        out = []
        for a in mesh.mesh_dim_names:
            if a in data and split_batch and bdim is not None:
                out.append(Shard(bdim))
            elif a == "model" and heads_split and hdim is not None:
                out.append(Shard(hdim))
            else:
                out.append(Replicate())
        return tuple(out)

    tensors = [t if isinstance(t, DTensor) else
               DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
               for t in tensors]
    split = {a for a in data if split_batch} | ({"model"} if heads_split else set())

    def grad_placements(bdim, hdim):
        return tuple(Partial() if a in split and isinstance(pl, Replicate) else pl
                     for a, pl in zip(mesh.mesh_dim_names, placements(bdim, hdim)))

    outs = tuple(placements(*d) for d in out_dims)
    return local_map(fn, outs, in_placements=[placements(*d) for d in dims],
                     in_grad_placements=[grad_placements(*d) for d in dims], device_mesh=mesh,
                     redistribute_inputs=True)(*tensors)


def get_ctx():
    """(mesh, rules, extras) of the active sharding context, or None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, tuple], **extras):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules, extras)
    try:
        yield
    finally:
        _STATE.ctx = prev


def activation_rules(plan) -> Dict[str, tuple]:
    """Logical-activation-axis -> mesh-axes mapping for a ShardingPlan."""
    return dict(plan.activation_rules)
