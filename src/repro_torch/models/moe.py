"""Mixture-of-Experts with sorted capacity dispatch (counterpart of the JAX
package's ``models/moe.py``, its unsharded path).

Dispatch is the sort-based formulation: flatten token->expert assignments,
stable-sort by expert id, compute each token's slot within its expert group,
drop beyond capacity, scatter into an (E, C, d) buffer, run the expert FFNs
as one batched matmul over every E x C slot (empty or not, as the reference
does), and combine each token's gated expert rows.  Both routers
(softmax top-k, and DeepSeek-V3's sigmoid with a selection bias) and the
shared expert are here, with the Switch-style load-balancing aux.

No TPU kernel covers MoE (the JAX package leaves the dispatch and the
expert products to XLA), so this is plain PyTorch.  It makes no host sync:
the capacity ``C`` is a Python int from the shapes, the per-expert counts
are an ``index_add_`` into a buffer of ``E + 1`` (``torch.bincount`` would
read its input's maximum back to the host), and nothing is indexed by a
boolean mask, so a MoE decode step can be captured in a CUDA graph.  On the
card ``index_add_`` adds with atomics in no fixed order, so it is used only
where the order cannot show: the dispatch only ever adds zeros onto a kept
token's slot.  The combine gathers each token's ``top_k`` gated rows into
(T, k, d) and sums over k, one fixed order for any ``top_k`` (deepseek-v3
routes top-8), so a replayed step equals its eager one bit for bit; for
top-2 it is the same sum as the JAX package's two adds onto zeros.

Inside a sharding context whose plan has ``moe_mode`` "capacity" or
"resident" (``sharding.use_rules(mesh, rules, moe_mode=...)``), ``apply_moe``
runs ``apply_moe_sharded``: expert parallelism over the ranks of a
``torch.distributed`` ``DeviceMesh``, each rank holding its own token shard.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..sharding.ctx import get_ctx, mesh_sizes, on_local_shards, sharded
from .layers import act_fn, apply_mlp, init_mlp, stacked_normal


def init_moe(cfg, generator: torch.Generator, device, dtype=torch.float32,
             layers: int = 0) -> Dict:
    """Router (float32 whatever ``dtype``), the experts' stacked (E, d, f) /
    (E, f, d) weights, a zero ``router_bias`` for the sigmoid router and a
    gated shared expert of width ``expert_dff * n_shared``; with
    ``layers > 0`` stacked for that many layers.  Each weight's scale is
    1/sqrt of its first per-layer axis, as in the JAX package (E for the
    experts' weights)."""
    m, d = cfg.moe, cfg.d_model
    w = lambda shape, dt=dtype: stacked_normal(shape, layers, generator, device, dt)  # noqa: E731
    p = {
        "router": w((d, m.n_experts), torch.float32),
        "wi_gate": w((m.n_experts, d, m.expert_dff)),
        "wi_up": w((m.n_experts, d, m.expert_dff)),
        "wo": w((m.n_experts, m.expert_dff, d)),
    }
    if m.router == "sigmoid":
        lead = (layers,) if layers else ()
        p["router_bias"] = torch.zeros(lead + (m.n_experts,), dtype=torch.float32, device=device)
    if m.n_shared:
        shared_cfg = dataclasses.replace(cfg, gated_mlp=True, use_bias=False)
        p["shared"] = init_mlp(shared_cfg, generator, device, dtype, layers,
                               d_ff=m.expert_dff * m.n_shared)
    return p


def route(p, x_flat: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T,k) in x's dtype, expert_idx (T,k), aux float32 0-d).
    The router runs in float32 on ``x_flat`` upcast."""
    gates, idx, probs = _route(p, x_flat, cfg)
    return gates, idx, _aux(cfg, _counts(cfg, idx), probs.mean(0), x_flat.shape[0])


def _route(p, x_flat: torch.Tensor, cfg):
    """(gates in x's dtype, expert_idx, the router's probabilities)."""
    m = cfg.moe
    logits = x_flat.float() @ p["router"]
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"]  # aux-loss-free balancing bias (DSv3)
        idx = torch.topk(sel, m.top_k, dim=-1).indices
        gates = torch.gather(scores, -1, idx)  # weights use the raw scores
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, m.top_k, dim=-1)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates.to(x_flat.dtype), idx, probs


def _counts(cfg, idx: torch.Tensor) -> torch.Tensor:
    """Assignments to each expert (float32 (E,))."""
    flat = idx.reshape(-1)
    return torch.zeros(cfg.moe.n_experts, dtype=torch.float32, device=idx.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=idx.device))


def _aux(cfg, counts: torch.Tensor, P: torch.Tensor, T: int) -> torch.Tensor:
    """Switch-style load-balance aux ``E * sum_e f_e * P_e`` of ``T`` tokens:
    f_e their share of the assignments, P_e their mean probability."""
    m = cfg.moe
    return m.n_experts * torch.sum(counts / (T * m.top_k) * P)


def _plan(idx: torch.Tensor, e0: int, E_loc: int, C: int):
    """The sorted dispatch of the assignments ``idx`` (T, k) to experts
    ``[e0, e0 + E_loc)``: (order, token of each sorted assignment, its
    destination row in the (E_loc * C, d) buffer, whether it is kept).  An
    assignment out of range sorts last; one beyond its expert's ``C`` slots
    is dropped (its destination clipped to the expert's last slot)."""
    T, k = idx.shape
    dev = idx.device
    eid_rel = idx.reshape(-1) - e0
    in_range = (eid_rel >= 0) & (eid_rel < E_loc)
    sort_key = torch.where(in_range, eid_rel, E_loc)  # out-of-range sorts last
    n = torch.arange(T * k, device=dev)
    order = torch.argsort(sort_key, stable=True)  # stable: token order within an expert
    key_s, tok_s = sort_key[order], order // k
    counts = torch.zeros(E_loc + 1, dtype=torch.int64, device=dev).index_add_(
        0, key_s, torch.ones_like(key_s, dtype=torch.int64))[:E_loc]
    starts = torch.cumsum(counts, 0) - counts
    safe_key = key_s.clamp(max=E_loc - 1)
    slot = n - starts[safe_key]
    keep = (key_s < E_loc) & (slot < C)
    dest = safe_key * C + slot.clamp(0, C - 1)
    return order, tok_s, dest, keep


def dropped(idx: torch.Tensor, n_experts: int, C: int) -> torch.Tensor:
    """How many of the assignments ``idx`` (T, k) find their expert's ``C``
    slots full (a 0-d tensor on idx's device)."""
    return (~_plan(idx, 0, n_experts, C)[3]).sum()


def _dispatch_ffn(x_flat, gates, idx, wg, wu, wo, e0: int, E_loc: int, C: int,
                  act: Callable[[torch.Tensor], torch.Tensor], dtype) -> torch.Tensor:
    """Sort-based capacity dispatch restricted to experts [e0, e0+E_loc).
    Returns the combined (T, d) contribution of those experts (zeros for
    tokens routed elsewhere)."""
    T, d = x_flat.shape
    order, tok_s, dest, keep = _plan(idx, e0, E_loc, C)
    buf = torch.zeros((E_loc * C, d), dtype=dtype, device=x_flat.device)
    buf.index_add_(0, dest, torch.where(keep[:, None], x_flat[tok_s].to(dtype), 0))
    h = buf.reshape(E_loc, C, d)
    out = torch.bmm(act(torch.bmm(h, wg)) * torch.bmm(h, wu), wo).reshape(E_loc * C, d)
    # each assignment's row back in (token, k) order, then each token's k rows
    # summed in that order
    dest_o = torch.empty_like(dest).scatter_(0, order, dest)
    keep_o = torch.empty_like(keep).scatter_(0, order, keep)
    k = idx.shape[1]
    contrib = out[dest_o] * torch.where(keep_o, gates.reshape(-1), 0.0)[:, None]
    return contrib.reshape(T, k, d).sum(dim=1)


def _capacity(cf: float, T: int, k: int, E: int) -> int:
    C = int(cf * T * k / E)
    return max(8, -(-C // 8) * 8)


def apply_moe(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux): route, dispatch to all ``n_experts`` at
    capacity ``_capacity(capacity_factor, B * S, top_k, n_experts)``, add the
    shared expert.  Under a sharding context with an EP ``moe_mode``,
    ``apply_moe_sharded``."""
    ctx = get_ctx()
    if ctx is not None and ctx[2].get("moe_mode") in ("capacity", "resident"):
        if sharded(x):  # each rank's own token shard, as apply_moe_sharded takes it
            return on_local_shards(lambda xl: apply_moe_sharded(p, xl, cfg, ctx), [x],
                                   [(0, None)], [(0, None), (None, None)], False)
        return apply_moe_sharded(p, x, cfg, ctx)
    if sharded(x, *_leaves(p)):
        return _apply_moe_on_shards(p, x, cfg)
    return _apply_moe_whole(p, x, cfg)


def _apply_moe_whole(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe`` of plain tensors, unsharded."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    gates, idx, aux = route(p, x_flat, cfg)
    C = _capacity(m.capacity_factor, T, m.top_k, m.n_experts)
    y = _dispatch_ffn(x_flat, gates, idx, p["wi_gate"], p["wi_up"], p["wo"],
                      0, m.n_experts, C, act_fn(cfg.act), x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x_flat, cfg)
    return y.reshape(B, S, d), aux


_F_DIM = {"wi_gate": 2, "wi_up": 2, "wo": 1}  # each expert weight's FFN dim
_F_DIM_SHARED = {"wi_gate": 1, "wi_up": 1, "wo": 0}


def _leaves(p) -> list:
    return [t for v in p.values() for t in (v.values() if isinstance(v, dict) else (v,))]


def _apply_moe_on_shards(p, x, cfg):
    """The unsharded dispatch on ``DTensor`` leaves (no EP mode): each rank
    routes its own tokens (x's batch split over the data axes) to every
    expert, on its slice of the experts' FFN dim over "model" (the weights
    redistributed so where they lie otherwise; whole where the dim does not
    split), the slices' contributions summed through the output's partial
    placement over "model"; the aux is each rank's tokens', averaged over
    the data axes (a share of it on each "model" rank, so that the router's
    gradient, a partial sum over every split axis, counts it once)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (x, *_leaves(p)) if isinstance(t, DTensor))
    names = mesh.mesh_dim_names
    sizes = mesh_sizes(mesh)
    data = [a for a in ("pod", "data") if a in sizes]
    if x.shape[0] % math.prod(sizes[a] for a in data):
        data = []  # the batch does not split: every rank routes all of it
    m = cfg.moe
    split_f = "model" in sizes and all(
        f % sizes["model"] == 0 for f in (m.expert_dff, m.expert_dff * max(m.n_shared, 1)))

    def pl(bdim=None, fdim=None, model_sum=False, data_avg=False):
        out = []
        for a in names:
            if a in data and bdim is not None:
                out.append(Shard(bdim))
            elif a in data and data_avg:
                out.append(Partial("avg"))
            elif a == "model" and split_f and fdim is not None:
                out.append(Shard(fdim))
            elif a == "model" and split_f and model_sum:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    keys = [(k, None) for k in p if k != "shared"] + [("shared", k) for k in p.get("shared", {})]
    ws = [p[k] if sub is None else p[k][sub] for k, sub in keys]
    w_pl = [pl(fdim=(_F_DIM.get(k) if sub is None else _F_DIM_SHARED[sub])) for k, sub in keys]

    n_split = sizes["model"] if split_f else 1

    def local(xl, *wl):
        tree = {}
        for (k, sub), w in zip(keys, wl):
            if sub is None:
                tree[k] = w
            else:
                tree.setdefault(k, {})[sub] = w
        y, aux = _apply_moe_whole(tree, xl, cfg)
        return y, aux / n_split

    def grads(pls):  # an input replicated over a split axis: a partial gradient
        split = set(data) | ({"model"} if split_f else set())
        return tuple(Partial() if a in split and isinstance(q, Replicate) else q
                     for a, q in zip(names, pls))

    ts = [t if isinstance(t, DTensor) else
          DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
          for t in (x, *ws)]
    ins = [pl(bdim=0)] + w_pl
    return local_map(local, (pl(bdim=0, model_sum=True), pl(model_sum=True, data_avg=True)),
                     in_placements=ins, in_grad_placements=[grads(q) for q in ins],
                     device_mesh=mesh, redistribute_inputs=True)(*ts)


# ------------------------------------------------------- expert parallelism
def apply_moe_sharded(p, x: torch.Tensor, cfg, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the ranks of the context's ``DeviceMesh``
    (counterpart of the JAX package's ``shard_map`` path).  ``x`` is this
    rank's token shard (the batch split over the data axes "pod" and
    "data"; replicated over "model"); returns its (y, aux), aux over the
    whole batch (the assignment counts and probability sums all-reduced
    over the data axes).

    mode="capacity" (train/prefill): each rank of a "model" group dispatches
      its own tokens to its ``E / n_model`` experts at capacity
      ``_capacity(cf, T_local, k, E)``; the combine is one all-reduce of the
      (T_local, d) contributions over "model".
    mode="resident" (decode): the experts are spread over ("model",) +
      ``dp_own``, the longest suffix of the data axes whose size with
      "model" divides E; the tokens are all-gathered within ``dp_own`` (the
      weights stay put), the contributions all-reduced over the whole group
      and each rank keeps its own tokens.  Other data axes (e.g. "pod")
      replicate the experts.
    When ``E % n_model != 0`` (e.g. mixtral's 8 experts over 16): TP within
      each expert, every rank holding all experts on a ``1/n_model`` slice
      of the FFN dim; the ``wo`` partials are summed by the same
      all-reduce.

    A weight leaf is a ``DTensor`` (redistributed to the mode's placements,
    its local shard used) or a plain full tensor, from which the rank takes
    its own experts or columns; either way a rank's block is its index over
    the owning mesh axes in the mesh's order.  A ``DTensor`` router or
    shared expert is gathered whole.  The collectives are
    ``torch.distributed.nn.functional``'s, which carry autograd."""
    mesh, _, extras = ctx
    mode = extras["moe_mode"]
    m = cfg.moe
    sizes = mesh_sizes(mesh)
    B, S, d = x.shape
    T_loc = B * S
    act = act_fn(cfg.act)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = math.prod(sizes[a] for a in dp)
    n_model = sizes.get("model", 1)
    E, k, cf = m.n_experts, m.top_k, m.capacity_factor

    x_flat = x.reshape(T_loc, d)
    p = {name: w if name in ("wi_gate", "wi_up", "wo") else _whole(w) for name, w in p.items()}
    gates, idx, probs = _route(p, x_flat, cfg)
    if n_data > 1:  # the aux of the whole batch
        group = _group(mesh, dp)
        counts = _all_reduce(_counts(cfg, idx), group)
        aux = _aux(cfg, counts, _all_reduce(probs.sum(0), group) / (T_loc * n_data),
                   T_loc * n_data)
    else:
        aux = _aux(cfg, _counts(cfg, idx), probs.mean(0), T_loc)
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]

    dp_own: tuple = ()
    for n_ax in range(len(dp), -1, -1):
        cand = dp[len(dp) - n_ax:]
        if E % (n_model * math.prod(sizes[a] for a in cand)) == 0:
            dp_own = cand
            break
    n_own = math.prod(sizes[a] for a in dp_own)

    if mode == "resident" and E % (n_model * n_own) == 0 and n_model * n_own > 1:
        own = ("model",) + dp_own
        E_loc = E // (n_model * n_own)
        C = _capacity(cf, T_loc * n_own, k, E)
        wg, wu, wo = (_local(w, mesh, 0, own) for w in (wg, wu, wo))
        group = _group(mesh, dp_own)
        xg, gg, ig = x_flat, gates, idx
        if group is not None:
            xg, gg = (torch.cat(_all_gather(t, group)) for t in (x_flat, gates))
            parts = [torch.empty_like(idx) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, idx.contiguous(), group=group)
            ig = torch.cat(parts)
        contrib = _dispatch_ffn(xg, gg, ig, wg, wu, wo, _block(mesh, own) * E_loc, E_loc, C,
                                act, x.dtype)
        out = _all_reduce(contrib, _group(mesh, own))
        d_idx = dist.get_group_rank(group, dist.get_rank()) if group is not None else 0
        y = out[d_idx * T_loc:(d_idx + 1) * T_loc]
    elif E % n_model == 0:  # capacity: experts split over "model"
        E_loc = E // n_model
        C = _capacity(cf, T_loc, k, E)
        wg, wu, wo = (_local(w, mesh, 0, ("model",)) for w in (wg, wu, wo))
        contrib = _dispatch_ffn(x_flat, gates, idx, wg, wu, wo, _block(mesh, ("model",)) * E_loc,
                                E_loc, C, act, x.dtype)
        y = _all_reduce(contrib, _group(mesh, ("model",)))
    else:  # TP within each expert: the FFN columns over "model"
        C = _capacity(cf, T_loc, k, E)
        wg, wu = (_local(w, mesh, 2, ("model",)) for w in (wg, wu))
        wo = _local(wo, mesh, 1, ("model",))
        contrib = _dispatch_ffn(x_flat, gates, idx, wg, wu, wo, 0, E, C, act, x.dtype)
        y = _all_reduce(contrib, _group(mesh, ("model",)))

    if "shared" in p:
        y = y + apply_mlp(p["shared"], x_flat, cfg)
    return y.reshape(B, S, d), aux


def _block(mesh, axes: Sequence[str]) -> int:
    """This rank's index over the mesh ``axes``, in the mesh's order."""
    block = 0
    for name, size in mesh_sizes(mesh).items():
        if name in axes:
            block = block * size + mesh.get_local_rank(name)
    return block


def _whole(tree):
    """A tree with each ``DTensor`` leaf gathered whole (the router and the
    shared expert, which every rank applies to its own tokens)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _local(w: torch.Tensor, mesh, dim: int, axes: Sequence[str]) -> torch.Tensor:
    """This rank's slice of ``w`` split along ``dim`` over the mesh
    ``axes``: a ``DTensor``'s local shard at those placements, or a slice of
    a full tensor (differentiable either way)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(w, DTensor):
        sizes = mesh_sizes(mesh)
        want = [Shard(dim) if a in axes else Replicate() for a in mesh.mesh_dim_names]
        # a split over an axis of one is no split: such a layout is kept as it is
        same = lambda pl: [Replicate() if sizes[a] == 1 else q  # noqa: E731
                           for a, q in zip(mesh.mesh_dim_names, pl)]
        if same(w.placements) != same(want):
            w = w.redistribute(mesh, want)
        return w.to_local()
    n = math.prod(mesh_sizes(mesh)[a] for a in axes)
    size = w.shape[dim] // n
    return w.narrow(dim, _block(mesh, axes) * size, size)


def _group(mesh, axes: Sequence[str]) -> Optional[object]:
    """The process group of this rank's cell over the mesh ``axes`` (None
    when they hold one rank; an axis of one rank is left out): the mesh's
    own for one axis; for several, a group made by the ranks in it at the
    first EP layer and kept on the mesh, so that it lives as long as the
    mesh's own groups (a world made anew, with its own mesh, makes its own)."""
    sizes = mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes and sizes[a] > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    keep = [names.index(a) for a in names if a not in axes]
    ranks = mesh.mesh.permute(keep + [names.index(a) for a in axes])
    mine = tuple(ranks[tuple(mesh.get_local_rank(names[i]) for i in keep)].reshape(-1).tolist())
    groups = mesh.__dict__.setdefault("_ep_groups", {})  # by the ranks in each group
    if mine not in groups:
        groups[mine] = dist.new_group(list(mine), use_local_synchronization=True)
    return groups[mine]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (the identity for None), with autograd."""
    if group is None:
        return t
    from torch.distributed.nn import functional as dfn

    with warnings.catch_warnings():  # deprecated for the functional collectives, no autograd
        warnings.simplefilter("ignore", FutureWarning)
        return dfn.all_reduce(t, group=group)


def _all_gather(t: torch.Tensor, group):
    from torch.distributed.nn import functional as dfn

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return dfn.all_gather(t.contiguous(), group=group)
