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

Expert parallelism over a mesh (the JAX package's ``apply_moe_sharded``) is
ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

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
    # Switch-style load-balance aux: E * sum_e f_e * P_e
    T = x_flat.shape[0]
    flat = idx.reshape(-1)
    f = torch.zeros(m.n_experts, dtype=torch.float32, device=x_flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x_flat.device)) / (T * m.top_k)
    aux = m.n_experts * torch.sum(f * probs.mean(0))
    return gates.to(x_flat.dtype), idx, aux


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
    shared expert."""
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
