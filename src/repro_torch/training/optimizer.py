"""AdamW with a global-norm clip, and the cosine and Warmup-Stable-Decay
(MiniCPM) learning-rate schedules (counterpart of the JAX package's
``training/optimizer.py``).

Parameters, gradients and moments are nested dicts (lists, tuples) of
tensors.  ``adamw_update`` updates in place where the JAX version builds new
arrays: each parameter, its two moments and its gradient (scaled by the clip)
are written where they lie, so a step holds no second copy of the model; at
minicpm-2b width in float32 that is 10.9 GB of parameters, as many of
gradients and twice as many of moments.  Leaves are visited in the JAX
package's order (dict keys sorted), so the global norm sums in the same
order.  The arithmetic is the JAX version's, op for op, in float32.  A
leaf is updated in flat slices of at most ``UPDATE_CHUNK`` elements, so
the update's temporaries stay a few slices large whatever the leaf: whole,
deepseek-v3's 129,280 x 7,168 embedding alone made three 3.7 GB
temporaries, past one card beside 4 B parameters, their gradients and
moments.  Elementwise, the slices give the whole leaf's update bit for
bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

#: elements of a leaf that ``adamw_update`` updates at a time (64 MB in float32)
UPDATE_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"  # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.8  # WSD: fraction of post-warmup steps at peak lr
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # 0-d int32


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in ``jax.tree.leaves``' order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` on each tensor of a tree, called in ``tree_leaves``' order; the
    structure kept."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Cosine or Warmup-Stable-Decay (MiniCPM) schedule at ``step`` (an int
    or a 0-d tensor, left on its device): a 0-d float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # stable at peak for stable_frac, then exponential-style decay to min
        d = torch.clamp((t - cfg.stable_frac) / max(1e-9, 1 - cfg.stable_frac), 0.0, 1.0)
        decay = torch.where(t > cfg.stable_frac, cfg.min_lr_frac ** d, torch.ones_like(t))
    else:
        decay = torch.ones_like(t)
    return cfg.lr * warm * decay


def init_opt_state(params) -> OptState:
    """Zero moments in float32 beside each parameter, step 0."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=leaves[0].device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in the JAX package's order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(g.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(grads, state: OptState, params,
                 cfg: OptConfig) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: the gradients clipped to a global norm of
    ``clip_norm``, bias-corrected moments, decoupled weight decay, the
    learning rate of ``schedule_lr`` at the new step.  In place: ``params``,
    ``state.m`` and ``state.v`` are updated where they lie and returned
    (a float32 gradient is scaled in place too).  Returns (params, the new
    OptState, {"grad_norm", "lr"}), with no host sync."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                 tree_leaves(state.v))
    for p, g, m, v in leaves:
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        for part in _slices(p, g, m, v):
            _adamw_part(*part, b1, b2, c1, c2, lr, cfg)
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm, "lr": lr}


def _adamw_part(p, g, m, v, b1, b2, c1, c2, lr, cfg: OptConfig) -> None:
    """The moments and the parameter of one slice, in place."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    p32 = p if p.dtype == torch.float32 else p.float()
    delta = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps)).add_(cfg.weight_decay * p32)
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(lr))
    else:
        p.copy_(p32 - lr * delta)


def _slices(p, g, m, v):
    """(p, g, m, v) as views of flat slices of at most ``UPDATE_CHUNK``
    elements, written through to the leaves; the leaves whole where one is
    not contiguous or they fit one slice."""
    n = p.numel()
    if n <= UPDATE_CHUNK or not all(t.is_contiguous() for t in (p, g, m, v)):
        return [(p, g, m, v)]
    flat = [t.view(-1) for t in (p, g, m, v)]
    return [tuple(t[i:i + UPDATE_CHUNK] for t in flat) for i in range(0, n, UPDATE_CHUNK)]
