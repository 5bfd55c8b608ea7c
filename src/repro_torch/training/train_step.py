"""Train and eval steps (counterpart of the JAX package's
``training/train_step.py``), unsharded: ``torch.autograd`` for the loss's
gradient, then ``adamw_update``.  The mesh and sharding-plan arguments wait
for ROADMAP Queue 1 item 9."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .optimizer import OptConfig, adamw_update, tree_leaves, tree_map


def loss_and_grads(model, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], dict]:
    """(loss, metrics, gradients): ``model.loss`` and its gradient with
    respect to every leaf of ``params``, a tree of the same structure (a
    leaf the loss does not reach gets zeros).  The loss and metrics come
    back detached; ``params`` is not modified."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    live_flat = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, live_flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g for g, p in zip(grads, live_flat)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(model, opt_cfg: Optional[OptConfig] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's gradient, then one AdamW step (in place; ``adamw_update``).
    The metrics are the loss's (``loss``, ``ce`` and the family's
    ``moe_aux``, ``mtp_ce``) and the optimizer's (``grad_norm``, ``lr``),
    0-d tensors on the model's device."""
    opt_cfg = opt_cfg or OptConfig(schedule=model.cfg.lr_schedule)

    def step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(model, params, batch)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


def make_eval_step(model):
    """``step(params, batch) -> metrics``: the loss's metrics, no gradient."""

    def step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics

    return step
