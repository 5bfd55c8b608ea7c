"""Abstract inputs and parameters of the (arch x shape) cells (counterpart of
the JAX package's ``launch/specs.py``).

The counterpart of ``jax.ShapeDtypeStruct`` / ``jax.eval_shape`` is a tensor
on the ``meta`` device: its shape and dtype, no allocation.
``input_specs(cfg, shape_name)`` gives the abstract inputs each step
consumes and ``abstract_params(model)`` the abstract parameters with their
logical axes tree.  ``step_fn_and_specs`` assembles a cell's whole
(step, arguments, shardings): train, prefill or decode, with the abstract
parameters, the optimizer state and the caches.
"""

from __future__ import annotations

import os as _os
from typing import Dict, Optional

import torch

from ..configs.base import SHAPES, ModelConfig
from ..sharding.ctx import mesh_sizes
from ..sharding.rules import NamedSharding, ShardingPlan, auto_plan, logical_to_mesh, \
    map_axes, param_shardings

PARAM_DTYPE = torch.bfloat16
#: KV-cache dtype; REPRO_CACHE_DTYPE=float8_e4m3fn halves the decode memory
CACHE_DTYPE = getattr(torch, _os.environ.get("REPRO_CACHE_DTYPE", "bfloat16"))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def whisper_decoder_len(seq: int) -> int:
    return max(seq // 8, 8)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for one assigned shape (tokens/frames/patches)."""
    seq, batch, kind = SHAPES[shape_name]
    if kind == "decode":
        return {"tokens": _sds((batch, 1), torch.int32)}
    if cfg.enc_dec:
        return {
            "frames": _sds((batch, seq, cfg.d_model), PARAM_DTYPE),
            "tokens": _sds((batch, whisper_decoder_len(seq)), torch.int32),
        }
    specs = {"tokens": _sds((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = _sds((batch, cfg.n_frontend_tokens, cfg.d_model), PARAM_DTYPE)
    return specs


def batch_axes(cfg: ModelConfig, shape_name: str) -> Dict[str, tuple]:
    seq, batch, kind = SHAPES[shape_name]
    if kind == "decode":
        return {"tokens": ("batch", None)}
    ax = {"tokens": ("batch", "seq")}
    if cfg.enc_dec:
        ax["frames"] = ("batch", "seq", "embed")
    if cfg.family == "vlm":
        ax["patches"] = ("batch", None, "embed")
    return ax


def abstract_params(model, max_seq: int = 4096):
    """(parameters on the ``meta`` device with ``model``'s shapes and
    dtypes, their logical axes tree)."""
    from ..models import Model

    meta = Model(model.cfg, model.dtype, device="meta", remat=model.remat)
    params = meta.init(torch.Generator().manual_seed(0), max_seq=max_seq)
    return params, meta.param_axes(params)


def step_fn_and_specs(
    cfg: ModelConfig,
    shape_name: str,
    mesh,
    plan: Optional[ShardingPlan] = None,
    remat: bool = True,
    level: str = "baseline",
    hbm_bytes: Optional[int] = None,
    device="meta",
):
    """Returns (fn, args, in_shardings, out_shardings, plan) of one cell on
    ``mesh``: ``args`` are tensors on the ``meta`` device and the shardings
    trees of ``sharding.rules.NamedSharding`` of the same structure (a
    single sharding stands for a whole subtree: the train step's metrics).
    A train cell takes (params, an ``OptState`` of float32 ``m``/``v`` at the
    parameters' shardings and a replicated step, batch); prefill (params,
    batch); decode (params, tokens, the ``CACHE_DTYPE`` cache of ``init_cache``
    at ``cache_axes``' shardings, a replicated 0-d int32 index).  The plan is
    ``auto_plan``'s unless given, on a budget of ``hbm_bytes`` (default: an
    H100's).  ``fn`` is the model's step on ``device``, the device its
    arguments will be materialised on."""
    from ..models import build_model
    from ..models.frontends import AUDIO_MEMORY_T
    from ..training.optimizer import OptConfig, OptState
    from ..training.train_step import make_serve_steps, make_train_step

    seq, batch, kind = SHAPES[shape_name]
    n_model = mesh_sizes(mesh).get("model", 1)
    plan = plan or auto_plan(cfg, kind, n_model=n_model, batch=batch, level=level,
                             hbm_bytes=hbm_bytes)
    model = build_model(cfg, param_dtype=PARAM_DTYPE, device=device, remat=remat)
    params, axes = abstract_params(model, max_seq=seq)
    p_shard = param_shardings(mesh, plan, axes, params)
    repl = NamedSharding(mesh, ())

    batch_sds = input_specs(cfg, shape_name)
    b_ax = batch_axes(cfg, shape_name)
    b_shard = {k: logical_to_mesh(mesh, plan.activation_rules, b_ax[k], v.shape)
               for k, v in batch_sds.items()}

    def cache_shardings(cache):
        return map_axes(lambda names, t: logical_to_mesh(mesh, plan.activation_rules, names,
                                                         t.shape), model.cache_axes(), cache)

    if kind == "train":
        f32 = lambda t: _sds(t.shape, torch.float32)  # noqa: E731
        opt = OptState(m=map_axes(lambda _, t: f32(t), axes, params),
                       v=map_axes(lambda _, t: f32(t), axes, params),
                       step=_sds((), torch.int32))
        opt_shard = OptState(m=p_shard, v=p_shard, step=repl)
        fn = make_train_step(model, mesh, plan, opt_cfg=OptConfig(schedule=cfg.lr_schedule))
        return (fn, (params, opt, batch_sds), (p_shard, opt_shard, b_shard),
                (p_shard, opt_shard, repl), plan)

    prefill_step, decode_step = make_serve_steps(model, mesh, plan)
    logits_sh = logical_to_mesh(mesh, plan.activation_rules, ("batch", "vocab"),
                                (batch, cfg.vocab))
    meta = build_model(cfg, param_dtype=PARAM_DTYPE, device="meta", remat=remat)
    if kind == "prefill":
        # the prefill's cache shapes: one row's prefill on meta, its batch dim widened
        one = {k: _sds((1, *v.shape[1:]), v.dtype) for k, v in batch_sds.items()}
        cache = map_axes(lambda names, t: _sds(tuple(batch if n == "cache_batch" else d
                                                     for n, d in zip(names, t.shape)), t.dtype),
                         model.cache_axes(), meta.prefill(params, one)[0])
        return (prefill_step, (params, batch_sds), (p_shard, b_shard),
                (cache_shardings(cache), logits_sh), plan)

    cache = meta.init_cache(batch, seq, dtype=CACHE_DTYPE, memory_t=AUDIO_MEMORY_T)
    c_shard = cache_shardings(cache)
    args = (params, batch_sds["tokens"], cache, _sds((), torch.int32))
    return (decode_step, args, (p_shard, b_shard["tokens"], c_shard, repl),
            (logits_sh, c_shard), plan)
