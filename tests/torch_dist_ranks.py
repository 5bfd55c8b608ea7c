"""Run a function on spawned ``torch.distributed`` gloo ranks, for the port's
multi-process tests on the CPU.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), each joining a gloo process group on a
``FileStore`` under ``tmp_path`` with one PyTorch thread, runs ``fn(rank,
world, *args)`` and returns each rank's result.  It joins the ranks with a
timeout: a rank still running then is killed and the call fails, as does a
rank that raised (its traceback is in the message), so a hung collective
cannot hold up the suite.

The rank bodies live here too: a spawned rank imports the module that
defines its function, and this one imports no JAX.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np


def _entry(fn, rank, world, tmp):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmp = Path(tmp)
    try:
        args = torch.load(tmp / "args.pt", weights_only=False)
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                                rank=rank, world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save(result, tmp / f"rank{rank}.pt")
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    import torch

    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    # the arguments go through a file: a large argument of ``Process`` would
    # make each ``start()`` wait until its rank has booted to read it
    torch.save(args, tmp / "args.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = "\n".join(f.read_text() for f in sorted(tmp.glob("rank*.err")))
    if hung:
        raise AssertionError(f"ranks {hung} still running after {timeout} s, killed\n{errors}")
    codes = [p.exitcode for p in procs]
    if any(codes) or errors:
        raise AssertionError(f"rank exit codes {codes}\n{errors}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ bodies
def ep_ranks(rank, world, cfg, weights, x, meshes, modes):
    """``apply_moe`` under the EP plans on each mesh: {(mesh shape, mode,
    weights kind): (data block, y, aux)} for this rank's token shard, with
    the weights plain (each rank slices its part) and, for two cases, as
    ``DTensor``s at the plan's placements; and the gradients of ``(y**2).sum()
    / n_model + aux / world`` on (2, 4) in capacity mode, which summed over
    the ranks are the gradients of the whole batch's ``(y**2).sum() +
    aux``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import params_from_numpy

    p = params_from_numpy(weights, device="cpu")
    xt = torch.from_numpy(x)
    out = {}
    for shape, axes in meshes:
        # a mesh smaller than the world is tiled over it, each rank in one
        # copy, so that every rank makes the same process groups in turn
        n = math.prod(shape)
        copies = [DeviceMesh("cpu", torch.arange(i * n, (i + 1) * n).reshape(shape),
                             mesh_dim_names=axes) for i in range(world // n)]
        _ep_on(copies[rank // n], shape, out, p, xt, cfg, modes, world)
    return out


def _ep_on(mesh, shape, out, p, xt, cfg, modes, world):
    """``ep_ranks``' cases on one mesh, for a rank in it."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import Model, moe
    from repro_torch.sharding import make_plan, param_shardings, use_rules
    from repro_torch.sharding.ctx import mesh_sizes

    sizes = mesh_sizes(mesh)
    dp = [a for a in ("pod", "data") if a in sizes]
    block = moe._block(mesh, dp)  # this rank's token shard: its index over the data axes
    b = xt.shape[0] // math.prod(sizes[a] for a in dp)
    xl = xt[block * b:(block + 1) * b]
    for mode in modes:
        plan = make_plan("t", moe_mode=mode)
        kinds = [("plain", p)]
        if (shape, mode) in (((2, 4), "capacity"), ((2, 2), "resident")):
            axes_tree = Model(cfg, device="meta").param_axes({"moe": p})["moe"]
            sh = param_shardings(mesh, plan, axes_tree, p)
            kinds.append(("dtensor", {k: distribute_tensor(v, mesh, sh[k].placements)
                                      for k, v in p.items()}))
        for kind, weights in kinds:
            with use_rules(mesh, plan.activation_rules, moe_mode=mode):
                y, aux = moe.apply_moe(weights, xl, cfg)
            out[(shape, mode, kind)] = (block, y.detach().numpy(), float(aux))
    if shape == (2, 4):
        live = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        with use_rules(mesh, make_plan("t").activation_rules, moe_mode="capacity"):
            y, aux = moe.apply_moe(live, xl, cfg)
        ((y ** 2).sum() / sizes["model"] + aux / world).backward()
        out["grads"] = {k: v.grad.numpy() for k, v in live.items()}


def restart_ranks(rank, world, cfg, weights, x, tmp):
    """``apply_moe`` in resident mode on a (2, 2) ("data", "model") mesh
    tiled over the world, whose experts' group spans both axes; then the
    world is destroyed and made anew on a new store with the ranks
    renumbered, as an elastic restart makes it, and the same layer runs on
    new meshes: [(copy, data block, y, aux)] of each run, by run."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import moe, params_from_numpy
    from repro_torch.sharding import make_plan, use_rules

    p = params_from_numpy(weights, device="cpu")
    xt = torch.from_numpy(x)
    plan = make_plan("t", moe_mode="resident")
    out = []
    for store in ("store", "store-new"):
        if out:  # the new world: old ranks (0, 2, 4, 6) make the first copy
            dist.destroy_process_group()
            rank = (rank % 2) * (world // 2) + rank // 2
            dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / store), world),
                                    rank=rank, world_size=world)
        copies = [DeviceMesh("cpu", torch.arange(i * 4, (i + 1) * 4).reshape(2, 2),
                             mesh_dim_names=("data", "model")) for i in range(world // 4)]
        mesh = copies[rank // 4]
        block = moe._block(mesh, ("data",))
        b = xt.shape[0] // 2
        with use_rules(mesh, plan.activation_rules, moe_mode="resident"):
            y, aux = moe.apply_moe(p, xt[block * b:(block + 1) * b], cfg)
        out.append((rank // 4, block, y.numpy(), float(aux)))
    return out


def psum_ranks(rank, world, xs):
    """``compressed_psum`` of this rank's ``xs[rank]`` over the world."""
    import torch

    from repro_torch.training.compress import compressed_psum

    return compressed_psum(torch.from_numpy(np.asarray(xs[rank]))).numpy()


def sharded_step_ranks(rank, world, arch, weights, moments, tokens, opt_cfg):
    """One train step of the reduced ``arch`` (remat on) on a (2, 2)
    ("data", "model") mesh at the "tp" plan's placements: every parameter
    and both AdamW moments ``DTensor``s (distributed from the same whole
    trees on every rank; ``moments`` is (m, v, step)), the batch split over
    "data".  Returns (loss, [each parameter leaf whole after the step]) as
    numpy."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.sharding import logical_to_mesh, make_plan, param_shardings
    from repro_torch.sharding.rules import map_axes
    from repro_torch.training import OptState, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config(arch).reduced()
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu", remat=True)
    plan = make_plan("tp")
    p = params_from_numpy(weights, device="cpu")
    axes = model.param_axes(p)
    sh = param_shardings(mesh, plan, axes, p)
    place = lambda tree: map_axes(  # noqa: E731
        lambda _, t, s: distribute_tensor(t, mesh, s.placements), axes,
        params_from_numpy(tree, device="cpu"), sh)
    params = place(weights)
    m, v, step = moments
    opt = OptState(place(m), place(v), torch.tensor(step, dtype=torch.int32))
    tok = torch.from_numpy(tokens)
    tok_sh = logical_to_mesh(mesh, plan.activation_rules, ("batch", "seq"), tok.shape)
    batch = {"tokens": distribute_tensor(tok, mesh, tok_sh.placements)}
    with implicit_replication():
        params, _, metrics = make_train_step(model, mesh, plan, opt_cfg=opt_cfg)(params, opt, batch)
    return (float(metrics["loss"].full_tensor()),
            [t.full_tensor().numpy() for t in tree_leaves(params)])


def sharded_decode_ranks(rank, world, arch, weights, cache, tokens, index):
    """One decode step of the reduced ``arch`` on a (2, 2) ("data",
    "model") mesh at the "tp" plan's placements: parameters and the cache
    (``init_cache``'s tree, float32, batch over "data" and the sequence over
    "model") ``DTensor``s, the tokens split over "data", ``index`` a 0-d
    position.  Returns (logits, the cache's leaves after the step), whole,
    as numpy."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.sharding import logical_to_mesh, make_plan, param_shardings
    from repro_torch.sharding.rules import map_axes
    from repro_torch.training import make_serve_steps
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config(arch).reduced()
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")
    plan = make_plan("tp")
    p = params_from_numpy(weights, device="cpu")
    axes = model.param_axes(p)
    params = map_axes(lambda _, t, s: distribute_tensor(t, mesh, s.placements), axes, p,
                      param_shardings(mesh, plan, axes, p))
    rules = plan.activation_rules
    c = map_axes(lambda names, a: distribute_tensor(
        torch.from_numpy(a), mesh, logical_to_mesh(mesh, rules, names, a.shape).placements),
        model.cache_axes(), cache)
    tok = torch.from_numpy(tokens)
    tok = distribute_tensor(tok, mesh, logical_to_mesh(mesh, rules, ("batch", None),
                                                       tok.shape).placements)
    with implicit_replication():
        logits, c = make_serve_steps(model, mesh, plan)[1](params, tok, c, torch.tensor(index))
    return logits.full_tensor().numpy(), [t.full_tensor().numpy() for t in tree_leaves(c)]
