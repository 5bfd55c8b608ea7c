"""Multi-pod dry run (counterpart of the JAX package's
``launch/dryrun.py``).

For every (architecture x input-shape x mesh) cell: build the step and its
abstract inputs (``launch/specs.py::step_fn_and_specs``), place every input
as a ``DTensor`` of fake local shards at its sharding, run the step once
eagerly under ``FakeTensorMode`` on a ``fake`` process group whose world is
the mesh (only rank 0 exists; nothing is computed or sent), and record one
device's FLOPs, bytes, memory and collectives (``utils/comms.py``), with
the roofline terms.  One JSON per cell under ``--out``
(``benchmarks/results/local/dryrun_torch`` by default, which git ignores);
existing JSONs are skipped unless ``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape decode_32k \\
      --mesh single
  ... --mesh-shape 4x4 --device cpu                              # reduced mesh, on the CPU

The mesh is a ``"cuda"`` ``DeviceMesh`` unless ``--device cpu`` (a CPU-only
build of PyTorch cannot make a ``"cuda"`` mesh); the world is the largest
mesh's size.  The process opens that world itself and refuses to run inside
another, so it runs as a process of its own.

Roofline terms (seconds a step, one device's work), from an NVIDIA H100 SXM
data sheet's figures (computed from these constants, not measured):
  compute    = FLOPs / 989e12 (dense bf16 on the tensor cores)
  memory     = (inputs read once + outputs written once) a device / 3.35e12
               (HBM3); the sum of every op's input and output bytes is kept
               as ``memory_s_xla``
  collective = ring traffic a device / 450e9 (NVLink 4, one direction): a
               floor for a group that spans nodes, whose links are slower.
Per-device FLOPs are the local shards': ``DTensor`` runs each op on them.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs.base import ARCH_ALIASES, ARCH_IDS, SHAPES, get_config
from ..sharding.ctx import mesh_sizes
from ..sharding.rules import NamedSharding, make_plan
from ..utils.comms import Accounting, collective_stats, op_census, total_collective_bytes
from .mesh import AXES, MULTI_POD_AXES, MULTI_POD_SHAPE, SHAPE
from .specs import step_fn_and_specs

# NVIDIA H100 SXM (data sheet), per card: the roofline's denominators
PEAK_FLOPS = 989e12  # dense bf16
HBM_BW = 3.35e12     # HBM3
LINK_BW = 450e9      # NVLink 4, one direction


def mesh_dims(mesh_arg: str, mesh_shape: str | None):
    """(dims, axis names) of ``--mesh`` / ``--mesh-shape``, as the
    reference reads them."""
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split("x"))
        return dims, (MULTI_POD_AXES if len(dims) == 3 else AXES)
    if mesh_arg == "multi":
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return SHAPE, AXES


def open_world(size: int) -> None:
    """A ``fake`` process group of ``size`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run opens a fake world of its own: run it in a process "
                           "with no process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(dims, axes, device_type: str):
    """A ``DeviceMesh`` over the first prod(dims) ranks of the world."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(dims)
    return DeviceMesh(device_type, torch.arange(n).reshape(dims), mesh_dim_names=axes)


def _leaves_with(tree, shardings, fn):
    """``fn(leaf, sharding)`` over ``tree``, the same structure back;
    ``shardings`` has ``tree``'s structure or is a prefix of it (one
    ``NamedSharding`` for a whole subtree)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    sub = (lambda k: shardings) if isinstance(shardings, NamedSharding) else \
        (lambda k: shardings[k])
    if isinstance(tree, dict):
        return {k: _leaves_with(v, sub(k), fn) for k, v in tree.items()}
    items = [_leaves_with(v, sub(i), fn) for i, v in enumerate(tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def local_shape(shape, sh: NamedSharding) -> list:
    """The shape of one rank's shard of a tensor of ``shape`` at ``sh``
    (the plans split a dim only where it divides)."""
    sizes = mesh_sizes(sh.mesh)
    out = list(shape)
    for dim, entry in enumerate(sh.spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[dim] //= sizes[ax]
    return out


def sharded_arg_bytes(args, shardings) -> int:
    """Exact per-device resident bytes of a tree of tensors (global shapes)
    at its shardings."""
    total = 0

    def one(t, sh):
        nonlocal total
        total += math.prod(local_shape(t.shape, sh)) * t.element_size()

    _leaves_with(args, shardings, one)
    return total


def materialize(args, shardings, device):
    """Each ``meta`` leaf of ``args`` as a ``DTensor`` at its sharding whose
    local shard is a fake tensor on ``device`` (call under a
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        loc = torch.empty(local_shape(t.shape, sh), dtype=t.dtype, device=device)
        return DTensor.from_local(loc, sh.mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return _leaves_with(args, shardings, one)


def run_cell(arch: str, shape: str, mesh, mesh_name: str, plan=None, remat=True,
             level: str = "baseline", device=None) -> dict:
    """One cell's record (the reference's keys; ``trace_s`` for its
    ``lower_s`` / ``compile_s``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    device = torch.device(device or mesh.device_type)
    cfg = get_config(arch)
    t0 = time.time()
    fn, args, in_sh, out_sh, plan = step_fn_and_specs(cfg, shape, mesh, plan=plan, remat=remat,
                                                      level=level, device=device)
    acc = Accounting()
    with FakeTensorMode(allow_non_fake_inputs=True):
        placed = materialize(args, in_sh, device)
        acc.track(placed)
        arg_live = acc.live_bytes
        with acc, implicit_replication():
            out = fn(*placed)
        del placed
        held = Accounting()
        held.track(out)
    t_trace = time.time() - t0

    stats = collective_stats(acc)
    traffic_b, result_b = total_collective_bytes(stats)
    n_chips = math.prod(mesh.shape)
    seq, batch, kind = SHAPES[shape]
    flops_dev, bytes_dev = acc.flops, acc.bytes
    arg_bytes = sharded_arg_bytes(args, in_sh)
    out_bytes = sharded_arg_bytes(out, out_sh)
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = (arg_bytes + out_bytes) / HBM_BW
    memory_s_xla = bytes_dev / HBM_BW
    collective_s = traffic_b / LINK_BW

    n_tok = batch * (1 if kind == "decode" else seq)
    model_flops = (6 if kind == "train" else 2) * cfg.n_active_params() * n_tok
    total_flops = flops_dev * n_chips
    return {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "mesh_shape": {k: int(v) for k, v in mesh_sizes(mesh).items()},
        "plan": plan.name,
        "kind": kind,
        "n_chips": n_chips,
        "device": device.type,
        "trace_s": round(t_trace, 2),
        "memory_analysis": {"argument_size_in_bytes": arg_live,
                            "output_size_in_bytes": held.live_bytes,
                            "peak_size_in_bytes": acc.peak_bytes},
        "arg_bytes_per_device": arg_bytes,
        "out_bytes_per_device": out_bytes,
        "cost_analysis": {"flops": flops_dev, "bytes accessed": bytes_dev},
        "collectives": stats,
        "collective_traffic_bytes_per_device": traffic_b,
        "collective_result_bytes_per_device": result_b,
        "op_census": op_census(acc),
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "memory_s_xla": memory_s_xla,
            "collective_s": collective_s,
            "dominant": max(
                ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                key=lambda kv: kv[1],
            )[0],
            "model_flops": model_flops,
            "hlo_flops_total": total_flops,
            "useful_flops_ratio": model_flops / total_flops if total_flops else 0.0,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None, help="override e.g. 4x4 (CI)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help='the mesh\'s device type and the fake shards\' device ("cpu": a '
                         "CPU-only build of PyTorch)")
    ap.add_argument("--out", default="benchmarks/results/local/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--plan", default=None, help="fsdp|tp|tp+seqshard override")
    ap.add_argument("--level", default="baseline", choices=["baseline", "opt"],
                    help="opt = the EP MoE modes and weight-stationary decode")
    ap.add_argument("--tag", default="", help="suffix for result filenames")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else [ARCH_ALIASES.get(args.arch, args.arch).replace("-", "_")]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    plan = None
    if args.plan:
        plan = make_plan(args.plan, fsdp="fsdp" in args.plan, seq_shard="seqshard" in args.plan)

    dims = {m: mesh_dims(m, args.mesh_shape) for m in meshes}
    open_world(max(math.prod(d) for d, _ in dims.values()))
    n_ok = n_skip = n_fail = 0
    for mesh_name in meshes:
        mesh = make_mesh(*dims[mesh_name], args.device)
        for arch in archs:
            cfg = get_config(arch)
            for shape in shapes:
                cell_id = f"{arch}__{shape}__{mesh_name}" + (f"__{args.tag}" if args.tag else "")
                path = outdir / f"{cell_id}.json"
                if path.exists() and not args.force:
                    print(f"[skip-cached] {cell_id}")
                    n_ok += 1
                    continue
                if shape == "long_500k" and not cfg.sub_quadratic:
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "skipped": True,
                        "note": "pure full-attention arch; see DESIGN.md §4",
                    }, indent=1))
                    print(f"[skip-noted ] {cell_id}")
                    n_skip += 1
                    continue
                try:
                    res = run_cell(arch, shape, mesh, mesh_name, plan=plan,
                                   remat=not args.no_remat, level=args.level)
                    path.write_text(json.dumps(res, indent=1))
                    r = res["roofline"]
                    print(
                        f"[ok] {cell_id}: trace={res['trace_s']}s "
                        f"flops/dev={res['cost_analysis'].get('flops', 0):.3e} "
                        f"terms(c/m/coll)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
                        f"{r['collective_s']:.2e}s dominant={r['dominant']}",
                        flush=True,
                    )
                    n_ok += 1
                except Exception:
                    n_fail += 1
                    err = traceback.format_exc()
                    (outdir / f"{cell_id}.FAILED.txt").write_text(err)
                    print(f"[FAIL] {cell_id}:\n{err}", flush=True)
    print(f"dryrun done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
