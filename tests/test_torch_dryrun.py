"""The dry-run accounting (``launch/dryrun.py``, ``kernels/counts.py``, the
kernel twins of ``kernels/ops.py``) and the steps on ``DTensor`` leaves.

* Each kernel wrapper on tensors that hold no data (fake on the CPU and on
  "cuda", and ``meta``) returns the plain version's output shapes and
  dtypes, adds ``kernels/counts.py``'s bytes and operations to the active
  accounting, and launches nothing; under autograd the forward twins reach
  the backward ones.
* A reduced minicpm-2b and mamba2-130m train step on 4 gloo ranks, every
  parameter and moment a ``DTensor`` at the "tp" plan's placements on a (2,
  2) mesh, against the unsharded step.
* Per-device FLOPs: a (4, 1) mesh's train cell reads a quarter of the (1, 1)
  mesh's.
* Cells of the port's dry run against the reference's own (the
  reference run as it is, its ``jax.make_mesh`` given the Auto axis types
  its code was written for, which this jax no longer defaults to).
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import counts, ops
from repro_torch.utils.comms import Accounting, KINDS
from torch_dist_ranks import run_ranks, sharded_decode_ranks, sharded_step_ranks

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300


# ------------------------------------------------------------------ twins
def _twin_cases():
    """name -> (inputs maker, call, expected counts from the inputs)."""
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    i32 = lambda hi, *s: torch.randint(0, hi, s, generator=g, dtype=torch.int32)  # noqa: E731
    B, S, H, KH, hd = 2, 16, 4, 2, 32
    P, N, Q = 8, 16, 8
    f32 = 4

    def ssd_in():
        x = rnd(B, S, H, P)
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        return [x, dt, -torch.exp(rnd(H)), rnd(B, S, 1, N), rnd(B, S, 1, N)]

    def ssd_bwd_in():
        t = ssd_in()
        return t + [rnd(B, S, H, P)]

    def flash_bwd_in():
        q, k, v = rnd(B, S, H, hd), rnd(B, S, KH, hd), rnd(B, S, KH, hd)
        out, lse = rnd(B, S, H, hd), rnd(B, H, S)
        return [q, k, v, out, lse, rnd(B, S, H, hd)]

    return {
        "sched_events": (
            lambda: [torch.zeros(6, dtype=torch.int32), i32(3, 6), torch.full((6,), -1,
                     dtype=torch.int32), i32(3, 3, 5), i32(4, 5)],
            lambda t: ops.sched_events(*t),
            lambda t: counts.sched_counts(np.zeros(6, np.int32), 3, 5)),
        "sched_step": (
            lambda: [i32(3, 6), i32(3, 3, 5), i32(4, 5)],
            lambda t: ops.sched_step(*t),
            lambda t: counts.sched_counts(np.zeros(6, np.int32), 3, 5)),
        "ssd_scan": (
            ssd_in, lambda t: ops.ssd_scan(*t, chunk=Q),
            lambda t: counts.ssd_counts(B, S, H, P, N, Q, f32)),
        "ssd_scan_bwd": (
            ssd_bwd_in,
            lambda t: ops.ssd_scan_bwd(*t[:5], Q, None, t[5], None,
                                       ops._ssd_forward(*t[:5], Q, None, keep=True)[2]),
            lambda t: counts.ssd_bwd_counts(B, S, H, P, N, 1, Q, f32)),
        "flash_attention": (
            lambda: [rnd(B, S, H, hd), rnd(B, S, KH, hd), rnd(B, S, KH, hd)],
            lambda t: ops.flash_attention(*t, True, 4),
            lambda t: counts.flash_counts(B, S, H, KH, hd, True, 4, f32)),
        "flash_attention_bwd": (
            flash_bwd_in, lambda t: ops.flash_attention_bwd(*t, True, None),
            lambda t: counts.flash_bwd_counts(B, S, H, KH, hd, True, None, f32)[:2]),
        "decode_attention": (
            lambda: [rnd(B, H, hd), rnd(B, S, KH, hd), rnd(B, S, KH, hd)],
            lambda t: ops.decode_attention(*t, 9),
            lambda t: counts.decode_counts(S, H, KH, hd, [9] * B, None, f32, f32)),
        "decode_attention_latent": (
            lambda: [rnd(1, 16, 512), rnd(1, 16, 64), rnd(1, 8, 512), rnd(1, 8, 64)],
            lambda t: ops.decode_attention_latent(*t, 5, 0.1),
            lambda t: counts.latent_counts(16, 512, 64, [5], 8, f32, f32)),
    }


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
@pytest.mark.parametrize("name", list(_twin_cases()))
def test_twin_shapes_counts_and_no_launch(name, device):
    make, call, want_counts = _twin_cases()[name]
    real = make()
    plain = _shapes(call(real))
    got = []
    counts._ACTIVE.append(lambda *a: got.append(a))
    before = ops.launch_counts()
    try:
        if device == "meta":
            out = call([t.to("meta") for t in real])
        else:
            with FakeTensorMode():
                out = call([torch.empty(t.shape, dtype=t.dtype, device=device) for t in real])
    finally:
        counts._ACTIVE.pop()
    assert _shapes(out) == plain
    assert all(t.device.type == device for t in (out if isinstance(out, tuple) else (out,)))
    # ssd_scan_bwd's case runs the forward twin first, for its scratch
    assert [a[0] for a in got] == (["ssd_scan"] if name == "ssd_scan_bwd" else []) + [name]
    assert got[-1][1:] == tuple(want_counts(real))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_twins_reach_their_backwards_under_autograd(device):
    # fake on the CPU (a CPU-only build cannot run autograd's engine on fake
    # "cuda" tensors), or meta
    with FakeTensorMode() if device == "cpu" else contextlib.nullcontext(), Accounting() as acc:
        q = torch.empty(1, 16, 2, 32, device=device, requires_grad=True)
        ops.flash_attention(q, q, q).sum().backward()
        x = torch.empty(1, 16, 2, 8, device=device, requires_grad=True)
        dt = torch.empty(1, 16, 2, device=device)
        A = torch.empty(2, device=device)
        Bm = torch.empty(1, 16, 1, 16, device=device)
        y, st = ops.ssd_scan(x, dt, A, Bm, Bm, chunk=8)
        (y.sum() + st.sum()).backward()
    assert {k: acc.census[k] for k in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                                       "ssd_scan_bwd")} == dict.fromkeys(
        ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"), 1)
    assert q.grad.shape == q.shape and x.grad.shape == x.shape


def test_twin_checks_as_the_card_does():
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 24)  # head dim 24: no kernel instance
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="multiple of n_kv_heads"):
            ops.flash_attention(torch.empty(1, 8, 3, 32), torch.empty(1, 8, 2, 32),
                                torch.empty(1, 8, 2, 32))


# ------------------------------------------------------- the sharded step
@pytest.mark.parametrize("arch", ["minicpm_2b", "mamba2_130m"])
def test_sharded_train_step_matches_unsharded(arch, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, OptState, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", remat=True)
    rng = np.random.default_rng(0)
    p = model.init(torch.Generator().manual_seed(0), max_seq=32)
    weights = tree_map(lambda t: t.numpy().copy(), p)
    # a state after some steps, so that the update is smooth in the gradient
    # (a first AdamW step moves each weight by ~lr * sign(g))
    m = tree_map(lambda t: (rng.standard_normal(t.shape) * 1e-3).astype(np.float32), p)
    v = tree_map(lambda t: rng.uniform(1e-4, 1e-3, t.shape).astype(np.float32), p)
    tokens = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=0)
    ranks = run_ranks(sharded_step_ranks, 4, tmp_path, arch, weights, (m, v, 10), tokens,
                      opt_cfg, timeout=TIMEOUT_S)

    T = lambda tree: tree_map(lambda a: torch.from_numpy(a.copy()), tree)  # noqa: E731
    want_p, _, met = make_train_step(model, opt_cfg=opt_cfg)(
        T(weights), OptState(T(m), T(v), torch.tensor(10, dtype=torch.int32)),
        {"tokens": torch.from_numpy(tokens)})
    loss = float(met["loss"])
    for got_loss, leaves in ranks:
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        for got, want in zip(leaves, tree_leaves(want_p)):
            want = want.numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("arch", ["minicpm_2b", "mamba2_130m"])
def test_sharded_decode_step_matches_unsharded(arch, tmp_path):
    """The KV cache's sequence split over "model": each rank writes the new
    row into its own slice (``sharding.ctx.write_rows``) and the attention
    reads the whole cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import make_serve_steps
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    p = model.init(torch.Generator().manual_seed(0), max_seq=32)
    weights = tree_map(lambda t: t.numpy().copy(), p)
    cache = tree_map(lambda t: rng.standard_normal(t.shape).astype(np.float32),
                     model.init_cache(4, 32, dtype=torch.float32))
    tokens = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    ranks = run_ranks(sharded_decode_ranks, 4, tmp_path, arch, weights, cache, tokens, 21,
                      timeout=TIMEOUT_S)
    T = lambda tree: tree_map(lambda a: torch.from_numpy(a.copy()), tree)  # noqa: E731
    logits, want = make_serve_steps(model)[1](T(weights), torch.from_numpy(tokens), T(cache),
                                               torch.tensor(21))
    for got_logits, leaves in ranks:
        np.testing.assert_allclose(got_logits, logits.numpy(), rtol=1e-5,
                                   atol=1e-5 * np.abs(logits.numpy()).max())
        for got, w in zip(leaves, tree_leaves(want)):
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-5 * np.abs(w.numpy()).max())


# ------------------------------------------------------------- the dry run
def _port_cell(tmp_path, arch, shape, mesh_shape, tag=""):
    out = tmp_path / f"port{tag}"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                        "--arch", arch, "--shape", shape, "--mesh", "single", "--mesh-shape",
                        mesh_shape, "--out", str(out), "--force"],
                       env=env, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((out / f"{arch.replace('-', '_')}__{shape}__single.json").read_text())


def test_per_device_flops_split_over_data(tmp_path):
    whole = _port_cell(tmp_path, "mamba2-130m", "train_4k", "1x1", "1")
    split = _port_cell(tmp_path, "mamba2-130m", "train_4k", "4x1", "4")
    assert whole["n_chips"] == 1 and split["n_chips"] == 4
    f1, f4 = whole["cost_analysis"]["flops"], split["cost_analysis"]["flops"]
    assert f1 > 0
    assert abs(f4 / f1 - 0.25) <= 0.01 * 0.25
    assert split["op_census"]["ssd_scan"] == 48 and split["op_census"]["ssd_scan_bwd"] == 24


# the reference's dry run with jax.make_mesh's axes Auto
REF_RUN = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
from jax.sharding import AxisType
_make = jax.make_mesh
jax.make_mesh = lambda shape, axes, **kw: _make(
    shape, axes, **{"axis_types": (AxisType.Auto,) * len(shape), **kw})
from repro.launch import dryrun
sys.exit(dryrun.main(sys.argv[1:]))
"""

PARITY_CELLS = [("mamba2-130m", "decode_32k"), ("mamba2-130m", "prefill_32k"),
                ("mamba2-130m", "train_4k")]
SAME = ("plan", "kind", "n_chips", "mesh_shape", "arg_bytes_per_device",
        "out_bytes_per_device")


@pytest.mark.parametrize("arch, shape", PARITY_CELLS)
def test_dryrun_cell_matches_reference(arch, shape, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_DRYRUN_DEVICES": "16",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", REF_RUN, "--arch", arch, "--shape", shape,
                        "--mesh", "single", "--mesh-shape", "4x4", "--out", str(tmp_path / "ref"),
                        "--force"], env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    name = f"{arch.replace('-', '_')}__{shape}__single.json"
    ref = json.loads((tmp_path / "ref" / name).read_text())
    got = _port_cell(tmp_path, arch, shape, "4x4")
    for key in SAME:
        assert got[key] == ref[key], key
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert got["cost_analysis"]["flops"] > 0
    assert set(got["collectives"]) <= set(KINDS)
    # the partitioner and DTensor place differently: shown, not held
    print(f"\n{arch} {shape} collectives (count, result bytes): port / reference")
    for kind in KINDS:
        a, b = got["collectives"].get(kind, {}), ref["collectives"].get(kind, {})
        print(f"  {kind:18s} {a.get('count', 0):5d} {a.get('result_bytes', 0):.3e} / "
              f"{b.get('count', 0):5d} {b.get('result_bytes', 0):.3e}")


def test_chip_smoke_dryrun_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's ``dryrun`` phase, rehearsed: its first CLI cell and a
    prefill cell, in two processes at once, on a "cpu" mesh, then
    ``train_mamba``'s step accounted on fake CPU tensors against the
    phase's bound formula and the card's 4.6 GiB (PERF.md)."""
    import chip_smoke

    from repro_torch import training
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    popen = subprocess.Popen
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DRYRUN_OUT", tmp_path)
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS", chip_smoke.DRYRUN_CELLS[:1] + (
        ("mamba2-130m", "prefill_32k", "4x4"),))
    monkeypatch.setattr(chip_smoke.subprocess, "Popen",
                        lambda cmd, **kw: popen(cmd + ["--device", "cpu"], **kw))
    cfg = get_config("mamba2_130m")
    n_ops = 8 * cfg.n_params() * chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ
    chip_smoke.phase_dryrun(torch, get_config, Model, training, ([], 190.0, n_ops, 4.6))
    assert {p.name for p in tmp_path.iterdir()} == {"mamba2_130m__decode_32k__single.json",
                                                    "mamba2_130m__prefill_32k__single.json"}
