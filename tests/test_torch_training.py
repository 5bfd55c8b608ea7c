"""The port's ``training/`` against the JAX package's, on the CPU: schedules,
AdamW on identical gradients, the Markov LM's batches, checkpoints (round
trips, integrity, GC, async, and restores across the two packages), int8
compression, pull dispatch, the whole train step against
``make_train_step(mesh=None)``, and the loss falling on the Markov LM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro.training import OptConfig as JOptConfig
from repro.training import OptState as JOptState
from repro.training import adamw_update as jax_adamw_update
from repro.training import checkpoint as jax_ckpt
from repro.training import compress as jax_compress
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro.training import schedule_lr as jax_schedule_lr
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import MarkovLM as JMarkovLM
from repro.training.pull_dispatch import simulate_dispatch as jax_simulate_dispatch
from repro_torch.configs import get_config
from repro_torch.models import Model, opt_state_from_numpy, params_from_numpy
from repro_torch.training import (OptConfig, OptState, adamw_update, init_opt_state,
                                  make_train_step, schedule_lr)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compress
from repro_torch.training.data import DataConfig, MarkovLM, device_put_batch
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.pull_dispatch import simulate_dispatch

# AdamW on identical gradients runs the same float32 operations in the same
# order: a few ulp apart
TOL_ADAM = dict(atol=1e-7, rtol=1e-6)
TOL_MODEL = dict(atol=1e-4, rtol=1e-3)  # a model's loss and gradients (test_torch_loss.py)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_jax(schedule):
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=10, total_steps=110, stable_frac=0.5)
    jcfg, cfg = JOptConfig(**kw), OptConfig(**kw)
    steps = list(range(0, 131, 2))
    want = [float(jax_schedule_lr(jcfg, jnp.int32(s))) for s in steps]
    got = [float(schedule_lr(cfg, torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=1e-6)
    assert got[0] == 0.0 and max(got) == pytest.approx(3e-3)


@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_jax(clip):
    """From the same non-zero state and gradients; with the clip engaged
    (global norm far above ``clip_norm``) and not."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "blk": {"x": (3, 4, 5), "y": (7,)}}
    draw = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads, m = draw(1.0), draw(3.0), draw(0.1)
    v = jax.tree.map(np.abs, draw(0.01))
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=50, clip_norm=1.0 if clip else 1e6)
    jp, js, jm = jax_adamw_update(jax.tree.map(jnp.asarray, grads),
                                  JOptState(jax.tree.map(jnp.asarray, m),
                                            jax.tree.map(jnp.asarray, v), jnp.int32(4)),
                                  jax.tree.map(jnp.asarray, params), JOptConfig(**kw))
    tp, ts, tm = adamw_update(params_from_numpy(grads, device="cpu"),
                              opt_state_from_numpy(m, v, 4, device="cpu"),
                              params_from_numpy(params, device="cpu"), OptConfig(**kw))
    assert (float(jm["grad_norm"]) > kw["clip_norm"]) == clip
    assert int(ts.step) == int(js.step) == 5
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), **TOL_ADAM)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_ADAM)


def test_init_opt_state_matches_jax():
    params = {"a": np.ones((3, 2), np.float32), "b": {"c": np.zeros(4, np.float32)}}
    js = jax_init_opt_state(jax.tree.map(jnp.asarray, params))
    ts = init_opt_state(params_from_numpy(params, device="cpu"))
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    for g, w in zip(tree_leaves(ts.m) + tree_leaves(ts.v), jax.tree.leaves((js.m, js.v))):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape and not g.any()


def test_markov_batches_match_jax_bit_for_bit():
    kw = dict(vocab=64, seq_len=16, global_batch=8, seed=3)
    jlm, lm = JMarkovLM(JDataConfig(**kw)), MarkovLM(DataConfig(**kw))
    for step in (0, 5, 6, 99):
        for host, n_hosts in ((0, 1), (0, 2), (1, 2), (3, 4)):
            want = jlm.batch_at(step, host, n_hosts)["tokens"]
            got = lm.batch_at(step, host, n_hosts)["tokens"]
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(lm.global_batch_at(step)["tokens"],
                              jlm.global_batch_at(step)["tokens"])
    assert lm.entropy_floor_nats() == jlm.entropy_floor_nats()
    batch = device_put_batch(lm.batch_at(1), device="cpu")
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].shape == (8, 16)


def _tree():
    """A checkpoint tree with float32, int32 and bfloat16 leaves, a list and
    an optimizer state (named-tuple fields)."""
    p = {"a": torch.arange(12.0).reshape(3, 4), "n": {"b": torch.ones(2, dtype=torch.int32)},
         "h": torch.linspace(-3, 3, 10).to(torch.bfloat16), "l": [torch.zeros(2), torch.ones(1)]}
    return {"params": p, "opt": init_opt_state(p)._replace(step=torch.tensor(7, dtype=torch.int32))}


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_and_integrity(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 7, tree)
    restored, step = ckpt.restore(tmp_path, tree, device="cpu")
    assert step == 7 and isinstance(restored["opt"], OptState)
    _same(restored, tree)
    path = tmp_path / "step_00000007" / "arrays.npz"
    data = dict(np.load(path))
    data["params/a"] = data["params/a"] + 1
    np.savez(path, **data)
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, tree, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", tree, device="cpu")


def test_checkpoint_gc_and_async(tmp_path):
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003", "step_00000004"]
    t = ckpt.save_async(tmp_path, 9, tree)
    tree["a"].add_(5.0)  # the train step updates in place: the snapshot is already taken
    ckpt.wait_pending(tmp_path)
    assert not t.is_alive() and ckpt.latest_step(tmp_path) == 9
    restored, _ = ckpt.restore(tmp_path, tree, device="cpu")
    assert not restored["a"].any()


def test_checkpoints_cross_restore_between_packages(tmp_path):
    """A checkpoint the JAX package wrote restores in the port, and one the
    port wrote restores in the JAX package: the same keys, bytes and
    dtypes (bfloat16 as uint16 bits) for a tree with an optimizer state."""
    tree = _tree()
    jtree = {"params": jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype), tree["params"]),
        "opt": JOptState(*(jax.tree.map(lambda t: jnp.asarray(t.numpy()), f) for f in tree["opt"]))}
    jax_ckpt.save(tmp_path / "jax", 3, jtree)
    restored, step = ckpt.restore(tmp_path / "jax", tree, device="cpu")
    assert step == 3
    _same(restored, tree)
    ckpt.save(tmp_path / "port", 4, tree)
    back, step = jax_ckpt.restore(tmp_path / "port", jtree)
    assert step == 4 and isinstance(back["opt"], JOptState)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), np.asarray(y))


def test_compression_matches_jax():
    x = (np.random.default_rng(0).standard_normal(1000) * 3.0).astype(np.float32)
    jq, js = jax_compress.quantize(jnp.asarray(x))
    q, s = compress.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    y = compress.dequantize(q, s, x.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_compress.dequantize(jq, js, x.shape)),
                               rtol=1e-7)
    err = compress.compress_roundtrip_error(torch.from_numpy(x))
    assert err < 2e-2 and err == pytest.approx(jax_compress.compress_roundtrip_error(
        jnp.asarray(x)), rel=1e-6)
    grads = {"a": x[:300].reshape(30, 10), "b": x[300:]}
    residual = {"a": x[:300].reshape(30, 10) * 1e-3, "b": x[300:] * 1e-3}
    jd, jr = jax_compress.compressed_grad_tree(jax.tree.map(jnp.asarray, grads),
                                               jax.tree.map(jnp.asarray, residual))
    d, r = compress.compressed_grad_tree(params_from_numpy(grads, device="cpu"),
                                         params_from_numpy(residual, device="cpu"))
    for g, w in zip(tree_leaves(d) + tree_leaves(r), jax.tree.leaves(jd) + jax.tree.leaves(jr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(n_micro=256, n_replicas=16, straggler_frac=0.12,
                                     slowdown=3.0, seed=4),
                                dict(n_micro=256, n_replicas=16, straggler_frac=0.0,
                                     jitter=0.01, seed=5)])
def test_simulate_dispatch_matches_jax(kw):
    for got, want in zip(simulate_dispatch(**kw), jax_simulate_dispatch(**kw)):
        assert got.makespan == want.makespan and got.assignment == want.assignment
        assert np.array_equal(got.per_replica_counts, want.per_replica_counts)


@pytest.mark.parametrize("arch,extra", [("minicpm_2b", set()),
                                        ("mixtral_8x22b", {"moe_aux"}),
                                        ("deepseek_v3_671b", {"moe_aux", "mtp_ce"})])
def test_train_step_matches_jax(arch, extra):
    """``make_train_step`` on reduced minicpm-2b, mixtral-8x22b (softmax
    top-2 over 4 experts, capacity dispatch) and deepseek-v3 (MLA, a dense
    layer, sigmoid top-2 with a shared expert, the MTP head) against the JAX
    package's ``make_train_step(model, opt_cfg=...)`` (mesh=None), from the
    same weights and the same non-zero optimizer state (one JAX step taken
    first): the metrics (``moe_aux`` and ``mtp_ce`` where the family has
    them) and the gradients to the model tolerance, the parameters and
    moments after the step within 1e-5 (a moment of the non-zero state keeps
    the update smooth in the gradient, so the model's gradient tolerance
    carries over scaled by lr)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, schedule="wsd")
    jstep = jax_make_train_step(jmodel, opt_cfg=JOptConfig(**kw))
    data = MarkovLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0))
    jparams, jstate, _ = jstep(jparams, jax_init_opt_state(jparams),
                               {"tokens": jnp.asarray(data.batch_at(0)["tokens"])})
    params = params_from_numpy(_np(jparams), device="cpu")
    state = opt_state_from_numpy(_np(jstate.m), _np(jstate.v), jstate.step, device="cpu")
    batch = data.batch_at(1)
    jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(batch["tokens"])})
    step = make_train_step(Model(cfg, device="cpu"), OptConfig(**kw))
    params, state, m = step(params, state, device_put_batch(batch, device="cpu"))
    assert set(m) == set(jm) == {"loss", "ce", "grad_norm", "lr"} | extra
    for key in jm:
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), **TOL_MODEL)
    assert int(state.step) == int(jstate.step) == 2
    for got, want in ((params, jparams), (state.m, jstate.m), (state.v, jstate.v)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_loss_decreases_small_model():
    """The reference's ``test_loss_decreases_small_model`` through the port:
    400 WSD steps of reduced minicpm-2b on the Markov LM must beat the
    unigram baseline and approach the chain's entropy floor."""
    cfg = get_config("minicpm_2b").reduced()
    model = Model(cfg, device="cpu", remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    data = MarkovLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0))
    step = make_train_step(model, OptConfig(lr=1e-2, warmup_steps=20, total_steps=400,
                                            schedule="wsd"))
    opt = init_opt_state(params)
    losses = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # ~1,000 small ops a step: one thread beats a contended pool
    try:
        for i in range(400):
            params, opt, metrics = step(params, opt,
                                        device_put_batch(data.batch_at(i), device="cpu"))
            losses.append(float(metrics["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert losses[-1] < losses[0] * 0.35, (losses[0], losses[-1])
    # the chain's floor is ~0.9 nats, far below ln(V) = 5.5
    assert losses[-1] < 2.0, losses[-1]


def test_adamw_update_in_slices_is_the_whole_leaf_update(monkeypatch):
    """``adamw_update`` over flat slices of ``UPDATE_CHUNK`` elements (here 7,
    so that slices end mid-row and one is short) gives the whole-leaf
    update bit for bit: parameters (float32 and bfloat16), moments and the
    step's metrics, from a non-zero state; a non-contiguous gradient leaf
    takes the whole-leaf path."""
    from repro_torch.training import optimizer

    rng = np.random.default_rng(3)
    leaf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    params = {"a": leaf(5, 9), "b": leaf(30), "c": leaf(4, 6).to(torch.bfloat16)}
    grads = {"a": leaf(5, 9), "b": leaf(30), "c": leaf(6, 4).t()}
    state = OptState({k: leaf(*t.shape) for k, t in params.items()},
                     {k: leaf(*t.shape).abs() for k, t in params.items()},
                     torch.tensor(3, dtype=torch.int32))
    cfg = OptConfig(lr=1e-2, warmup_steps=0)
    runs = []
    for chunk in (optimizer.UPDATE_CHUNK, 7):
        monkeypatch.setattr(optimizer, "UPDATE_CHUNK", chunk)
        copy = lambda tree: {k: t.clone() for k, t in tree.items()}  # noqa: E731
        s = OptState(copy(state.m), copy(state.v), state.step.clone())
        runs.append(adamw_update(copy(grads), s, copy(params), cfg))
    (p1, s1, m1), (p2, s2, m2) = runs
    for a, b in zip(tree_leaves((p1, s1.m, s1.v, m1)), tree_leaves((p2, s2.m, s2.v, m2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_updates_in_place():
    """``adamw_update`` writes the parameters and moments where they lie
    (no second copy of the model) and leaves the caller's step tensor."""
    params = {"w": torch.ones(4, 4)}
    state = init_opt_state(params)
    ptr = params["w"].data_ptr(), state.m["w"].data_ptr(), state.v["w"].data_ptr()
    new_p, new_s, _ = adamw_update({"w": torch.full((4, 4), 0.5)}, state, params,
                                   OptConfig(lr=1e-2, warmup_steps=0))
    assert (new_p["w"].data_ptr(), new_s.m["w"].data_ptr(), new_s.v["w"].data_ptr()) == ptr
    assert int(state.step) == 0 and int(new_s.step) == 1
    assert new_p["w"].lt(1.0).all()
