"""The port's hybrid family (zamba2-2.7b: groups of Mamba2 layers, each
followed by one application of a shared attention block) held against the
JAX package on the CPU, at ``reduced()`` (6 Mamba layers in 2 groups of 3,
so both shared blocks are applied), with the JAX ``Model.init`` weights
carried across by ``params_from_numpy`` and inputs drawn with numpy from a
seed; float32 to ``atol=1e-4, rtol=1e-3``.

* prefill (logits and every cache leaf) and three ``decode_step``s from a
  cache that holds the prompt; decode from the zero cache of ``init_cache``;
* ``Instance.generate`` gives the JAX package's tokens;
* a ``ContinuousBatcher`` run with slot reuse gives the JAX batcher's tokens,
  and copies its caveat: a released slot keeps its Mamba state, so a request
  admitted into it starts from the previous occupant's state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro.serving import Endpoint as JaxEndpoint
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import GenRequest as JaxRequest
from repro.serving.worker import Instance as JaxInstance
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import ContinuousBatcher, Endpoint, GenRequest, Instance

TOL = dict(atol=1e-4, rtol=1e-3)
S = 40  # > the reduced chunk of 32: two chunks, the second ragged


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _all_close(tcache, jcache):
    """Every leaf of the port's cache against the JAX one, in tree order."""
    tl = [tcache["mamba"].conv, tcache["mamba"].ssm, *tcache["shared_kv"]]
    jl = [jcache["mamba"].conv, jcache["mamba"].ssm, *jcache["shared_kv"]]
    for got, want in zip(tl, jl):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_get_config("zamba2_2p7b").reduced(), get_config("zamba2_2p7b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.n_layers // tcfg.hybrid.every == tcfg.hybrid.n_shared_blocks == 2
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    return jmodel, jparams, Model(tcfg, device="cpu"), params_from_numpy(_np(jparams), device="cpu")


def test_config_copy_matches_jax():
    j, t = jax_get_config("zamba2_2p7b"), get_config("zamba2_2p7b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()
    assert 2.0e9 <= t.n_params() <= 3.5e9  # tests/test_models_smoke.py's range
    assert Endpoint("z", t, max_cache_len=2048).est_bytes() == \
        JaxEndpoint("z", j, max_cache_len=2048).est_bytes()


def test_random_init_matches_jax_layout():
    """The port draws its own weights in the JAX package's tree and shapes:
    ``mamba_groups`` (n_groups, every, ...), ``shared_blocks`` (2, ...)."""
    jcfg, tcfg = jax_get_config("zamba2_2p7b").reduced(), get_config("zamba2_2p7b").reduced()
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           unzip(jax_build_model(jcfg).init(jax.random.key(0)))[0])
    p = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jshapes
    proj = p["shared_blocks"]["proj"]
    assert proj.shape == (2, 2 * tcfg.d_model, tcfg.d_model)
    assert abs(float(proj.std()) - (2 * tcfg.d_model) ** -0.5) < 0.01


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    _all_close(tcache, jcache)
    # decode from a cache of S + 4 positions holding the prompt's K/V and state
    big = [np.zeros(a.shape[:2] + (S + 4,) + a.shape[3:], np.float32) for a in jcache["shared_kv"]]
    for b, a in zip(big, jcache["shared_kv"]):
        b[:, :, :S] = np.asarray(a)
    jc = {"mamba": jcache["mamba"], "shared_kv": tuple(jnp.asarray(b) for b in big)}
    tc = {"mamba": tcache["mamba"], "shared_kv": tuple(torch.tensor(b) for b in big)}
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, S + step)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc, S + step)
        _close(tl, jl)
        _all_close(tc, jc)


def test_decode_from_zero_cache_matches_jax(pair):
    """``Instance.generate``'s decode: the zero cache of ``init_cache`` (the
    same layout in both packages), per-row positions included."""
    jmodel, jparams, tmodel, tparams = pair
    jc = jmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(2, 16, dtype=torch.float32)
    _all_close(tc, jc)
    tok = np.array([[5], [9]], np.int32)
    for idx in (3, 4, np.array([15, 6], np.int32), 16):  # 16: past the end, written at 15
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(idx))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc, torch.as_tensor(idx))
        _close(tl, jl)
        _all_close(tc, jc)


def test_forward_matches_jax(pair):
    """The train-mode forward: the same logits and a zero aux."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(3).integers(0, tmodel.cfg.vocab, (2, 20)).astype(np.int32)
    jl, ja, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    tl, ta, caches = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    assert caches is None and float(ta) == float(ja) == 0.0


# ----------------------------------------------------------------- serving
def _tiny(get):
    cfg = get("zamba2_2p7b").reduced()
    return dataclasses.replace(cfg, vocab=64)


@pytest.mark.parametrize("S,gen_len,seed", [(9, 4, 0), (45, 3, 1)])
def test_generate_matches_jax_tokens(S, gen_len, seed):
    jep = JaxEndpoint("z", _tiny(jax_get_config), seed=seed, max_cache_len=64)
    jinst = JaxInstance(jep)
    ep = Endpoint("z", _tiny(get_config), seed=seed, max_cache_len=64)
    inst = Instance(ep, device="cpu", params=params_from_numpy(_np(jinst.params), device="cpu"))
    tokens = np.random.default_rng(S).integers(0, 64, (2, S)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    np.testing.assert_array_equal(inst.generate(torch.from_numpy(tokens), gen_len).numpy(), want)


@pytest.fixture(scope="module")
def tiny_pair():
    jmodel = jax_build_model(_tiny(jax_get_config), remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(4)))
    return jmodel, jparams, Model(_tiny(get_config), device="cpu"), \
        params_from_numpy(_np(jparams), device="cpu")


def _requests(cls, n, seed):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", prompt=[int(t) for t in rng.integers(0, 64, rng.integers(1, 9))],
                max_new_tokens=int(rng.integers(1, 8))) for i in range(n)]


def test_batcher_matches_jax_tokens(tiny_pair):
    """7 requests through 3 slots (slots reused), the same tokens in the
    same number of steps."""
    jmodel, jparams, model, params = tiny_pair
    jb = JaxBatcher(jmodel, jparams, n_slots=3, max_len=24)
    tb = ContinuousBatcher(model, params, n_slots=3, max_len=24)
    for req in _requests(JaxRequest, 7, 5):
        jb.submit(req)
    for req in _requests(GenRequest, 7, 5):
        tb.submit(req)
    assert tb.run_to_completion() == jb.run_to_completion()
    assert tb.steps == jb.steps


def test_reused_slot_keeps_the_previous_ssm_state(tiny_pair):
    """The reference's caveat, copied: with one slot, request ``b`` admitted
    after ``a`` starts from ``a``'s Mamba state (attention K/V is masked by
    length, the state is not reset).  Both packages give ``b`` the same
    tokens, and its first logits differ from those of ``b`` alone."""
    jmodel, jparams, model, params = tiny_pair
    a, b = [3, 4, 5, 6], [7, 8]
    runs = {}
    for label, reqs in (("after a", [("a", a, 5), ("b", b, 4)]), ("alone", [("b", b, 4)])):
        jb = JaxBatcher(jmodel, jparams, n_slots=1, max_len=24)
        tb = ContinuousBatcher(model, params, n_slots=1, max_len=24)
        for rid, prompt, n in reqs:
            jb.submit(JaxRequest(rid, prompt, max_new_tokens=n))
            tb.submit(GenRequest(rid, prompt, max_new_tokens=n))
        if label == "after a":
            while "a" not in tb.completed:
                tb.step()
                jb.step()
            ssm = tb.mgr.cache["mamba"].ssm[:, :, 0]
            assert float(ssm.abs().max()) > 0  # released, not reset
        tb.step()
        jb.step()
        first = tb.logits[0].clone()
        out, jout = tb.run_to_completion(), jb.run_to_completion()
        assert out["b"] == jout["b"]
        runs[label] = first
    assert float((runs["after a"] - runs["alone"]).abs().max()) > 1e-3
