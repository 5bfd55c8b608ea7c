"""The port's continuous batching (``serving/kv_cache.py``,
``serving/batching.py``) held against the JAX package's on the CPU, on the
tiny llava-next-mistral-7b of ``tests/test_batching.py`` with the JAX
``Model.init`` weights carried across by ``params_from_numpy``: the
reference's three tests (slots, completion with interleaving, batched
isolation) on the port, and the port's batcher giving the JAX batcher's
tokens exactly for the same requests (greedy argmax over float32 logits that
agree to ~1e-6, so the tokens agree unless two logits tie that closely)."""

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
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import GenRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import CacheManager, ContinuousBatcher, GenRequest


def _tiny(get):
    cfg = get("llava_next_mistral_7b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                               head_dim=16, d_ff=64, vocab=64)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _tiny(jax_get_config), _tiny(get_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(tcfg, device="cpu"), tparams


def test_cache_manager_slots(pair):
    _, _, model, _ = pair
    mgr = CacheManager(model, n_slots=3, max_len=16, dtype=torch.float32)
    a, b, c = (mgr.allocate(r) for r in "abc")
    assert {a.idx, b.idx, c.idx} == {0, 1, 2}
    assert mgr.allocate("d") is None  # full
    assert mgr.utilization() == 1.0
    mgr.release("b")
    d = mgr.allocate("d")
    assert d.idx == 1  # reused slot
    assert mgr.bytes() == 2 * 2 * 3 * 16 * 2 * 16 * 4  # (k, v) x (L, B, S, KH, hd) float32
    assert [s.request_id for s in mgr.active] == ["a", "d", "c"]
    d.length = 5
    np.testing.assert_array_equal(mgr.lengths(), [0, 5, 0])


def test_cache_manager_default_dtype_is_bf16(pair):
    _, _, model, _ = pair
    mgr = CacheManager(model, n_slots=2, max_len=8)
    assert all(t.dtype == torch.bfloat16 for t in mgr.cache["stack"])


def test_continuous_batching_completes_and_interleaves(pair):
    _, _, model, params = pair
    b = ContinuousBatcher(model, params, n_slots=2, max_len=32)
    # 4 requests but only 2 slots: finishing requests free slots mid-run
    for i in range(4):
        b.submit(GenRequest(f"r{i}", prompt=[1 + i, 2 + i], max_new_tokens=3 + i))
    out = b.run_to_completion()
    assert set(out) == {"r0", "r1", "r2", "r3"}
    for i in range(4):
        assert len(out[f"r{i}"]) == 3 + i
        assert all(0 <= t < model.cfg.vocab for t in out[f"r{i}"])
    assert b.mgr.utilization() == 0.0  # all slots returned


def test_batched_isolation(pair):
    """Tokens decoded in one slot must not corrupt another slot's stream."""
    _, _, model, params = pair
    b1 = ContinuousBatcher(model, params, n_slots=2, max_len=32)
    b1.submit(GenRequest("solo", prompt=[5, 6, 7], max_new_tokens=4))
    solo = b1.run_to_completion()["solo"]
    b2 = ContinuousBatcher(model, params, n_slots=2, max_len=32)
    b2.submit(GenRequest("solo", prompt=[5, 6, 7], max_new_tokens=4))
    b2.submit(GenRequest("noise", prompt=[9, 10, 11, 12], max_new_tokens=6))
    assert b2.run_to_completion()["solo"] == solo


def _requests(cls, n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", prompt=[int(t) for t in rng.integers(0, vocab, rng.integers(1, 9))],
                max_new_tokens=int(rng.integers(1, 8))) for i in range(n)]


@pytest.mark.parametrize("n_slots,max_len,n,seed", [(2, 32, 4, 0), (3, 16, 7, 1), (4, 12, 9, 2)],
                         ids=["2slots", "3slots-clamped", "4slots-clamped"])
def test_batcher_matches_jax_tokens(pair, n_slots, max_len, n, seed):
    """The same requests through both batchers give the same tokens, in
    the same number of steps.  With max_len 12 and 16 some slots reach the
    clamp at max_len - 1, where both keep writing the last row."""
    jmodel, jparams, model, params = pair
    jb = JaxBatcher(jmodel, jparams, n_slots=n_slots, max_len=max_len)
    tb = ContinuousBatcher(model, params, n_slots=n_slots, max_len=max_len)
    for req in _requests(JaxRequest, n, seed, model.cfg.vocab):
        jb.submit(req)
    for req in _requests(GenRequest, n, seed, model.cfg.vocab):
        tb.submit(req)
    assert tb.run_to_completion() == jb.run_to_completion()
    assert tb.steps == jb.steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_step_logits_match_jax(pair, dtype):
    """One step's logits over per-row lengths of different ages (one slot in
    prefill, one decoding, one free), to atol=1e-4, rtol=1e-3 on a float32
    cache and a relative L2 of 1e-2 on a bfloat16 one (both caches round the
    same K/V to bfloat16; the products differ in order)."""
    jmodel, jparams, model, params = pair
    jb = JaxBatcher(jmodel, jparams, n_slots=3, max_len=16, dtype=getattr(jnp, dtype))
    tb = ContinuousBatcher(model, params, n_slots=3, max_len=16, dtype=getattr(torch, dtype))
    for b, cls in ((jb, JaxRequest), (tb, GenRequest)):
        b.submit(cls("a", prompt=[3, 4, 5, 6, 7, 8], max_new_tokens=4))
        b.submit(cls("b", prompt=[9], max_new_tokens=9))
    for _ in range(4):
        jb.step()
        tb.step()
    toks = np.zeros((3, 1), np.int32)
    lengths = tb.mgr.lengths()
    np.testing.assert_array_equal(lengths, jb.mgr.lengths())
    toks[:2, 0] = [7, tb.running["b"].generated[-1]]
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(toks), jb.mgr.cache, jnp.asarray(lengths))
    tl, _ = model.decode_step(params, torch.from_numpy(toks), tb.mgr.cache,
                              torch.from_numpy(lengths))
    got, want = tl.float().numpy(), np.asarray(jl, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
