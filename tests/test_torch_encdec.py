"""The port's encoder-decoder family (whisper-small: a bidirectional encoder
over post-conv frames, learned positions, decoder blocks that cross-attend
to the encoded memory) held against the JAX package on the CPU, at
``reduced()`` (2 encoder and 2 decoder layers, d_model 64, 4 heads of 16),
with the JAX weights carried across by ``unzip`` -> numpy ->
``params_from_numpy`` and inputs drawn with numpy from a seed.  float32 to
``atol=1e-4, rtol=1e-3`` (``TOL_MODEL``), the attention kernels' plain
versions to ``atol=rtol=2e-5`` as in ``tests/test_torch_attention.py``.

* cross ``attn_forward`` with T memory rows != S queries, for a query
  sequence (through ``flash_attention``'s plain version) and one query a
  row (through ``decode_attention``'s);
* ``flash_attention_ref`` with keys of another length against a JAX einsum
  of the same function, with Sk == S non-causal against the Pallas kernel
  in interpret mode, and a causal mask or a window with Sk != S raising;
* the reduced model's ``forward("train")``, prefill (logits and caches)
  with T != S, and decode with an int, a 0-d and a ``(B,)`` index;
* ``Instance.generate`` and ``ContinuousBatcher`` tokens against the JAX
  package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro.serving import Endpoint as JaxEndpoint
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import GenRequest as JaxRequest
from repro.serving.worker import Instance as JaxInstance
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.serving import ContinuousBatcher, Endpoint, GenRequest, Instance

TOL_MODEL = dict(atol=1e-4, rtol=1e-3)
TOL_ATTN = dict(atol=2e-5, rtol=2e-5)
NAME = "whisper_small"
T, S = 24, 5  # encoder frames, decoder tokens


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL_MODEL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_get_config(NAME).reduced(), get_config(NAME).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0), max_seq=64))
    return jmodel, jparams, Model(tcfg, device="cpu"), params_from_numpy(_np(jparams), device="cpu")


def _batch(rng, cfg, B, T_, S_):
    frames = _randn(rng, B, T_, cfg.d_model, scale=0.02)
    tokens = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)})


def test_config_copy_matches_jax():
    j, t = jax_get_config(NAME), get_config("whisper-small")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()
    assert Endpoint("w", t, max_cache_len=448).est_bytes() == \
        JaxEndpoint("w", j, max_cache_len=448).est_bytes()
    with pytest.raises(KeyError):
        get_config("whisper_medium")


# ------------------------------------------------------------ cross-attention
@pytest.mark.parametrize("S_", [S, 1], ids=["queries", "one-query"])
def test_cross_attn_forward_matches_jax(pair, S_):
    """Layer 1's cross-attention (biases made nonzero) over T memory rows:
    S_ queries go through ``flash_attention``, one query a row through
    ``decode_attention``; K and V are projected from the memory, with no
    rope and no mask."""
    jmodel, jparams, tmodel, _ = pair
    rng = np.random.default_rng(1)
    p = {k: np.array(v[1]) for k, v in jparams["stack"]["cross"].items()}
    p.update({k: _randn(rng, *p[k].shape, scale=0.1) for k in ("bq", "bk", "bv", "bo")})
    x, mem = _randn(rng, 2, S_, 64), _randn(rng, 2, T, 64)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (2, S_))
    mem_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jy, (jk, jv) = jax_attn.attn_forward(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), jmodel.cfg, jnp.asarray(pos),
        kv_memory=(jnp.asarray(mem), jnp.asarray(mem_pos)))
    ops.reset_launches()
    ty, (tk, tv) = attn.attn_forward(
        {k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x), tmodel.cfg,
        torch.from_numpy(pos.copy()), kv_memory=(torch.from_numpy(mem), torch.from_numpy(mem_pos)))
    assert tuple(tk.shape) == (2, T, 4, 16)
    assert sum(ops.LAUNCHES.values()) == 0 and not ops.SHAPE_LAUNCHES  # the plain versions
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want)


def _jax_cross(q, k, v):
    """Unmasked attention of S queries over Sk keys, float32, per kv head
    group as the JAX ``sdpa`` runs it."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, hd)
    logits = jnp.einsum("bqkgh,bskh->bkgqs", qg, k) / jnp.sqrt(jnp.float32(hd))
    out = jnp.einsum("bkgqs,bskh->bqkgh", jax.nn.softmax(logits, axis=-1), v)
    return out.reshape(B, Sq, H, hd)


@pytest.mark.parametrize("B,S_,Sk,H,KH,hd", [(2, 5, 24, 4, 4, 16), (1, 1, 70, 4, 2, 32),
                                             (1, 130, 7, 2, 1, 64)])
def test_flash_ref_other_key_length_matches_jax(B, S_, Sk, H, KH, hd):
    rng = np.random.default_rng(S_ + Sk)
    q, k, v = _randn(rng, B, S_, H, hd), _randn(rng, B, Sk, KH, hd), _randn(rng, B, Sk, KH, hd)
    want = _jax_cross(*map(jnp.asarray, (q, k, v)))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert got.shape == (B, S_, H, hd)
    _close(got, want, TOL_ATTN)
    ops.reset_launches()  # the wrapper on the CPU is the plain version
    _close(ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False), want, TOL_ATTN)
    assert ops.LAUNCHES["flash_attention"] == 0 and not ops.SHAPE_LAUNCHES


def test_flash_ref_bidirectional_matches_pallas_interpret():
    """Sk == S, non-causal (whisper's encoder): the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, 1, 128, 4, 16) for _ in range(3))
    want = jax_ops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False, block_q=64,
                                   block_k=64, interpret=True)
    _close(ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False), want,
           TOL_ATTN)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 8), (True, 8)])
def test_flash_other_key_length_takes_no_mask(causal, window):
    q, k = torch.zeros(1, 5, 2, 16), torch.zeros(1, 24, 2, 16)
    for fn in (ref.flash_attention_ref, ops.flash_attention):
        with pytest.raises(ValueError, match="no causal mask and no window"):
            fn(q, k, k, causal=causal, window=window)


# ------------------------------------------------------------------- model
def test_forward_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch(np.random.default_rng(2), tmodel.cfg, 2, T, S)
    jl, ja, jc = jmodel.forward(jparams, jb)
    tl, ta, tc = tmodel.forward(tparams, tb)
    assert tl.shape == (2, S, tmodel.cfg.vocab) and jc is None and tc is None
    _close(tl, jl)
    assert float(ta) == float(ja) == 0.0


def test_prefill_and_decode_match_jax(pair):
    """Prefill with T != S: the last logits and the caches (decoder K/V,
    memory, enc_pos).  Then those copied into ``init_cache(B, 16,
    memory_t=T)`` of both packages, and three decode steps with an int, a
    0-d and a per-row ``(B,)`` index (one row past S-1), each row
    cross-attending to the encoded memory."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    jb, tb = _batch(rng, cfg, 2, T, S)
    jcache, jlogits = jmodel.prefill(jparams, jb)
    tcache, tlogits = tmodel.prefill(tparams, tb)
    _close(tlogits, jlogits)
    assert sorted(tcache) == sorted(jcache) == ["enc_pos", "memory", "stack"]
    for got, want in zip(tcache["stack"], jcache["stack"]):
        assert tuple(got.shape) == (cfg.n_layers, 2, S, 4, 16)
        _close(got, want)
    _close(tcache["memory"], jcache["memory"])
    assert tcache["enc_pos"].dtype == torch.int32
    np.testing.assert_array_equal(tcache["enc_pos"].numpy(), np.asarray(jcache["enc_pos"]))

    Sc = 16
    zero = tmodel.init_cache(2, Sc, torch.float32, memory_t=T)
    jzero = jmodel.init_cache(2, Sc, jnp.float32, memory_t=T)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jzero) == \
        {k: (tuple((tuple(a.shape), str(a.dtype).removeprefix("torch.")) for a in v)
             if isinstance(v, tuple) else (tuple(v.shape), str(v.dtype).removeprefix("torch.")))
         for k, v in zero.items()}
    kv = []
    for want in jcache["stack"]:
        b = np.zeros((cfg.n_layers, 2, Sc, 4, 16), np.float32)
        b[:, :, :S] = np.asarray(want)
        kv.append(b)
    mem, mem_pos = np.asarray(jcache["memory"]), np.asarray(jcache["enc_pos"])
    jc = {"stack": tuple(map(jnp.asarray, kv)), "memory": jnp.asarray(mem),
          "enc_pos": jnp.asarray(mem_pos)}
    tc = {"stack": tuple(torch.tensor(b) for b in kv), "memory": torch.tensor(mem),
          "enc_pos": torch.tensor(mem_pos)}
    for step, idx in enumerate((S, np.int32(S + 1), np.array([S + 2, Sc + 3], np.int32))):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, jnp.asarray(idx))
        tidx = idx if step == 0 else torch.from_numpy(np.asarray(idx))
        tl, tc2 = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc, tidx)
        assert tc2["stack"][0] is tc["stack"][0] and tc2["memory"] is tc["memory"]
        tc = tc2
        _close(tl, jl)
        for got, want in zip(tc["stack"], jc["stack"]):
            _close(got, want)


def test_random_init_distributions():
    """The port draws reduced whisper's own weights with the JAX package's
    keys, shapes and distributions: position tables normal x 0.02 of
    ``max_seq`` rows, cross-attention normal / sqrt(d_model) with zero
    biases, LayerNorms ones and zeros."""
    cfg = get_config(NAME).reduced()
    p = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0), max_seq=96)
    jp, _ = unzip(jax_build_model(jax_get_config(NAME).reduced()).init(jax.random.key(0), max_seq=96))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(p) == jax.tree.map(lambda a: tuple(a.shape), _np(jp))
    for key in ("enc_pos", "dec_pos"):
        assert p[key].shape == (96, cfg.d_model)
        assert abs(float(p[key].std()) - 0.02) < 0.002
    cross, ln = p["stack"]["cross"], p["stack"]["ln_cross"]
    assert cross["wq"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_)
    for w in ("wq", "wk", "wv"):
        assert abs(float(cross[w].std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(cross["wo"].std()) - cfg.n_heads ** -0.5) < 0.05
    assert all(torch.all(cross[b] == 0) for b in ("bq", "bk", "bv", "bo"))
    assert torch.all(ln["scale"] == 1) and torch.all(ln["bias"] == 0)
    assert "cross" not in p["encoder"] and "ln_cross" not in p["encoder"]


# ----------------------------------------------------------------- serving
def _tiny(get):
    return dataclasses.replace(get(NAME).reduced(), vocab=64)


@pytest.mark.parametrize("S_,gen_len,seed", [(9, 4, 0), (30, 3, 1)])
def test_generate_matches_jax_tokens(S_, gen_len, seed):
    """Zero frames of the prompt's length into the encoder, then decoding
    over 8 rows of zero memory, as the JAX package's ``Instance`` does."""
    jinst = JaxInstance(JaxEndpoint("w", _tiny(jax_get_config), seed=seed, max_cache_len=40))
    ep = Endpoint("w", _tiny(get_config), seed=seed, max_cache_len=40)
    inst = Instance(ep, device="cpu", params=params_from_numpy(_np(jinst.params), device="cpu"))
    tokens = np.random.default_rng(S_).integers(0, 64, (2, S_)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    np.testing.assert_array_equal(inst.generate(torch.from_numpy(tokens), gen_len).numpy(), want)
    batch = inst.prefill_batch(torch.from_numpy(tokens))
    assert batch["frames"].shape == (2, S_, 64) and not batch["frames"].any()
    cache = inst.decode_cache(2)
    assert tuple(cache["memory"].shape) == (2, 8, 64) and cache["enc_pos"].dtype == torch.int32


def test_own_init_position_tables_follow_max_cache_len():
    inst = Instance(Endpoint("w", _tiny(get_config), seed=0, max_cache_len=40), device="cpu")
    assert inst.params["enc_pos"].shape == inst.params["dec_pos"].shape == (40, 64)


def test_batcher_matches_jax_tokens():
    """7 requests through 3 slots (slots reused) over the batcher's default
    1,500 rows of zero memory: the same tokens in the same number of
    steps; the memory keeps its batch axis at 0."""
    jmodel = jax_build_model(_tiny(jax_get_config), remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(4), max_seq=64))
    model = Model(_tiny(get_config), device="cpu")
    params = params_from_numpy(_np(jparams), device="cpu")
    jb = JaxBatcher(jmodel, jparams, n_slots=3, max_len=24)
    tb = ContinuousBatcher(model, params, n_slots=3, max_len=24)
    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, 64, rng.integers(1, 9))],
             int(rng.integers(1, 8))) for i in range(7)]
    for rid, prompt, n in reqs:
        jb.submit(JaxRequest(rid, prompt, max_new_tokens=n))
        tb.submit(GenRequest(rid, prompt, max_new_tokens=n))
    assert tb.run_to_completion() == jb.run_to_completion()
    assert tb.steps == jb.steps
    assert tuple(tb.mgr.cache["memory"].shape) == (3, 1500, 64)
    assert tuple(tb.mgr.cache["enc_pos"].shape) == (3, 1500)
