"""The port's MoE (``models/moe.py``) and the moe family's ``Model`` held
against the JAX package on the CPU, on reduced mixtral-8x22b (4 experts,
top-2) with the softmax router, and with the sigmoid router and one shared
expert (DeepSeek-V3's routing on mixtral's widths).  Weights come from the
JAX ``init_moe`` / ``Model.init`` through ``unzip`` -> numpy ->
``params_from_numpy``; inputs are drawn with numpy from a seed.

* ``route``: the same experts, gates and aux to 1e-6;
* ``_dispatch_ffn`` fed the JAX gates and experts at a capacity low enough
  that tokens drop: the same output (float32, ``atol=1e-4, rtol=1e-3``), and
  the count dropped equal to a plain numpy count of the sorted dispatch;
* ``apply_moe`` end to end, output and aux;
* ``Model`` prefill (logits, aux, cache) and three ``decode_step``s, for
  reduced mixtral and for reduced mixtral with one leading dense layer of
  width 128 (``dense_stack`` + ``moe_stack``);
* ``Instance.generate`` tokens and a ``ContinuousBatcher`` run with slot
  reuse give the JAX package's tokens;
* ``params_from_numpy(..., dtype=torch.bfloat16)`` gives the leaf dtypes of
  the port's own bfloat16 init, for every ported family.
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
from repro.models import moe as jax_moe
from repro.models import unzip
from repro.serving import Endpoint as JaxEndpoint
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import GenRequest as JaxRequest
from repro.serving.worker import Instance as JaxInstance
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, moe, params_from_numpy
from repro_torch.models.layers import act_fn
from repro_torch.serving import ContinuousBatcher, Endpoint, GenRequest, Instance

TOL = dict(atol=1e-4, rtol=1e-3)
ROUTERS = {"softmax": {}, "sigmoid": dict(router="sigmoid", n_shared=1)}
T = 96  # tokens: 192 assignments over 4 experts


def _moe_cfg(get, router):
    cfg = get("mixtral_8x22b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **ROUTERS[router]))


def _dense_first(get):
    cfg = get("mixtral_8x22b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_dense_layers=1,
                                                            dense_dff=128))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.fixture(scope="module", params=list(ROUTERS))
def layer(request):
    jcfg, tcfg = _moe_cfg(jax_get_config, request.param), _moe_cfg(get_config, request.param)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, _ = unzip(jax_moe.init_moe(jax.random.key(3), jcfg))
    x = np.random.default_rng(7).standard_normal((T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), device="cpu"), x


def test_config_copy_matches_jax():
    j, t = jax_get_config("mixtral_8x22b"), get_config("mixtral_8x22b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()
    assert 120e9 <= t.n_params() <= 150e9  # tests/test_models_smoke.py's range
    assert Endpoint("m", t, max_cache_len=1024).est_bytes() == \
        JaxEndpoint("m", j, max_cache_len=1024).est_bytes()


def test_route_matches_jax(layer):
    jcfg, tcfg, jp, tp, x = layer
    jg, ji, ja = jax_moe.route(jp, jnp.asarray(x), jcfg)
    tg, ti, ta = moe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, atol=1e-6, rtol=0)
    _close(ta, ja, atol=1e-6, rtol=0)
    assert tg.dtype == torch.float32 and ta.dtype == torch.float32


def _numpy_dropped(idx, E, C):
    """Assignments beyond their expert's C slots, in the order of a stable
    sort by expert: for each expert, its assignments in (token, k) order."""
    flat = idx.reshape(-1)
    return sum(max(0, int((flat == e).sum()) - C) for e in range(E))


def test_dispatch_matches_jax_where_tokens_drop(layer):
    jcfg, tcfg, jp, tp, x = layer
    m = jcfg.moe
    jg, ji, _ = jax_moe.route(jp, jnp.asarray(x), jcfg)
    C = jax_moe._capacity(0.25, T, m.top_k, m.n_experts)
    assert C == moe._capacity(0.25, T, m.top_k, m.n_experts) == 16
    want = jax_moe._dispatch_ffn(jnp.asarray(x), jg, ji, jp["wi_gate"], jp["wi_up"], jp["wo"],
                                 0, m.n_experts, C, jax.nn.silu, jnp.float32)
    tg, ti = torch.from_numpy(np.asarray(jg)), torch.from_numpy(np.asarray(ji))
    got = moe._dispatch_ffn(torch.from_numpy(x), tg, ti, tp["wi_gate"], tp["wi_up"], tp["wo"],
                            0, m.n_experts, C, act_fn(tcfg.act), torch.float32)
    _close(got, want)
    n_drop = _numpy_dropped(np.asarray(ji), m.n_experts, C)
    assert n_drop > 20  # the capacity really drops tokens
    assert int(moe.dropped(ti, m.n_experts, C)) == n_drop
    # a token whose both assignments were dropped gets zeros in both packages
    assert np.array_equal(np.all(np.asarray(want) == 0, -1), (got == 0).all(-1).numpy())


def test_apply_moe_top8_matches_jax():
    """DeepSeek-V3's top-8 routing at the reduced widths (16 experts, the
    sigmoid router and a shared expert): each token's 8 gated rows summed in
    a fixed order give the JAX package's scatter-adds, with tokens dropped
    at a low capacity and without."""
    cfgs = [dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_experts=16, top_k=8))
            for c in (_moe_cfg(jax_get_config, "sigmoid"), _moe_cfg(get_config, "sigmoid"))]
    jp, _ = unzip(jax_moe.init_moe(jax.random.key(5), cfgs[0]))
    tp = params_from_numpy(_np(jp), device="cpu")
    x = np.random.default_rng(9).standard_normal((4, T // 4, cfgs[0].d_model)).astype(np.float32)
    for cf in (1.25, 0.25):
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
                      for c in cfgs)
        jy, ja = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
        ty, ta = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
        _close(ty, jy)
        _close(ta, ja, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_apply_moe_matches_jax(layer, cf):
    jcfg, tcfg, jp, tp, x = layer
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    x3 = x.reshape(4, T // 4, -1)
    jy, ja = jax_moe.apply_moe(jp, jnp.asarray(x3), jcfg)
    ty, ta = moe.apply_moe(tp, torch.from_numpy(x3), tcfg)
    _close(ty, jy)
    _close(ta, ja, atol=1e-6, rtol=0)


# ------------------------------------------------------------------- model
MODELS = {"mixtral": lambda get: get("mixtral_8x22b").reduced(), "mixtral-dense-first": _dense_first}
S = 24  # > the reduced sliding window of 16


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    jcfg, tcfg = MODELS[request.param](jax_get_config), MODELS[request.param](get_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    return jmodel, jparams, Model(tcfg, device="cpu"), params_from_numpy(_np(jparams), device="cpu")


def test_forward_aux_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(1).integers(0, tmodel.cfg.vocab, (2, S)).astype(np.int32)
    jl, ja, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    tl, ta, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    _close(ta, ja, atol=1e-5, rtol=0)
    assert float(ta) > 0


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    assert sorted(tcache) == sorted(jcache)
    big = {}
    for key, pair_ in jcache.items():
        for got, want in zip(tcache[key], pair_):
            _close(got, want)
        shape = (pair_[0].shape[0], 2, S + 4, cfg.n_kv_heads, cfg.head_dim_)
        big[key] = [np.zeros(shape, np.float32) for _ in range(2)]
        for b, a in zip(big[key], pair_):
            b[:, :, :S] = np.asarray(a)
    # the port's own zero cache has the layout its decode reads
    zero = tmodel.init_cache(2, S + 4, torch.float32)
    assert {k: [tuple(t.shape) for t in v] for k, v in zero.items()} == \
        {k: [b.shape for b in v] for k, v in big.items()}
    jc = {k: tuple(jnp.asarray(b) for b in v) for k, v in big.items()}
    tc = {k: tuple(torch.tensor(b) for b in v) for k, v in big.items()}
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, S + step)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc, S + step)
        _close(tl, jl)
        for key in jc:
            for got, want in zip(tc[key], jc[key]):
                _close(got, want)


# ----------------------------------------------------------------- serving
def _tiny(get):
    cfg = get("mixtral_8x22b").reduced()
    return dataclasses.replace(cfg, n_layers=2, vocab=64)


@pytest.mark.parametrize("S,gen_len,seed", [(9, 4, 0), (30, 3, 1)])
def test_generate_matches_jax_tokens(S, gen_len, seed):
    jep = JaxEndpoint("m", _tiny(jax_get_config), seed=seed, max_cache_len=40)
    jinst = JaxInstance(jep)
    ep = Endpoint("m", _tiny(get_config), seed=seed, max_cache_len=40)
    inst = Instance(ep, device="cpu", params=params_from_numpy(_np(jinst.params), device="cpu"))
    tokens = np.random.default_rng(S).integers(0, 64, (2, S)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    np.testing.assert_array_equal(inst.generate(torch.from_numpy(tokens), gen_len).numpy(), want)


def _requests(cls, n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", prompt=[int(t) for t in rng.integers(0, vocab, rng.integers(1, 9))],
                max_new_tokens=int(rng.integers(1, 8))) for i in range(n)]


def test_batcher_matches_jax_tokens():
    """7 requests through 3 slots (slots reused), the same tokens in the
    same number of steps."""
    jmodel = jax_build_model(_tiny(jax_get_config), remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(4)))
    model = Model(_tiny(get_config), device="cpu")
    params = params_from_numpy(_np(jparams), device="cpu")
    jb = JaxBatcher(jmodel, jparams, n_slots=3, max_len=24)
    tb = ContinuousBatcher(model, params, n_slots=3, max_len=24)
    for req in _requests(JaxRequest, 7, 5, 64):
        jb.submit(req)
    for req in _requests(GenRequest, 7, 5, 64):
        tb.submit(req)
    assert tb.run_to_completion() == jb.run_to_completion()
    assert tb.steps == jb.steps


# ----------------------------------------------------------- leaf dtypes
UNPORTED = ()
PORTED = [n for n in ARCH_IDS if n not in UNPORTED]


def test_ported_configs():
    assert not UNPORTED and len(PORTED) == 10
    for name in PORTED:
        assert get_config(name).name == name
    with pytest.raises(KeyError):
        get_config("not_an_architecture")


def _dtypes(tree, prefix=""):
    """{path: dtype name} of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _dtypes(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _dtypes(sub, f"{prefix}/{i}").items()}
    return {prefix: str(tree.dtype).removeprefix("torch.")}


@pytest.mark.parametrize("name", PORTED + ["mixtral-dense-first"])
def test_bf16_carried_weights_have_the_init_dtypes(name):
    """For every ported family (and a MoE model with a leading dense layer):
    a float32 JAX init carried across with ``dtype=torch.bfloat16`` has the
    leaf dtypes of the port's own bfloat16 init and of the JAX bfloat16 init:
    norms, the router and the Mamba block's A_log/D/dt_bias/norm float32,
    the rest bfloat16."""
    make = _dense_first if name == "mixtral-dense-first" else (lambda get: get(name).reduced())
    jcfg, cfg = make(jax_get_config), make(get_config)
    jparams, _ = unzip(jax_build_model(jcfg).init(jax.random.key(0)))
    carried = _dtypes(params_from_numpy(_np(jparams), device="cpu", dtype=torch.bfloat16))
    own = _dtypes(Model(cfg, param_dtype=torch.bfloat16, device="cpu").init(
        torch.Generator().manual_seed(0)))
    jax_bf16, _ = unzip(jax_build_model(jcfg, param_dtype=jnp.bfloat16).init(jax.random.key(0)))
    assert carried == own == _dtypes(jax_bf16)
    assert set(own.values()) == {"float32", "bfloat16"}
