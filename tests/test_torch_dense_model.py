"""The port's dense family held against the JAX model on the same weights:
minicpm-2b (scale_emb, depth_scale, tied head), gemma3-4b (GQA, qk-norm,
window 16 with a global layer among 6, two rope thetas) and command-r-35b
(LayerNorm, parallel block), each at ``reduced()``.  The JAX ``Model.init``
parameters are carried across with ``params_from_numpy``; prefill (the
(k, v) cache and the last logits) and three ``decode_step``s from a cache
that holds the prompt, float32 to ``atol=1e-4, rtol=1e-3``."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.transformer import GLOBAL_WINDOW, layer_meta

TOL = dict(atol=1e-4, rtol=1e-3)
NAMES = ["minicpm_2b", "gemma3_4b", "command_r_35b"]
S = 28  # > gemma3's reduced window of 16


def _reduced(get, name):
    cfg = get(name).reduced()
    return dataclasses.replace(cfg, n_layers=6) if name == "gemma3_4b" else cfg


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jcfg, tcfg = _reduced(jax_get_config, name), _reduced(get_config, name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(tcfg, device="cpu"), tparams


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_config_copies_match_jax(name):
    j, t = jax_get_config(name), get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()


def test_reduced_configs_keep_the_scaling_knobs():
    """The reduced configs the parity tests use keep MiniCPM's real
    scale_emb and depth_scale and gemma3's window pattern and thetas."""
    m = _reduced(get_config, "minicpm_2b")
    assert m.scale_emb == 12.0 and m.depth_scale == pytest.approx(1.4 / math.sqrt(40))
    g = _reduced(get_config, "gemma3_4b")
    windows, thetas = layer_meta(g)
    assert windows == [16] * 5 + [GLOBAL_WINDOW] and thetas == [1e4] * 5 + [1e6]
    c = get_config("command_r_35b")
    assert c.parallel_block and c.norm == "layernorm" and not c.norm_bias


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    for got, want in zip(tcache["stack"], jcache["stack"]):
        assert got.shape == (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim_)
        _close(got, want)
    # decode from a cache of S + 4 positions holding the prompt's K/V
    big = [np.zeros((cfg.n_layers, 2, S + 4, cfg.n_kv_heads, cfg.head_dim_), np.float32)
           for _ in range(2)]
    for b, a in zip(big, jcache["stack"]):
        b[:, :, :S] = np.asarray(a)
    jc = {"stack": tuple(jnp.asarray(b) for b in big)}
    tc = {"stack": tuple(torch.tensor(b) for b in big)}
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, S + step)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc, S + step)
        _close(tl, jl)
        for got, want in zip(tc["stack"], jc["stack"]):
            _close(got, want)


def test_decode_from_zero_cache_matches_jax(pair):
    """``Instance.generate``'s decode: a zero cache, then a few positions."""
    jmodel, jparams, tmodel, tparams = pair
    jc = jmodel.init_cache(1, 16, dtype=jnp.float32)
    tc = tmodel.init_cache(1, 16, dtype=torch.float32)
    assert [t.shape for t in tc["stack"]] == [a.shape for a in jc["stack"]]
    tok = np.array([[5]], np.int32)
    for idx in (3, 4, 15, 16):  # 16: past the end, written at 15
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc, idx)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc, idx)
        _close(tl, jl)


def test_minicpm_scaling_knobs_move_the_output():
    """Parity alone would not show that scale_emb and depth_scale are used
    (both packages could drop them); at reduced size each one moves the
    logits well beyond the tolerance."""
    base = _reduced(get_config, "minicpm_2b")
    params = Model(base, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.from_numpy(np.arange(12, dtype=np.int32)[None] % base.vocab)}
    _, want = Model(base, device="cpu").prefill(params, tokens)
    for knob in ("scale_emb", "depth_scale"):
        _, got = Model(dataclasses.replace(base, **{knob: 1.0}), device="cpu").prefill(params, tokens)
        assert float((got - want).abs().max()) > 100 * TOL["atol"], knob


@pytest.mark.parametrize("name", NAMES)
def test_random_init_matches_jax_layout(name):
    """The port draws its own weights with the JAX package's tree, shapes
    and distributions."""
    jcfg, tcfg = _reduced(jax_get_config, name), _reduced(get_config, name)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           unzip(jax_build_model(jcfg).init(jax.random.key(0)))[0])
    p = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jshapes
    st = p["stack"]
    assert abs(float(p["embed"]["tokens"].std()) - 0.02) < 0.002
    assert abs(float(st["attn"]["wq"].std()) - tcfg.d_model ** -0.5) < 0.02
    assert abs(float(st["attn"]["wo"].std()) - tcfg.n_heads ** -0.5) < 0.05  # fan_in = H
    assert abs(float(st["mlp"]["wo"].std()) - tcfg.d_ff ** -0.5) < 0.01
    if tcfg.norm == "layernorm":
        assert torch.all(st["ln1"]["scale"] == 1)
    else:
        assert torch.all(st["ln1"]["scale"] == 0)
