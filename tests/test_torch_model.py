"""The port's mamba2 model held against the JAX model on the same weights:
the JAX ``Model.init`` parameters carried across with ``params_from_numpy``,
the same numpy tokens, float32 to ``atol=1e-4, rtol=1e-3``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro.models.mamba import mamba_forward as jax_mamba_forward
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.mamba import MambaState, mamba_forward

TOL = dict(atol=1e-4, rtol=1e-3)


def _tiny(cfg):
    """The tiny serving config of tests/test_serving.py."""
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, vocab=64,
                               ssm=dataclasses.replace(cfg.ssm, d_state=8, headdim=8))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _tiny(jax_get_config("mamba2_130m")), _tiny(get_config("mamba2_130m"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(tcfg, device="cpu"), tparams


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_config_copy_matches_jax():
    j, t = jax_get_config("mamba2_130m"), get_config("mamba2_130m")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()
    # whisper_small, the last architecture ported, is a copy too
    jw, tw = jax_get_config("whisper_small"), get_config("whisper_small")
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    assert jw.n_params() == tw.n_params() and jw.reduced().n_params() == tw.reduced().n_params()


@pytest.mark.parametrize("S", [40, 32])
def test_prefill_and_decode_match_jax(pair, S):
    jmodel, jparams, tmodel, tparams = pair
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, 64, (2, S)).astype(np.int32)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    _close(tcache["layers"].conv, jcache["layers"].conv)
    _close(tcache["layers"].ssm, jcache["layers"].ssm)
    for step in range(3):
        nxt = rng.integers(0, 64, (2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache, S + step)
        tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(nxt), tcache, S + step)
        _close(tl, jl)
        _close(tcache["layers"].ssm, jcache["layers"].ssm)
        _close(tcache["layers"].conv, jcache["layers"].conv)


def test_decode_from_zero_cache_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    jcache = jmodel.init_cache(1, 32, dtype=jnp.float32)
    tcache = tmodel.init_cache(1, 32, dtype=torch.float32)
    assert tcache["layers"].conv.shape == jcache["layers"].conv.shape
    assert tcache["layers"].ssm.shape == jcache["layers"].ssm.shape
    tok = np.array([[5]], np.int32)
    jl, _ = jmodel.decode_step(jparams, jnp.asarray(tok), jcache, 0)
    tl, _ = tmodel.decode_step(tparams, torch.from_numpy(tok), tcache, 0)
    _close(tl, jl)


@pytest.mark.parametrize("S", [45, 7, 64])
def test_mamba_forward_matches_jax(pair, S):
    """One block, including S not a multiple of the chunk (32)."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["mamba"])
    tp = {k: v[1] for k, v in tparams["layers"]["mamba"].items()}
    jy, jst = jax_mamba_forward(jp, jnp.asarray(x), jmodel.cfg)
    ty, tst = mamba_forward(tp, torch.from_numpy(x), cfg)
    _close(ty, jy)
    _close(tst.conv, jst.conv)
    _close(tst.ssm, jst.ssm)
    # and with an entering state (the second half of a split sequence)
    ty2, _ = mamba_forward(tp, torch.from_numpy(x), cfg, MambaState(tst.conv, tst.ssm))
    jy2, _ = jax_mamba_forward(jp, jnp.asarray(x), jmodel.cfg, jst)
    _close(ty2, jy2)


def test_random_init_distributions():
    """The port draws its own weights with the JAX package's distributions."""
    cfg = get_config("mamba2_130m").reduced()
    p = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m = p["layers"]["mamba"]
    assert p["layers"]["ln"]["scale"].shape == (cfg.n_layers, cfg.d_model)
    assert abs(float(p["embed"]["tokens"].std()) - 0.02) < 0.002
    assert abs(float(m["in_proj"].std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(m["conv_w"].std()) - 0.5) < 0.05
    assert torch.all(m["D"] == 1) and torch.all(m["A_log"] == 0) and torch.all(m["conv_b"] == 0)
    # and reduced whisper's encoder-decoder leaves
    wcfg = get_config("whisper_small").reduced()
    w = Model(wcfg, device="cpu").init(torch.Generator().manual_seed(0), max_seq=128)
    for key in ("enc_pos", "dec_pos"):
        assert w[key].shape == (128, wcfg.d_model)
        assert abs(float(w[key].std()) - 0.02) < 0.002
    cross = w["stack"]["cross"]
    assert abs(float(cross["wk"].std()) - wcfg.d_model ** -0.5) < 0.02
    assert torch.all(cross["bk"] == 0) and torch.all(cross["bo"] == 0)
    assert torch.all(w["stack"]["ln_cross"]["scale"] == 1)
    assert torch.all(w["stack"]["ln_cross"]["bias"] == 0)
