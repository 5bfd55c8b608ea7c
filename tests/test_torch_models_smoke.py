"""Every architecture of ``ARCH_IDS`` at ``reduced()`` through the port,
against the JAX package on the same weights: the counterpart of
``tests/test_models_smoke.py``, with the port's outputs held to the JAX
model's and not only checked for shape and finiteness.

For each of the 10 architectures the JAX ``Model.init`` parameters are
carried across by ``unzip`` -> numpy -> ``params_from_numpy``, and the
inputs are drawn with numpy from a seed (frames for whisper, patches for
llava).  Held in float32 to ``atol=1e-4, rtol=1e-3``:

* ``forward("train")`` logits;
* one decode step from ``init_cache(2, 16, memory_t=8)`` (logits, and the
  cache's structure and shapes);
* ``prefill``'s last logits.

And ``Model.decode_attention_calls()`` against the decode-kernel calls that
one decode step makes.

The loss and its gradient (the other half of ``test_models_smoke.py``) are
held against ``jax.value_and_grad`` in ``test_torch_loss.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.models import Model, params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-3)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _models(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0), max_seq=64))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(tcfg, device="cpu"), tparams


def _batch(cfg, B, S, seed=1):
    """The batches of ``test_models_smoke.py``'s ``_batch_for``, from numpy:
    (the JAX batch, the port's)."""
    rng = np.random.default_rng(seed)
    if cfg.enc_dec:
        arrays = {"frames": (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32),
                  "tokens": rng.integers(0, cfg.vocab, (B, max(S // 4, 8))).astype(np.int32)}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.family == "vlm":
            arrays["patches"] = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a) for k, a in arrays.items()})


def _leaves(tree):
    """A cache's tensors in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    jb, tb = _batch(tmodel.cfg, 2, 32)
    jl = jmodel.forward(jparams, jb, mode="train")[0]
    tl = tmodel.forward(tparams, tb, mode="train")[0]
    assert tuple(tl.shape) == (2, tb["tokens"].shape[1], tmodel.cfg.vocab)
    assert torch.isfinite(tl).all()
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    B, S_cache = 2, 16
    jcache = jmodel.init_cache(B, S_cache, dtype=jnp.float32, memory_t=8)
    tcache = tmodel.init_cache(B, S_cache, dtype=torch.float32, memory_t=8)
    assert [tuple(a.shape) for a in jax.tree.leaves(jcache)] == \
        [tuple(t.shape) for t in _leaves(tcache)]
    jl, jcache2 = jmodel.decode_step(jparams, jnp.ones((B, 1), jnp.int32), jcache, jnp.int32(3))
    tl, tcache2 = tmodel.decode_step(tparams, torch.ones((B, 1), dtype=torch.int32), tcache, 3)
    assert tuple(tl.shape) == (B, tmodel.cfg.vocab) and torch.isfinite(tl).all()
    _close(tl, jl)
    shapes = [tuple(t.shape) for t in _leaves(tcache2)]
    assert shapes == [tuple(a.shape) for a in jax.tree.leaves(jcache2)]
    for got, want in zip(_leaves(tcache2), jax.tree.leaves(jcache2)):
        _close(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    jb, tb = _batch(tmodel.cfg, 2, 16)
    _, jl = jmodel.prefill(jparams, jb)
    _, tl = tmodel.prefill(tparams, tb)
    assert tuple(tl.shape) == (2, tmodel.cfg.vocab) and torch.isfinite(tl).all()
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_attention_calls(arch, monkeypatch):
    """``Model.decode_attention_calls()`` is the number of decode-kernel
    calls (``decode_attention`` or MLA's ``decode_attention_latent``) that
    one decode step makes."""
    calls = []
    for name in ("decode_attention", "decode_attention_latent"):
        def counted(*args, _fn=getattr(ops, name), **kw):
            calls.append(1)
            return _fn(*args, **kw)
        monkeypatch.setattr(ops, name, counted)
    model = Model(get_config(arch).reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0), max_seq=64)
    cache = model.init_cache(2, 16, dtype=torch.float32, memory_t=8)
    model.decode_step(params, torch.ones((2, 1), dtype=torch.int32), cache, 3)
    assert len(calls) == model.decode_attention_calls()
