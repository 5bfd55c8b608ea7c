"""Low-precision KV caches in the port, held against the JAX package's
``tests/test_cache_dtypes.py`` on the CPU: reduced llava-next-mistral-7b
with the JAX ``Model.init`` weights, 6 decode steps over 2 rows.

* the reference's bounds on the port's own logits: relative L2 error against
  the float32-cache logits below 0.15 (bfloat16) and 0.60 (float8_e4m3fn);
* the port's logits against the JAX logits for the same cache dtype, within
  a relative L2 of 1e-5: both write the same K/V into the cache bit for bit
  (below), so only the order of float32 sums separates them;
* the fp8 cache halves the bytes of command-r-plus-104b's (shapes on the
  ``meta`` device, nothing allocated);
* the fp8 cache the port writes equals the JAX one bit for bit (as uint8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import unzip
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import CacheManager

B, S, STEPS = 2, 16, 6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
BOUND = {"bfloat16": 0.15, "float8_e4m3fn": 0.60}           # tests/test_cache_dtypes.py
VS_JAX = 1e-5


@pytest.fixture(scope="module")
def runs():
    """Logits and final caches of both packages for each cache dtype."""
    jmodel = jax_build_model(jax_get_config("llava_next_mistral_7b").reduced(), remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    model = Model(get_config("llava_next_mistral_7b").reduced(), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    out = {}
    for name, (jd, td) in DTYPES.items():
        jcache, tcache = jmodel.init_cache(B, S, dtype=jd), model.init_cache(B, S, dtype=td)
        for i in range(STEPS):
            jlog, jcache = jmodel.decode_step(jparams, jnp.full((B, 1), 3 + i, jnp.int32), jcache,
                                              jnp.int32(i))
            tlog, tcache = model.decode_step(params, torch.full((B, 1), 3 + i, dtype=torch.int32),
                                             tcache, i)
        out[name] = (np.asarray(jlog, np.float32), tlog.float().numpy(), jcache, tcache)
    return out


def _rel(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


@pytest.mark.parametrize("name", list(BOUND))
def test_decode_with_quantized_cache(runs, name):
    """The reference's bound, on the port's logits."""
    got, ref = runs[name][1], runs["float32"][1]
    assert np.isfinite(got).all()
    assert _rel(got, ref) < BOUND[name], f"{name}: rel={_rel(got, ref):.3f}"


@pytest.mark.parametrize("name", list(DTYPES))
def test_logits_match_jax_per_cache_dtype(runs, name):
    jlog, tlog, _, _ = runs[name]
    assert _rel(tlog, jlog) < VS_JAX, f"{name}: rel={_rel(tlog, jlog):.2e}"


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn"])
def test_low_precision_cache_matches_jax_bitwise(runs, name):
    """The K/V the port wrote are the JAX package's, bit for bit."""
    _, _, jcache, tcache = runs[name]
    view = torch.uint8 if name == "float8_e4m3fn" else torch.int16
    for j, t in zip(jcache["stack"], tcache["stack"]):
        want = np.asarray(j).view(np.uint8 if view == torch.uint8 else np.int16)
        np.testing.assert_array_equal(t.view(view).numpy(), want)
        assert t.view(view)[:, :, STEPS:].eq(0).all()  # rows past the last step untouched


def test_fp8_conversion_matches_jax_in_range():
    """float32 -> float8_e4m3fn rounds alike in both packages (to nearest,
    ties to even, subnormals included) for every finite |x| below 464, the
    midpoint between the largest value 448 and the overflow.  Beyond it they
    part: PyTorch saturates to +-448, JAX (ml_dtypes) gives NaN; a cache
    value that large does not occur in these models."""
    rng = np.random.default_rng(0)
    fp8 = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(np.float32)
    fp8 = np.sort(fp8[np.isfinite(fp8)])
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32) * s
                        for s in (1e-3, 0.1, 1, 10, 100)]
                       + [fp8, (fp8[1:] + fp8[:-1]) / 2, [463.9, -463.9, 2**-10, 3 * 2**-11]])
    x = x.astype(np.float32)
    assert np.abs(x).max() < 464
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    big = torch.tensor([465.0, 1e4, -1e4]).to(torch.float8_e4m3fn).float()
    assert big.tolist() == [448.0, 448.0, -448.0]
    assert np.isnan(np.asarray(jnp.asarray([465.0, 1e4]).astype(jnp.float8_e4m3fn), np.float32)).all()


def test_fp8_cache_halves_bytes():
    model = Model(get_config("command_r_plus_104b"), device="meta")
    b8 = CacheManager(model, 8, 128, dtype=torch.float8_e4m3fn).bytes()
    b16 = CacheManager(model, 8, 128, dtype=torch.bfloat16).bytes()
    assert b8 * 2 == b16 == 2 * 64 * 8 * 128 * 8 * 128 * 2  # (k, v) x (L, B, S, KH, hd) x 2 bytes
    jm = jax_build_model(jax_get_config("command_r_plus_104b"))
    c16 = jax.eval_shape(lambda: jm.init_cache(8, 128, dtype=jnp.bfloat16))
    assert b16 == sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                      for leaf in jax.tree.leaves(c16))
