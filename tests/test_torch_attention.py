"""The port's attention against the JAX package on shared numpy inputs.

* ``kernels/ref.py``'s ``flash_attention_ref`` / ``decode_attention_ref``
  (the plain versions of the CUDA kernels, and what ``kernels.ops`` runs on
  the CPU) against ``repro.kernels.ref`` at the shapes of
  ``tests/test_kernels.py``, and against the Pallas kernels in interpret
  mode at the smallest of them: float32 to ``atol=rtol=2e-5``, bfloat16 to
  ``2e-2`` (the tolerances of ``tests/test_kernels.py``).
* ``attn_forward`` / ``attn_decode`` against the JAX ones on parameters
  carried across, with GQA, qk-norm, nonzero biases and a window that bites:
  ``atol=1e-4, rtol=1e-3``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import unzip
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TOL_MODEL = dict(atol=1e-4, rtol=1e-3)
FLASH_SHAPES = [  # tests/test_kernels.py
    (1, 128, 4, 4, 64, True, None),     # MHA causal
    (2, 256, 8, 2, 64, True, None),     # GQA
    (1, 256, 4, 1, 128, True, 64),      # MQA + sliding window
    (2, 128, 4, 4, 32, False, None),    # bidirectional
]
DECODE_SHAPES = [  # tests/test_kernels.py
    (2, 512, 8, 2, 64, 511, None),
    (1, 256, 4, 4, 128, 100, None),
    (2, 512, 16, 2, 64, 300, 128),      # SWA decode
    (1, 128, 8, 1, 64, 0, None),        # first token
]


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same arrays for both packages, rounded alike to ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return [jnp.asarray(a, jd) for a in arrays], [torch.tensor(a).to(td) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,causal,window", FLASH_SHAPES)
def test_flash_ref_matches_jax(B, S, H, KH, hd, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], S), dtype)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,valid,window", DECODE_SHAPES)
def test_decode_ref_matches_jax(B, S, H, KH, hd, valid, window, dtype):
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], S + valid), dtype)
    want = jax_ref.decode_attention_ref(jq, jk, jv, jnp.int32(valid), window=window)
    got = ref.decode_attention_ref(q, k, v, valid, window=window)
    _close(got, want, TOL[dtype])


def test_ops_on_cpu_match_pallas_interpret():
    """On the CPU the port's wrappers take the plain versions (and count no
    launch); both agree with the Pallas kernels run in interpret mode."""
    B, S, H, KH, hd, causal, window = FLASH_SHAPES[0]
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 1), "float32")
    ops.reset_launches()
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window, block_q=64,
                                   block_k=64, interpret=True)
    _close(ops.flash_attention(q, k, v, causal, window), want, TOL["float32"])
    B, S, H, KH, hd, valid, window = DECODE_SHAPES[3]
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 2), "float32")
    want = jax_ops.decode_attention(jq, jk, jv, jnp.int32(valid), window=window, block_k=64,
                                    interpret=True)
    _close(ops.decode_attention(q, k, v, valid, window), want, TOL["float32"])
    assert ops.LAUNCHES["flash_attention"] == 0 and ops.LAUNCHES["decode_attention"] == 0


@pytest.mark.parametrize("B,S,H,KH,hd,valid,window", DECODE_SHAPES)
def test_decode_tensor_valid_len_matches_pallas(B, S, H, KH, hd, valid, window):
    """``valid_len`` as a 0-d int32 tensor, the form the Pallas kernel takes:
    the port's wrapper (on the CPU, the plain path) and its plain version
    against the Pallas kernel in interpret mode."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], S + valid), "float32")
    want = jax_ops.decode_attention(jq, jk, jv, jnp.int32(valid), window=window, block_k=128,
                                    interpret=True)
    t = torch.tensor(valid, dtype=torch.int32)
    _close(ops.decode_attention(q, k, v, t, window), want, TOL["float32"])
    _close(ref.decode_attention_ref(q, k, v, t, window), want, TOL["float32"])


def test_decode_ref_no_live_position_gives_zeros():
    """With no live position the Pallas kernel's l is 0 and it writes zeros;
    the plain version does the same, for an int and a tensor."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(1, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], 9), "float32")
    want = jax_ops.decode_attention(jq, jk, jv, jnp.int32(-1), block_k=64, interpret=True)
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    for valid in (-1, torch.tensor(-1, dtype=torch.int32)):
        assert not ref.decode_attention_ref(q, k, v, valid).any()
    assert not ref.decode_attention_ref(q, k, v, 63 + 10, window=5).any()


N_SM = 132  # an H100 SXM


@pytest.mark.parametrize("B,KH,G,hd,elem,S,window", [
    (1, 36, 1, 64, 4, 2048, None),    # minicpm-2b
    (1, 4, 2, 256, 4, 2048, 1024),    # gemma3-4b, window 1024
    (1, 4, 2, 256, 2, 2048, None),    # gemma3-4b in bfloat16
    (2, 2, 4, 64, 4, 512, None),      # the tiny shapes of DECODE_SHAPES
    (1, 4, 1, 128, 4, 256, None),
    (2, 2, 8, 64, 4, 512, 128),
    (1, 1, 8, 64, 2, 128, None),
    (1, 2, 32, 128, 4, 300, 37),      # G=32: several head groups
    (64, 8, 4, 128, 4, 96, None),     # more units than SMs: one CTA each
])
def test_decode_geometry_covers_the_live_range(B, KH, G, hd, elem, S, window):
    """The decode kernel's geometry depends on the shapes only; for every
    valid_len in [0, S-1] (and past it) the CTAs' shares hold every live row
    exactly once and no other row; one wave of at most DECODE_CTAS_PER_SM
    CTAs per SM, and at least one per SM up to rounding."""
    gb, n_hg, splits = ops.decode_geometry(B, KH, G, hd, elem, N_SM)
    assert gb == ops.decode_heads_per_pass(hd, elem) and n_hg * gb >= G > (n_hg - 1) * gb
    units = B * KH * n_hg
    assert 1 <= splits <= ops.DECODE_MAX_SPLITS
    assert units * splits <= ops.DECODE_CTAS_PER_SM * N_SM or splits == 1
    assert splits >= min(N_SM // units, ops.DECODE_MAX_SPLITS) and units * splits >= N_SM // 2
    if (B, KH, G, hd, elem) == (1, 36, 1, 64, 4):
        assert splits == 14  # 504 CTAs
    if (B, KH, G, hd, elem) == (1, 4, 2, 256, 4):
        assert (gb, splits) == (2, 33)  # 132 CTAs
    for valid in list(range(S)) + [S, S + 5]:
        lo = max(0, valid - window + 1) if window else 0
        hi = min(valid, S - 1)
        rows = []
        for split in range(splits):
            b, e = ops.decode_share(valid, S, window, splits, split)
            assert e == b or (b - lo) % ops.DECODE_SHARE_ROWS == 0
            rows.extend(range(b, e))
        assert rows == list(range(lo, hi + 1)), valid


# ------------------------------------------------------ attention functions
def _cfg(get, **kw):
    """Reduced gemma3-4b (GQA 4:2, qk-norm, window 16) with biases on."""
    return dataclasses.replace(get("gemma3_4b").reduced(), use_bias=True, **kw)


def _params(cfg, seed=0):
    """JAX ``init_attention`` parameters, with biases and qk-norm scales made
    nonzero so that they are exercised; as numpy, for both packages."""
    p, _ = unzip(jax_attn.init_attention(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in p.items():
        a = np.asarray(a)
        if name[0] == "b" or name.endswith("_norm"):
            a = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        out[name] = a
    return out


@pytest.mark.parametrize("window,theta,causal", [(16, 1e4, True), (jax_attn.GLOBAL_WINDOW, 1e6, True),
                                                 (None, None, False)])
def test_attn_forward_matches_jax(window, theta, causal):
    jcfg, tcfg = _cfg(jax_get_config), _cfg(get_config)
    p = _params(jcfg)
    B, S = 2, 24  # S > window: the window bites
    x = np.random.default_rng(3).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, (jk, jv) = jax_attn.attn_forward({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                         jcfg, jnp.asarray(pos), window, theta, causal=causal)
    tw = None if window is None else int(window)
    ty, (tk, tv) = attn.attn_forward({k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x),
                                     tcfg, torch.tensor(pos), tw, theta, causal=causal)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, TOL_MODEL)


@pytest.mark.parametrize("cache_index", [20, 31, 40, np.array([7, 26], np.int32)],
                         ids=["scalar", "last", "past-end", "per-slot"])
@pytest.mark.parametrize("window", [16, None])
def test_attn_decode_matches_jax(cache_index, window):
    """Scalar and (B,) per-slot ``cache_index`` (the latter on the plain
    path); the new K/V land at the clamped index, the mask uses the
    unclamped one."""
    jcfg, tcfg = _cfg(jax_get_config), _cfg(get_config)
    p = _params(jcfg, seed=1)
    B, S, KH, hd = 2, 32, jcfg.n_kv_heads, jcfg.head_dim_
    x, kc, vc = _inputs([(B, 1, jcfg.d_model), (B, S, KH, hd), (B, S, KH, hd)], 5)
    jidx = jnp.asarray(cache_index) if isinstance(cache_index, np.ndarray) else jnp.int32(cache_index)
    tidx = torch.tensor(cache_index) if isinstance(cache_index, np.ndarray) else cache_index
    jy, (jk, jv) = jax_attn.attn_decode({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                        (jnp.asarray(kc), jnp.asarray(vc)), jcfg, jidx, window)
    ty, (tk, tv) = attn.attn_decode({k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x),
                                    (torch.tensor(kc), torch.tensor(vc)), tcfg, tidx, window)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, TOL_MODEL)


def test_softcap_runs_the_plain_path_on_cpu():
    """A logit softcap is not in the kernels; on the CPU ``sdpa`` takes it
    and matches the JAX package."""
    jcfg = _cfg(jax_get_config, attn_logit_softcap=0.5)
    tcfg = _cfg(get_config, attn_logit_softcap=0.5)
    p = _params(jcfg, seed=2)
    x = np.random.default_rng(4).standard_normal((1, 20, jcfg.d_model)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None]
    jy, _ = jax_attn.attn_forward({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), jcfg,
                                  jnp.asarray(pos), 16, 1e4)
    ty, _ = attn.attn_forward({k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x), tcfg,
                              torch.tensor(pos), 16, 1e4)
    _close(ty, jy, TOL_MODEL)


def test_mla_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        attn.init_mla(get_config("minicpm_2b"), None, "cpu")
