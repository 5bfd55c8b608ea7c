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
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
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
    """A logit softcap: on the CPU the attention kernels' plain versions
    apply it and match the JAX package (the kernels on the card are held to
    them in ``test_torch_gpu.py``)."""
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
    """``init_mla`` on reduced deepseek-v3 gives the JAX ``init_mla``'s keys,
    shapes and dtypes (norm scales zero and float32), unstacked and stacked
    on a leading layer axis."""
    jcfg, cfg = jax_get_config("deepseek_v3_671b").reduced(), get_config("deepseek_v3_671b").reduced()
    want, _ = unzip(jax_attn.init_mla(jax.random.key(0), jcfg, jnp.bfloat16))
    for layers in (0, 3):
        got = attn.init_mla(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16, layers)
        lead = (layers,) if layers else ()
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == \
            {k: (lead + a.shape, str(a.dtype)) for k, a in want.items()}
        assert not got["q_norm"].any() and not got["kv_norm"].any()


# ------------------------------------------- per-row lengths, cache dtypes
CACHE_DTYPES = ["float32", "bfloat16", "float8_e4m3fn"]


@pytest.mark.parametrize("B,S,H,KH,hd,window,lengths", [
    (3, 128, 8, 2, 64, None, [0, 77, 127]),
    (4, 256, 4, 4, 128, 64, [5, 200, 255, 300]),   # one row past S-1
    (2, 128, 8, 1, 64, None, [-1, 40]),            # a row with no live position
])
def test_decode_per_row_lengths_match_pallas(B, S, H, KH, hd, window, lengths):
    """A (B,) int32 ``valid_len``: each row of the plain version (and of the
    wrapper on the CPU) against the Pallas kernel in interpret mode run on
    that row alone with its own length; a row with none live gives zeros."""
    (jq, jk, jv), (q, k, v) = _pair(_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], B + S), "float32")
    t = torch.tensor(lengths, dtype=torch.int32)
    got_ref = ref.decode_attention_ref(q, k, v, t, window)
    got_ops = ops.decode_attention(q, k, v, t, window)
    for b, n in enumerate(lengths):
        want = jax_ops.decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], jnp.int32(n),
                                        window=window, block_k=64, interpret=True)
        _close(got_ref[b:b + 1], want, TOL["float32"])
        _close(got_ops[b:b + 1], want, TOL["float32"])
        if n < 0:
            assert not got_ref[b].any()


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_decode_mixed_dtypes_match_pallas(q_dtype, cache_dtype):
    """q and the cache in the dtypes the decode kernel is instantiated for,
    with per-row lengths: the plain version upcasts the cache straight to
    float32, as the Pallas kernel does per tile (run here in interpret mode
    on the same rounded inputs, row by row).  Tolerance: q's dtype's."""
    B, S, H, KH, hd, window, lengths = 2, 128, 8, 2, 64, None, [31, 127]
    a = _inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 11)
    jq, tq = jnp.asarray(a[0], getattr(jnp, q_dtype)), torch.tensor(a[0]).to(getattr(torch, q_dtype))
    jk, jv = (jnp.asarray(x, getattr(jnp, cache_dtype)) for x in a[1:])
    tk, tv = (torch.tensor(x).to(getattr(torch, cache_dtype)) for x in a[1:])
    got = ref.decode_attention_ref(tq, tk, tv, torch.tensor(lengths, dtype=torch.int32), window)
    assert got.dtype == tq.dtype
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    for b, n in enumerate(lengths):
        want = jax_ops.decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], jnp.int32(n),
                                        window=window, block_k=64, interpret=True)
        _close(got[b:b + 1], want, TOL[q_dtype])
    torch.testing.assert_close(ops.decode_attention(tq, tk, tv, torch.tensor(lengths, dtype=torch.int32)),
                               got, atol=0, rtol=0)


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
@pytest.mark.parametrize("window", [16, None])
def test_attn_decode_per_row_cache_dtypes_match_jax(cache_dtype, window):
    """``attn_decode`` with a (B,) int32 ``cache_index`` into a cache of each
    dtype: output and written cache against the JAX function, to atol=1e-4,
    rtol=1e-3 (a bfloat16 or fp8 cache compared exactly: the float32 K/V
    that differ in the last bit round alike)."""
    jcfg, tcfg = _cfg(jax_get_config), _cfg(get_config)
    p = _params(jcfg, seed=3)
    B, S, KH, hd = 3, 32, jcfg.n_kv_heads, jcfg.head_dim_
    x, kc, vc = _inputs([(B, 1, jcfg.d_model), (B, S, KH, hd), (B, S, KH, hd)], 6)
    idx = np.array([0, 19, 40], np.int32)
    jd, td = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jy, (jk, jv) = jax_attn.attn_decode({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                        (jnp.asarray(kc, jd), jnp.asarray(vc, jd)), jcfg,
                                        jnp.asarray(idx), window)
    ty, (tk, tv) = attn.attn_decode({k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x),
                                    (torch.tensor(kc).to(td), torch.tensor(vc).to(td)), tcfg,
                                    torch.from_numpy(idx), window)
    _close(ty, jy, TOL_MODEL)
    for got, want in ((tk, jk), (tv, jv)):
        assert got.dtype == td
        _close(got, want, TOL_MODEL if cache_dtype == "float32" else dict(atol=0, rtol=0))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float8_e4m3fn"])
def test_flash_mixed_dtypes_match_pallas(dtype):
    """q in float32 with k and v in another dtype: the wrapper casts all to
    float32 (the Pallas kernel casts each tile) and returns q's dtype."""
    B, S, H, KH, hd, causal, window = FLASH_SHAPES[2]
    a = _inputs([(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 12)
    jq, tq = jnp.asarray(a[0]), torch.tensor(a[0])
    jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in a[1:])
    tk, tv = (torch.tensor(x).to(getattr(torch, dtype)) for x in a[1:])
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window, block_q=64,
                                   block_k=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal, window)
    assert got.dtype == torch.float32
    _close(got, want, TOL["float32"])


def test_ssd_scan_mixed_dtypes_match_float32():
    """x in bfloat16 with B, C in float32 and dt in bfloat16: the wrapper
    casts every input to float32 (as the Pallas kernel does per tile) and
    returns y in x's dtype and the state in float32."""
    rng = np.random.default_rng(13)
    Bsz, S, H, P, G, N = 1, 64, 4, 8, 1, 8
    x = torch.tensor(rng.standard_normal((Bsz, S, H, P)), dtype=torch.bfloat16)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))), dtype=torch.bfloat16)
    A = -torch.tensor(np.exp(rng.standard_normal(H) * 0.3), dtype=torch.float32)
    Bm, Cm = (torch.tensor(rng.standard_normal((Bsz, S, G, N)) * 0.3, dtype=torch.float32)
              for _ in range(2))
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    y32, st32 = ops.ssd_scan(x.float(), dt.float(), A, Bm, Cm, chunk=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y, y32.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(st, st32, atol=0, rtol=0)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, Bm, Cm, chunk=32)


def test_vlm_forward_with_patches_matches_jax():
    """Reduced llava-next-mistral-7b: ``forward`` with precomputed patch
    embeddings spliced over the first tokens, against the JAX
    ``Model.forward`` on the same weights and patches (atol=1e-4,
    rtol=1e-3); the patches move the logits of every position."""
    from repro.models import build_model as jax_build_model
    from repro_torch.models import Model, params_from_numpy
    from repro_torch.models.frontends import synth_patches

    jcfg = jax_get_config("llava_next_mistral_7b").reduced()
    tcfg = get_config("llava_next_mistral_7b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build_model(jcfg, remat=False)
    jp, _ = unzip(jm.init(jax.random.key(1)))
    model = Model(tcfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(14)
    tokens = rng.integers(0, tcfg.vocab, (2, 20)).astype(np.int32)
    patches = (rng.standard_normal((2, tcfg.n_frontend_tokens, tcfg.d_model)) * 0.02).astype(np.float32)
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    tl, _, _ = model.forward(params, {"tokens": torch.from_numpy(tokens),
                                      "patches": torch.from_numpy(patches)})
    _close(tl, jl, TOL_MODEL)
    plain, _, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert (plain - tl).abs().amax(dim=-1).min() > 0
    g = synth_patches(torch.Generator().manual_seed(0), 2, tcfg.n_frontend_tokens, tcfg.d_model)
    assert g.shape == (2, 8, tcfg.d_model) and abs(float(g.std()) - 0.02) < 0.005
