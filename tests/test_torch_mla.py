"""The port's MLA family (deepseek-v3-671b: multi-head latent attention with
the absorbed decode, sigmoid-routed MoE with a shared expert after a leading
dense layer, a depth-1 MTP head) held against the JAX package on the CPU, at
``reduced()`` (4 layers, 1 dense, 4 experts top-2; MLA ranks 32 / 16, dims
16 + 8 against 16), with the JAX weights carried across by ``unzip`` ->
numpy -> ``params_from_numpy`` and inputs drawn with numpy from a seed.
float32 to ``atol=1e-4, rtol=1e-3`` (``TOL_MODEL``), the attention kernels'
plain versions to ``atol=rtol=2e-5`` as in ``tests/test_torch_attention.py``.

* ``mla_forward`` and ``mla_decode`` (an int, a 0-d and a per-row ``(B,)``
  index, written into a cache that holds a prompt) against the JAX ones;
* ``flash_attention_ref`` with split head dims and ``decode_attention_latent_ref``
  against JAX einsums of the same function, and, with the head dims made
  equal (v or the latent padded with zeros) and the default scale, against
  the Pallas kernels in interpret mode;
* the reduced model's ``forward("train")`` logits, MoE aux and MTP hidden,
  prefill (logits and the latent caches) and decode steps;
* ``Instance.generate`` and ``ContinuousBatcher`` tokens against the JAX
  package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
NAME = "deepseek_v3_671b"
S = 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL_MODEL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_get_config(NAME).reduced(), get_config(NAME).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(0)))
    return jmodel, jparams, Model(tcfg, device="cpu"), params_from_numpy(_np(jparams), device="cpu")


def test_config_copy_matches_jax():
    j, t = jax_get_config(NAME), get_config("deepseek-v3-671b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params() and j.reduced().n_params() == t.reduced().n_params()
    assert Endpoint("m", t, max_cache_len=1024).est_bytes() == \
        JaxEndpoint("m", j, max_cache_len=1024).est_bytes()


# ------------------------------------------------------------------ layers
def _layer(pair, i=1):
    """Layer ``i`` of the moe stack's MLA parameters, in both packages."""
    jmodel, jparams, tmodel, tparams = pair
    jp = jax.tree.map(lambda a: a[i], jparams["moe_stack"]["attn"])
    tp = {k: v[i] for k, v in tparams["moe_stack"]["attn"].items()}
    return jmodel.cfg, tmodel.cfg, jp, tp


def test_mla_forward_matches_jax(pair):
    jcfg, tcfg, jp, tp = _layer(pair)
    x = _randn(np.random.default_rng(1), 2, S, tcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jy, (jc, jr) = jax_attn.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    ty, (tc, tr) = attn.mla_forward(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    _close(ty, jy)
    _close(tc, jc)
    _close(tr, jr)


@pytest.mark.parametrize("index", ["int", "0-d", "per-row"])
def test_mla_decode_matches_jax(pair, index):
    """One decode step into a latent cache that holds a 12-token prompt (and
    zeros beyond): the output and both cache arrays, written in place in the
    port; the per-row index has one row past the prompt and one past S-1."""
    jcfg, tcfg, jp, tp = _layer(pair, 2)
    m, B, Sc = tcfg.mla, 2, 16
    rng = np.random.default_rng(2)
    c = np.zeros((B, Sc, m.kv_lora_rank), np.float32)
    r = np.zeros((B, Sc, m.qk_rope_head_dim), np.float32)
    c[:, :S], r[:, :S] = _randn(rng, B, S, m.kv_lora_rank), _randn(rng, B, S, m.qk_rope_head_dim)
    x = _randn(rng, B, 1, tcfg.d_model)
    idx = {"int": S, "0-d": np.int32(S), "per-row": np.array([S + 2, Sc + 3], np.int32)}[index]
    jy, (jc, jr) = jax_attn.mla_decode(jp, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(r)),
                                       jcfg, jnp.asarray(idx))
    tidx = idx if index == "int" else torch.from_numpy(np.asarray(idx))
    cache = (torch.from_numpy(c.copy()), torch.from_numpy(r.copy()))
    ty, (tc, tr) = attn.mla_decode(tp, torch.from_numpy(x), cache, tcfg, tidx)
    assert tc is cache[0] and tr is cache[1]
    _close(ty, jy)
    _close(tc, jc)
    _close(tr, jr)


# ---------------------------------------------------------- plain kernels
def _jax_split_sdpa(q, k, v, scale):
    """Causal attention with q/k heads of one width and v of another, as the
    JAX ``mla_forward`` runs it through ``sdpa`` (float32)."""
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    Sq = q.shape[1]
    ok = jnp.arange(Sq)[None, :] <= jnp.arange(Sq)[:, None]
    probs = jax.nn.softmax(jnp.where(ok, logits, -2.0e38), axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v)


@pytest.mark.parametrize("hd,hd_v,S", [(24, 16, 20), (192, 128, 20), (192, 128, 70)])
def test_flash_ref_split_head_dims_matches_jax(hd, hd_v, S):
    """At the scale JAX's MLA uses, 1/sqrt(nope + rope), which is the plain
    version's (and the kernel's) 1/sqrt of q's head dim."""
    rng = np.random.default_rng(hd + hd_v + S)
    q, k = _randn(rng, 2, S, 3, hd), _randn(rng, 2, S, 3, hd)
    v = _randn(rng, 2, S, 3, hd_v)
    s = 1.0 / jnp.sqrt(jnp.float32(hd))
    want = _jax_split_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), s)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), True, None)
    assert got.shape == (2, S, 3, hd_v)
    _close(got, want, TOL_ATTN)
    # the wrapper on the CPU is the plain version; a strided v (the tail of
    # each head's [k_nope | v] row, as mla_forward passes it) reads the same
    kv = torch.cat([torch.from_numpy(k), torch.from_numpy(v)], dim=-1)
    ops.reset_launches()
    _close(ops.flash_attention(torch.from_numpy(q), kv[..., :hd], kv[..., hd:], True, None),
           want, TOL_ATTN)
    assert ops.LAUNCHES["flash_attention"] == 0


def test_flash_ref_split_dims_match_pallas_interpret():
    """v padded with zeros to q's head dim gives the Pallas kernel's
    equal-dims attention (interpret mode, default scale) in its first hd_v
    columns."""
    rng = np.random.default_rng(5)
    q, k, v = _randn(rng, 1, 128, 2, 32), _randn(rng, 1, 128, 2, 32), _randn(rng, 1, 128, 2, 16)
    v_pad = np.concatenate([v, np.zeros_like(v)], axis=-1)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v_pad),
                                   causal=True, block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), True)
    _close(got, np.asarray(want)[..., :16], TOL_ATTN)


def _jax_latent(q_lat, q_rope, c, r, valid, scale):
    """The attention of the JAX ``mla_decode``, float32."""
    scores = (jnp.einsum("bhr,bsr->bhs", q_lat, c) + jnp.einsum("bhe,bse->bhs", q_rope, r))
    ok = jnp.arange(c.shape[1])[None, :] <= jnp.broadcast_to(valid, (c.shape[0],))[:, None]
    probs = jax.nn.softmax(jnp.where(ok[:, None, :], scores * scale, -2.0e38), axis=-1)
    return jnp.einsum("bhs,bsr->bhr", probs, c)


@pytest.mark.parametrize("valid", [0, 37, 63, 90, "per-row", "0-d"])
def test_latent_ref_matches_jax(valid):
    rng = np.random.default_rng(7)
    B, H, Sc, dc, dr = 3, 8, 64, 32, 16
    q_lat, q_rope = _randn(rng, B, H, dc), _randn(rng, B, H, dr)
    c, r = _randn(rng, B, Sc, dc), _randn(rng, B, Sc, dr)
    v = {"per-row": np.array([5, 63, 70], np.int32), "0-d": np.int32(20)}.get(valid, valid)
    scale = float(np.float32(1) / np.sqrt(np.float32(24)))
    want = _jax_latent(*map(jnp.asarray, (q_lat, q_rope, c, r)), jnp.asarray(v), scale)
    tv = torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
    args = (*map(torch.from_numpy, (q_lat, q_rope, c, r)), tv, scale)
    _close(ref.decode_attention_latent_ref(*args), want, TOL_ATTN)
    ops.reset_launches()
    _close(ops.decode_attention_latent(*args), want, TOL_ATTN)
    assert ops.LAUNCHES["decode_attention_latent"] == 0


def test_latent_ref_matches_pallas_interpret():
    """The latent decode is one kv head read by every query head: the Pallas
    decode kernel (interpret mode) on q = [q_lat | q_rope], k = [c | r] and
    v = [c | 0] gives the latent output in its first dc columns, at the
    default scale 1/sqrt(dc + dr); per row with its own length."""
    rng = np.random.default_rng(8)
    B, H, Sc, dc, dr = 2, 4, 128, 16, 16
    q_lat, q_rope = _randn(rng, B, H, dc), _randn(rng, B, H, dr)
    c, r = _randn(rng, B, Sc, dc), _randn(rng, B, Sc, dr)
    lengths = [40, 127]
    scale = float(np.float32(1) / np.sqrt(np.float32(dc + dr)))
    got = ref.decode_attention_latent_ref(*map(torch.from_numpy, (q_lat, q_rope, c, r)),
                                          torch.tensor(lengths, dtype=torch.int32), scale)
    q = np.concatenate([q_lat, q_rope], -1)
    k = np.concatenate([c, r], -1)[:, :, None]
    v = np.concatenate([c, np.zeros_like(r)], -1)[:, :, None]
    for b, n in enumerate(lengths):
        want = jax_ops.decode_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                        jnp.asarray(v[b:b + 1]), jnp.int32(n), block_k=64,
                                        interpret=True)
        _close(got[b:b + 1], np.asarray(want)[..., :dc], TOL_ATTN)


def _shares_cover_live_rows(B, S, tensor_cores):
    heads, rows, n_hg, splits = ops.latent_geometry(B, 128, S, 132, tensor_cores)
    assert n_hg == 128 // heads and 1 <= splits <= -(-S // rows)
    per_sm = ops.LATENT_CTAS_PER_SM if tensor_cores else ops.LATENT_F32_CTAS_PER_SM
    assert B * n_hg * splits <= per_sm * 132 or splits == 1
    for valid in (0, 15, 16, 63, 64, 500, S - 1, S + 5):
        rows_read = []
        for sp in range(splits):
            b, e = ops.decode_share(valid, S, None, splits, sp, rows)
            assert b == e or (b % rows == 0)
            rows_read.extend(range(b, e))
        assert rows_read == list(range(min(valid, S - 1) + 1))


def test_latent_geometry_shares_cover_every_live_row_once():
    """The tensor-core latent kernel's grid (64 heads a CTA: 128 heads are 2
    head groups) comes from the shapes alone, and its splits' shares
    (``decode_share`` in ``LATENT_ROWS``-row granules) cover each live row
    exactly once, at the batcher's and the engine's shapes."""
    for B, S in ((8, 1024), (1, 1024), (1, 48), (1, 2048), (5, 1024), (3, 200)):
        _shares_cover_live_rows(B, S, tensor_cores=True)
    assert ops.latent_geometry(8, 128, 1024, 132) == (64, 64, 2, 8)
    assert ops.latent_geometry(1, 128, 2048, 132) == (64, 64, 2, 32)


def test_latent_geometry_of_the_cuda_core_kernel():
    """The CUDA-core latent kernel (float32 or mixed types) keeps its own
    geometry: 16 heads a CTA (8 head groups at 128 heads), 16-row tiles, 2
    CTAs an SM, at most 16 splits, and the same cover of the live rows."""
    for B, S in ((8, 1024), (1, 1024), (1, 48)):
        _shares_cover_live_rows(B, S, tensor_cores=False)
    assert ops.latent_geometry(8, 128, 1024, 132, tensor_cores=False) == (16, 16, 8, 4)
    assert ops.latent_geometry(1, 128, 1024, 132, tensor_cores=False) == (16, 16, 8, 16)


# ------------------------------------------------------------------- model
def test_forward_mtp_and_aux_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(3).integers(0, tmodel.cfg.vocab, (2, S)).astype(np.int32)
    jl, (ja, jh), _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    tl, (ta, th), _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    _close(th, jh)
    _close(ta, ja, dict(atol=1e-5, rtol=0))
    assert th.shape == (2, S, tmodel.cfg.d_model) and float(ta) > 0
    # prefill and decode never run the MTP head
    assert not isinstance(tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                                         mode="prefill")[1], tuple)


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    jcache, jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tcache, tlogits = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    assert sorted(tcache) == sorted(jcache) == ["dense", "moe"]
    zero = tmodel.init_cache(2, S + 4, torch.float32)
    big = {}
    for key, jpair in jcache.items():
        big[key] = []
        for got, want, z in zip(tcache[key], jpair, zero[key]):
            _close(got, want)
            assert z.shape[:3] == got.shape[:2] + (S + 4,) and z.shape[3:] == got.shape[3:]
            b = np.zeros(tuple(z.shape), np.float32)
            b[:, :, :S] = np.asarray(want)
            big[key].append(b)
    jc = {k: tuple(jnp.asarray(b) for b in v) for k, v in big.items()}
    tc = {k: tuple(torch.tensor(b) for b in v) for k, v in big.items()}
    for step, idx in enumerate((S, np.int32(S + 1), np.array([S + 2, 3], np.int32))):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc, jnp.asarray(idx))
        tidx = idx if step == 0 else torch.from_numpy(np.asarray(idx))
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc, tidx)
        _close(tl, jl)
        for key in jc:
            for got, want in zip(tc[key], jc[key]):
                _close(got, want)


# ----------------------------------------------------------------- serving
def _tiny(get):
    return dataclasses.replace(get(NAME).reduced(), vocab=64)


@pytest.mark.parametrize("S_,gen_len,seed", [(9, 4, 0), (30, 3, 1)])
def test_generate_matches_jax_tokens(S_, gen_len, seed):
    jinst = JaxInstance(JaxEndpoint("m", _tiny(jax_get_config), seed=seed, max_cache_len=40))
    ep = Endpoint("m", _tiny(get_config), seed=seed, max_cache_len=40)
    inst = Instance(ep, device="cpu", params=params_from_numpy(_np(jinst.params), device="cpu"))
    tokens = np.random.default_rng(S_).integers(0, 64, (2, S_)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    np.testing.assert_array_equal(inst.generate(torch.from_numpy(tokens), gen_len).numpy(), want)


def test_bf16_endpoint_decodes_on_a_bf16_cache():
    """``Instance.generate`` decodes on a cache of the endpoint's parameter
    dtype: a bfloat16 endpoint's latent cache is bfloat16."""
    inst = Instance(Endpoint("m", _tiny(get_config), seed=2, max_cache_len=40,
                             param_dtype=torch.bfloat16), device="cpu")
    made = []
    init_cache = inst.model.init_cache
    inst.model.init_cache = lambda *a, **kw: made.append(init_cache(*a, **kw)) or made[-1]
    out = inst.generate(torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 9))
                                         .astype(np.int32)), 4)
    assert out.shape == (2, 4) and len(made) == 1
    leaves = [t for pair in made[0].values() for t in pair]
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)


def test_batcher_matches_jax_tokens():
    """7 requests through 3 slots (slots reused, each slot's latent rows
    masked by its own length), the same tokens in the same number of
    steps."""
    jmodel = jax_build_model(_tiny(jax_get_config), remat=False)
    jparams, _ = unzip(jmodel.init(jax.random.key(4)))
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
    c, r = tb.mgr.cache["moe"]
    assert tuple(c.shape) == (3, 3, 24, 16) and tuple(r.shape) == (3, 3, 24, 8)
