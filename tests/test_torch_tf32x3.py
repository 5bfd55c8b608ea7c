"""The numerics argument for the kernels' tensor-core products.

``csrc/flash_attention_bwd.cu``, ``csrc/ssd_scan_bwd.cu`` and
``csrc/linear_tf32x3.cu`` (the served prefill's dense products) run their
float32 products on TF32 tensor cores in split precision: x = big + small,
big = tf32(x), small = tf32(x - big), a.b = small.big + big.small + big.big.
These tests hold that scheme, as ``kernels/ref.py`` writes it out on the
CPU, against float64 and against the kernels' tolerances, at the depths the
kernels use, and show that one TF32 product (what ``allow_tf32`` would give)
misses them, so the split is needed; for the dense products, through one
full-width minicpm-2b layer to its logits.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro_torch.kernels import ref

TOL_BWD = dict(atol=1e-4, rtol=1e-3)  # the float32 gradients' tolerance (chip_smoke.py)
# a product's error against float64, relative to sum_k |a_ik| |b_kj| (the
# scale every term's rounding is relative to): split precision drops
# small.small (2^-22) and rounds small (2^-22 of x) and sums in float32,
# ~3e-7 here; one TF32 product rounds each operand to 2^-11, ~1e-4
SPLIT_REL = 1e-6


def _f32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_round_tf32_is_round_to_nearest_ties_away():
    """``round_tf32`` keeps 10 explicit mantissa bits, rounds to nearest and
    breaks ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    rng = np.random.default_rng(0)
    x = _f32(rng.standard_normal(10_000) * np.exp(rng.uniform(-30, 30, 10_000)))
    r = ref.round_tf32(x)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    # within half a TF32 ulp (2^-11 of the leading bit)
    assert torch.all((r.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs())
    # ties go away from zero (also from an odd last bit); just under a tie
    # goes down
    ties = _f32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23])
    want = _f32([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0])
    assert torch.equal(ref.round_tf32(ties), want)


def _products(rng, case):
    """(equation, a, b) of one product as a backward kernel chains it."""
    if case in ("qk_hd64", "qk_hd80"):  # the scores q.k^T (and dO.v^T): depth hd
        hd = 64 if case == "qk_hd64" else 80
        return "ik,jk->ij", rng.standard_normal((256, hd)), rng.standard_normal((256, hd))
    if case in ("pdo_hd64", "pdo_hd80"):  # dv = P^T dO (and dk, dq): depth S
        hd = 64 if case == "pdo_hd64" else 80
        p = np.exp(rng.standard_normal((256, 256)))
        return "ik,kj->ij", p / p.sum(1, keepdims=True), rng.standard_normal((256, hd))
    if case == "stages_64x64x256":  # mma_stages: a 64 x 64 tile over four 64-deep stages
        return "ik,kj->ij", rng.standard_normal((64, 256)) * 0.3, rng.standard_normal((256, 64))
    # zamba2-2.7b's decays: cs falls by hundreds over a 256-long chunk, and
    # M_qk = (C_q . B_k) exp(cs_q - cs_k) dt_k spans as many orders of
    # magnitude along each row of the last q tile
    Q = 256
    dt = np.log1p(np.exp(rng.standard_normal(Q)))
    cs = np.cumsum(dt * -np.exp(rng.standard_normal() + 1.0))
    assert cs[0] - cs[-1] > 100
    q, k = np.arange(Q - 64, Q), np.arange(Q)
    decay = np.where(k[None] <= q[:, None], np.exp(cs[q][:, None] - cs[None]), 0.0)
    return "ik,kj->ij", rng.standard_normal((64, Q)) * 0.1 * decay * dt, rng.standard_normal((Q, 64))


@pytest.mark.parametrize("case", ["qk_hd64", "qk_hd80", "pdo_hd64", "pdo_hd80",
                                  "stages_64x64x256", "large_cs_zamba2"])
def test_split_product_matches_float64(case):
    """Split precision lies within SPLIT_REL of the float64 product, element
    by element relative to sum_k |a_ik| |b_kj|; one TF32 product misses that
    by two orders of magnitude or more."""
    eq, a, b = _products(np.random.default_rng(1), case)
    a, b = _f32(a), _f32(b)
    exact = torch.einsum(eq, a.double(), b.double())
    scale = torch.einsum(eq, a.double().abs(), b.double().abs())
    split = (ref.einsum_tf32x3(eq, a, b).double() - exact).abs() / scale
    one = (ref.einsum_tf32(eq, a, b).double() - exact).abs() / scale
    assert float(split.max()) <= SPLIT_REL
    assert float(one.max()) > 100 * SPLIT_REL


def _attn(hd, seed):
    rng = np.random.default_rng(seed)
    B, S, H, KH = 1, 256, 4, 2
    q, k, v, do = (_f32(rng.standard_normal(s)) for s in
                   [(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd), (B, S, H, hd)])
    return q, k, v, do


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_bwd_split_within_tolerance(hd):
    """``flash_attention_bwd_ref`` with its five products in split precision
    stays within TOL_BWD of the float32 plain version (about 1 % of it);
    with one TF32 product each it misses TOL_BWD (the cancelling dO.v - D
    and the softmax magnify the 2^-11 rounding)."""
    q, k, v, do = _attn(hd, hd)
    out = ref.flash_attention_ref(q, k, v, True)
    lse = ref.flash_attention_lse_ref(q, k, True)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    split = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, einsum=ref.einsum_tf32x3)
    one = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, einsum=ref.einsum_tf32)
    for s, p in zip(split, plain):
        torch.testing.assert_close(s, p, **TOL_BWD)
    assert not all(torch.allclose(o, p, **TOL_BWD) for o, p in zip(one, plain))


def _flash_bwd_float64(q, k, v, do, causal, window, cap):
    """The gradient of capped attention in float64, with its own float64
    forward: the truth both float32 versions are held against."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg, dog = q.reshape(B, S, KH, H // KH, hd), do.reshape(B, S, KH, H // KH, hd)
    u = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / np.sqrt(hd)
    t = torch.tanh(u / cap)
    pos = torch.arange(S)
    live = torch.ones(S, S, dtype=torch.bool)
    if causal:
        live &= pos[None] <= pos[:, None]
    if window:
        live &= pos[:, None] - pos[None] < window
    p = torch.softmax((cap * t).masked_fill(~live, -np.inf), -1)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", dog, v)
              - (dog * o).sum(-1).permute(0, 2, 3, 1)[..., None]) * (1 - t * t)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k).reshape(B, S, H, hd) / np.sqrt(hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) / np.sqrt(hd)
    return dq, dk, dv


def _softcap_data():
    """tests/test_torch_gpu.py's softcap data: q scaled by 8, logits of ~+-60."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_f32(rng.standard_normal(s)) for s in
                   [(1, 200, 4, 64), (1, 200, 2, 64), (1, 200, 2, 64), (1, 200, 4, 64)])
    return q * 8, k, v, do


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_bwd_split_against_float64(causal, window):
    """At the card's softcap test data (cap 50, q scaled by 8: logits of
    +-60, where the last bit of a float32 logit moves P by ~4e-6), the split
    version and the float32 plain version both lie within TOL_BWD of the
    float64 gradient, and one TF32 product lies outside it, so TOL_BWD
    against float64 tells the split from one TF32 product there."""
    q, k, v, do = _softcap_data()
    cap = 50.0
    out = ref.flash_attention_ref(q, k, v, causal, window, cap)
    lse = ref.flash_attention_lse_ref(q, k, causal, window, cap)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    split = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap,
                                        einsum=ref.einsum_tf32x3)
    one = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap,
                                      einsum=ref.einsum_tf32)
    want = _flash_bwd_float64(q, k, v, do, causal, window, cap)
    for s, p, w in zip(split, plain, want):
        torch.testing.assert_close(s.double(), w, **TOL_BWD)
        torch.testing.assert_close(p.double(), w, **TOL_BWD)
    assert not any(torch.allclose(o.double(), w, **TOL_BWD) for o, w in zip(one, want))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_bwd_float64_logits_miss_2e5(causal, window):
    """At the same data a backward whose products are float64, each rounded
    once to float32, still lies more than atol = rtol = 2e-5 (the card's
    TOL_ATTN) from the float32 plain version: the plain version's own
    logits are that far from exact.  So 2e-5 there holds only a backward
    that sums its logits in the plain version's order; it is not a bound
    on a backward's accuracy."""
    q, k, v, do = _softcap_data()
    cap = 50.0
    out = ref.flash_attention_ref(q, k, v, causal, window, cap)
    lse = ref.flash_attention_lse_ref(q, k, causal, window, cap)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    exact = ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal, window, cap,
        einsum=lambda eq, a, b: torch.einsum(eq, a.double(), b.double()).float())
    assert not all(torch.allclose(e, p, atol=2e-5, rtol=2e-5) for e, p in zip(exact, plain))


def _ssd(H, a_scale, seed):
    rng = np.random.default_rng(seed)
    B, S, P, N, G = 1, 512, 64, 64, 1
    x = _f32(rng.standard_normal((B, S, H, P)) * 0.5)
    dt = _f32(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = _f32(-np.exp(rng.standard_normal(H) * a_scale))
    Bm, Cm = (_f32(rng.standard_normal((B, S, G, N)) * 0.3) for _ in range(2))
    dy = _f32(rng.standard_normal((B, S, H, P)))
    return x, dt, A, Bm, Cm, dy


@pytest.mark.parametrize("width,a_scale", [("mamba2", 0.3), ("zamba2_large_cs", 1.0)])
def test_ssd_bwd_split_within_tolerance(width, a_scale):
    """``ssd_scan_bwd_ref`` with its matrix products in split precision stays
    within TOL_BWD of the float32 plain version at chunk 256, also where
    |cs| falls by hundreds over a chunk (a_scale 1.0: zamba2-2.7b's decays);
    with one TF32 product each it misses TOL_BWD."""
    x, dt, A, Bm, Cm, dy = _ssd(8, a_scale, 3)
    cs = torch.cumsum(dt * A, 1).reshape(1, 2, 256, 8)
    span = float((cs[:, :, 0] - cs[:, :, -1]).abs().max())
    assert span > (100 if a_scale == 1.0 else 10)
    plain = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, 256, None, dy, None)
    split = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, 256, None, dy, None, einsum=ref.einsum_tf32x3)
    one = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, 256, None, dy, None, einsum=ref.einsum_tf32)
    for s, p in zip(split, plain):
        torch.testing.assert_close(s, p, **TOL_BWD)
    assert not all(torch.allclose(o, p, **TOL_BWD) for o, p in zip(one, plain))


TOL_ATTN = dict(atol=2e-5, rtol=2e-5)  # the card's float32 attention tolerance


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_plain_bwd_against_float64(causal, window):
    """At the card's softcap test data (cap 50, logits of +-60) the float32
    plain backward lies outside TOL_ATTN of the float64 gradient in dk (by
    up to 4.83e-5, 3.76e-5 and 3.57e-5; 2, 1 and 1 elements over) and within
    it in dq and dv (6.4e-6, 1.04e-5 at most).  So the card's test holds the
    float32 kernel to float64, at most TOL_ATTN's atol less accurate than
    this plain version, not to the plain version at TOL_ATTN."""
    q, k, v, do = _softcap_data()
    cap = 50.0
    out = ref.flash_attention_ref(q, k, v, causal, window, cap)
    lse = ref.flash_attention_lse_ref(q, k, causal, window, cap)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    want = _flash_bwd_float64(q, k, v, do, causal, window, cap)
    assert not torch.allclose(dk.double(), want[1], **TOL_ATTN)
    assert float((dk.double() - want[1]).abs().max()) < 5e-5
    for g, w in ((dq, want[0]), (dv, want[2])):
        torch.testing.assert_close(g.double(), w, **TOL_ATTN)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_bwd_float32_logits_within_limit(causal, window):
    """The float32 backward with a softcap as the kernel computes it: the
    logits q.k^T in float32 (FFMA on the CUDA cores), the other four
    products in split precision.  At the card's softcap data (cap 50, logits
    of +-60) each of dq, dk and dv lies within the float32 plain version's
    own error + 2e-5 of the float64 gradient, the limit
    ``tests/test_torch_gpu.py::test_softcap_kernels_match_plain`` holds the
    kernel to.  With all five products split (the logits too: ~2^-21 of
    +-60 moves P where the cap bends it) the gradient misses that limit."""
    q, k, v, do = _softcap_data()
    cap = 50.0
    out = ref.flash_attention_ref(q, k, v, causal, window, cap)
    lse = ref.flash_attention_lse_ref(q, k, causal, window, cap)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    kernel = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap,
                                         einsum=ref.einsum_tf32x3, logits_einsum=torch.einsum)
    split = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap,
                                        einsum=ref.einsum_tf32x3)
    want = _flash_bwd_float64(q, k, v, do, causal, window, cap)

    def within(got):
        return [float((g.double() - w).abs().max()) <= float((p.double() - w).abs().max())
                + TOL_ATTN["atol"] for g, p, w in zip(got, plain, want)]

    assert all(within(kernel)), within(kernel)
    assert not all(within(split))


def _attention64(flash):
    """``ops.flash_attention`` with float64 q, k, v in float64 (causal
    softmax attention, the port's plain version otherwise)."""

    def attend(q, k, v, causal=True, window=None, softcap=None):
        if q.dtype != torch.float64:
            return flash(q, k, v, causal, window, softcap)
        assert window is None and softcap is None and k.shape[2] == q.shape[2]
        S, hd = q.shape[1], q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        live = torch.ones(S, S, dtype=torch.bool).tril()
        probs = torch.softmax(logits.masked_fill(~live, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    return attend


def test_minicpm_layer_logits_split_within_a_tenth_of_the_check(monkeypatch):
    """One minicpm-2b layer at full width (d 2,304, 36 heads of 64, SwiGLU
    5,760), its vocabulary cut to 4,096, over 128 tokens, with every dense
    product routed as on the card and computed as ``linear_tf32x3``'s plain
    version (``ref.einsum_tf32x3``): the logits' relative error (max |diff|
    over max |reference|, the check's ``prefill_logit_err``) against the
    same layer in float64 (products and attention; the norms and RoPE round
    to float32 in both, ~6e-8 of their values) stays under a tenth of the
    check's 1e-4 (~2.5e-7 at seed 0).  One TF32 product in each place
    misses that tenth by far (~9e-5 on this one layer; the check's control
    reads ~1e-3 on the whole model)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("minicpm_2b"), n_layers=1, vocab=4096)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 128)))

    def logits(dtype, tree):
        return Model(cfg, dtype, device="cpu").forward(tree, {"tokens": tokens}, "prefill")[0]

    monkeypatch.setattr(ops, "flash_attention", _attention64(ops.flash_attention))
    want = logits(torch.float64, _tree(params, torch.float64))
    # every product as on the card
    monkeypatch.setattr(ops, "_tc_plan", lambda x, ws: (None, x.reshape(-1, x.shape[-1]), None))
    got = logits(torch.float32, params)
    monkeypatch.setattr(ref, "linear_tf32x3_ref",
                        lambda a, w: ref.einsum_tf32("mk,kn->mn", a, w))
    control = logits(torch.float32, params)

    def err(t):
        return float((t.double() - want).abs().max() / want.abs().max())

    assert err(got) < 1e-5 < err(control) / 5, (err(got), err(control))


def _tree(p, dtype):
    if isinstance(p, dict):
        return {k: _tree(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_tree(v, dtype) for v in p)
    return p.to(dtype) if isinstance(p, torch.Tensor) and p.is_floating_point() else p
