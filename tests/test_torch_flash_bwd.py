"""The plain versions of the attention kernels' gradient and softcap against
the JAX package, on the CPU.

* ``flash_attention_bwd_ref`` (the backward kernel's plain version, written
  out as formulas) against ``jax.vjp`` of the reference's
  ``kernels/ref.py::flash_attention_ref`` (causal, window, GQA), and of its
  ``models/attention.py::sdpa`` where that kernel takes no case (keys of
  another length, a softcap, v's head dim other than q's, v a strided
  view), at ``atol=1e-5, rtol=1e-4``; and against
  ``torch.autograd`` through the port's ``flash_attention_ref``;
* ``flash_attention_lse_ref`` against ``jax.nn.logsumexp`` of the same
  logits;
* the softcap in ``flash_attention_ref`` and ``decode_attention_ref``
  against the reference's ``sdpa`` with a softcap;
* ``ops.flash_attention`` on CPU tensors differentiates through its plain
  version, and ``ops.flash_attention_bwd`` on the CPU is the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-5, rtol=1e-4)

# B, S, H, KH, hd, causal, window, Sk, softcap, hd_v (None: hd), v_row (None:
# v contiguous; else v is the last hd_v of each head's row of v_row, as
# mla_forward passes MLA's v)
CASES = {
    "causal": (2, 40, 4, 4, 16, True, None, None, None, None, None),
    "window": (1, 50, 4, 4, 32, True, 12, None, None, None, None),
    "gqa": (2, 33, 8, 2, 16, True, None, None, None, None, None),
    "gqa_window_bidir": (1, 37, 6, 3, 16, False, 9, None, None, None, None),
    "bidirectional": (1, 24, 2, 1, 64, False, None, None, None, None, None),
    "cross": (2, 12, 4, 2, 16, False, None, 30, None, None, None),
    "softcap": (1, 30, 4, 2, 16, True, 10, None, 5.0, None, None),
    "split_dims": (2, 35, 4, 4, 48, True, None, None, None, 32, None),
    "split_dims_gqa": (1, 41, 6, 2, 48, True, None, None, None, 32, None),
    "split_dims_v_slice": (2, 29, 4, 4, 48, True, None, None, None, 32, 64),
}


def _inputs(B, S, H, KH, hd, Sk, seed=0, hd_v=None, v_row=None):
    """q, k, v, dout as float32 numpy arrays; with ``v_row`` v is a strided
    view, the tail of each head's row of that width."""
    rng = np.random.default_rng(seed)
    Sk, hd_v = Sk or S, hd_v or hd
    shapes = [(B, S, H, hd), (B, Sk, KH, hd), (B, Sk, KH, v_row or hd_v), (B, S, H, hd_v)]
    q, k, v, do = [(rng.standard_normal(s) * (2.0 if i == 0 else 1.0)).astype(np.float32)
                   for i, s in enumerate(shapes)]
    return q, k, v[..., v.shape[-1] - hd_v:], do


def _jax_attention(causal, window, softcap, split=False):
    """The reference's attention as one JAX function of (q, k, v): its
    kernels' ``flash_attention_ref`` where that takes the case, else its
    models' ``sdpa`` with the mask its ``attn_forward`` builds (a softcap,
    or v's head dim other than q's: the kernel's reference reshapes its
    output with q's)."""
    if softcap is None and not split:
        def f(q, k, v):
            if k.shape[1] == q.shape[1]:
                return jax_ref.flash_attention_ref(q, k, v, causal, window)
            B, S, H, hd = q.shape
            KH = k.shape[2]
            return jax_attn.sdpa(q.reshape(B, S, KH, H // KH, hd), k, v, None).reshape(q.shape)
        return f

    def f(q, k, v):
        B, S, H, hd = q.shape
        KH = k.shape[2]
        pos = jnp.arange(S)
        bias = jax_attn._mask_bias(pos, pos, window or 2**30, causal)[None, None, None]
        return jax_attn.sdpa(q.reshape(B, S, KH, H // KH, hd), k, v, bias,
                             softcap).reshape(B, S, H, v.shape[-1])
    return f


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp(case):
    """At split head dims (MLA's shape, smaller) too: dq and dk at hd, dv at
    hd_v, the scale 1/sqrt(hd); with v a strided view as MLA passes it."""
    B, S, H, KH, hd, causal, window, Sk, cap, hd_v, v_row = CASES[case]
    q, k, v, do = _inputs(B, S, H, KH, hd, Sk, 0, hd_v, v_row)
    jout, vjp = jax.vjp(_jax_attention(causal, window, cap, hd_v is not None), jnp.asarray(q),
                        jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    assert tv.is_contiguous() == (v_row is None)
    out = ref.flash_attention_ref(tq, tk, tv, causal, window, cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    lse = ref.flash_attention_lse_ref(tq, tk, causal, window, cap)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal, window, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_torch_autograd(case):
    B, S, H, KH, hd, causal, window, Sk, cap, hd_v, v_row = CASES[case]
    arrays = _inputs(B, S, H, KH, hd, Sk, 1, hd_v, v_row)
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in arrays[:3]]
    do = torch.from_numpy(arrays[3])
    out = ref.flash_attention_ref(*leaves, causal, window, cap)
    out.backward(do)
    q, k, v = (t.detach() for t in leaves)
    got = ref.flash_attention_bwd_ref(q, k, v, out.detach(),
                                      ref.flash_attention_lse_ref(q, k, causal, window, cap), do,
                                      causal, window, cap)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, **TOL)


@pytest.mark.parametrize("case", ["causal", "gqa_window_bidir", "cross", "softcap"])
def test_lse_ref_matches_jax_logsumexp(case):
    B, S, H, KH, hd, causal, window, Sk, cap, _, _ = CASES[case]
    q, k, _, _ = _inputs(B, S, H, KH, hd, Sk, 2)
    Sk = k.shape[1]
    logits = jnp.einsum("bqkgh,bskh->bkgqs", jnp.asarray(q).reshape(B, S, KH, H // KH, hd),
                        jnp.asarray(k)) / jnp.sqrt(jnp.float32(hd))
    if cap:
        logits = cap * jnp.tanh(logits / cap)
    i, j = jnp.arange(S)[:, None], jnp.arange(Sk)[None, :]
    ok = jnp.ones((S, Sk), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= i - j < window
    want = jax.nn.logsumexp(jnp.where(ok, logits, -jnp.inf), axis=-1).reshape(B, H, S)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal, window,
                                      cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cap", [5.0, 50.0])
def test_softcap_plain_versions_match_jax_sdpa(cap):
    """The reference's ``sdpa`` applies the softcap to the scaled logits
    before its additive mask; so do the kernels' plain versions, prefill
    (causal and window) and decode (per-row lengths)."""
    B, S, H, KH, hd, window = 2, 40, 4, 2, 16, 12
    q, k, v, _ = _inputs(B, S, H, KH, hd, None, 3)
    q = q * 4  # logits of ~+-10, where a cap of 5 bends them
    want = _jax_attention(True, window, cap)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), True, window, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lengths = np.array([17, 39], np.int32)
    bias = np.where((np.arange(S)[None] <= lengths[:, None])
                    & (lengths[:, None] - np.arange(S)[None] < window), 0.0, -2e38)
    want = jax_attn.sdpa(jnp.asarray(q[:, :1]).reshape(B, 1, KH, H // KH, hd), jnp.asarray(k),
                         jnp.asarray(v), jnp.asarray(bias, jnp.float32)[:, None, None, None],
                         cap).reshape(B, H, hd)
    got = ref.decode_attention_ref(torch.from_numpy(q[:, 0]), *map(torch.from_numpy, (k, v)),
                                   torch.from_numpy(lengths), window, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_on_cpu_take_the_plain_paths():
    """On CPU tensors ``ops.flash_attention`` differentiates through its
    plain version and launches nothing; ``ops.flash_attention_bwd`` is the
    plain backward."""
    B, S, H, KH, hd, causal, window, Sk, cap, _, _ = CASES["softcap"]
    q, k, v, do = map(torch.from_numpy, _inputs(B, S, H, KH, hd, Sk, 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, causal, window, cap)
    out.backward(do)
    assert not any(ops.LAUNCHES.values())
    lse = ref.flash_attention_lse_ref(q, k, causal, window, cap)
    got = ops.flash_attention_bwd(q, k, v, out.detach(), lse, do, causal, window, cap)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, **TOL)
    with pytest.raises(ValueError):  # a softcap must be positive
        ops._softcap_arg(-1.0)
