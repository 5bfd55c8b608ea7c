"""The plain version of the SSD scan's backward kernel, and the autograd
Function around the scan, on the CPU.

* ``ref.ssd_scan_bwd_ref`` (the chunked decomposition the CUDA kernel
  ``csrc/ssd_scan_bwd.cu`` follows, written out as formulas) against
  ``jax.vjp`` of the reference's ``kernels/ref.py::ssd_scan_ref`` (its
  ``models/mamba.py::ssd_chunked``) and against ``torch.autograd`` through
  the port's ``ssd_chunked``: every gradient (dx, ddt, dA, dB, dC, d
  init_state) at ``atol=1e-4, rtol=1e-3``, the forward's float32 tolerance
  (the gradients sum over up to S positions in another order);
* ``ops._SsdScan`` on CPU tensors (its plain forward, ``ops.ssd_scan_bwd``'s
  plain backward) against ``torch.autograd`` through ``ssd_chunked``, with
  the padding ``ops.ssd_scan`` applies, a gradient of y alone (the final
  state's comes as None, as in training), of the final state alone, of
  both, and bfloat16 inputs (``atol=rtol=5e-2``, the forward's bfloat16
  tolerance).

Inputs are made with numpy from a seed and fed to both packages.  The CUDA
kernel's tests are in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch
import torch.nn.functional as F

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.models.mamba import ssd_chunked

TOL = dict(atol=1e-4, rtol=1e-3)       # float32
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)  # bfloat16 inputs
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init_state")

# B, S, H, P, N, G, chunk, init_state given, d_final_state nonzero
CASES = {
    "one_chunk": (1, 64, 4, 16, 16, 1, 64, False, False),
    "chunks": (2, 256, 8, 16, 32, 1, 64, False, True),
    "mamba_heads": (1, 128, 24, 64, 128, 1, 64, False, False),  # mamba2-130m's head dims
    "groups": (1, 128, 8, 16, 16, 2, 32, False, True),
    "init_state": (2, 192, 6, 16, 32, 1, 64, True, True),
    "groups_init": (1, 96, 6, 8, 16, 3, 32, True, True),
    "ragged": (1, 100, 4, 16, 16, 1, 32, True, True),             # padded to 128
    "ragged_groups": (2, 70, 4, 8, 8, 2, 32, False, True),        # padded to 96
}


def _inputs(B, S, H, P, N, G, init, dfin, seed=0):
    """x, dt, A, Bm, Cm, init_state (or None), dy, d_final_state (or None)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f32)
    h0 = rng.standard_normal((B, H, P, N)).astype(f32) if init else None
    dy = rng.standard_normal((B, S, H, P)).astype(f32)
    dfin = rng.standard_normal((B, H, P, N)).astype(f32) if dfin else None
    return x, dt, A, Bm, Cm, h0, dy, dfin


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _pad(t, pad):
    """Zeros after the last position, as ``ops.ssd_scan`` pads to the chunk."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t


def _ref_grads(case):
    """The plain backward on the padded inputs, cut back to S."""
    B, S, H, P, N, G, Q, init, dfin = CASES[case]
    x, dt, A, Bm, Cm, h0, dy, df = map(_t, _inputs(B, S, H, P, N, G, init, dfin))
    pad = (-S) % Q
    x, dt, Bm, Cm, dy = (_pad(t, pad) for t in (x, dt, Bm, Cm, dy))
    got = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, Q, h0, dy, df)
    return [g[:, :S] if i in (0, 1, 3, 4) else g for i, g in enumerate(got)]


def _shapes(case):
    B, S, H, P, N, G, _, _, _ = CASES[case]
    return [(B, S, H, P), (B, S, H), (H,), (B, S, G, N), (B, S, G, N), (B, H, P, N)]


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp(case):
    """Every gradient against ``jax.vjp`` of the reference's scan (padded and
    cut back as its ``mamba_forward`` does), the initial state always given
    to JAX (zeros where the port passes None) so that its gradient exists."""
    B, S, H, P, N, G, Q, init, dfin = CASES[case]
    x, dt, A, Bm, Cm, h0, dy, df = _inputs(B, S, H, P, N, G, init, dfin)
    pad = (-S) % Q

    def f(x, dt, A, Bm, Cm, h0):
        if pad:
            x, dt, Bm, Cm = (jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
                             for t in (x, dt, Bm, Cm))
        y, st = jax_ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, h0)
        return y[:, :S], st

    h0_j = h0 if h0 is not None else np.zeros((B, H, P, N), np.float32)
    (y, st), vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, Bm, Cm, h0_j)))
    want = vjp((jnp.asarray(dy), jnp.asarray(df) if df is not None else jnp.zeros_like(st)))
    got = _ref_grads(case)
    for name, g, w, shape in zip(NAMES, got, want, _shapes(case)):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_torch_autograd(case):
    """The same against ``torch.autograd`` through the port's ``ssd_chunked``."""
    B, S, H, P, N, G, Q, init, dfin = CASES[case]
    x, dt, A, Bm, Cm, h0, dy, df = map(_t, _inputs(B, S, H, P, N, G, init, dfin))
    pad = (-S) % Q
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm,
                                                    h0 if h0 is not None else
                                                    torch.zeros((B, H, P, N)))]
    xp, dtp, Bp, Cp = (_pad(t, pad) for t in (leaves[0], leaves[1], leaves[3], leaves[4]))
    y, st = ssd_chunked(xp, dtp, leaves[2], Bp, Cp, Q, leaves[5])
    loss = (y[:, :S] * dy).sum() + ((st * df).sum() if df is not None else 0.0)
    want = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(NAMES, _ref_grads(case), want):
        torch.testing.assert_close(g, w, **TOL, msg=name)


@pytest.mark.parametrize("wrt", ["y", "state", "both"])
@pytest.mark.parametrize("case", ["chunks", "groups_init", "ragged"])
def test_ssd_function_on_cpu_matches_autograd(case, wrt):
    """``ops._SsdScan`` on CPU tensors (its plain forward, then
    ``ops.ssd_scan_bwd``'s plain backward) against ``torch.autograd`` through
    ``ssd_chunked``: the padding as ``ops.ssd_scan`` applies it, and a
    gradient of y alone (the final state's comes as None), of the final
    state alone (y's comes as None), or of both."""
    B, S, H, P, N, G, Q, init, _ = CASES[case]
    x, dt, A, Bm, Cm, h0, dy, df = map(_t, _inputs(B, S, H, P, N, G, init, True, seed=1))
    pad = (-S) % Q
    grads = []
    for fn in (ops._SsdScan.apply, ssd_chunked):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        h = h0.clone().requires_grad_() if h0 is not None else None
        xp, dtp, Bp, Cp = (_pad(t, pad) for t in (leaves[0], leaves[1], leaves[3], leaves[4]))
        y, st = fn(xp, dtp, leaves[2], Bp, Cp, Q, h)
        loss = ((y[:, :S] * dy).sum() if wrt != "state" else 0.0) + \
            ((st * df).sum() if wrt != "y" else 0.0)
        wrt_leaves = leaves + ([h] if h is not None else [])
        got = torch.autograd.grad(loss, wrt_leaves, allow_unused=True)  # C: not in the state
        grads.append([torch.zeros_like(t) if g is None else g for g, t in zip(got, wrt_leaves)])
    for name, g, w in zip(NAMES, *grads):
        torch.testing.assert_close(g, w, **TOL, msg=name)


def test_ssd_function_casts_bf16_on_cpu():
    """bfloat16 x, B, C through ``ops._SsdScan`` on the CPU: gradients come
    back in the inputs' dtypes, within the bfloat16 tolerance of autograd
    through ``ssd_chunked`` on the same (rounded) inputs."""
    B, S, H, P, N, G, Q, _, _ = CASES["groups"]
    x, dt, A, Bm, Cm, _, dy, _ = map(_t, _inputs(B, S, H, P, N, G, False, False, seed=2))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    grads = []
    for fn in (ops._SsdScan.apply, ssd_chunked):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, _ = fn(*leaves, Q, None)
        grads.append(torch.autograd.grad((y.float() * dy).sum(), leaves))
    for name, g, w, t in zip(NAMES, *grads, (x, dt, A, Bm, Cm)):
        assert g.dtype == t.dtype, name
        torch.testing.assert_close(g.float(), w.float(), **TOL_BF16, msg=name)


def test_ssd_scan_bwd_wrapper_on_cpu_is_the_plain_version():
    """``ops.ssd_scan_bwd`` on CPU tensors is ``ref.ssd_scan_bwd_ref``, its
    results in the inputs' dtypes; a None gradient of y or of the final
    state counts as zero."""
    B, S, H, P, N, G, Q, _, _ = CASES["groups_init"]
    x, dt, A, Bm, Cm, h0, dy, df = map(_t, _inputs(B, S, H, P, N, G, True, True, seed=3))
    got = ops.ssd_scan_bwd(x, dt, A, Bm, Cm, Q, h0, dy, df)
    for g, w in zip(got, ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, Q, h0, dy, df)):
        assert torch.equal(g, w)
    zero = torch.zeros_like
    for a, b in ((None, df), (dy, None)):
        for g, w in zip(ops.ssd_scan_bwd(x, dt, A, Bm, Cm, Q, h0, a, b),
                        ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, Q, h0,
                                             zero(dy) if a is None else a,
                                             zero(df) if b is None else b)):
            assert torch.equal(g, w)
    assert all(g.abs().max() == 0 for g in ops.ssd_scan_bwd(x, dt, A, Bm, Cm, Q, h0, None, None))
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    dx, ddt, dA, dB, dC, d0 = ops.ssd_scan_bwd(xb, dt, A, Bb, Cb, Q, h0, dy.to(torch.bfloat16), df)
    assert (dx.dtype, dB.dtype, dC.dtype) == (torch.bfloat16,) * 3
    assert ddt.dtype == dA.dtype == d0.dtype == torch.float32


@pytest.mark.parametrize("case", ["chunks", "groups_init"])
def test_ssd_chunked_computes_float64_inputs_in_float64(case):
    """The port's ``ssd_chunked`` on float64 inputs computes and returns
    float64 (the train phase's gradient diagnostic on the card runs the
    plain scan so), within the float32 tolerance of the reference's scan."""
    B, S, H, P, N, G, Q, init, _ = CASES[case]
    x, dt, A, Bm, Cm, h0, _, _ = _inputs(B, S, H, P, N, G, init, False)
    y, st = ssd_chunked(*(torch.from_numpy(a).double() for a in (x, dt, A, Bm, Cm)), Q,
                        None if h0 is None else torch.from_numpy(h0).double())
    assert y.dtype == st.dtype == torch.float64
    want = jax_ref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q,
                                None if h0 is None else jnp.asarray(h0))
    for got, w in zip((y, st), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("S,chunk,seed", [
    *[pytest.param(256, 128, seed, id=str(seed)) for seed in range(4)],
    *[pytest.param(1000, 256, seed, id=f"1000-{seed}") for seed in range(4)],
])
def test_ssd_plain_grad_float32_within_tol_of_float64(S, chunk, seed):
    """At the data of the card's ``test_ssd_autograd_matches_plain_autograd
    [S-1-False-seed]`` (G=1, H=8, P=32, N=64; S=256 at chunk 128, or
    S=1000 padded to chunk 256; x, dt, A, B, C from numpy seed 9, dy and
    the final state's gradient from a torch generator seeded with ``seed``)
    the float32 plain scan's gradient lies within TOL of the same scan run
    in float64, every leaf (at S=256 dA, the worst, at most ~0.7 of TOL over
    these seeds), but dA at S=1000: there it is held to ``dA_limit``, the
    limit the card's test sets for the float32 plain route's dA.  Each head's
    dA sums S x P x N (~2 M) products of both signs: at seed 0 one head sums
    to 0.219 while the largest reaches 159.8, and float32 leaves that head
    7.9e-4 off, an error that scales with the terms summed, not with their
    cancelled sum.  The card's test holds the kernel's gradient, dA
    included, to the float64 gradient at TOL."""
    H, P, N = 8, 32, 64
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((1, S, H))))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((1, S, 1, N)) * 0.3
    Cm = rng.standard_normal((1, S, 1, N)) * 0.3
    base = [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(1, S, H, P, generator=g)
    dst = torch.randn(1, H, P, N, generator=g)
    grads = []
    pad = (-S) % chunk
    for dtype in (torch.float32, torch.float64):
        leaves = [t.to(dtype).clone().requires_grad_() for t in base]
        xp, dtp, Bp, Cp = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                           for t in (leaves[0], leaves[1], leaves[3], leaves[4]))
        y, st = ref.ssd_scan_ref(xp, dtp, leaves[2], Bp, Cp, chunk)
        y = y[:, :S]
        assert y.dtype == st.dtype == dtype
        ((y * dy.to(dtype)).sum() + (st * dst.to(dtype)).sum()).backward()
        grads.append([t.grad for t in leaves])
    for name, a, w in zip(NAMES, *grads):
        tol = dA_limit(w) if name == "dA" and S == 1000 else TOL
        torch.testing.assert_close(a.double(), w, **tol, msg=name)


def dA_limit(dA64):
    """The float32 plain route's dA against float64 (the card's
    ``test_ssd_autograd_matches_plain_autograd``): TOL, plus a norm-wise
    term of 1e-5 of the largest head's value, ~170 float32 ulps of it, for a
    sum of ~2 M signed terms."""
    return dict(atol=TOL["atol"] + 1e-5 * float(dA64.abs().max()), rtol=TOL["rtol"])
