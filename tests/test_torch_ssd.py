"""The port's SSD chunked scan: its plain version held against the JAX
package's ``repro.kernels.ref.ssd_scan_ref`` on shared numpy inputs, and
the wrapper's padding.  The CUDA kernel's tests are in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(atol=1e-4, rtol=1e-3)      # float32, as tests/test_kernels.py
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)  # bfloat16 inputs, as tests/test_kernels.py


def _inputs(B, S, H, P, N, G=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(args, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in args]


SHAPES = [  # (B, S, H, P, N, chunk): the sweep of tests/test_kernels.py
    (2, 256, 8, 16, 32, 64),
    (1, 128, 24, 64, 128, 64),   # mamba2-130m head dims
    (1, 64, 4, 16, 16, 64),      # single chunk
    (2, 192, 6, 16, 32, 64),
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_ssd_ref_matches_jax(B, S, H, P, N, chunk):
    args = _inputs(B, S, H, P, N, seed=S + H)
    yj, sj = jref.ssd_scan_ref(*[jnp.asarray(a) for a in args], chunk)
    y, st = ref.ssd_scan_ref(*_t(args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_ssd_ref_groups_match_jax():
    """ngroups > 1 through the wrapper on the CPU (the kernel's G=2 test is
    in test_torch_gpu.py)."""
    args = _inputs(1, 128, 8, 16, 16, G=2, seed=3)
    yj, sj = jref.ssd_scan_ref(*[jnp.asarray(a) for a in args], 32)
    y, st = ops.ssd_scan(*_t(args), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_ssd_state_carry_equals_two_halves():
    """Scanning S tokens == scanning S/2 then S/2 with the carried state."""
    B, S, H, P, N, chunk = 1, 128, 4, 16, 16, 32
    x, dt, A, Bm, Cm = _t(_inputs(B, S, H, P, N, seed=4))
    y_full, st_full = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    h = S // 2
    _, st1 = ref.ssd_scan_ref(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], chunk)
    y2, st2 = ops.ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], chunk, init_state=st1)
    np.testing.assert_allclose(y_full[:, h:].numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(st_full.numpy(), st2.numpy(), **TOL)


@pytest.mark.parametrize("S", [100, 64, 1])
def test_ops_pads_to_the_chunk_on_cpu(S):
    """S not a multiple of the chunk: zero padding (dt = 0 leaves the state
    untouched) gives the JAX wrapper's result, cut back to S."""
    args = _inputs(2, S, 4, 8, 8, seed=S)
    ops.reset_launches()
    y, st = ops.ssd_scan(*_t(args), chunk=32)
    assert y.shape == (2, S, 4, 8) and ops.LAUNCHES["ssd_scan"] == 0
    pad = (-S) % 32
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)) if a.ndim > 1 else a
              for a in args]
    yj, sj = jref.ssd_scan_ref(*[jnp.asarray(a) for a in padded], 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj)[:, :S], **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
