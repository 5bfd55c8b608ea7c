"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no interpret mode.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sched as T
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-4, rtol=1e-3)       # float32
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)  # bfloat16 inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _burst(R, F, W, seed):
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, R)
    funcs = rng.integers(0, F, R)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, R))
    idle = rng.integers(0, 3, (F, W))
    conns = rng.integers(0, 5, W)
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in (kinds, funcs, workers, idle, conns)]


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().long(), b.cpu().long())


@pytest.mark.parametrize("R,F,W", [(32, 4, 8), (100, 10, 16), (57, 3, 5), (128, 40, 130),
                                   (1, 1, 1), (4096, 40, 1600), (512, 4, 60000)])
def test_sched_kernels_match_plain(cuda, R, F, W):
    args = [a.to(cuda) for a in _burst(R, F, W, R + W)]
    ops.reset_launches()
    _same(ops.sched_events(*args), ref.sched_events_ref(*args))
    kinds, funcs, workers, idle, conns = args
    _same(ops.sched_step(funcs, idle, conns), ref.sched_step_ref(funcs, idle, conns))
    assert ops.LAUNCHES["sched_events"] == 1 and ops.LAUNCHES["sched_step"] == 1


def test_sched_kernel_checks_inputs(cuda):
    kinds, funcs, workers, idle, conns = (a.to(cuda) for a in _burst(8, 2, 4, 0))
    with pytest.raises(TypeError):
        ops.sched_events(kinds, funcs, workers, idle.long(), conns)
    with pytest.raises(ValueError):
        ops.sched_events(kinds, funcs, workers, idle, conns.cpu())
    with pytest.raises(ValueError):
        ops.sched_events(kinds, funcs, workers, idle.t(), conns[:2].contiguous())


def test_sched_many_fused_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    n, F, W = 3000, 40, 130
    kinds = rng.integers(0, 3, n)
    kinds[:700] = 0  # an arrival burst: its chunks take sched_step
    ev = torch.from_numpy(np.stack([kinds, rng.integers(0, F, n),
                                    np.where(kinds == 0, -1, rng.integers(0, W, n))], 1)
                          .astype(np.int32))
    want_s, (want_w, want_warm) = T.sched_many(T.init_state(F, W, "cpu"), ev)
    ops.reset_launches()
    s, (w, warm) = T.sched_many_fused(T.init_state(F, W), ev, chunk=256)
    _same((w, warm, s.idle, s.conns), (want_w, want_warm, want_s.idle, want_s.conns))
    assert ops.LAUNCHES["sched_step"] >= 2 and ops.LAUNCHES["sched_events"] >= 1


def _ssd_inputs(B, S, H, P, N, G=1, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)) * 0.3
    Cm = rng.standard_normal((B, S, G, N)) * 0.3
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 8, 16, 32, 64),
    (1, 128, 24, 64, 128, 64),
    (1, 64, 4, 16, 16, 64),
    (2, 192, 6, 16, 32, 64),
    (1, 1000, 24, 64, 128, 256),   # mamba2-130m, S padded to the chunk
    (2, 100, 4, 8, 8, 32),         # the tiny serving config's head dims
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N)
    xd, Bd, Cd = (t.to(cuda, dtype) for t in (x, Bm, Cm))
    y, st = ops.ssd_scan(xd, dt.to(cuda), A.to(cuda), Bd, Cd, chunk=chunk)
    torch.cuda.synchronize()
    yr, sr = ops.ssd_scan(x.to(dtype).float(), dt, A, Bm.to(dtype).float(),
                          Cm.to(dtype).float(), chunk=chunk)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    torch.testing.assert_close(y.float().cpu(), yr, **tol)
    torch.testing.assert_close(st.cpu(), sr, **tol)


def test_ssd_kernel_carries_init_state(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 256, 4, 16, 16)
    init = torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(0))
    y, st = ops.ssd_scan(*(t.to(cuda) for t in (x, dt, A, Bm, Cm)), chunk=64,
                         init_state=init.to(cuda))
    yr, sr = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64, init_state=init)
    torch.testing.assert_close(y.cpu(), yr, **TOL)
    torch.testing.assert_close(st.cpu(), sr, **TOL)


def test_ssd_kernel_raises_for_groups(cuda):
    args = [t.to(cuda) for t in _ssd_inputs(1, 64, 4, 8, 8, G=2)]
    with pytest.raises(ValueError):
        ops.ssd_scan(*args, chunk=32)
