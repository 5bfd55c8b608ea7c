"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the dense model through both attention kernels against the CPU.

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
from test_torch_sched_cases import burst, sched_case
from test_torch_tf32x3 import _flash_bwd_float64

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-4, rtol=1e-3)       # float32
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)  # bfloat16 inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().long(), b.cpu().long())


@pytest.mark.parametrize("R,F,W,case", [
    pytest.param(*shape, "random", id="-".join(map(str, shape)))
    for shape in [(32, 4, 8), (100, 10, 16), (57, 3, 5), (128, 40, 130), (1, 1, 1),
                  (4096, 40, 1600), (512, 4, 60000)]
] + [
    (1024, 40, 1600, "random"),    # the main path's burst, on-chip state
    (1, 40, 1600, "random"),       # R = 1
    (33, 40, 1600, "random"),      # R not a multiple of the 32-event tile
    (300, 40, 1601, "random"),     # W not a multiple of 32
    (300, 7, 33, "random"),
    (300, 5, 31, "random"),        # W < 32
    (300, 5, 128, "random"),       # one 128-worker row of four-worker groups
    (300, 5, 129, "random"),       # and one worker more
    (300, 8, 513, "random"),       # W rounded up to the next instantiation (CHUNK 32)
    (300, 8, 1700, "random"),      # and to the widest (CHUNK 64)
    (300, 4, 2048, "random"),      # the widest on-chip state
    (300, 4, 2049, "random"),      # the narrowest large one, by width
    (100, 116, 1600, "random"),    # the most functions that fit on chip at W=1600
    (300, 120, 1600, "random"),    # too many functions for shared memory: large path
    (200, 3, 40, "sat300"),
    (200, 3, 40, "sat70000"),
    (1024, 40, 1600, "empty"),
    (1024, 40, 1600, "ties"),
    (1024, 40, 1600, "pad"),
    (1024, 40, 1600, "bigconns"),  # the block-wide path inside the on-chip kernel
    (512, 4, 60000, "empty"),
    (512, 4, 60000, "ties"),
])
def test_sched_kernels_match_plain(cuda, R, F, W, case):
    args = [a.to(cuda) for a in sched_case(case, R, F, W, R + W)]
    ops.reset_launches()
    _same(ops.sched_events(*args), ref.sched_events_ref(*args))
    kinds, funcs, workers, idle, conns = args
    _same(ops.sched_step(funcs, idle, conns), ref.sched_step_ref(funcs, idle, conns))
    assert ops.LAUNCHES["sched_events"] == 1 and ops.LAUNCHES["sched_step"] == 1


@pytest.mark.parametrize("W", [1600, 60000])
def test_sched_kernels_take_strided_columns(cuda, W):
    """The three columns of one (R, 3) event tensor, as strided views, give
    what contiguous copies give; columns of unequal stride raise."""
    kinds, funcs, workers, idle, conns = (a.to(cuda) for a in burst(700, 40, W, 3))
    ev = torch.stack([kinds, funcs, workers], 1)
    assert ev[:, 1].stride(0) == 3
    _same(ops.sched_events(ev[:, 0], ev[:, 1], ev[:, 2], idle, conns),
          ops.sched_events(kinds, funcs, workers, idle, conns))
    _same(ops.sched_step(ev[:, 1], idle, conns), ops.sched_step(funcs, idle, conns))
    with pytest.raises(ValueError):
        ops.sched_events(ev[:, 0], funcs, ev[:, 2], idle, conns)


def test_sched_kernel_checks_inputs(cuda):
    kinds, funcs, workers, idle, conns = (a.to(cuda) for a in burst(8, 2, 4, 0))
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
    (2, 100, 4, 8, 8, 32),         # the tiny serving config's head dims
    (1, 256, 24, 64, 128, 256),    # mamba2-130m width: one chunk
    (1, 512, 24, 64, 128, 256),    # two: the state entering chunk 1 is chunk 0's
    (1, 1024, 24, 64, 128, 256),   # four: the main path's prefill
    (2, 1024, 24, 64, 128, 256),
    (1, 1000, 24, 64, 128, 256),   # ragged: padded rows leave the state alone
    (1, 1024, 80, 64, 64, 256),    # zamba2-2.7b width (80 heads, N=64): the hybrid prefill
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,N,chunk", [(256, 4, 16, 16, 64), (512, 24, 64, 128, 256)])
def test_ssd_kernel_carries_init_state(cuda, S, H, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(1, S, H, P, N)
    init = torch.randn(1, H, P, N, generator=torch.Generator().manual_seed(0))
    xd, Bd, Cd = (t.to(cuda, dtype) for t in (x, Bm, Cm))
    y, st = ops.ssd_scan(xd, dt.to(cuda), A.to(cuda), Bd, Cd, chunk=chunk, init_state=init.to(cuda))
    yr, sr = ops.ssd_scan(x.to(dtype).float(), dt, A, Bm.to(dtype).float(), Cm.to(dtype).float(),
                          chunk=chunk, init_state=init)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(y.float().cpu(), yr, **tol)
    torch.testing.assert_close(st.cpu(), sr, **tol)


def test_ssd_kernel_groups(cuda):
    """ngroups G=2 at mamba2-130m head dims: heads 0-11 read group 0, 12-23
    group 1."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 24, 64, 128, G=2, seed=3)
    ops.reset_launches()
    y, st = ops.ssd_scan(*(t.to(cuda) for t in (x, dt, A, Bm, Cm)), chunk=256)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, 256)
    torch.testing.assert_close(y.cpu(), yr, **TOL)
    torch.testing.assert_close(st.cpu(), sr, **TOL)
    with pytest.raises(ValueError):  # 24 heads do not split into 5 groups
        ops.ssd_scan(*(t.to(cuda) for t in _ssd_inputs(1, 64, 24, 8, 8, G=5)), chunk=32)


# ------------------------------------------------------------------ attention
TOL_ATTN = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _attn_inputs(shapes, dtype, seed, cuda):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,causal,window", [
    (1, 128, 4, 4, 64, True, None),     # the shapes of tests/test_kernels.py
    (2, 256, 8, 2, 64, True, None),
    (1, 256, 4, 1, 128, True, 64),
    (2, 128, 4, 4, 32, False, None),
    (1, 1000, 4, 2, 64, True, None),    # ragged S: no tile divides it
    (1, 1000, 8, 4, 256, True, 300),    # gemma3-4b heads, window, ragged
    (2, 200, 4, 4, 80, True, None),
    (1, 130, 2, 1, 16, False, 40),      # bidirectional window
    (1, 1024, 36, 36, 64, True, None),  # minicpm-2b prefill width
    (1, 2048, 8, 4, 256, True, 1024),   # gemma3-4b width, window 1024 at S=2048
    (1, 2048, 8, 4, 256, True, None),
    (1, 1024, 32, 32, 80, True, None),  # zamba2-2.7b shared block prefill, hd 80
    (1, 512, 48, 8, 128, True, 4096),   # mixtral-8x22b prefill: GQA 6:1, window 4096 > S
])
def test_flash_kernel_matches_plain(cuda, B, S, H, KH, hd, causal, window, dtype):
    q, k, v = _attn_inputs([(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], dtype, S + hd, cuda)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", ops.ATTN_HEAD_DIMS)
@pytest.mark.parametrize("S,KH,causal,window", [
    (130, 2, True, None),    # ragged, one partial q tile after two full ones
    (1000, 1, True, 96),     # ragged, GQA 4:1, window
    (257, 4, False, None),   # bidirectional
])
def test_flash_kernel_every_head_dim(cuda, hd, S, KH, causal, window, dtype):
    H = 4
    q, k, v = _attn_inputs([(1, S, H, hd), (1, S, KH, hd), (1, S, KH, hd)], dtype, S + hd, cuda)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])


def test_flash_kernel_rejects_misaligned_views(cuda):
    """The kernel copies 16 bytes at a time: a view one element into its
    storage must raise, not read across the boundary."""
    q, k, v = _attn_inputs([(1, 64, 2, 64)] * 3, torch.float32, 0, cuda)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError):
        ops.flash_attention(shifted, k, v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, shifted)


def test_each_wrapper_call_counts_one_launch(cuda):
    """ssd_scan (three CUDA launches) adds exactly 1 per wrapper call, as do
    the single-launch kernels (decode_attention among them)."""
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(1, 512, 4, 16, 16))
    q, k, v = _attn_inputs([(1, 64, 2, 32)] * 3, torch.float32, 1, cuda)
    args = [a.to(cuda) for a in burst(16, 2, 4, 0)]
    calls = {
        "ssd_scan": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128),
        "flash_attention": lambda: ops.flash_attention(q, k, v),
        "flash_attention_bwd": lambda: ops.flash_attention_bwd(
            q, k, v, q, torch.zeros((1, 2, 64), device=cuda), v),
        "decode_attention": lambda: ops.decode_attention(q[:, 0], k, v, 40),
        "decode_attention_latent": lambda: ops.decode_attention_latent(
            *_latent_inputs(1, 64, 16, torch.float32, torch.float32, 2, cuda), 40, 0.1),
        "sched_events": lambda: ops.sched_events(*args),
        "sched_step": lambda: ops.sched_step(*args[1:2], *args[3:]),
    }
    _, _, saved = ops._ssd_forward(x, dt, A, Bm, Cm, 128, None, keep=True)
    calls["ssd_scan_bwd"] = lambda: ops.ssd_scan_bwd(x, dt, A, Bm, Cm, 128, None, x, None, saved)
    for name, call in calls.items():
        for n in (1, 2, 3):
            ops.reset_launches()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            assert ops.LAUNCHES == {**{kn: 0 for kn in ops.LAUNCHES}, name: n}
    # under autograd: one ssd_scan, and after backward() one ssd_scan_bwd
    xg = x.clone().requires_grad_()
    ops.reset_launches()
    y, _ = ops.ssd_scan(xg, dt, A, Bm, Cm, chunk=128)
    assert ops.LAUNCHES == {**{kn: 0 for kn in ops.LAUNCHES}, "ssd_scan": 1}
    y.sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**{kn: 0 for kn in ops.LAUNCHES}, "ssd_scan": 1, "ssd_scan_bwd": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,valid,window", [
    (2, 512, 8, 2, 64, 511, None),      # the shapes of tests/test_kernels.py
    (1, 256, 4, 4, 128, 100, None),
    (2, 512, 16, 2, 64, 300, 128),
    (1, 128, 8, 1, 64, 0, None),
    (1, 2048, 36, 36, 64, 1031, None),  # minicpm-2b width, mid-block
    (1, 2048, 8, 4, 256, 2047, 1024),   # gemma3-4b width, last position, window
    (1, 2048, 8, 4, 256, 0, 1024),
    (2, 300, 4, 2, 80, 150, None),
    (1, 64, 4, 2, 128, 63, 1),          # a window of one position
    (1, 2048, 36, 36, 64, 1119, None),  # minicpm-2b: 14 shares of 80 rows, each full
    (1, 2048, 36, 36, 64, 1120, None),  # and one row past the last boundary
    (1, 256, 4, 4, 64, 255, None),      # valid_len at S-1
    (1, 256, 4, 2, 64, 300, None),      # past S-1: every row live
    (1, 256, 8, 4, 256, 400, 200),      # past S-1 with a window
    (1, 2048, 32, 32, 80, 1031, None),  # zamba2-2.7b width, hd 80, float32 cache 2048
    (1, 2048, 32, 32, 80, 2047, None),
])
def test_decode_kernel_matches_plain(cuda, B, S, H, KH, hd, valid, window, dtype):
    q, kc, vc = _attn_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], dtype, S + valid, cuda)
    ops.reset_launches()
    out = ops.decode_attention(q, kc, vc, valid, window=window)
    want = ref.decode_attention_ref(q, kc, vc, valid, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    assert out.dtype == dtype and out.shape == (B, H, hd)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])


def test_decode_kernel_never_reads_past_valid_len(cuda):
    """NaN in every cache row past valid_len (and before the window) must
    not reach the output."""
    q, kc, vc = _attn_inputs([(1, 8, 64), (1, 512, 4, 64), (1, 512, 4, 64)], torch.float32, 3, cuda)
    want = ref.decode_attention_ref(q, kc, vc, 300, window=100)
    for t in (kc, vc):
        t[:, 301:] = float("nan")
        t[:, :201] = float("nan")
    out = ops.decode_attention(q, kc, vc, 300, window=100)
    torch.testing.assert_close(out, want, **TOL_ATTN[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,valid,window", [
    (1, 2048, 36, 36, 64, 1024, None),  # minicpm-2b width
    (1, 2048, 8, 4, 256, 2047, 1024),   # gemma3-4b width
    (2, 300, 64, 2, 128, 299, None),    # G=32
    (1, 130, 4, 2, 16, 500, 400),       # past S-1 with a window
])
def test_decode_kernel_takes_tensor_valid_len(cuda, B, S, H, KH, hd, valid, window, dtype):
    """A 0-d tensor valid_len (int32 or int64) on the card gives what the int
    gives, and the plain version."""
    q, kc, vc = _attn_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], dtype, S + hd, cuda)
    want = ref.decode_attention_ref(q, kc, vc, valid, window=window)
    by_int = ops.decode_attention(q, kc, vc, valid, window=window)
    for t in (torch.tensor(valid, dtype=torch.int32, device=cuda),
              torch.tensor(valid, dtype=torch.int64, device=cuda)):
        ops.reset_launches()
        out = ops.decode_attention(q, kc, vc, t, window=window)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == 1
        torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])
        torch.testing.assert_close(out, by_int, atol=0, rtol=0)


@pytest.mark.parametrize("B,S,H,KH,hd,window", [
    (1, 2048, 36, 36, 64, None),
    (1, 2048, 8, 4, 256, 1024),
])
def test_decode_kernel_graph_replays_new_valid_len(cuda, B, S, H, KH, hd, window):
    """One call captured in a CUDA graph with a tensor valid_len, replayed
    after setting the tensor to three other values: each output matches the
    plain version at that value."""
    q, kc, vc = _attn_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], torch.float32, 5, cuda)
    valid = torch.tensor(100, dtype=torch.int32, device=cuda)
    ops.decode_attention(q, kc, vc, valid, window)  # first call outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, kc, vc, valid, window)
    for v in (7, S - 1, 1500):
        valid.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.decode_attention_ref(q, kc, vc, v, window),
                                   **TOL_ATTN[torch.float32])


def test_decode_kernel_repeat_calls_agree(cuda):
    """The last CTA of each unit resets its ticket: a second and a third
    call give what the first gave, and leave the tickets at zero."""
    q, kc, vc = _attn_inputs([(1, 8, 256), (1, 2048, 4, 256), (1, 2048, 4, 256)], torch.float32, 6, cuda)
    first = ops.decode_attention(q, kc, vc, 1500, 1024)
    for _ in range(2):
        torch.testing.assert_close(ops.decode_attention(q, kc, vc, 1500, 1024), first, atol=0, rtol=0)
    torch.cuda.synchronize()
    assert not ops._tickets[q.device].any()
    torch.testing.assert_close(first, ref.decode_attention_ref(q, kc, vc, 1500, 1024),
                               **TOL_ATTN[torch.float32])


@pytest.mark.parametrize("valid,window", [(-1, None), (-5, 3), (300, 40)])
def test_decode_kernel_no_live_position_gives_zeros(cuda, valid, window):
    """With a tensor valid_len and no live position the kernel writes zeros,
    as the Pallas kernel does (l = 0); the cache is never read (NaN)."""
    q, kc, vc = _attn_inputs([(1, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)], torch.float32, 7, cuda)
    kc.fill_(float("nan"))
    vc.fill_(float("nan"))
    out = ops.decode_attention(q, kc, vc, torch.tensor(valid, device=cuda), window)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_attention_kernels_check_inputs(cuda):
    q, kc, vc = _attn_inputs([(2, 4, 64), (2, 32, 2, 64), (2, 32, 2, 64)], torch.float32, 0, cuda)
    lengths = torch.tensor([3, 5], device=cuda)  # per-row lengths are taken (ROADMAP Queue 1 item 6)
    torch.testing.assert_close(ops.decode_attention(q, kc, vc, lengths),
                               ref.decode_attention_ref(q, kc, vc, lengths),
                               **TOL_ATTN[torch.float32])
    with pytest.raises(ValueError):  # neither 0-d nor (B,)
        ops.decode_attention(q, kc, vc, torch.tensor([3, 5, 7], device=cuda))
    with pytest.raises(TypeError):
        ops.decode_attention(q, kc, vc, torch.tensor(3.0, device=cuda))
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, vc, torch.tensor(3))  # on the CPU
    q96, k96, v96 = _attn_inputs([(2, 4, 96), (2, 32, 2, 96), (2, 32, 2, 96)], torch.float32, 0, cuda)
    with pytest.raises(ValueError):
        ops.decode_attention(q96, k96, v96, 3)
    with pytest.raises(ValueError):
        ops.flash_attention(q96[:, None], k96[:, :1].contiguous(), v96[:, :1].contiguous())
    with pytest.raises(TypeError):
        ops.decode_attention(q.double(), kc.double(), vc.double(), 3)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, vc.transpose(1, 2), 3)
    with pytest.raises(ValueError):  # no live position
        ops.decode_attention(q, kc, vc, 40, window=4)
    shifted = torch.empty(kc.numel() + 1, device=cuda)[1:].view(kc.shape)
    with pytest.raises(ValueError):  # the kernel loads 16 bytes at a time
        ops.decode_attention(q, shifted, vc, 3)


def test_dense_model_on_card_matches_cpu(cuda):
    """Reduced gemma3-4b (GQA, qk-norm, window 16, a global layer) on the
    card through both kernels, against the same model on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("gemma3_4b").reduced(), n_layers=6)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    params_card = {k: _tree_to(v, cuda) for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    ops.reset_launches()
    cache_c, logits_c = card.prefill(params_card, {"tokens": tokens.to(cuda)})
    cache, logits = cpu.prefill(params, {"tokens": tokens})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(logits_c.cpu(), logits, **TOL)
    kv_c, kv = card.init_cache(2, 48, torch.float32), cpu.init_cache(2, 48, torch.float32)
    for a, b, src in zip(kv_c["stack"], kv["stack"], cache["stack"]):
        a[:, :, :40] = src.to(cuda)
        b[:, :, :40] = src
    tok = tokens[:, -1:]
    for step in range(3):
        lc, kv_c = card.decode_step(params_card, tok.to(cuda), kv_c, 40 + step)
        lp, kv = cpu.decode_step(params, tok, kv, 40 + step)
        torch.testing.assert_close(lc.cpu(), lp, **TOL)
        tok = lp.argmax(-1, keepdim=True).to(torch.int32)
    assert ops.LAUNCHES["decode_attention"] == 3 * cfg.n_layers
    # a per-row (B,) cache_index (ROADMAP Queue 1 item 6) goes through the kernel too
    idx = torch.tensor([43, 41], dtype=torch.int32)
    lc, kv_c = card.decode_step(params_card, tok.to(cuda), kv_c, idx.to(cuda))
    lp, kv = cpu.decode_step(params, tok, kv, idx)
    torch.testing.assert_close(lc.cpu(), lp, **TOL)
    for a, b in zip(kv_c["stack"], kv["stack"]):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    assert ops.LAUNCHES["decode_attention"] == 4 * cfg.n_layers
    # a logit softcap goes through both kernels too
    capped = dataclasses.replace(cfg, attn_logit_softcap=50.0)
    ops.reset_launches()
    _, lc = Model(capped, device=cuda).prefill(params_card, {"tokens": tokens.to(cuda)})
    _, lp = Model(capped, device="cpu").prefill(params, {"tokens": tokens})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(lc.cpu(), lp, **TOL)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------ per-row lengths, cache dtypes, graphs
CACHE_DTYPES = [torch.float32, torch.bfloat16, torch.float8_e4m3fn]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
@pytest.mark.parametrize("B,S,H,KH,hd,window,lengths", [
    (4, 512, 8, 2, 64, None, [511, 0, 300, -1]),          # -1: no live position
    (8, 1024, 32, 8, 128, None, [15, 511, 1023, 700, 64, 1, 333, 1500]),  # llava width
    (8, 1024, 48, 8, 128, 4096, [15, 511, 1023, 700, 64, 1, 333, 0]),  # mixtral-8x22b width
    (3, 2048, 36, 36, 64, None, [1024, 2047, 7]),        # minicpm-2b width
    (2, 2048, 8, 4, 256, 1024, [2047, 100]),             # gemma3-4b width, window
    (3, 300, 4, 2, 80, 40, [150, 10, 299]),
    (2, 128, 64, 2, 16, None, [127, 50]),                # G=32, hd=16
    (5, 64, 4, 4, 32, 3, [63, 0, 2, 40, -4]),
])
def test_decode_kernel_per_row_and_cache_dtypes(cuda, B, S, H, KH, hd, window, lengths,
                                                 cache_dtype, q_dtype):
    """(B,) int32 lengths x cache dtype x q dtype against the plain version
    (which upcasts a cache of another dtype to float32 as the kernel does):
    to q's dtype's tolerance; a row with no live position is zeros."""
    q, kc, vc = _attn_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], torch.float32,
                             B + S + hd, cuda)
    q, kc, vc = q.to(q_dtype), kc.to(cache_dtype), vc.to(cache_dtype)
    valid = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    ops.reset_launches()
    out = ops.decode_attention(q, kc, vc, valid, window)
    want = ref.decode_attention_ref(q, kc, vc, valid, window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    assert out.dtype == q_dtype and out.shape == (B, H, hd)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[q_dtype])
    for b, n in enumerate(lengths):
        lo = max(0, n - window + 1) if window else 0
        if min(n, S - 1) < lo:
            assert not out[b].any()


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_decode_kernel_per_row_graph_replays(cuda, cache_dtype):
    """One call with (B,) lengths captured in a CUDA graph and replayed with
    new lengths in the same tensor; the rows past each length are NaN and
    must not be read."""
    B, S, H, KH, hd = 8, 1024, 32, 8, 128
    q, kc, vc = _attn_inputs([(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], torch.float32, 21, cuda)
    q, kc, vc = q.to(torch.bfloat16), kc.to(cache_dtype), vc.to(cache_dtype)
    valid = torch.zeros(B, dtype=torch.int32, device=cuda)
    ops.decode_attention(q, kc, vc, valid)  # the first call outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, kc, vc, valid)
    rng = np.random.default_rng(0)
    k0, v0 = kc.clone(), vc.clone()
    for _ in range(3):
        lengths = rng.integers(0, 900, B)
        want = ref.decode_attention_ref(q, k0, v0, torch.from_numpy(lengths).to(cuda))
        kc.copy_(k0)
        vc.copy_(v0)
        for b, n in enumerate(lengths):
            kc[b, n + 1:] = float("nan")
            vc[b, n + 1:] = float("nan")
        valid.copy_(torch.from_numpy(lengths))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[torch.bfloat16])


def test_decode_graph_survives_a_larger_shape(cuda):
    """A graph captured at a small shape keeps its ticket buffer when a
    larger shape later makes the wrapper allocate a larger one (the old one
    is held, not freed and reused): replays after that, with the freed
    memory churned, still give the plain version's output."""
    q, kc, vc = _attn_inputs([(2, 8, 64), (2, 512, 4, 64), (2, 512, 4, 64)], torch.float32, 22, cuda)
    valid = torch.tensor(100, dtype=torch.int32, device=cuda)
    ops.decode_attention(q, kc, vc, valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, kc, vc, valid)
    old = ops._tickets[q.device]
    big_b = old.numel() // 32 + 1  # KH=32, one head group: units = B * 32 > the old buffer
    q2, k2, v2 = _attn_inputs([(big_b, 32, 64), (big_b, 32, 32, 64), (big_b, 32, 32, 64)],
                              torch.float32, 23, cuda)
    torch.testing.assert_close(ops.decode_attention(q2, k2, v2, 20),
                               ref.decode_attention_ref(q2, k2, v2, 20), **TOL_ATTN[torch.float32])
    assert ops._tickets[q.device] is not old and any(t is old for t in ops._held_tickets)
    del q2, k2, v2
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), 7, dtype=torch.int32, device=cuda) for _ in range(8)]
    for n in (511, 3, 300):
        valid.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref.decode_attention_ref(q, kc, vc, n),
                                   **TOL_ATTN[torch.float32])
    assert not old.any() and all(int(j[0]) == 7 for j in junk)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn])
def test_flash_kernel_mixed_dtypes(cuda, kv_dtype):
    """q in float32 with k and v in another dtype: the wrapper casts to
    float32, launches the float32 kernel once, returns float32."""
    q, k, v = _attn_inputs([(1, 1000, 8, 64), (1, 1000, 4, 64), (1, 1000, 4, 64)], torch.float32,
                           24, cuda)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, True, 300)
    want = ref.flash_attention_ref(q, k.float(), v.float(), True, 300)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1 and out.dtype == torch.float32
    torch.testing.assert_close(out, want, **TOL_ATTN[torch.float32])


def test_ssd_kernel_mixed_dtypes(cuda):
    """x in bfloat16, dt in bfloat16, B and C in float32: cast to float32,
    one launch; y in bfloat16, the state in float32."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 24, 64, 128, seed=4)
    xd, dtd = x.to(cuda, torch.bfloat16), dt.to(cuda, torch.bfloat16)
    ops.reset_launches()
    y, st = ops.ssd_scan(xd, dtd, A.to(cuda), Bm.to(cuda), Cm.to(cuda), chunk=256)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1 and y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yr, sr = ref.ssd_scan_ref(xd.float().cpu(), dtd.float().cpu(), A, Bm, Cm, 256)
    torch.testing.assert_close(y.float().cpu(), yr, **TOL_BF16)
    torch.testing.assert_close(st.cpu(), sr, **TOL)


def _tiny_endpoint(name):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import Endpoint

    cfg = get_config(name).reduced()
    if name == "mamba2_130m":
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=32, vocab=64,
                                  ssm=dataclasses.replace(cfg.ssm, d_state=8, headdim=8))
    return Endpoint(name, cfg, seed=3, max_cache_len=64)


def _eager_generate(inst, tokens, gen_len):
    """``Instance.generate``'s loop, run eagerly on the card."""
    model, ep = inst.model, inst.endpoint
    cache = inst.decode_cache(tokens.shape[0])
    _, lg = model.prefill(inst.params, inst.prefill_batch(tokens))
    out = [lg.argmax(-1)]
    idx = min(tokens.shape[1], ep.max_cache_len - gen_len - 1)
    for i in range(gen_len - 1):
        lg, cache = model.decode_step(inst.params, out[-1][:, None], cache, idx + i)
        out.append(lg.argmax(-1))
    return torch.stack(out, 1)


@pytest.mark.parametrize("name", ["mamba2_130m", "minicpm_2b", "zamba2_2p7b", "mixtral_8x22b",
                                  "whisper_small"])
def test_generate_replays_the_captured_step(cuda, name):
    """``Instance.generate`` on the card replays one captured decode step a
    token: its tokens equal the eager loop's, twice over (the static cache
    is zeroed between requests), for two batch sizes; each replay counts
    the step's launches."""
    from repro_torch.serving import Instance, captured

    inst = Instance(_tiny_endpoint(name), device=cuda)
    rng = np.random.default_rng(1)
    for B, S, gen_len in ((1, 20, 6), (2, 9, 4), (1, 40, 5)):
        tokens = torch.from_numpy(rng.integers(0, inst.model.cfg.vocab, (B, S)).astype(np.int32))
        tokens = tokens.to(cuda)
        want = _eager_generate(inst, tokens, gen_len)
        inst.prepare(B)  # cold start's capture: one eager step, then the graph
        ops.reset_launches()
        captured.reset_replays()
        got = inst.generate(tokens, gen_len)
        assert torch.equal(got, want)
        assert captured.REPLAYED["steps"] == gen_len - 1
        per_step = inst.model.decode_attention_calls()
        assert captured.REPLAYED["decode_attention"] == per_step * (gen_len - 1)
        assert ops.LAUNCHES["decode_attention"] == 0
    assert sorted(inst._loops) == [1, 2]


def test_batcher_on_card_matches_cpu(cuda):
    """Reduced llava-next-mistral-7b (float32 weights and cache): the
    batcher on the card, one graph replay a step, gives the CPU batcher's
    tokens for the same requests, and its last logits agree to 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, GenRequest, captured

    cfg = dataclasses.replace(get_config("llava_next_mistral_7b").reduced(), n_layers=2)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(5))
    card = Model(cfg, device=cuda)
    params_card = {k: _tree_to(v, cuda) for k, v in params.items()}
    rng = np.random.default_rng(2)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, cfg.vocab, rng.integers(1, 12))],
             int(rng.integers(1, 9))) for i in range(7)]
    outs, logits = [], []
    for model, p in ((cpu, params), (card, params_card)):
        b = ContinuousBatcher(model, p, n_slots=3, max_len=24)
        for rid, prompt, n in reqs:
            b.submit(GenRequest(rid, prompt, max_new_tokens=n))
        captured.reset_replays()
        ops.reset_launches()
        outs.append(b.run_to_completion())
        logits.append(b.logits.float().cpu())
        if model is card:
            assert captured.REPLAYED["steps"] == b.steps
            assert captured.REPLAYED["decode_attention"] == cfg.n_layers * b.steps
            assert ops.LAUNCHES["decode_attention"] == 0
    assert outs[0] == outs[1]
    torch.testing.assert_close(logits[1], logits[0], **TOL)


# ------------------------------------------------------- hybrid and MoE families
def _family_cfg(name):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name.removesuffix("-dense-first")).reduced()
    if name.endswith("-dense-first"):  # one leading dense layer of width 128
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_dense_layers=1,
                                                               dense_dff=128))
    return cfg


@pytest.mark.parametrize("name", ["zamba2_2p7b", "mixtral_8x22b", "mixtral_8x22b-dense-first"])
def test_hybrid_and_moe_models_on_card_match_cpu(cuda, name):
    """Reduced zamba2-2.7b (two groups of three Mamba layers, both shared
    blocks) and reduced mixtral-8x22b (window 16, and with a leading dense
    layer) on the card through the kernels, against the same model on the
    CPU: prefill logits and aux, then three decode steps from a zero cache,
    the last with per-row positions."""
    from repro_torch.models import Model

    cfg = _family_cfg(name)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
                              .astype(np.int32))
    ops.reset_launches()
    logits_c, aux_c, _ = card.forward(params_card, {"tokens": tokens.to(cuda)}, mode="prefill")
    logits, aux, _ = cpu.forward(params, {"tokens": tokens}, mode="prefill")
    assert ops.LAUNCHES["flash_attention"] == card.decode_attention_calls()  # one a layer
    assert ops.LAUNCHES["ssd_scan"] == (cfg.n_layers if cfg.family == "hybrid" else 0)
    torch.testing.assert_close(logits_c.cpu(), logits, **TOL)
    torch.testing.assert_close(aux_c.cpu(), aux, **TOL)
    kv_c, kv = card.init_cache(2, 48, torch.float32), cpu.init_cache(2, 48, torch.float32)
    tok = tokens[:, -1:]
    for idx in (40, 41, torch.tensor([44, 7], dtype=torch.int32)):
        lc, kv_c = card.decode_step(params_card, tok.to(cuda), kv_c,
                                    idx.to(cuda) if isinstance(idx, torch.Tensor) else idx)
        lp, kv = cpu.decode_step(params, tok, kv, idx)
        torch.testing.assert_close(lc.cpu(), lp, **TOL)
        tok = lp.argmax(-1, keepdim=True).to(torch.int32)
    assert ops.LAUNCHES["decode_attention"] == 3 * card.decode_attention_calls()


def test_moe_decode_step_makes_no_host_sync(cuda):
    """Reduced mixtral-8x22b in bfloat16 with a bfloat16 cache: a decode step
    with (B,) per-row positions runs under ``set_sync_debug_mode("error")``
    (the routing's sort, the per-expert counts and the scatter-adds read
    nothing back to the host), and one replay of it captured in a CUDA graph
    gives the eager step's logits bit for bit (the top-2 combine adds two
    rows onto zeros, so the atomics' order does not matter)."""
    from repro_torch.models import Model
    from repro_torch.serving.captured import CapturedStep, copy_into, tree_leaves

    cfg = _family_cfg("mixtral_8x22b")
    model = Model(cfg, param_dtype=torch.bfloat16, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    B = 8
    cache = model.init_cache(B, 32, torch.bfloat16)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, 1))
                           .astype(np.int32)).to(cuda)
    lengths = torch.tensor([3, 0, 17, 9, 31, 30, 1, 12], dtype=torch.int32, device=cuda)
    model.decode_step(params, tok, cache, lengths)  # first call: loads, allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager, _ = model.decode_step(params, tok, cache, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    snap = [t.clone() for t in tree_leaves(cache)]

    def step():
        logits, new = model.decode_step(params, tok, cache, lengths)
        copy_into(cache, new)
        return logits

    graph = CapturedStep(step, cuda)
    for t, s in zip(tree_leaves(cache), snap):
        t.copy_(s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.out, eager)


@pytest.mark.parametrize("name", ["zamba2_2p7b", "mixtral_8x22b"])
def test_new_family_batcher_on_card_matches_cpu(cuda, name):
    """The batcher on the card (one replay a step) gives the CPU batcher's
    tokens for 7 requests through 3 slots, slots reused (for zamba2 the
    reused slot's stale Mamba state included), float32 weights and cache."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, GenRequest, captured

    cfg = dataclasses.replace(_family_cfg(name), vocab=64)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(5))
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    rng = np.random.default_rng(2)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, cfg.vocab, rng.integers(1, 12))],
             int(rng.integers(1, 9))) for i in range(7)]
    outs, logits = [], []
    for model, p in ((cpu, params), (card, params_card)):
        b = ContinuousBatcher(model, p, n_slots=3, max_len=24)
        for rid, prompt, n in reqs:
            b.submit(GenRequest(rid, prompt, max_new_tokens=n))
        captured.reset_replays()
        outs.append(b.run_to_completion())
        logits.append(b.logits.float().cpu())
        if model is card:
            assert captured.REPLAYED["steps"] == b.steps
            assert captured.REPLAYED["decode_attention"] == card.decode_attention_calls() * b.steps
    assert outs[0] == outs[1]
    torch.testing.assert_close(logits[1], logits[0], **TOL)


# ------------------------------------------------------------ MLA (deepseek-v3)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,strided", [
    (1, 130, 4, False),   # ragged: two full q tiles and a partial one
    (2, 64, 8, True),     # v read in place as the tail of [k_nope | v]
    (1, 300, 16, True),   # ragged and strided
    (1, 1024, 128, True), # deepseek-v3 prefill width
])
def test_flash_kernel_split_head_dims(cuda, B, S, H, strided, dtype):
    """MLA's prefill shape: q/k heads of 192 (nope 128 + rope 64), v heads
    of 128, causal, against the plain version; v strided as ``mla_forward``
    passes it; one launch; output (B,S,H,128)."""
    q, k, kv = _attn_inputs([(B, S, H, 192), (B, S, H, 192), (B, S, H, 256)], dtype, S + H, cuda)
    v = kv[..., 128:] if strided else kv[..., 128:].contiguous()
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, True, None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == (B, S, H, 128)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])


def _latent_inputs(B, S, H, q_dtype, cache_dtype, seed, cuda):
    q_lat, q_rope, c, r = _attn_inputs([(B, H, 512), (B, H, 64), (B, S, 512), (B, S, 64)],
                                       torch.float32, seed, cuda)
    return q_lat.to(q_dtype), q_rope.to(q_dtype), c.to(cache_dtype), r.to(cache_dtype)


LATENT_SCALE = float(np.float32(1) / np.sqrt(np.float32(192)))


MLA_B8_LENGTHS = np.random.default_rng(7).integers(16, 577, 8).tolist()  # chip_smoke's mla_b8


@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,S,H,valid,form", [
    (1, 1024, 128, 1023, "int"),     # the engine's shape: one row, the last position
    (1, 1024, 128, 1023, "0-d"),
    (1, 1024, 128, 0, "0-d"),        # the first token
    (1, 100, 128, 37, "int"),        # a partial tile
    (1, 64, 128, 500, "0-d"),        # past S-1: every row live
    (3, 300, 128, [5, 299, 140], "per-row"),
    (8, 1024, 128, [200, 200, 133, 200, 200, 200, 200, 9], "per-row"),  # the batcher's shape
    (2, 200, 16, [100, 63], "per-row"),     # 16 heads: 48 zero rows of the 64-head tile
    (2, 200, 80, [64, 130], "per-row"),     # 80 heads: the second head group padded
    (1, 1024, 128, 700, "0-d"),             # the last split's share ends mid-tile
    (8, 1024, 128, MLA_B8_LENGTHS, "per-row"),  # chip_smoke's mla_b8 row
    (1, 2048, 128, 1024, "0-d"),            # the mla endpoint's cache, 1,025 live rows
])
def test_latent_kernel_matches_plain(cuda, B, S, H, valid, form, q_dtype, cache_dtype):
    """The absorbed-MLA entry at deepseek-v3's dims (latent 512 + rope 64;
    128 heads, and 16 and 80) against its plain version: an int, a 0-d or a
    (B,) valid_len; one launch counted (the tensor-core path makes two:
    the kernel and the merge); output (B,H,512) in q's dtype; a second run
    equal bit for bit (no atomics but the CUDA-core kernel's tickets)."""
    v = valid if form == "int" else torch.tensor(valid, dtype=torch.int32, device=cuda)
    args = _latent_inputs(B, S, H, q_dtype, cache_dtype, S + B, cuda)
    ops.reset_launches()
    out = ops.decode_attention_latent(*args, v, LATENT_SCALE)
    again = ops.decode_attention_latent(*args, v, LATENT_SCALE)
    want = ref.decode_attention_latent_ref(*args, v, LATENT_SCALE)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention_latent"] == 2
    assert out.dtype == q_dtype and out.shape == (B, H, 512)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[q_dtype])


def test_latent_kernel_never_reads_past_valid_len(cuda):
    """NaN in every cache row past each row's length must not reach the
    output; repeat calls agree bit for bit and leave the tickets at zero."""
    q_lat, q_rope, c, r = _latent_inputs(2, 256, 128, torch.bfloat16, torch.bfloat16, 4, cuda)
    lengths = torch.tensor([100, 17], dtype=torch.int32, device=cuda)
    want = ref.decode_attention_latent_ref(q_lat, q_rope, c, r, lengths, LATENT_SCALE)
    for b, n in enumerate(lengths.tolist()):
        c[b, n + 1:] = float("nan")
        r[b, n + 1:] = float("nan")
    first = ops.decode_attention_latent(q_lat, q_rope, c, r, lengths, LATENT_SCALE)
    torch.testing.assert_close(first.float(), want.float(), **TOL_ATTN[torch.bfloat16])
    for _ in range(2):
        assert torch.equal(ops.decode_attention_latent(q_lat, q_rope, c, r, lengths,
                                                       LATENT_SCALE), first)
    torch.cuda.synchronize()
    assert not ops._decode_tickets(q_lat.device, 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latent_kernel_no_live_position_gives_zeros(cuda, dtype):
    q_lat, q_rope, c, r = _latent_inputs(2, 64, 16, dtype, dtype, 5, cuda)
    c.fill_(float("nan"))
    r.fill_(float("nan"))
    out = ops.decode_attention_latent(q_lat, q_rope, c, r, torch.tensor([-1, -3], device=cuda),
                                      LATENT_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_latent_kernel_graph_replays_new_lengths(cuda):
    """One call with (B,) lengths captured in a CUDA graph, replayed with new
    lengths in the same tensor: each against the plain version."""
    B, S = 8, 1024
    q_lat, q_rope, c, r = _latent_inputs(B, S, 128, torch.bfloat16, torch.bfloat16, 6, cuda)
    valid = torch.zeros(B, dtype=torch.int32, device=cuda)
    ops.decode_attention_latent(q_lat, q_rope, c, r, valid, LATENT_SCALE)  # outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention_latent(q_lat, q_rope, c, r, valid, LATENT_SCALE)
    rng = np.random.default_rng(1)
    for _ in range(3):
        lengths = torch.from_numpy(rng.integers(0, S + 20, B).astype(np.int32)).to(cuda)
        valid.copy_(lengths)
        graph.replay()
        torch.cuda.synchronize()
        want = ref.decode_attention_latent_ref(q_lat, q_rope, c, r, lengths, LATENT_SCALE)
        torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[torch.bfloat16])


def test_latent_kernel_checks_inputs(cuda):
    q_lat, q_rope, c, r = _latent_inputs(1, 64, 16, torch.float32, torch.float32, 7, cuda)
    with pytest.raises(ValueError):  # 12 heads: not a multiple of 16
        ops.decode_attention_latent(q_lat[:, :12].contiguous(), q_rope[:, :12].contiguous(), c,
                                    r, 3, LATENT_SCALE)
    with pytest.raises(ValueError):  # no instantiation at (256, 64)
        ops.decode_attention_latent(q_lat[..., :256].contiguous(), q_rope,
                                    c[..., :256].contiguous(), r, 3, LATENT_SCALE)
    strided = torch.empty(1, 64, 1024, device=cuda)[..., :512]
    with pytest.raises(ValueError):  # the kernel reads the caches in place, contiguous
        ops.decode_attention_latent(q_lat, q_rope, strided, r, 3, LATENT_SCALE)
    with pytest.raises(ValueError):  # no live position for an int
        ops.decode_attention_latent(q_lat, q_rope, c, r, -1, LATENT_SCALE)


def _mla_cfg():
    """Reduced deepseek-v3 at its real MLA head dims (nope 128, rope 64, v
    128, kv_lora 512) with 16 heads, so both attention kernels take it."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_config

    cfg = get_config("deepseek_v3_671b").reduced()
    return dataclasses.replace(cfg, n_heads=16, n_kv_heads=16,
                               mla=MLAConfig(q_lora_rank=64, kv_lora_rank=512,
                                             qk_nope_head_dim=128, qk_rope_head_dim=64,
                                             v_head_dim=128))


def test_mla_model_on_card_matches_cpu(cuda):
    """The MLA model (leading dense layer, sigmoid MoE with a shared expert)
    on the card through ``flash_attention`` at (192, 128) and the latent
    decode, against the same model on the CPU: prefill logits, then three
    decode steps into the prompt's latent cache, the last with per-row
    positions; and the MTP hidden of ``forward("train")``."""
    from repro_torch.models import Model

    cfg = _mla_cfg()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
                              .astype(np.int32))
    ops.reset_launches()
    cache_c, logits_c = card.prefill(params_card, {"tokens": tokens.to(cuda)})
    cache, logits = cpu.prefill(params, {"tokens": tokens})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(logits_c.cpu(), logits, **TOL)
    kv_c, kv = card.init_cache(2, 48, torch.float32), cpu.init_cache(2, 48, torch.float32)
    for key in kv:
        for a, b, src in zip(kv_c[key], kv[key], cache[key]):
            a[:, :, :40] = src.to(cuda)
            b[:, :, :40] = src
    tok = tokens[:, -1:]
    for idx in (40, 41, torch.tensor([44, 7], dtype=torch.int32)):
        lc, kv_c = card.decode_step(params_card, tok.to(cuda), kv_c,
                                    idx.to(cuda) if isinstance(idx, torch.Tensor) else idx)
        lp, kv = cpu.decode_step(params, tok, kv, idx)
        torch.testing.assert_close(lc.cpu(), lp, **TOL)
        tok = lp.argmax(-1, keepdim=True).to(torch.int32)
    assert ops.LAUNCHES["decode_attention_latent"] == 3 * cfg.n_layers
    assert ops.LAUNCHES["decode_attention"] == 0
    _, (_, h_c), _ = card.forward(params_card, {"tokens": tokens.to(cuda)})
    _, (_, h), _ = cpu.forward(params, {"tokens": tokens})
    torch.testing.assert_close(h_c.cpu(), h, **TOL)


def test_mla_batcher_and_generate_on_card_match_cpu(cuda):
    """The MLA model's batcher on the card (one replay a step, 4 latent
    launches a replay) gives the CPU batcher's tokens for 7 requests
    through 3 slots; ``Instance.generate`` replays give the eager loop's."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, Endpoint, GenRequest, Instance, captured

    cfg = dataclasses.replace(_mla_cfg(), vocab=64)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(5))
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    rng = np.random.default_rng(2)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, cfg.vocab, rng.integers(1, 12))],
             int(rng.integers(1, 9))) for i in range(7)]
    outs, logits = [], []
    for model, p in ((cpu, params), (card, params_card)):
        b = ContinuousBatcher(model, p, n_slots=3, max_len=24)
        for rid, prompt, n in reqs:
            b.submit(GenRequest(rid, prompt, max_new_tokens=n))
        captured.reset_replays()
        outs.append(b.run_to_completion())
        logits.append(b.logits.float().cpu())
        if model is card:
            assert captured.REPLAYED["steps"] == b.steps
            assert captured.REPLAYED["decode_attention_latent"] == cfg.n_layers * b.steps
    assert outs[0] == outs[1]
    torch.testing.assert_close(logits[1], logits[0], **TOL)
    inst = Instance(Endpoint("mla", cfg, seed=3, max_cache_len=64), device=cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 20)).astype(np.int32)).to(cuda)
    want = _eager_generate(inst, tokens, 6)
    inst.prepare(1)
    captured.reset_replays()
    assert torch.equal(inst.generate(tokens, 6), want)
    assert captured.REPLAYED["decode_attention_latent"] == cfg.n_layers * 5


def test_bf16_endpoint_replays_on_a_bf16_latent_cache(cuda):
    """A bfloat16 endpoint's captured decode loop keeps its latent cache in
    bfloat16, and its replayed tokens equal the eager loop's on that cache."""
    import dataclasses

    from repro_torch.serving import Endpoint, Instance, captured

    cfg = dataclasses.replace(_mla_cfg(), vocab=64)
    inst = Instance(Endpoint("mla", cfg, seed=3, max_cache_len=64, param_dtype=torch.bfloat16),
                    device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 20))
                              .astype(np.int32)).to(cuda)
    want = _eager_generate(inst, tokens, 6)
    inst.prepare(2)
    assert {t.dtype for t in captured.tree_leaves(inst._loops[2].cache)} == {torch.bfloat16}
    captured.reset_replays()
    assert torch.equal(inst.generate(tokens, 6), want)
    assert captured.REPLAYED["decode_attention_latent"] == cfg.n_layers * 5


def test_moe_top8_replay_equals_eager(cuda):
    """Top-8 routing (16 experts, the sigmoid router, bfloat16): a decode step
    captured in a CUDA graph and replayed gives the eager step's logits bit
    for bit, since each token's 8 gated rows are summed in a fixed order."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serving.captured import CapturedStep, copy_into, tree_leaves

    cfg = _family_cfg("mixtral_8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=8,
                                                           router="sigmoid", n_shared=1))
    model = Model(cfg, param_dtype=torch.bfloat16, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    B = 8
    cache = model.init_cache(B, 32, torch.bfloat16)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 1))
                           .astype(np.int32)).to(cuda)
    lengths = torch.tensor([3, 0, 17, 9, 31, 30, 1, 12], dtype=torch.int32, device=cuda)
    model.decode_step(params, tok, cache, lengths)  # first call: loads, allocations
    torch.cuda.synchronize()
    snap = [t.clone() for t in tree_leaves(cache)]
    eager, _ = model.decode_step(params, tok, cache, lengths)

    def step():
        logits, new = model.decode_step(params, tok, cache, lengths)
        copy_into(cache, new)
        return logits

    graph = CapturedStep(step, cuda)
    for _ in range(3):
        for t, s in zip(tree_leaves(cache), snap):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.out, eager)


# ---------------------------------------------- encoder-decoder (whisper-small)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,H,KH,hd", [
    (1, 4, 1500, 12, 12, 64),     # whisper's start sequence over 30 s of audio
    (1, 448, 1500, 12, 12, 64),   # its text context over the same
    (2, 130, 70, 4, 2, 32),       # fewer keys than queries, GQA, ragged tiles
    (1, 1, 9, 4, 4, 80),          # one query, keys short of one tile
    (3, 65, 200, 8, 8, 128),
])
def test_flash_kernel_other_key_length(cuda, B, S, Sk, H, KH, hd, dtype):
    """Cross-attention: S queries over Sk keys, no mask, against the plain
    version; one launch."""
    q, k, v = _attn_inputs([(B, S, H, hd), (B, Sk, KH, hd), (B, Sk, KH, hd)], dtype, S + Sk,
                           cuda)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ATTN[dtype])


def test_flash_kernel_encoder_width(cuda):
    """whisper's encoder: 1,500 frames, 12 heads of 64, bidirectional."""
    q, k, v = _attn_inputs([(1, 1500, 12, 64)] * 3, torch.float32, 3, cuda)
    out = ops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v, causal=False),
                               **TOL_ATTN[torch.float32])


@pytest.mark.parametrize("causal,window", [(True, None), (False, 16)])
def test_flash_kernel_other_key_length_takes_no_mask(cuda, causal, window):
    q, k, v = _attn_inputs([(1, 5, 2, 64), (1, 24, 2, 64), (1, 24, 2, 64)], torch.float32, 0,
                           cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="no causal mask and no window"):
        ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == 0


def _whisper_cfg(vocab=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("whisper_small").reduced()
    return dataclasses.replace(cfg, vocab=vocab) if vocab else cfg


def test_whisper_model_on_card_matches_cpu(cuda):
    """Reduced whisper on the card through both kernels, against the same
    model on the CPU: ``forward("train")``; prefill with 37 frames and 9
    tokens (3 flash_attention a layer: encoder, self, cross at Sk != S);
    then the prefill's caches copied into ``init_cache(2, 24,
    memory_t=37)`` and three decode steps (an int, a 0-d and a per-row
    index; 2 decode_attention a layer: self, and cross over the memory)."""
    from repro_torch.models import Model

    cfg = _whisper_cfg()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0), max_seq=64)
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    rng = np.random.default_rng(1)
    batch = {"frames": torch.from_numpy((rng.standard_normal((2, 37, cfg.d_model)) * 0.02)
                                        .astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32))}
    batch_c = _tree_to(batch, cuda)
    torch.testing.assert_close(card.forward(params_card, batch_c)[0].cpu(),
                               cpu.forward(params, batch)[0], **TOL)
    ops.reset_launches()
    cache_c, logits_c = card.prefill(params_card, batch_c)
    cache, logits = cpu.prefill(params, batch)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    torch.testing.assert_close(logits_c.cpu(), logits, **TOL)
    torch.testing.assert_close(cache_c["memory"].cpu(), cache["memory"], **TOL)
    kv_c, kv = card.init_cache(2, 24, torch.float32, 37), cpu.init_cache(2, 24, torch.float32, 37)
    for c, src in ((kv_c, cache_c), (kv, cache)):
        c["memory"].copy_(src["memory"])
        c["enc_pos"].copy_(src["enc_pos"])
        for a, b in zip(c["stack"], src["stack"]):
            a[:, :, :9] = b
    tok = batch["tokens"][:, -1:]
    for idx in (9, torch.tensor(10, dtype=torch.int32), torch.tensor([13, 30], dtype=torch.int32)):
        lc, kv_c = card.decode_step(params_card, tok.to(cuda), kv_c,
                                    idx.to(cuda) if isinstance(idx, torch.Tensor) else idx)
        lp, kv = cpu.decode_step(params, tok, kv, idx)
        torch.testing.assert_close(lc.cpu(), lp, **TOL)
        tok = lp.argmax(-1, keepdim=True).to(torch.int32)
    for a, b in zip(kv_c["stack"], kv["stack"]):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    assert ops.LAUNCHES["decode_attention"] == 3 * 2 * cfg.n_layers


def test_whisper_replay_equals_eager_step(cuda):
    """A whisper decode step over 40 rows of encoded memory, captured in a
    CUDA graph (the cross K/V projected from the static memory buffer on
    every replay, no host copy inside the capture) and replayed with new
    memory and positions, gives the eager step's logits bit for bit."""
    from repro_torch.models import Model
    from repro_torch.serving.captured import CapturedStep, copy_into, tree_leaves

    cfg = _whisper_cfg()
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), max_seq=64)
    B = 3
    cache = model.init_cache(B, 32, torch.float32, memory_t=40)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
    lengths = torch.zeros((B,), dtype=torch.int32, device=cuda)

    def step():
        logits, new = model.decode_step(params, tok, cache, lengths)
        copy_into(cache, new)
        return logits

    graph = CapturedStep(step, cuda)
    assert graph.launches["decode_attention"] == 2 * cfg.n_layers
    # by shape: n_layers over the 32-row self cache, n_layers over 40 memory rows
    rows = {key[2][0][1]: n for key, n in graph.shape_launches.items()
            if key[0] == "decode_attention"}
    assert rows == {32: cfg.n_layers, 40: cfg.n_layers}
    gen = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(3):
        for t in tree_leaves(cache):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
        tok.random_(0, cfg.vocab, generator=gen)
        lengths.random_(0, 40, generator=gen)
        snap = [t.clone() for t in tree_leaves(cache)]
        eager, _ = model.decode_step(params, tok, cache, lengths)
        for t, s in zip(tree_leaves(cache), snap):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.out, eager)


def test_whisper_batcher_on_card_matches_cpu(cuda):
    """The whisper batcher on the card (one replay a step, 2 decode launches
    a layer, over 1,500 rows of zero memory) gives the CPU batcher's tokens
    for 7 requests through 3 slots."""
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, GenRequest, captured

    cfg = _whisper_cfg(vocab=64)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(5), max_seq=64)
    card = Model(cfg, device=cuda)
    params_card = _tree_to(params, cuda)
    rng = np.random.default_rng(2)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(0, cfg.vocab, rng.integers(1, 12))],
             int(rng.integers(1, 9))) for i in range(7)]
    outs, logits = [], []
    for model, p in ((cpu, params), (card, params_card)):
        b = ContinuousBatcher(model, p, n_slots=3, max_len=24)
        for rid, prompt, n in reqs:
            b.submit(GenRequest(rid, prompt, max_new_tokens=n))
        captured.reset_replays()
        outs.append(b.run_to_completion())
        logits.append(b.logits.float().cpu())
        if model is card:
            assert captured.REPLAYED["steps"] == b.steps
            assert captured.REPLAYED["decode_attention"] == card.decode_attention_calls() * b.steps
            by_shape = {key[2][0][1]: n for key, n in captured.REPLAYED_SHAPES.items()
                        if key[0] == "decode_attention"}
            assert by_shape == {24: cfg.n_layers * b.steps, 1500: cfg.n_layers * b.steps}
    assert outs[0] == outs[1]
    torch.testing.assert_close(logits[1], logits[0], **TOL)


# ------------------------------------------------------------ training
BWD_SHAPES = [
    (1, 128, 4, 4, 64, True, None, None),
    (2, 256, 8, 2, 64, True, None, None),     # GQA 4:1
    (1, 300, 4, 1, 128, True, 64, None),      # ragged, GQA, window
    (2, 130, 4, 4, 32, False, None, None),    # bidirectional
    (1, 200, 4, 2, 80, True, None, None),
    (1, 100, 4, 4, 16, False, 40, None),      # bidirectional window
    (1, 257, 4, 2, 256, True, None, None),
    (2, 64, 4, 4, 64, False, None, 300),      # keys of another length (cross-attention)
    (1, 1024, 36, 36, 64, True, None, None),  # minicpm-2b width
]
# BWD_SHAPES with no softcap, then the cases the tensor-core tiles (16 rows a
# warp, 32-row streamed tiles, head-dim slices at 128 and 256) must meet:
# head counts of every kind, S and Sk off the tiles, windows, softcaps and
# every head dim, hd 80 at zamba2-2.7b's train width among them
BWD_CASES = [(*shape, None) for shape in BWD_SHAPES] + [
    (1, 200, 3, 1, 80, True, None, None, None),     # 3 heads on one kv head, S off the tile
    (2, 333, 20, 4, 80, True, 100, None, None),     # GQA 5:1 with a window
    (1, 96, 8, 8, 80, False, None, 77, None),       # Sk != S, neither a tile multiple
    (1, 200, 4, 2, 64, True, None, None, 50.0),     # softcap
    (1, 130, 6, 3, 80, True, 48, None, 30.0),       # softcap, window, hd 80
    (1, 100, 2, 2, 128, False, None, 260, 50.0),    # cross-attention with a softcap
    (1, 77, 2, 1, 256, True, 20, None, None),       # hd 256, window
    (1, 50, 2, 2, 16, True, None, None, 20.0),
    (1, 70, 4, 2, 32, False, 16, None, None),
    (2, 1024, 32, 32, 80, True, None, None, None),  # zamba2-2.7b train width
]


def _bwd_inputs(B, S, H, KH, hd, Sk, dtype, seed, cuda):
    Sk = Sk or S
    return _attn_inputs([(B, S, H, hd), (B, Sk, KH, hd), (B, Sk, KH, hd), (B, S, H, hd)], dtype,
                        seed, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,causal,window,Sk,cap", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, S, H, KH, hd, causal, window, Sk, cap, dtype):
    """The forward kernel's LSE and the backward kernel's dq, dk, dv against
    ``flash_attention_lse_ref`` and ``flash_attention_bwd_ref`` on the same
    out and lse; two runs bit for bit (no atomics)."""
    q, k, v, do = _bwd_inputs(B, S, H, KH, hd, Sk, dtype, S + hd, cuda)
    if cap:
        q = q * 4  # logits where the cap bends them
    out, lse = ops._flash_forward(q, k, v, causal, window, cap, want_lse=True)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(q, k, causal, window, cap),
                               atol=1e-4 if cap else 2e-5, rtol=2e-5)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window, cap)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window, cap)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    tol = TOL_ATTN[torch.float32] if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_kernels_match_plain(cuda, causal, window, dtype):
    """cap = 50: the forward, its LSE and ``decode_attention`` against their
    plain versions; the backward against its plain version in bfloat16 and
    against the float64 gradient in float32.

    At this data (q x 8: logits of ~+-60, where the cap bends them) the
    float32 plain backward ``ref.flash_attention_bwd_ref`` itself misses
    TOL_ATTN (2e-5) against the float64 gradient ``_flash_bwd_float64`` in
    dk, by up to 4.83e-5, 3.76e-5 and 3.57e-5 in the three cases (2, 1 and
    1 elements over); dq stays within 6.4e-6 and dv within 1.04e-5
    (``tests/test_torch_tf32x3.py::test_softcap_plain_bwd_against_float64``).
    So a float32 comparison with the plain version at 2e-5 measures the
    plain version's own error as well.  Each float32 gradient of the kernel
    is held to float64 instead, at most TOL_ATTN's atol less accurate than
    the plain version on the same out and lse: max |kernel - f64| <= max
    |plain - f64| + 2e-5."""
    cap = 50.0
    q, k, v, do = _bwd_inputs(1, 200, 4, 2, 64, None, dtype, 5, cuda)
    q = q * 8  # logits of ~+-60, where the cap bends them
    out, lse = ops._flash_forward(q, k, v, causal, window, cap, want_lse=True)
    tol = TOL_ATTN[dtype]
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v, causal, window, cap)
                               .float(), **tol)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(q, k, causal, window, cap),
                               atol=1e-4, rtol=2e-5)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window, cap)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, cap)
    if dtype == torch.float32:
        exact = _flash_bwd_float64(*(t.cpu() for t in (q, k, v, do)), causal, window, cap)
        for name, g, pl, w in zip(("dq", "dk", "dv"), got, plain, exact):
            plain_err = float((pl.cpu().double() - w).abs().max())
            err = float((g.cpu().double() - w).abs().max())
            assert err <= plain_err + TOL_ATTN[torch.float32]["atol"], \
                f"{name}: kernel {err:.3e} from float64, plain {plain_err:.3e}"
    else:
        for g, w in zip(got, plain):
            torch.testing.assert_close(g.float(), w.float(), atol=5e-2, rtol=5e-2)
    kc, vc = k.contiguous(), v.contiguous()
    for valid in (100, torch.tensor([150], device=cuda)):
        torch.testing.assert_close(
            ops.decode_attention(q[:, 150], kc, vc, valid, window, cap).float(),
            ref.decode_attention_ref(q[:, 150], kc, vc, valid, window, cap).float(), **tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_softcap_bwd_kernel_against_float64(cuda, causal, window):
    """The float32 backward at ``test_softcap_kernels_match_plain``'s data
    (cap 50, logits of ~+-60) against the float64 gradient of capped
    attention, at TOL: split precision meets it on the CPU and one TF32
    product misses it (tests/test_torch_tf32x3.py)."""
    cap = 50.0
    q, k, v, do = _bwd_inputs(1, 200, 4, 2, 64, None, torch.float32, 5, cuda)
    q = q * 8
    out, lse = ops._flash_forward(q, k, v, causal, window, cap, want_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window, cap)
    want = _flash_bwd_float64(*(t.cpu() for t in (q, k, v, do)), causal, window, cap)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu().double(), w, **TOL)


@pytest.mark.parametrize("B,S,H,KH,hd,causal,window,Sk", BWD_SHAPES[:4])
def test_flash_autograd_matches_plain_autograd(cuda, B, S, H, KH, hd, causal, window, Sk):
    """``ops.flash_attention`` under autograd on the card (one forward and
    one backward launch) against ``torch.autograd`` through the plain
    version; with no gradient wanted, the serving path's launch alone."""
    q, k, v, do = _bwd_inputs(B, S, H, KH, hd, Sk, torch.float32, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.flash_attention(*leaves, causal, window).backward(do)
    ref.flash_attention_ref(*plain, causal, window).backward(do)
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, **TOL_ATTN[torch.float32])
    ops.reset_launches()
    with torch.no_grad():
        ops.flash_attention(*leaves, causal, window)
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 0
    assert list(ops.SHAPE_LAUNCHES) == [("flash_attention", *ops.shape_key(q, k, v, causal,
                                                                            window))]


# B, S, H, KH, causal, window: the backward at MLA's head dims (q/k 192, v
# 128), v the tail of each head's [k_nope | v] row, S off the 64-row and
# 32-row tiles; and deepseek-v3's train shape at B=1
SPLIT_BWD_CASES = [
    (1, 200, 8, 8, True, None),
    (2, 130, 8, 8, True, None),
    (1, 97, 8, 2, True, None),      # GQA 4:1 (no config; the kernel takes it)
    (1, 150, 8, 8, False, None),    # bidirectional
    (1, 300, 8, 8, True, 64),       # window
    (1, 1024, 128, 128, True, None),  # deepseek-v3 width
]


def _split_inputs(B, S, H, KH, dtype, seed, cuda):
    """q (B,S,H,192), k (B,S,KH,192), v (B,S,KH,128) read at a head stride of
    256 (the tail of a [k_nope | v] row, as ``mla_forward`` passes it) and
    dout (B,S,H,128)."""
    q, k, kv, do = _attn_inputs([(B, S, H, 192), (B, S, KH, 192), (B, S, KH, 256),
                                 (B, S, H, 128)], dtype, seed, cuda)
    return q, k, kv[..., 128:], do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,causal,window", SPLIT_BWD_CASES)
def test_flash_bwd_kernel_split_dims_matches_plain(cuda, B, S, H, KH, causal, window, dtype):
    """The backward kernel at (192, 128) with v read in place at its head
    stride, from the forward kernel's out and LSE: dq, dk (192) and dv
    (128) against ``flash_attention_bwd_ref`` on the same out and lse (float32
    at TOL_ATTN, bfloat16 at its backward tolerance), two runs bit for bit,
    one launch a call; the LSE against its plain version."""
    q, k, v, do = _split_inputs(B, S, H, KH, dtype, S + H, cuda)
    assert not v.is_contiguous() and v.stride(2) == 256
    out, lse = ops._flash_forward(q, k, v, causal, window, None, want_lse=True)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(q, k, causal, window),
                               atol=2e-5, rtol=2e-5)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 2
    tol = TOL_ATTN[torch.float32] if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and g.is_contiguous()
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("B,S,H,KH,causal,window", SPLIT_BWD_CASES[:3])
def test_flash_autograd_split_dims_matches_plain_autograd(cuda, B, S, H, KH, causal, window):
    """``ops.flash_attention`` under autograd at (192, 128), v a strided view
    of a [k_nope | v] leaf as ``mla_forward`` makes it: one forward and one
    backward launch, the gradients of q, k and the whole [k_nope | v] leaf
    against ``torch.autograd`` through the plain version."""
    q, k, kv, do = _attn_inputs([(B, S, H, 192), (B, S, KH, 192), (B, S, KH, 256),
                                 (B, S, H, 128)], torch.float32, 4, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, kv)]
    plain = [t.clone().requires_grad_() for t in (q, k, kv)]
    ops.reset_launches()
    ops.flash_attention(leaves[0], leaves[1], leaves[2][..., 128:], causal, window).backward(do)
    ref.flash_attention_ref(plain[0], plain[1], plain[2][..., 128:], causal,
                            window).backward(do)
    assert ops.LAUNCHES["flash_attention"] == 1 and ops.LAUNCHES["flash_attention_bwd"] == 1
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, **TOL_ATTN[torch.float32])
    assert torch.equal(leaves[2].grad[..., :128], torch.zeros_like(leaves[2].grad[..., :128]))


def test_kernels_without_backward_raise_under_autograd(cuda):
    """No silent gradient: the wrappers with no backward kernel (the two
    decode entries: no train step decodes) raise on the card under
    autograd, and run as before without it."""
    q, kc, vc = _attn_inputs([(1, 4, 64), (1, 32, 2, 64), (1, 32, 2, 64)], torch.float32, 0, cuda)
    lat = _latent_inputs(1, 64, 16, torch.float32, torch.float32, 2, cuda)
    calls = {
        "decode_attention": lambda g: ops.decode_attention(q.requires_grad_(g), kc, vc, 20),
        "decode_attention_latent": lambda g: ops.decode_attention_latent(
            lat[0].requires_grad_(g), *lat[1:], 40, 0.1),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of reduced minicpm-2b (with remat) on the card, its
    attention through both flash kernels, against the CPU's: the loss, the
    metrics, every gradient leaf, and the parameters after the step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import OptConfig, init_opt_state, loss_and_grads, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config("minicpm_2b").reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device=cuda)
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = _tree_to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
                              .astype(np.int32))
    ops.reset_launches()
    loss_c, _, grads_c = loss_and_grads(card, params_card, {"tokens": tokens.to(cuda)})
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers  # forward and remat recompute
    assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    loss, _, grads = loss_and_grads(cpu, params, {"tokens": tokens})
    torch.testing.assert_close(loss_c.cpu(), loss, **TOL)
    for a, b in zip(tree_leaves(grads_c), tree_leaves(grads)):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_c, _, m_c = make_train_step(card, opt)(params_card, init_opt_state(params_card),
                                             {"tokens": tokens.to(cuda)})
    p, _, m = make_train_step(cpu, opt)(copy.deepcopy(params), init_opt_state(params),
                                        {"tokens": tokens})
    for key in ("loss", "ce", "grad_norm", "lr"):
        torch.testing.assert_close(m_c[key].cpu(), m[key], **TOL)
    # step 1 of AdamW moves each weight by ~lr * sign(g): compare where |g| is not tiny
    for a, b, g in zip(tree_leaves(p_c), tree_leaves(p), tree_leaves(grads)):
        big = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close(a.cpu()[big], b[big], atol=1e-5, rtol=1e-5)


# B, S, H, P, N, G, chunk, init_state given, d_final_state given
SSD_BWD_SHAPES = [
    (1, 64, 4, 16, 16, 1, 64, False, False),
    (2, 256, 8, 16, 32, 1, 64, False, True),
    (1, 192, 6, 16, 8, 2, 64, True, True),      # G=2
    (2, 200, 3, 16, 16, 3, 100, False, True),   # chunk not a multiple of the 64 tile
    (1, 256, 4, 96, 80, 2, 128, True, True),    # P and N not multiples of 64
    (1, 1024, 24, 64, 128, 1, 256, False, False),  # mamba2-130m width
    (1, 1024, 80, 64, 64, 1, 256, False, False),   # zamba2-2.7b width
    (1, 512, 24, 64, 128, 2, 256, True, True),
    # head counts that the dC / dB CTAs' slices of 8 heads do not divide
    (1, 128, 3, 16, 16, 1, 64, True, True),     # H=3: one short slice
    (1, 256, 20, 32, 32, 1, 128, False, True),  # H=20: slices of 8, 8 and 4
    (1, 192, 18, 16, 16, 2, 96, True, True),    # G=2, 9 heads a group: 8 and 1
    (2, 256, 40, 32, 64, 2, 128, True, False),  # G=2, 20 heads a group
    (1, 512, 80, 64, 64, 1, 256, True, True),   # zamba2-2.7b width with both states
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,init,dfin", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(cuda, B, S, H, P, N, G, chunk, init, dfin, dtype):
    """``ssd_scan_bwd`` from the forward kernel's scratch against
    ``ssd_scan_bwd_ref`` on the same inputs: every gradient in its dtype,
    two runs bit for bit (no atomics)."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, G=G, seed=S + H)
    rng = np.random.default_rng(S)
    h0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32)) if init else None
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    df = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32)) if dfin else None
    xd, Bd, Cd, dyd = (t.to(cuda, dtype) for t in (x, Bm, Cm, dy))
    dtd, Ad = dt.to(cuda), A.to(cuda)
    h0d, dfd = (t.to(cuda) if t is not None else None for t in (h0, df))
    _, _, saved = ops._ssd_forward(xd, dtd, Ad, Bd, Cd, chunk, h0d, keep=True)
    ops.reset_launches()
    got = ops.ssd_scan_bwd(xd, dtd, Ad, Bd, Cd, chunk, h0d, dyd, dfd, saved)
    again = ops.ssd_scan_bwd(xd, dtd, Ad, Bd, Cd, chunk, h0d, dyd, dfd, saved)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan_bwd"] == 2 and ops.LAUNCHES["ssd_scan"] == 0
    want = ref.ssd_scan_bwd_ref(xd.float(), dtd, Ad, Bd.float(), Cd.float(), chunk, h0d,
                                dyd.float(), dfd)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    for g, a, w, t in zip(got, again, want, (xd, dtd, Ad, Bd, Cd, dtd)):
        assert g.dtype == t.dtype and g.shape == w.shape and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w, **tol)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("S,G,init", [(256, 1, False), (200, 2, True), (1000, 1, False)])
def test_ssd_autograd_matches_plain_autograd(cuda, S, G, init, seed):
    """``ops.ssd_scan`` under autograd on the card (padding included: one
    ``ssd_scan`` and one ``ssd_scan_bwd`` launch) and ``torch.autograd``
    through the float32 plain version, each against the plain version run
    in float64 on the same inputs (``ssd_chunked`` computes float64 inputs
    in float64), at TOL; with no gradient wanted, the serving path's launch
    alone at the same shape.  dy, the final state's gradient and h0 come
    from a generator seeded with ``seed``.  The float32 plain gradient
    itself lies up to 0.68 of TOL from float64 (dA, 6.4e-4 at S=256 over 12
    seeds; ``tests/test_torch_ssd_bwd.py::
    test_ssd_plain_grad_float32_within_tol_of_float64``), so a comparison of
    the kernel with it, not with float64, adds two such errors.

    The float32 plain route's dA alone is held to TOL plus a norm-wise term,
    ``atol = 1e-4 + 1e-5 * max_h |dA64_h|`` (``_plain_dA_limit``), at every
    case: each head's dA sums S x P x N (~2 M at S=1000) products of both
    signs, so its float32 rounding scales with the terms summed, not with
    their cancelled sum (at S=1000, seed 0, one head sums to 0.219 where the
    largest reaches 159.8, and the float32 plain dA lies 4.8e-4 from
    float64 there, 2.5 x TOL; ``tests/test_torch_ssd_bwd.py::
    test_ssd_plain_grad_float32_within_tol_of_float64``).  1e-5 of the
    largest head is ~170 float32 ulps of it.  The kernel route is held to
    TOL at every leaf, dA included."""
    H, P, N, chunk = 8, 32, 64, 128 if S != 1000 else 256
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(1, S, H, P, N, G=G, seed=9))
    g = torch.Generator().manual_seed(seed)
    h0 = torch.randn(1, H, P, N, generator=g).to(cuda) if init else None
    dy = torch.randn(1, S, H, P, generator=g).to(cuda)
    dst = torch.randn(1, H, P, N, generator=g).to(cuda)
    grads = {}
    for route in ("kernel", "plain", "float64"):
        dtype = torch.float64 if route == "float64" else torch.float32
        leaves = [t.to(dtype).clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        h = h0.to(dtype).clone().requires_grad_() if init else None
        ops.reset_launches()
        if route == "kernel":
            y, st = ops.ssd_scan(*leaves, chunk=chunk, init_state=h)
        else:
            pad = (-S) % chunk
            xp, dtp, Bp, Cp = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                               for t in (leaves[0], leaves[1], leaves[3], leaves[4]))
            y, st = ref.ssd_scan_ref(xp, dtp, leaves[2], Bp, Cp, chunk, h)
            y = y[:, :S]
        assert y.dtype == st.dtype == dtype
        ((y * dy.to(dtype)).sum() + (st * dst.to(dtype)).sum()).backward()
        torch.cuda.synchronize()
        want_launches = {"ssd_scan": 1, "ssd_scan_bwd": 1} if route == "kernel" else {}
        assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES}, **want_launches}
        grads[route] = [t.grad for t in leaves + ([h] if init else [])]
    for route in ("kernel", "plain"):
        for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), grads[route],
                              grads["float64"]):
            assert a.dtype == torch.float32
            tol = _plain_dA_limit(w) if (route, name) == ("plain", "dA") else TOL
            torch.testing.assert_close(a.double(), w, **tol, msg=lambda m: f"{route} {name}: {m}")
    ops.reset_launches()
    with torch.no_grad():
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0)
    assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES}, "ssd_scan": 1}
    assert [k[0] for k in ops.SHAPE_LAUNCHES] == ["ssd_scan"]


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v3_671b"])
def test_moe_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of reduced mixtral-8x22b (softmax top-2, a window) and
    of deepseek-v3 at MLA's real head dims (``_mla_cfg``: a dense layer,
    sigmoid top-2 with a shared expert, the MTP head), with remat, on the
    card against the CPU's: the loss, the metrics (``moe_aux``, ``mtp_ce``),
    every gradient leaf, and the parameters after the step.  The attention
    runs through both flash kernels, at (192, 128) with v strided for MLA:
    each layer's forward twice (the remat recompute), the MTP block's once,
    every backward once."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import OptConfig, init_opt_state, loss_and_grads, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    cfg = _mla_cfg() if arch == "deepseek_v3_671b" else get_config(arch).reduced()
    cpu, card = Model(cfg, device="cpu", remat=True), Model(cfg, device=cuda, remat=True)
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = _tree_to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 70))
                              .astype(np.int32))
    ops.reset_launches()
    loss_c, m_c, grads_c = loss_and_grads(card, params_card, {"tokens": tokens.to(cuda)})
    mtp = 1 if cfg.mtp_depth else 0
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers + mtp
    assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers + mtp
    loss, m, grads = loss_and_grads(cpu, params, {"tokens": tokens})
    assert set(m_c) == set(m) == {"loss", "ce", "moe_aux"} | ({"mtp_ce"} if mtp else set())
    torch.testing.assert_close(loss_c.cpu(), loss, **TOL)
    for key in m:
        torch.testing.assert_close(m_c[key].cpu(), m[key], **TOL)
    for a, b in zip(tree_leaves(grads_c), tree_leaves(grads)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, **TOL)
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_c, _, m_c = make_train_step(card, opt)(params_card, init_opt_state(params_card),
                                             {"tokens": tokens.to(cuda)})
    p, _, m = make_train_step(cpu, opt)(copy.deepcopy(params), init_opt_state(params),
                                        {"tokens": tokens})
    for key in m:
        torch.testing.assert_close(m_c[key].cpu(), m[key], **TOL)
    for a, b, g in zip(tree_leaves(p_c), tree_leaves(p), tree_leaves(grads)):
        big = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close(a.cpu()[big], b[big], atol=1e-5, rtol=1e-5)


def _plain_dA_limit(dA64):
    """The float32 plain scan's dA against float64: TOL plus 1e-5 of the
    largest head's value (``test_ssd_autograd_matches_plain_autograd``)."""
    return dict(atol=TOL["atol"] + 1e-5 * float(dA64.abs().max()), rtol=TOL["rtol"])


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2p7b"])
def test_ssm_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of reduced mamba2-130m and zamba2-2.7b (with remat) on
    the card, the scan through ``ssd_scan`` and ``ssd_scan_bwd`` (zamba2's
    shared attention through both flash kernels), against the CPU's: the
    loss, the metrics, every gradient leaf, and the parameters after the
    step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import OptConfig, init_opt_state, loss_and_grads, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_config(arch).reduced()
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device=cuda)
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = _tree_to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 100))
                              .astype(np.int32))  # 100: padded to the chunk of 32
    ops.reset_launches()
    loss_c, _, grads_c = loss_and_grads(card, params_card, {"tokens": tokens.to(cuda)})
    groups = cfg.n_layers // cfg.hybrid.every if cfg.hybrid else 0
    assert ops.LAUNCHES["ssd_scan"] == 2 * cfg.n_layers  # forward and remat recompute
    assert ops.LAUNCHES["ssd_scan_bwd"] == cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == 2 * groups
    assert ops.LAUNCHES["flash_attention_bwd"] == groups
    loss, _, grads = loss_and_grads(cpu, params, {"tokens": tokens})
    torch.testing.assert_close(loss_c.cpu(), loss, **TOL)
    for a, b in zip(tree_leaves(grads_c), tree_leaves(grads)):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    p_c, _, m_c = make_train_step(card, opt)(params_card, init_opt_state(params_card),
                                             {"tokens": tokens.to(cuda)})
    p, _, m = make_train_step(cpu, opt)(copy.deepcopy(params), init_opt_state(params),
                                        {"tokens": tokens})
    for key in ("loss", "ce", "grad_norm", "lr"):
        torch.testing.assert_close(m_c[key].cpu(), m[key], **TOL)
    for a, b, g in zip(tree_leaves(p_c), tree_leaves(p), tree_leaves(grads)):
        big = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close(a.cpu()[big], b[big], atol=1e-5, rtol=1e-5)
