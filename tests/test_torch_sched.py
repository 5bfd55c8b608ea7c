"""The port's scheduling paths (repro_torch.core.sched, kernels.ref/ops)
held bitwise against the JAX package's plain scan
``repro.core.jax_sched.sched_many(key=None)`` and its oracles in
``repro.kernels.ref``, on inputs drawn once with numpy and fed to both.
The CUDA kernel's tests are in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.core import jax_sched as J
from repro.core.simulator import BurstDetector as JaxBurstDetector
from repro.kernels import ref as jref
from repro_torch.core import sched as T
from repro_torch.kernels import ops, ref
from test_torch_sched_cases import sched_case

CPU = "cpu"


def _mixed(seed, n, n_funcs=6, n_workers=9):
    """The mixed-event streams of tests/test_scheduler.py (_mixed_events)."""
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(n):
        k = int(rng.integers(0, 3))
        events.append((k, int(rng.integers(0, n_funcs)),
                       -1 if k == 0 else int(rng.integers(0, n_workers))))
    return np.array(events, np.int32).reshape(-1, 3)


def _burst(R, F, W, seed):
    """The (R, F, W) bursts of tests/test_kernels.py, with a random state."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, R)
    funcs = rng.integers(0, F, R)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, R))
    idle = rng.integers(0, 3, (F, W))
    conns = rng.integers(0, 5, W)
    return [np.asarray(a, np.int32) for a in (kinds, funcs, workers, idle, conns)]


def _jax_scan(idle, conns, events):
    s, (ws, warm) = J.sched_many(J.JIQState(jnp.asarray(idle), jnp.asarray(conns)),
                                 jnp.asarray(events))
    return [np.asarray(a) for a in (ws, warm, s.idle, s.conns)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _assert_same(port, want):
    for got, w in zip(port, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(got.astype(np.int64), np.asarray(w).astype(np.int64))


_EVICT = np.array([(0, 0, -1), (1, 0, 0), (2, 0, 0), (0, 0, -1)], np.int32)

STREAMS = {
    "evict": (2, 3, _EVICT),
    "mixed5": (6, 9, _mixed(5, 150)),
    "mixed7": (6, 9, _mixed(7, 300)),
    "mixed11": (6, 9, _mixed(11, 130)),
    "wide130": (40, 130, _mixed(3, 400, 40, 130)),
    # an arrival burst then mixed traffic: fused chunks inside the burst take
    # the ARRIVAL-only specialisation (ops.sched_step)
    "burst": (6, 9, np.concatenate([
        np.stack([np.zeros(130), np.random.default_rng(2).integers(0, 6, 130), -np.ones(130)], 1),
        _mixed(13, 150)]).astype(np.int32)),
}


def _state(F, W, seed=None):
    if seed is None:
        return np.zeros((F, W), np.int32), np.zeros((W,), np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, (F, W)).astype(np.int32), rng.integers(0, 5, W).astype(np.int32)


# ------------------------------------------------------------ plain scan
@pytest.mark.parametrize("start", ["empty", "random"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_sched_many_matches_jax(name, start):
    F, W, ev = STREAMS[name]
    idle, conns = _state(F, W, None if start == "empty" else 17)
    want = _jax_scan(idle, conns, ev)
    s, (ws, warm) = T.sched_many(T.JIQState(_t(idle), _t(conns)), _t(ev))
    _assert_same((ws, warm, s.idle, s.conns), want)
    assert T.check_invariants(s)


def test_sched_step_one_event_matches_jax():
    idle, conns = _state(6, 9, 4)
    state = T.JIQState(_t(idle), _t(conns))
    for ev in _mixed(21, 40):
        jstate, (jw, jwarm) = J.sched_step(J.JIQState(jnp.asarray(np.asarray(state.idle)),
                                                      jnp.asarray(np.asarray(state.conns))),
                                           jnp.asarray(ev))
        state, (w, warm) = T.sched_step(state, ev.tolist())
        assert (w, warm) == (int(jw), bool(jwarm))
        _assert_same((state.idle, state.conns), (jstate.idle, jstate.conns))


# ------------------------------------------------------------ fused path
@pytest.mark.parametrize("chunk", [1, 7, 64, 149, 150, 1024])
@pytest.mark.parametrize("name", ["mixed5", "wide130", "burst"])
def test_sched_many_fused_matches_jax(name, chunk):
    F, W, ev = STREAMS[name]
    idle, conns = _state(F, W, 9)
    want = _jax_scan(idle, conns, ev)
    s, (ws, warm) = T.sched_many_fused(T.JIQState(_t(idle), _t(conns)), _t(ev),
                                       chunk=chunk, device=CPU)
    assert warm.dtype == torch.bool
    _assert_same((ws, warm, s.idle, s.conns), want)


def test_sched_many_fused_edges():
    empty = np.zeros((0, 3), np.int32)
    s, (ws, warm) = T.sched_many_fused(T.init_state(2, 2, CPU), _t(empty), device=CPU)
    assert ws.shape == (0,) and warm.shape == (0,) and int(s.idle.sum()) == 0
    with pytest.raises(ValueError):
        T.sched_many_fused(T.init_state(2, 2, CPU), _t(_EVICT), chunk=0, device=CPU)


# --------------------------------------------------------- adaptive path
class _Spy:
    """Records the chunk sizes a detector answers."""

    def __init__(self, det):
        self.det, self.chunks = det, []

    def observe(self, density):
        self.chunks.append(self.det.observe(density))
        return self.chunks[-1]


@pytest.mark.parametrize(
    "stream,segment,densities,thresholds",
    [
        ("mixed7", 80, [0.0, 500.0, 500.0, 0.0], ((100.0, 64),)),  # switches mid-stream
        ("mixed11", 64, None, ((64.0, 32),)),                       # own event counts
        ("wide130", 50, [10.0, 900.0, 300.0, 0.0, 2000.0, 0.0, 0.0, 900.0], ((1000.0, 128), (200.0, 16))),
    ],
)
def test_sched_many_adaptive_matches_jax(stream, segment, densities, thresholds):
    F, W, ev = STREAMS[stream]
    want = _jax_scan(*_state(F, W), ev)
    det = _Spy(T.BurstDetector(alpha=1.0, thresholds=thresholds, base_chunk=1))
    s, (ws, warm) = T.sched_many_adaptive(T.init_state(F, W, CPU), _t(ev), det,
                                          densities=densities, segment=segment, device=CPU)
    assert min(det.chunks) == 1 and max(det.chunks) > 1  # both routes were taken
    _assert_same((ws, warm, s.idle, s.conns), want)


def test_sched_many_adaptive_edges():
    det = T.BurstDetector()
    s, (ws, warm) = T.sched_many_adaptive(T.init_state(2, 2, CPU), _t(np.zeros((0, 3), np.int32)),
                                          det, device=CPU)
    assert ws.shape == (0,) and warm.shape == (0,) and det.ewma == 0.0
    ev = _t(STREAMS["mixed11"][2])
    with pytest.raises(ValueError):
        T.sched_many_adaptive(T.init_state(6, 9, CPU), ev, det, densities=[1.0], segment=64, device=CPU)
    with pytest.raises(ValueError):
        T.sched_many_adaptive(T.init_state(6, 9, CPU), ev, det, segment=0, device=CPU)
    # with a generator the whole stream takes the plain scan, on the same draws
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    sa, (wa, _) = T.sched_many(T.init_state(6, 9, CPU), ev, g1)
    sb, (wb, _) = T.sched_many_adaptive(T.init_state(6, 9, CPU), ev, det, generator=g2, device=CPU)
    assert torch.equal(wa, wb) and torch.equal(sa.conns, sb.conns)


# ------------------------------------------------------ plain versions
@pytest.mark.parametrize("R,F,W", [(32, 4, 8), (100, 10, 16), (57, 3, 5), (128, 40, 130)])
def test_sched_events_ref_matches_jax(R, F, W):
    args = _burst(R, F, W, R * 1000 + W)
    want = jref.sched_events_ref(*[jnp.asarray(a) for a in args])
    _assert_same(ref.sched_events_ref(*[_t(a) for a in args]), want)
    # on the CPU the wrapper is the plain version and launches nothing
    ops.reset_launches()
    _assert_same(ops.sched_events(*[_t(a) for a in args]), want)
    assert ops.LAUNCHES["sched_events"] == 0


@pytest.mark.parametrize("R,F,W", [(16, 4, 8), (64, 10, 16), (8, 1, 4), (128, 40, 5)])
def test_sched_step_ref_matches_jax(R, F, W):
    _, funcs, _, idle, conns = _burst(R, F, W, R + F + W)
    want = jref.sched_step_ref(jnp.asarray(funcs), jnp.asarray(idle), jnp.asarray(conns))
    got = ref.sched_step_ref(_t(funcs), _t(idle), _t(conns))
    assert got[1].dtype == torch.bool
    _assert_same(got, want)
    ops.reset_launches()
    _assert_same(ops.sched_step(_t(funcs), _t(idle), _t(conns)), want)
    assert ops.LAUNCHES["sched_step"] == 0


ADVERSARIAL = [("sat300", 200, 3, 40), ("sat70000", 200, 3, 40), ("empty", 300, 6, 40),
               ("ties", 300, 6, 40), ("pad", 300, 6, 33), ("bigconns", 300, 6, 40),
               ("random", 300, 5, 31)]


@pytest.mark.parametrize("case,R,F,W", ADVERSARIAL)
def test_sched_events_ref_adversarial_matches_jax(case, R, F, W):
    """The bursts the kernel's tests aim at its edges (idle counts past a
    byte, rows with nothing idle, all ties, padding kinds, conns past the
    on-chip key field, W < 32), through the plain version and the CPU
    wrapper, against JAX's scan."""
    kinds, funcs, workers, idle, conns = (a.numpy() for a in sched_case(case, R, F, W, R + W))
    want = _jax_scan(idle, conns, np.stack([kinds, funcs, workers], 1))
    args = [_t(a) for a in (kinds, funcs, workers, idle, conns)]
    _assert_same(ref.sched_events_ref(*args), want)
    _assert_same(ops.sched_events(*args), want)


@pytest.mark.parametrize("case,R,F,W", [c for c in ADVERSARIAL if c[0] != "sat70000"])
def test_sched_step_ref_adversarial_matches_jax(case, R, F, W):
    _, funcs, _, idle, conns = (a.numpy() for a in sched_case(case, R, F, W, R + W))
    want = jref.sched_step_ref(jnp.asarray(funcs), jnp.asarray(idle), jnp.asarray(conns))
    _assert_same(ref.sched_step_ref(_t(funcs), _t(idle), _t(conns)), want)


def test_sched_wrappers_take_strided_columns():
    """On the CPU too, the columns of one (R, 3) event tensor as strided
    views give what contiguous copies give."""
    kinds, funcs, workers, idle, conns = (_t(a) for a in _burst(200, 6, 40, 8))
    ev = torch.stack([kinds, funcs, workers], 1)
    assert ev[:, 0].stride(0) == 3
    _assert_same(ops.sched_events(ev[:, 0], ev[:, 1], ev[:, 2], idle, conns),
                 ops.sched_events(kinds, funcs, workers, idle, conns))
    _assert_same(ops.sched_step(ev[:, 1], idle, conns), ops.sched_step(funcs, idle, conns))


# ------------------------------------------------------- keyed ties
@pytest.mark.parametrize(
    "idle_row,tied",
    [([0, 0, 0, 0], {0, 1, 2, 3}),   # fallback: every worker tied at 0 conns
     ([1, 0, 1, 1], {0, 2, 3})],     # pull: ties among the enqueued workers only
)
def test_keyed_tiebreak_uniform(idle_row, tied):
    """With a generator, exact ties are broken uniformly (Algorithm 1 l.10)."""
    g = torch.Generator().manual_seed(0)
    state = T.JIQState(torch.tensor([idle_row], dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    counts = dict.fromkeys(range(4), 0)
    n = 3000
    for _ in range(n):
        _, (w, warm) = T.sched_step(state, (T.ARRIVAL, 0, -1), g)
        counts[w] += 1
        assert warm == any(idle_row)
    expect = n / len(tied)
    for w in range(4):
        if w in tied:  # ~5 standard deviations either side
            assert abs(counts[w] - expect) < 5 * (expect * (1 - 1 / len(tied))) ** 0.5
        else:
            assert counts[w] == 0


# ------------------------------------------------------ burst detector
@pytest.mark.parametrize(
    "alpha,thresholds,base,samples",
    [
        (0.5, ((1000.0, 1024), (100.0, 128)), 1, [2000, 0, 0, 0, 0, 0]),
        (0.25, ((4096.0, 4096), (1024.0, 1024), (256.0, 256)), 1, [10, 5000, 5000, 300, 0, 9000]),
        (1.0, ((64.0, 32),), 4, [64, 63, 0, 100]),
    ],
)
def test_burst_detector_copy_matches_jax(alpha, thresholds, base, samples):
    a, b = T.BurstDetector(alpha, thresholds, base), JaxBurstDetector(alpha, thresholds, base)
    for d in samples:
        assert a.observe(d) == b.observe(d)
        assert a.ewma == b.ewma and a.chunk == b.chunk


@pytest.mark.parametrize("kw", [dict(alpha=0.0), dict(base_chunk=0),
                                dict(thresholds=((1.0, 0),)), dict(thresholds=((1.0, 4), (2.0, 8)))])
def test_burst_detector_rejects_bad_args(kw):
    with pytest.raises(ValueError):
        T.BurstDetector(**kw)


def test_check_invariants_flags_negative_state():
    assert T.check_invariants(T.init_state(2, 3, CPU))
    assert not T.check_invariants(T.JIQState(torch.tensor([[0, -1]], dtype=torch.int32),
                                             torch.zeros(2, dtype=torch.int32)))


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    ev = _t(_EVICT)
    with pytest.raises(RuntimeError):
        T.init_state(2, 3)
    with pytest.raises(RuntimeError):
        T.sched_many_fused(T.init_state(2, 3, CPU), ev)
    with pytest.raises(RuntimeError):
        T.sched_many_adaptive(T.init_state(2, 3, CPU), ev, T.BurstDetector())
