"""Vectorized, bit-exact per-request service-time RNG.

A copy of the JAX package's ``core/fastrng.py`` (pure numpy), with its own
copy of the learned ziggurat tables (``zig_tables.json`` beside this file,
byte for byte the JAX package's).  The tables are learned against numpy's own
generator and are never regenerated in place: :func:`write_tables` takes the
path to write explicitly.

The simulator seeds every request's service-time fluctuation by identity:
``np.random.default_rng((seed, vu, ev_idx)).lognormal(mean, sigma)`` — the
paper's fairness device (every scheduler replays identical stochastic
demand).  Constructing a fresh ``Generator`` per request costs ~10µs and was
the single largest item in the simulator profile.

This module computes the *same* doubles vectorized over the whole
``(vu, ev_idx)`` grid at ~0.1–0.3µs per draw by reimplementing, in numpy
array arithmetic, the exact pipeline a fresh ``default_rng(tuple)`` executes
for one lognormal draw:

  1. ``SeedSequence`` entropy pool mixing (uint32 hash mixing, pool size 4);
  2. ``PCG64`` seeding from ``generate_state(4, uint64)`` plus the first
     state advance (128-bit LCG emulated on uint64 hi/lo pairs) and the
     XSL-RR output function;
  3. the first iteration of the ziggurat ``standard_normal`` rejection
     sampler — the branch taken ~98.5% of the time;
  4. ``exp(mean + sigma * z)``.

For step 3 the ziggurat tables (``wi_double``/``ki_double``) are not exposed
by numpy, so ``learn_tables`` recovers them *observationally*: it draws
known-stream samples from real ``Generator`` objects and solves for the only
``wi[idx]`` double consistent with every observed ``(rabs, |z|)`` pair, and
records the largest first-draw-accepted ``rabs`` per idx as a conservative
acceptance bound.  Any draw the fast path cannot *prove* it reproduces
(rejection iterations, tail/wedge branches, unlearned idx, out-of-range
entropy) falls back to a per-element ``default_rng`` call — so the output is
bit-identical by construction, fast path or not.

A one-shot runtime self-test (:func:`selftest`) cross-checks a few hundred
tuples against ``default_rng`` on first use; on any mismatch (e.g. a numpy
upgrade changing the stream) the module degrades to the slow path globally.
"""

from __future__ import annotations

import json
import math
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "lognormal_matrix",
    "uniform_block",
    "learn_tables",
    "selftest",
    "selftest_uniform",
    "write_tables",
]

_TABLE_PATH = Path(__file__).with_name("zig_tables.json")

# ---------------------------------------------------------------- constants
# SeedSequence hash constants (numpy/random/bit_generator.pyx).
_XSHIFT = np.uint32(16)
_INIT_A = 0x43B0D7E5
_MULT_A = 0x931E8875
_INIT_B = 0x8B51F9DD
_MULT_B = 0x58F38DED
_MIX_L = np.uint32(0xCA01F9DD)
_MIX_R = np.uint32(0x4973F715)
_M32 = 0xFFFFFFFF

# PCG64 default multiplier (numpy/random/src/pcg64/pcg64.h), as hi/lo words.
_PCG_MULT_HI = np.uint64(2549297995355413924)
_PCG_MULT_LO = np.uint64(4865540595714422341)

_LO32 = np.uint64(0xFFFFFFFF)
_U64_1 = np.uint64(1)
_U64_32 = np.uint64(32)
_U64_63 = np.uint64(63)
_RABS_MASK = np.uint64(0x000FFFFFFFFFFFFF)


# ------------------------------------------------------------ 128-bit limbs
def _mul64_full(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Full 64x64 -> 128 multiply on uint64 arrays, as (hi, lo)."""
    a0 = a & _LO32
    a1 = a >> _U64_32
    b0 = b & _LO32
    b1 = b >> _U64_32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = (p00 >> _U64_32) + (p01 & _LO32) + (p10 & _LO32)
    lo = (p00 & _LO32) | ((mid & _LO32) << _U64_32)
    hi = a1 * b1 + (p01 >> _U64_32) + (p10 >> _U64_32) + (mid >> _U64_32)
    return hi, lo


def _pcg_step(sh, sl, inch, incl):
    """state = state * PCG_MULT + inc   (mod 2**128), vectorized."""
    hi, lo = _mul64_full(sl, _PCG_MULT_LO)
    hi = hi + sl * _PCG_MULT_HI + sh * _PCG_MULT_LO
    lo2 = lo + incl
    carry = (lo2 < lo).astype(np.uint64)
    return hi + inch + carry, lo2


def _pcg_output(sh, sl):
    """XSL-RR 128 -> 64 output function."""
    rot = sh >> np.uint64(58)
    xored = sh ^ sl
    return (xored >> rot) | (xored << ((np.uint64(64) - rot) & _U64_63))


# ------------------------------------------------------- SeedSequence stages
def _hashmix(v: np.ndarray, hc: int) -> Tuple[np.ndarray, int]:
    """One hashmix() call; ``hc`` is the evolving scalar hash constant."""
    v = v ^ np.uint32(hc)
    hc = (hc * _MULT_A) & _M32
    v = v * np.uint32(hc)
    v = v ^ (v >> _XSHIFT)
    return v, hc


def _mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    r = x * _MIX_L - y * _MIX_R
    return r ^ (r >> _XSHIFT)


def _seedseq_state4(words) -> Tuple[np.ndarray, ...]:
    """``SeedSequence(words).generate_state(4, uint64)`` for 3-word entropy.

    ``words`` are three broadcast-compatible uint32 arrays; returns four
    uint64 arrays (the PCG64 initstate/initseq words).
    """
    with np.errstate(over="ignore"):
        hc = _INIT_A
        pool = []
        for i in range(4):
            src = words[i] if i < len(words) else np.asarray(0, np.uint32)
            v, hc = _hashmix(src, hc)
            pool.append(v)
        for i_src in range(4):
            for i_dst in range(4):
                if i_src != i_dst:
                    h, hc = _hashmix(pool[i_src], hc)
                    pool[i_dst] = _mix(pool[i_dst], h)
        # entropy is never longer than the pool here (3 words < 4): done.
        hc = _INIT_B
        out32 = []
        for i in range(8):
            v = pool[i % 4] ^ np.uint32(hc)
            hc = (hc * _MULT_B) & _M32
            v = v * np.uint32(hc)
            out32.append(v ^ (v >> _XSHIFT))
        return tuple(
            out32[2 * i].astype(np.uint64) | (out32[2 * i + 1].astype(np.uint64) << _U64_32)
            for i in range(4)
        )


def _init_state(seed: int, vu: np.ndarray, ev: np.ndarray):
    """Freshly seeded PCG64 state for ``default_rng((seed, vu, ev))``.

    Returns ``(sh, sl, inch, incl)`` uint64 arrays: the 128-bit state a new
    generator holds *before* its first draw, plus the stream increment.
    """
    # 0-d array, not np.uint32 scalar: scalar uint ops emit overflow warnings
    w = (np.asarray(seed, np.uint32), vu.astype(np.uint32), ev.astype(np.uint32))
    v0, v1, v2, v3 = _seedseq_state4(w)
    # pcg64_set_seed: state=0; step; state+=initstate; step.
    inch = (v2 << _U64_1) | (v3 >> _U64_63)
    incl = (v3 << _U64_1) | _U64_1
    sl = incl + v1  # state=0 -> first step yields state=inc; then +initstate
    carry = (sl < incl).astype(np.uint64)
    sh = inch + v0 + carry
    sh, sl = _pcg_step(sh, sl, inch, incl)
    return sh, sl, inch, incl


def _first_uint64(seed: int, vu: np.ndarray, ev: np.ndarray):
    """The first uint64 a fresh ``default_rng((seed, vu, ev))`` would draw."""
    sh, sl, inch, incl = _init_state(seed, vu, ev)
    sh, sl = _pcg_step(sh, sl, inch, incl)  # advance consumed by the draw
    return _pcg_output(sh, sl)


# --------------------------------------------------- per-VU uniform streams
# next_double() for PCG64: (next_uint64 >> 11) * 2**-53.
_DOUBLE_SCALE = 1.0 / 9007199254740992.0
_U64_11 = np.uint64(11)

_SELFTEST_U_OK: Optional[bool] = None


def _init_state2(seed: int, vu: np.ndarray):
    """Freshly seeded PCG64 state for ``default_rng((seed, vu))``.

    The 2-word-entropy sibling of :func:`_init_state` (same SeedSequence
    pool mixing — entropy shorter than the pool takes the identical
    schedule), used for whole per-VU *streams* rather than one draw.
    """
    w = (np.asarray(seed, np.uint32), vu.astype(np.uint32))
    v0, v1, v2, v3 = _seedseq_state4(w)
    inch = (v2 << _U64_1) | (v3 >> _U64_63)
    incl = (v3 << _U64_1) | _U64_1
    sl = incl + v1
    carry = (sl < incl).astype(np.uint64)
    sh = inch + v0 + carry
    return _pcg_step(sh, sl, inch, incl) + (inch, incl)


def _uniform_block_impl(seed: int, n_vus: int, n_draws: int, vu_start: int = 0) -> np.ndarray:
    vu = np.arange(vu_start, vu_start + n_vus, dtype=np.uint32)
    sh, sl, inch, incl = _init_state2(seed, vu)
    out = np.empty((n_draws, n_vus))
    for _ in range(n_draws):
        sh, sl = _pcg_step(sh, sl, inch, incl)
        out[_] = (_pcg_output(sh, sl) >> _U64_11) * _DOUBLE_SCALE
    return np.ascontiguousarray(out.T)


def _slow_uniform_block(seed: int, n_vus: int, n_draws: int, vu_start: int = 0) -> np.ndarray:
    return np.array(
        [
            np.random.default_rng((seed, v)).random(n_draws)
            for v in range(vu_start, vu_start + n_vus)
        ]
    ).reshape(n_vus, n_draws)


def selftest_uniform(n: int = 64) -> bool:
    """Cross-check :func:`uniform_block` against per-VU ``default_rng`` once.

    Cached; on mismatch every subsequent ``uniform_block`` call takes the
    per-VU slow path (still bit-exact, just not fast)."""
    global _SELFTEST_U_OK
    if _SELFTEST_U_OK is None:
        try:
            got = _uniform_block_impl(192837, 8, n, vu_start=3)
            want = _slow_uniform_block(192837, 8, n, vu_start=3)
            _SELFTEST_U_OK = bool(np.array_equal(got, want))
        except Exception:
            _SELFTEST_U_OK = False
    return _SELFTEST_U_OK


def uniform_block(seed: int, n_vus: int, n_draws: int, vu_start: int = 0) -> np.ndarray:
    """(n_vus, n_draws) matrix whose row ``i`` is bit-identical to
    ``np.random.default_rng((seed, vu_start + i)).random(n_draws)``.

    These raw doubles are the substrate for any per-VU seeded draw sequence
    (``trace.make_vu_programs`` rebuilds its weighted choices and think
    times from them); vectorizing the PCG64 streams removes the per-VU
    ``Generator`` construction that dominates workload generation at
    mega-VU scale."""
    if n_vus <= 0 or n_draws <= 0:
        return np.zeros((max(n_vus, 0), max(n_draws, 0)))
    seed = int(seed)
    if not (0 <= seed < 2**32) or not selftest_uniform():
        if 0 <= seed < 2**32:
            _warn_fallback_once()
        return _slow_uniform_block(seed, n_vus, n_draws, vu_start=vu_start)
    return _uniform_block_impl(seed, n_vus, n_draws, vu_start=vu_start)


# ------------------------------------------------------------------- tables
_TABLES: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
_SELFTEST_OK: Optional[bool] = None
_FALLBACK_WARNED = False


def _warn_fallback_once() -> None:
    """One warning per process when the self-test disables the fast path.

    The slow path is engaged on *every* subsequent call, so the guard keeps
    a degraded environment (e.g. a numpy upgrade that changed the PCG64 /
    ziggurat stream) from spamming a warning per matrix request while still
    surfacing the ~50x slowdown once.
    """
    global _FALLBACK_WARNED
    if not _FALLBACK_WARNED:
        _FALLBACK_WARNED = True
        warnings.warn(
            "fastrng fast path disabled (runtime self-test mismatch with this "
            "numpy's default_rng stream); falling back to per-tuple "
            "default_rng draws — still bit-exact, but ~50x slower",
            RuntimeWarning,
            stacklevel=3,
        )


def _load_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wi, ki_safe, usable) arrays from the checked-in learned tables."""
    global _TABLES
    if _TABLES is None:
        wi = np.full(256, np.nan)
        ki = np.zeros(256, np.uint64)
        usable = np.zeros(256, bool)
        try:
            raw = json.loads(_TABLE_PATH.read_text())
            for k, hexval in raw["wi"].items():
                i = int(k)
                wi[i] = float.fromhex(hexval)
                ki[i] = int(raw["ki"][k])
                usable[i] = True
        except (OSError, KeyError, ValueError):
            pass  # no tables -> fast path never accepts, slow path still exact
        _TABLES = (wi, ki, usable)
    return _TABLES


def _slow_one(seed: int, vu: int, ev: int, mean: float, sigma: float) -> float:
    return float(np.random.default_rng((seed, vu, ev)).lognormal(mean=mean, sigma=sigma))


# Reusable generator for fast-path rejects: resetting PCG64 state to the
# (already vectorized-computed) freshly seeded state skips the ~7µs
# SeedSequence construction and replays the identical stream.
_FB_BG = np.random.PCG64()
_FB_GEN = np.random.Generator(_FB_BG)


def _slow_from_state(state: int, inc: int, mean: float, sigma: float) -> float:
    _FB_BG.state = {
        "bit_generator": "PCG64",
        "state": {"state": state, "inc": inc},
        "has_uint32": 0,
        "uinteger": 0,
    }
    return float(_FB_GEN.lognormal(mean=mean, sigma=sigma))


def selftest(n: int = 384) -> bool:
    """Cross-check the fast path against per-tuple ``default_rng`` once.

    Cached; on mismatch the module permanently falls back to the slow path
    (still bit-exact, just not fast).
    """
    global _SELFTEST_OK
    if _SELFTEST_OK is None:
        try:
            seed, vus, evs = 987654, 6, max(1, n // 6)
            got = _lognormal_matrix_impl(seed, vus, evs, -0.03125, 0.25, check=False)
            want = np.array(
                [[_slow_one(seed, v, e, -0.03125, 0.25) for e in range(evs)] for v in range(vus)]
            )
            _SELFTEST_OK = bool(np.array_equal(got, want))
        except Exception:
            _SELFTEST_OK = False
    return _SELFTEST_OK


def _lognormal_matrix_impl(
    seed: int,
    n_vus: int,
    n_events: int,
    mean: float,
    sigma: float,
    check: bool = True,
    ev_start: int = 0,
    vu_start: int = 0,
) -> np.ndarray:
    if check and not selftest():
        _warn_fallback_once()
        return np.array(
            [
                [_slow_one(seed, v, e, mean, sigma) for e in range(ev_start, ev_start + n_events)]
                for v in range(vu_start, vu_start + n_vus)
            ]
        )
    wi, ki_safe, usable = _load_tables()
    vu = np.repeat(np.arange(vu_start, vu_start + n_vus, dtype=np.uint32), n_events)
    ev = np.tile(np.arange(ev_start, ev_start + n_events, dtype=np.uint32), n_vus)
    sh0, sl0, inch, incl = _init_state(seed, vu, ev)
    sh, sl = _pcg_step(sh0, sl0, inch, incl)  # advance consumed by the draw
    r = _pcg_output(sh, sl)
    idx = (r & np.uint64(0xFF)).astype(np.intp)
    rr = r >> np.uint64(8)
    sign = (rr & _U64_1).astype(bool)
    rabs = (rr >> _U64_1) & _RABS_MASK
    # Fast-accept only when provably inside the learned acceptance region.
    ok = usable[idx] & (rabs <= ki_safe[idx])
    z = rabs.astype(np.float64) * wi[idx]
    z = np.where(sign, -z, z)
    # scalar libm exp, NOT np.exp: numpy's SIMD exp differs from the C
    # ``exp()`` inside random_lognormal by 1 ulp on some inputs
    arg = mean + sigma * z
    out = np.fromiter(map(math.exp, arg.tolist()), np.float64, count=arg.size)
    if not ok.all():
        for flat in np.flatnonzero(~ok):
            state = (int(sh0[flat]) << 64) | int(sl0[flat])
            inc = (int(inch[flat]) << 64) | int(incl[flat])
            out[flat] = _slow_from_state(state, inc, mean, sigma)
    return out.reshape(n_vus, n_events)


def lognormal_matrix(
    seed: int,
    n_vus: int,
    n_events: int,
    mean: float,
    sigma: float,
    ev_start: int = 0,
    vu_start: int = 0,
) -> np.ndarray:
    """(n_vus, n_events) matrix whose entry [i, j] is bit-identical to
    ``np.random.default_rng((seed, vu_start + i, ev_start + j)).lognormal(mean, sigma)``.

    ``ev_start`` extends a band rightward (more events per VU); ``vu_start``
    generates rows for a VU range, which is how dynamically admitted VUs get
    their fluctuation row without recomputing the whole band."""
    if n_vus <= 0 or n_events <= 0:
        return np.zeros((max(n_vus, 0), max(n_events, 0)))
    seed = int(seed)
    if not (0 <= seed < 2**32):  # multi-word entropy: different mix schedule
        return np.array(
            [
                [_slow_one(seed, v, e, mean, sigma) for e in range(ev_start, ev_start + n_events)]
                for v in range(vu_start, vu_start + n_vus)
            ]
        )
    return _lognormal_matrix_impl(
        seed, n_vus, n_events, mean, sigma, ev_start=ev_start, vu_start=vu_start
    )


# ----------------------------------------------------------- table learning
def learn_tables(n_draws: int = 200_000, min_samples: int = 3):
    """Recover ``wi``/acceptance-bound tables by observing real Generators.

    For entropy tuples ``(0, 0, e)`` we compute the first raw uint64 via the
    vectorized pipeline, draw ``standard_normal()`` from an identically
    seeded ``Generator``, and keep samples whose post-draw PCG64 state shows
    exactly one advance (first-draw ziggurat accept).  ``wi[idx]`` is then
    the unique double with ``rabs * wi == |z|`` across every sample of that
    idx; the acceptance bound is the largest accepted ``rabs`` observed.
    """
    ev = np.arange(n_draws, dtype=np.uint32)
    vu = np.zeros(n_draws, np.uint32)
    sh0, sl0, inch, incl = _init_state(0, vu, ev)
    sh, sl = _pcg_step(sh0, sl0, inch, incl)  # state after one consumed draw
    r = _pcg_output(sh, sl)
    idx_a = (r & np.uint64(0xFF)).astype(np.intp)
    rabs_a = ((r >> np.uint64(9)) & _RABS_MASK).astype(np.uint64)
    samples: dict = {}
    for e in range(n_draws):
        g = np.random.default_rng((0, 0, e))
        z = g.standard_normal()
        st = g.bit_generator.state["state"]["state"]
        if st == (int(sh[e]) << 64) | int(sl[e]):
            samples.setdefault(int(idx_a[e]), []).append((int(rabs_a[e]), abs(z)))
    wi_out, ki_out = {}, {}
    for idx, ss in samples.items():
        if len(ss) < min_samples:
            continue
        rab0, z0 = max(ss)
        if rab0 == 0:
            continue
        cands = {np.float64(z0) / np.float64(rab0)}
        for _ in range(3):
            cands.add(np.nextafter(max(cands), np.inf))
            cands.add(np.nextafter(min(cands), -np.inf))
        good = [c for c in cands if all(np.float64(ra) * c == zv for ra, zv in ss)]
        if len(good) != 1:
            continue
        wi_out[str(idx)] = float(good[0]).hex()
        ki_out[str(idx)] = max(ra for ra, _ in ss)
    return {"wi": wi_out, "ki": ki_out, "n_draws": n_draws, "numpy": np.__version__}


def write_tables(path: Path, n_draws: int = 200_000) -> Path:
    """Learn the tables and write them to ``path`` (never the checked-in
    ``zig_tables.json``: pass a scratch path to probe a numpy version)."""
    path = Path(path)
    if path.resolve() == _TABLE_PATH.resolve():
        raise ValueError(f"refusing to overwrite the checked-in tables at {path}")
    path.write_text(json.dumps(learn_tables(n_draws), indent=0))
    return path
