"""The one traffic generator: a mix file (``traffic/<name>.json``) and a
seed give a deployment and a request stream.

Every seed gets the same work.  The mix's ``stream_seed`` fixes the
stream's shape as a recorded invocation trace would: a window of
``seconds`` at ``rate`` requests/s holds ``N = round(rate * seconds)``
requests, their gaps the N quantiles of the exponential distribution of
that rate (an open-loop Poisson stream), their prompt lengths the N
quantiles of the mix's log-uniform lengths, their functions the mix's
invocation weights times N rounded by largest remainder, each list in an
order drawn from ``stream_seed``, which also seeds the scheduler's
tie-break.  The seed draws the prompts' tokens: what the model reads and
the check compares is new in every run, while when each request comes,
how long it is and which requests start cold are not.  (Letting the seed
reorder the gaps and the lengths moved a window's 90th percentile by 10 to
30 % between seeds: a change of work, not of inputs.)

The warm-up that precedes the window is drawn the same way, request after
request until the mix's ``warmup`` rule holds (``fill``: every worker holds
an instance; ``rounds``: one request per function, in a drawn order, round
after round until a whole round is warm).  The harness serves it and asks
``warmup_done`` after each request.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator, List

import numpy as np

#: the longest warm-up the rules may take, in requests
MAX_WARMUP = 256


@dataclasses.dataclass(frozen=True)
class Request:
    func: int            # index of the mix's function
    due_s: float         # seconds from the window's start (0 in the warm-up)
    tokens: np.ndarray   # prompt token ids, int64
    gen_len: int


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    functions: int
    weights: tuple           # invocation probabilities, one a function
    weight_seed_base: int    # function i's weights come from seed base + i
    workers: int
    pool_bytes: int
    keep_alive_s: float
    scheduler: str
    prompt_min: int
    prompt_max: int
    gen_len: int
    warmup: str
    stream_seed: int         # draws the functions' order and the tie-breaks

    @staticmethod
    def load(path: Path) -> "Mix":
        d = json.loads(Path(path).read_text())
        w = np.asarray(d["invocation_weights"], dtype=np.float64)
        if len(w) != d["functions"] or abs(w.sum() - 1.0) > 1e-9 or (w < 0).any():
            raise ValueError(f"{path}: invocation_weights must be {d['functions']} "
                             "non-negative numbers summing to 1")
        if d["warmup"] not in ("fill", "rounds"):
            raise ValueError(f"{path}: unknown warmup rule {d['warmup']!r}")
        if d["arrivals"] != "poisson" or d["prompt_len"]["dist"] != "loguniform":
            raise ValueError(f"{path}: the generator draws Poisson arrivals and log-uniform "
                             "prompt lengths only")
        return Mix(name=Path(path).stem, functions=d["functions"], weights=tuple(w.tolist()),
                   weight_seed_base=d["weight_seed_base"], workers=d["workers"],
                   pool_bytes=int(d["pool_gib"] * 2**30), keep_alive_s=d["keep_alive_s"],
                   scheduler=d["scheduler"], prompt_min=d["prompt_len"]["min"],
                   prompt_max=d["prompt_len"]["max"], gen_len=d["gen_len"],
                   warmup=d["warmup"], stream_seed=d["stream_seed"])


def _loguniform_quantiles(n: int, lo: int, hi: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))).astype(np.int64)


def function_counts(weights, n: int, rng: np.random.Generator) -> np.ndarray:
    """``weights * n`` rounded by largest remainder to counts summing to
    ``n``; equal remainders are ranked in a random order from ``rng``."""
    w = np.asarray(weights, dtype=np.float64) * n
    counts = np.floor(w).astype(np.int64)
    rem = w - counts
    order = np.lexsort((rng.permutation(len(w)), -rem))  # largest remainder, ties at random
    counts[order[: n - counts.sum()]] += 1
    return counts


def window(mix: Mix, seed: int, seconds: float, rate: float, vocab: int) -> List[Request]:
    """The measured window's requests in due order."""
    rng = np.random.default_rng([seed, 1])
    n = max(1, int(round(rate * seconds)))
    fixed = np.random.default_rng([mix.stream_seed, n, 1])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.concatenate([[0.0], np.cumsum(fixed.permutation(gaps))[:-1]])
    lengths = fixed.permutation(_loguniform_quantiles(n, mix.prompt_min, mix.prompt_max))
    funcs = fixed.permutation(np.repeat(np.arange(mix.functions),
                                        function_counts(mix.weights, n, fixed)))
    return [Request(int(f), float(t), rng.integers(0, vocab, int(s), dtype=np.int64), mix.gen_len)
            for f, t, s in zip(funcs, due, lengths)]


def warmup(mix: Mix, seed: int, vocab: int) -> Iterator[Request]:
    """The warm-up's requests, drawn as they are asked for.  The first has
    the mix's longest prompt, so that the window asks no larger buffers of
    the allocator than the warm-up did."""
    rng = np.random.default_rng([seed, 2])
    fixed = np.random.default_rng([mix.stream_seed, 2])
    lo, hi = np.log(mix.prompt_min), np.log(mix.prompt_max)
    p = np.asarray(mix.weights)
    for i in range(MAX_WARMUP):
        if mix.warmup == "rounds":
            if i % mix.functions == 0:
                order = fixed.permutation(mix.functions)
            f = int(order[i % mix.functions])
        else:
            f = int(fixed.choice(mix.functions, p=p))
        s = mix.prompt_max if i == 0 else int(np.rint(np.exp(fixed.uniform(lo, hi))))
        yield Request(f, 0.0, rng.integers(0, vocab, s, dtype=np.int64), mix.gen_len)


def warmup_done(mix: Mix, served: list, holders: List[List[int]]) -> bool:
    """Whether the warm-up may end, after the requests ``served`` so far
    ((func, cold) pairs) and with ``holders[w]`` the functions worker ``w``
    holds idle instances of."""
    if mix.warmup == "fill":
        return all(holders)
    k = mix.functions
    return len(served) >= k and len(served) % k == 0 and not any(c for _, c in served[-k:])
