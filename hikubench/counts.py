"""The yardstick's arithmetic: each kernel's least work and a served
request's model operations, from shapes alone, and the card's peaks.

The kernel counts are a frozen copy of the port's ``kernels/counts.py``
(``flash_counts``, ``decode_counts`` and ``live_pairs``): a
later change to a kernel cannot change the work it is measured against.
Bytes count each input read once and each output written once; operations
count what the computation needs, not what a kernel repeats.

The model counts follow the configuration's widths (``configs/<name>.json``),
not what a kernel does: two operations per multiply-add of every matrix
product a token passes through (the tied unembedding included), plus
attention's score and value products at the lengths the port runs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: NVIDIA H100 SXM data sheet, dense: the TF32 tensor-core rate, the fastest
#: any product with float32 inputs can run on the card
PEAK_F32_OPS_PER_S = 495e12
#: HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the card could take: the larger of operations over the
    peak rate and bytes over the peak bandwidth."""
    return max(nops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


# ------------------------------------------------------------ kernel counts
def live_pairs(S, causal, window, Sk=None):
    """(query, key) pairs the masks leave live in one head, for S queries
    over Sk keys (S unless given; with Sk != S there is no mask)."""
    Sk = Sk or S
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        n += (i if causal else Sk - 1) - lo + 1
    return n


def flash_counts(B, S, H, KH, hd, causal, window, elem, hd_v=None, Sk=None):
    """q, k, v read once and out written once; 2*hd + 2*hd_v operations (q.k
    and p*v) per live pair."""
    hd_v, Sk = hd_v or hd, Sk or S
    nbytes = (B * S * H * (hd + hd_v) + B * Sk * KH * (hd + hd_v)) * elem
    return nbytes, 2 * (hd + hd_v) * B * H * live_pairs(S, causal, window, Sk)


def decode_counts(S, H, KH, hd, lengths, window, q_elem, cache_elem):
    """q and out at q's element size, and the live K/V rows only at the
    cache's, for one length a batch row; operations 4*hd per query head and
    live row."""
    n_live = sum(max(0, min(n, S - 1) - (max(0, n - window + 1) if window else 0) + 1)
                 for n in lengths)
    B = len(lengths)
    return 2 * B * H * hd * q_elem + 2 * n_live * KH * hd * cache_elem, 4 * hd * H * n_live


# ---------------------------------------------------------- a request's work
def decode_start(S: int, gen_len: int, max_cache_len: int) -> int:
    """The position of a request's first decode step: the served path
    decodes from a zero cache at ``min(S, max_cache_len - gen_len - 1)``."""
    return min(S, max_cache_len - gen_len - 1)


def attention_calls(cfg: Dict) -> int:
    """Attention applications a token passes through."""
    return cfg["n_layers"]


def matmul_params(cfg: Dict) -> int:
    """Weights of the matrix products one token passes through, the tied
    unembedding included and the embedding lookup not."""
    d, H, KH, hd, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    block = d * hd * (H + 2 * KH) + H * hd * d + 3 * d * f
    return cfg["n_layers"] * block + cfg["vocab"] * d


def request_flops(cfg: Dict, S: int, gen_len: int, max_cache_len: int) -> float:
    """Model operations of one served request: a prefill of ``S`` tokens
    (every position through the unembedding, as the served prefill computes
    it) and ``gen_len - 1`` decode steps from ``decode_start``."""
    H, KH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    n_attn = attention_calls(cfg)
    steps = gen_len - 1
    ops = 2.0 * matmul_params(cfg) * (S + steps)
    ops += n_attn * flash_counts(1, S, H, KH, hd, True, None, 4)[1]
    idx = decode_start(S, gen_len, max_cache_len)
    ops += n_attn * sum(decode_counts(max_cache_len, H, KH, hd, [idx + t], None, 4, 4)[1]
                        for t in range(steps))
    return ops


def kernel_work(cfg: Dict, S: int, gen_len: int, max_cache_len: int
                ) -> Dict[str, List[Tuple[float, float]]]:
    """(bytes, operations) of each call of the port's model kernels in one
    served request, by kernel: ``flash_attention`` once an attention
    application of the prefill, ``decode_attention`` once an application of
    each decode step (at ``valid_len`` = the step's position); float32
    operands."""
    H, KH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    n_attn = attention_calls(cfg)
    idx = decode_start(S, gen_len, max_cache_len)
    return {
        "flash_attention": [flash_counts(1, S, H, KH, hd, True, None, 4)] * n_attn,
        "decode_attention": [decode_counts(max_cache_len, H, KH, hd, [idx + t], None, 4, 4)
                             for t in range(gen_len - 1) for _ in range(n_attn)],
    }
