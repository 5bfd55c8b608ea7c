"""The least work of each kernel: bytes moved and operations done, from the
call's shapes (and, where the work depends on it, the call's data: the live
(query, key) pairs, the cache rows a decode reads, the ARRIVALs of a
burst).  Bytes count each input read once and each output written once;
operations count what the computation needs, not what a kernel repeats.

``chip_smoke.py`` divides these by the card's peak rates for each kernel's
bound; the dry run (``launch/dryrun.py``) adds them to its per-device FLOPs
and bytes where a kernel wrapper is called on tensors that hold no data (its
"twin", ``kernels/ops.py``), through the accounting that ``account`` feeds.
"""

from __future__ import annotations

from typing import Callable, List

#: the active accountings, innermost last: each is called as
#: ``fn(kernel name, bytes, operations)`` once a twin call
_ACTIVE: List[Callable[[str, float, float], None]] = []


def account(name: str, nbytes: float, nops: float) -> None:
    """Add one call of kernel ``name`` to the innermost active accounting
    (none active: nothing)."""
    if _ACTIVE:
        _ACTIVE[-1](name, nbytes, nops)


def ssd_counts(B, S, H, P, N, Q, elem):
    """Bytes each input read once / output written once, and float32
    operations counted once (C.B^T shared by the heads, ngroups=1)."""
    Sp = -(-S // Q) * Q
    nc = Sp // Q
    tri = Q * (Q + 1) // 2
    ops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * elem + 2 * B * S * N * elem + B * S * H * 4 + H * 4
              + B * H * P * N * 4)
    return nbytes, ops


def ssd_bwd_counts(B, S, H, P, N, G, Q, elem, d_final=False):
    """The gradient's least work, counted once: x, dy, B, C, dt, A read with
    the forward's scratch the backward starts from (the chunk cumsums, the
    states entering the chunks, C.B^T on and below the diagonal) and
    d_final_state where given; dx, dB, dC, ddt, dA and d_init_state written.
    Operations, per chunk: each head's dh = exp(cs) dy^T C, its carried dC
    = exp(cs) dy h, G B^T (dx's state term and dw), dB's state term w x^T G
    (each Q P N), D = dy x^T and dx's quadratic term (each Q(Q+1)/2 P); each
    group's dC and dB from dCB (each Q(Q+1)/2 N); two operations each."""
    Sp = -(-S // Q) * Q
    nc = Sp // Q
    tri = Q * (Q + 1) // 2
    ops = 2 * B * nc * (H * (4 * Q * P * N + 2 * tri * P) + G * 2 * tri * N)
    nbytes = (3 * B * Sp * H * P * elem + 4 * B * Sp * G * N * elem + 2 * B * Sp * H * 4
              + 2 * H * 4 + B * nc * H * (Q + N * P) * 4 + B * nc * G * tri * 4
              + (2 if d_final else 1) * B * H * P * N * 4)
    return nbytes, ops


def sched_counts(kinds, F, W):
    """Bytes (events read, idle/conns read and written, outputs written) and
    operations (two compares per worker per ARRIVAL of this run's data)."""
    R = len(kinds)
    nbytes = 3 * R * 4 + 2 * F * W * 4 + 2 * W * 4 + 2 * R * 4
    return nbytes, 2 * W * int((kinds == 0).sum())


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
    and p*v) per live pair (hd_v: v's head dim, hd unless given; Sk: the
    keys' length, S unless given)."""
    hd_v, Sk = hd_v or hd, Sk or S
    nbytes = (B * S * H * (hd + hd_v) + B * Sk * KH * (hd + hd_v)) * elem
    return nbytes, 2 * (hd + hd_v) * B * H * live_pairs(S, causal, window, Sk)


def decode_counts(S, H, KH, hd, lengths, window, q_elem, cache_elem):
    """q and out at q's element size, and the live K/V rows only (the kernel
    reads no other) at the cache's, for one length a batch row; operations
    4*hd per query head and live row."""
    n_live = sum(max(0, min(n, S - 1) - (max(0, n - window + 1) if window else 0) + 1)
                 for n in lengths)
    B = len(lengths)
    return 2 * B * H * hd * q_elem + 2 * n_live * KH * hd * cache_elem, 4 * hd * H * n_live


def latent_counts(H, dc, dr, lengths, S, q_elem, cache_elem):
    """The latent decode's bytes (q_lat, q_rope and out at q's element size,
    the live c and r rows once at the cache's) and operations (2 x (dc + dr)
    for the score and 2 x dc for the value, per head and live row)."""
    n_live = sum(min(n, S - 1) + 1 for n in lengths)
    B = len(lengths)
    nbytes = B * H * (2 * dc + dr) * q_elem + n_live * (dc + dr) * cache_elem
    return nbytes, 2 * H * (2 * dc + dr) * n_live


def flash_bwd_counts(B, S, H, KH, hd, causal, window, elem, Sk=None, hd_v=None):
    """q, k, v, out and dout read once with the forward's lse, dq, dk and dv
    written once; five products per live pair (the scores again, since P
    is not kept, and dq and dk: 2*hd operations each; dO.v and dv: 2*hd_v
    each): the least work of the gradient.  Returns (bytes, operations, the
    kernel's operations: seven products, q.k and dO.v twice)."""
    Sk, hd_v = Sk or S, hd_v or hd
    nbytes = ((2 * hd + 2 * hd_v) * B * S * H + 2 * (hd + hd_v) * B * Sk * KH) * elem \
        + B * H * S * 4
    pairs = B * H * live_pairs(S, causal, window, Sk)
    return nbytes, 2 * (3 * hd + 2 * hd_v) * pairs, 2 * (4 * hd + 3 * hd_v) * pairs


def linear_counts(M, K, widths, elem=4):
    """``linear_tf32x3`` of an (M, K) input with weights of ``widths``
    columns: the input read once, each weight read once, each output
    written once; 2 M K N operations a product (the split's three TF32
    products are the kernel's, not the function's)."""
    n = sum(widths)
    return (M * K + K * n + M * n) * elem, 2 * M * K * n
