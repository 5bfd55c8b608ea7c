"""Plain PyTorch versions of the CUDA kernels, with the kernels' contracts.

  sched_step_ref   <-> csrc/sched.cu, ARRIVAL-only specialisation
  sched_events_ref <-> csrc/sched.cu (mixed ARRIVAL|FINISH|EVICT bursts)
  ssd_scan_ref     <-> csrc/ssd_scan.cu (the chunked SSD of models/mamba.py)
  flash_attention_ref  <-> csrc/flash_attention.cu (flash_attention_lse_ref: its
                           row log-sum-exp, written when a gradient is wanted)
  flash_attention_bwd_ref <-> csrc/flash_attention_bwd.cu (dq, dk, dv)
  decode_attention_ref <-> csrc/decode_attention.cu
  decode_attention_latent_ref <-> csrc/decode_attention.cu, the absorbed-MLA entry

``kernels/ops.py`` takes these for tensors on the CPU; the tests and
``chip_smoke.py`` hold each kernel against its plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_NEG_INF = -2.0e38  # masked logits, as in the TPU kernels
Tensors4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sched_step_ref(funcs: torch.Tensor, idle: torch.Tensor, conns: torch.Tensor) -> Tensors4:
    """ARRIVAL-only burst with lowest-index ties.

    funcs (R,) int32; idle (F, W) int32; conns (W,) int32.  Returns
    (assign (R,) int32, warm (R,) bool, idle', conns'); inputs untouched.
    """
    kinds = torch.zeros_like(funcs)
    workers = torch.full_like(funcs, -1)
    a, warm, idle2, conns2 = sched_events_ref(kinds, funcs, workers, idle, conns)
    return a, warm.bool(), idle2, conns2


def sched_events_ref(
    kinds: torch.Tensor,    # (R,) int32 — 0 ARRIVAL / 1 FINISH / 2 EVICT / >=3 no-op
    funcs: torch.Tensor,    # (R,) int32
    workers: torch.Tensor,  # (R,) int32 (-1 for ARRIVAL)
    idle: torch.Tensor,     # (F, W) int32
    conns: torch.Tensor,    # (W,) int32
) -> Tensors4:
    """Mixed-event burst: ``core.sched.sched_many`` with lowest-index ties.

    Returns (assign (R,) int32, -1 for non-ARRIVAL; warm (R,) int32; idle';
    conns').  Inputs untouched.
    """
    from ..core.sched import JIQState, sched_many  # deferred: core imports ops

    events = torch.stack([kinds, funcs, workers], dim=1).to(torch.int32)
    state, (ws, warm) = sched_many(JIQState(idle, conns), events)
    return ws, warm.to(torch.int32), state.idle, state.conns


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD oracle: the model's plain implementation."""
    from ..models.mamba import ssd_chunked  # deferred: models import ops

    return ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)


def attn_scale(hd: int) -> float:
    """1/sqrt(hd) computed in float32, as the JAX package does."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _flash_logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
                  softcap: Optional[float]):
    """(logits (B,KH,G,S,Sk) float32 with the masked ones at -2e38, the live
    mask (S,Sk) or None, tanh(u / softcap) of the scaled logits u or None):
    the logits are ``q . k / sqrt(hd)``, then ``softcap * tanh(. /
    softcap)`` with a softcap, as the JAX package's ``sdpa`` applies it
    before the mask."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window)
    qg = q.reshape(B, S, KH, H // KH, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * attn_scale(hd)
    t = None
    if softcap:
        t = torch.tanh(logits / softcap)
        logits = softcap * t
    ok = None
    if causal or window is not None:
        pos = torch.arange(S, device=q.device)
        ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            ok &= pos[None, :] <= pos[:, None]
        if window is not None:
            ok &= (pos[:, None] - pos[None, :]) < window
        logits = logits.masked_fill(~ok, _NEG_INF)
    return logits, ok, t


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of a whole query sequence over a whole key sequence.  q
    (B,S,H,hd); k (B,Sk,KH,hd); v (B,Sk,KH,hd_v), whose head dim may differ
    from q's and k's (MLA: 192 and 128); Sk is S for self-attention and any
    length for cross-attention (whisper's decoder over the encoded audio);
    query head h reads kv head h // (H/KH).  Key j is live for query i when
    ``j <= i`` (causal) and ``i - j < window`` (window set); both masks
    need Sk == S (``check_key_length``).  The logits are scaled by
    ``1/sqrt(hd)`` in float32, capped to ``softcap * tanh(logit / softcap)``
    with a softcap, masked logits are -2e38, the softmax runs in float32
    and its probabilities are cast to ``q.dtype`` before the product with
    ``v``.  Returns (B,S,H,hd_v)."""
    B, S, H, _ = q.shape
    logits, _, _ = _flash_logits(q, k, causal, window, softcap)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(q.dtype))
    return out.reshape(B, S, H, v.shape[-1])


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp (natural log) of ``flash_attention_ref``'s live
    logits, (B,H,S) float32: what the kernel writes for the backward pass."""
    B, S, H, _ = q.shape
    logits, _, _ = _flash_logits(q, k, causal, window, softcap)
    return torch.logsumexp(logits, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The gradient of ``flash_attention`` (equal head dims) written out, in
    float32 from the forward's output ``out`` (B,S,H,hd) and row
    log-sum-exp ``lse`` (B,H,S), as the backward kernel computes it, with
    the logits s of ``flash_attention_ref`` (any Sk; the masks as there):

        P  = exp(s - lse), 0 where masked      dV = P^T dO
        D  = rowsum(dO * O)                    dS = P * (dO V^T - D)
        dQ = dS K * scale                      dK = dS^T Q * scale

    with scale = 1/sqrt(hd), dS taking the factor ``1 - tanh^2`` of the
    softcap, and dK, dV summed over each kv head's query group.  Returns
    (dq, dk, dv) in the dtypes of q, k and v."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    logits, ok, t = _flash_logits(q, k, causal, window, softcap)
    p = torch.exp(logits - lse.float().reshape(B, KH, G, S, 1))
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    do = dout.float().reshape(B, S, KH, G, hd)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    d = (do * out.float().reshape(B, S, KH, G, hd)).sum(-1)         # (B,S,KH,G)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1 - t * t)
    scale = attn_scale(hd)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()).reshape(B, S, H, hd) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q.float().reshape(B, S, KH, G, hd)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_key_length(S: int, Sk: int, causal: bool, window: Optional[int]) -> None:
    """Keys of another length than the queries (cross-attention) are all
    live: the causal mask and the window compare a query's index with a
    key's, which means something only where Sk == S, so with Sk != S either
    raises (the JAX package never makes such a call)."""
    if Sk != S and (causal or window is not None):
        raise ValueError(f"keys of length {Sk} against {S} queries take no causal mask and no "
                         f"window (causal={causal}, window={window})")


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         valid_len, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """One new token per sequence against a cache.  q (B,H,hd); caches
    (B,S,KH,hd); ``valid_len`` a Python int or a 0-d integer tensor (one
    length for the batch), or a ``(B,)`` integer tensor (each row its own);
    positions ``<= valid_len`` are live, and with a window only those with
    ``valid_len - pos < window``.  The logits are capped to ``softcap *
    tanh(logit / softcap)`` with a softcap, before the mask, as in
    ``flash_attention_ref``.  Masked logits -2e38, softmax in float32;
    a cache in q's dtype is used as it is and the probabilities are cast to
    ``q.dtype``, a cache in another dtype is upcast straight to float32 (as
    the Pallas kernel upcasts each tile) and the product runs in float32.  A
    row with no live position has probabilities 0, so its output is zeros,
    as the Pallas kernel's (l = 0).  Returns (B,H,hd) in q's dtype."""
    B, S, KH, hd = k_cache.shape
    H = q.shape[1]
    G = H // KH
    work = q.dtype if k_cache.dtype == v_cache.dtype == q.dtype else torch.float32
    qg = q.reshape(B, KH, G, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * attn_scale(hd)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    ok = _live(S, valid_len, window, q.device).reshape(-1, 1, 1, S)  # (1 or B, 1, 1, S)
    logits = logits.masked_fill(~ok, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).masked_fill(~ok, 0.0).to(work)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.to(work))
    return out.reshape(B, H, hd).to(q.dtype)


def _live(S: int, valid_len, window: Optional[int], device) -> torch.Tensor:
    """(1 or B, S) live cache positions: ``pos <= valid_len`` and, with a
    window, ``valid_len - pos < window``."""
    pos = torch.arange(S, device=device)
    valid = (valid_len.to(device).reshape(-1, 1) if isinstance(valid_len, torch.Tensor)
             else int(valid_len))  # an int stays on the host: no copy to the card
    ok = pos <= valid
    if window is not None:
        ok &= (valid - pos) < window
    return ok.reshape(-1, S)


def decode_attention_latent_ref(q_lat: torch.Tensor, q_rope: torch.Tensor, c_cache: torch.Tensor,
                                r_cache: torch.Tensor, valid_len, scale: float) -> torch.Tensor:
    """Absorbed MLA decode: one new token per sequence against the latent
    cache, every query head reading the one shared latent row.  q_lat
    (B,H,dc) and q_rope (B,H,dr) are the query absorbed through W_UK and its
    rope part; c_cache (B,S,dc) and r_cache (B,S,dr).  The score of head h
    at position p is ``(q_lat_h . c_p + q_rope_h . r_p) * scale`` and the
    values are the latent rows ``c_p`` themselves.  ``valid_len`` as in
    ``decode_attention_ref`` (no window); masked logits -2e38, softmax in
    float32, a row with no live position gives zeros; caches in q's dtype
    are used as they are and the probabilities cast to it, caches in
    another dtype are upcast to float32.  Returns (B,H,dc) in q_lat's
    dtype."""
    B, S, _ = c_cache.shape
    work = q_lat.dtype if c_cache.dtype == r_cache.dtype == q_lat.dtype else torch.float32
    logits = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_cache.float())
              + torch.einsum("bhe,bse->bhs", q_rope.float(), r_cache.float())) * scale
    ok = _live(S, valid_len, None, q_lat.device)[:, None, :]  # (1 or B, 1, S)
    logits = logits.masked_fill(~ok, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).masked_fill(~ok, 0.0).to(work)
    return torch.einsum("bhs,bsr->bhr", probs, c_cache.to(work)).to(q_lat.dtype)
