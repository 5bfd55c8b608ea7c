"""Plain PyTorch versions of the CUDA kernels, with the kernels' contracts.

  sched_step_ref   <-> csrc/sched.cu, ARRIVAL-only specialisation
  sched_events_ref <-> csrc/sched.cu (mixed ARRIVAL|FINISH|EVICT bursts)
  ssd_scan_ref     <-> csrc/ssd_scan.cu (the chunked SSD of models/mamba.py)
  flash_attention_ref  <-> csrc/flash_attention.cu (flash_attention_lse_ref: its
                           row log-sum-exp, written when a gradient is wanted)
  flash_attention_bwd_ref <-> csrc/flash_attention_bwd.cu (dq, dk, dv)
  decode_attention_ref <-> csrc/decode_attention.cu
  decode_attention_latent_ref <-> csrc/decode_attention.cu, the absorbed-MLA entry
  linear_tf32x3_ref <-> csrc/linear_tf32x3.cu (the split-precision dense product)

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


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, chunk: int, init_state=None, dy=None, d_final_state=None,
                     einsum=torch.einsum):
    """The gradient of ``ssd_scan_ref`` written out in its chunked form, as
    the backward kernel computes it.  Shapes as the forward's (S a multiple
    of ``chunk``); ``dy`` (B,S,H,P) and ``d_final_state`` (B,H,P,N) are the
    gradients of y and of the final state, either None for zero.  Per chunk,
    with cs the cumsum of a = dt * A over the chunk, h the state entering it,
    G the gradient of the state leaving it, w_k = exp(cs_last - cs_k) dt_k
    and M_qk = (C_q . B_k) exp(cs_q - cs_k) dt_k for q >= k (0 above the
    diagonal):

      carried     dC_q += exp(cs_q) dy_q h         dh_c = sum_q exp(cs_q) dy_q (x) C_q
                  dcs_q += exp(cs_q) dy_q . (h C_q)
      state pass  from the last chunk down, G_c = the gradient leaving chunk c
                  (d_final_state for the last); the one entering is
                  exp(cs_last) G_c + dh_c; d cs_last += exp(cs_last) sum(G_c * h)
      state       dx_k += w_k G B_k                dB_k += w_k G^T x_k
                  dw_k = x_k . (G B_k);  ddt_k += exp(cs_last - cs_k) dw_k;
                  dcs_k -= w_k dw_k;  dcs_last += sum_k w_k dw_k
      quadratic   D_qk = dy_q . x_k                dx_k += sum_q M_qk dy_q
                  dCB_qk = D_qk exp(cs_q - cs_k) dt_k, summed over a group's
                  heads: dC_q += sum_k dCB_qk B_k, dB_k += sum_q dCB_qk C_q
                  Z = D (C.B) exp(cs_q - cs_k): ddt_k += sum_q Z_qk;
                  T = Z dt_k: dcs_q += sum_k T_qk, dcs_k -= sum_q T_qk
      cumsum      da_t = sum_{q >= t} dcs_q (inside the chunk);
                  ddt += da A;  dA_h = sum over batch and positions of da dt

    dB and dC sum over the heads of a group (head h reads group h // (H/G)).
    cs is summed as the forward kernel sums it: the products dt * A in
    float32, summed in float64 and rounded to float32 (|cs| reaches hundreds
    over a chunk at full width, and float32 sums in two orders would differ
    there by more than the 1e-4 / 1e-3 tolerance in every decay).  The
    float64 sums of two orders differ far below float32's rounding but are
    not exact, so this cs and the kernel's may still differ by an ulp.  The sums that
    cancel (T's row and column sums, d cs, its reverse cumsum, dA and the
    decay term) are taken in float64, as in the kernel; the rest in float32.
    ``einsum`` computes the backward's matrix products (dy h, G B, x G, D,
    M dy and dCB with B and C): the tests pass ``einsum_tf32x3`` or
    ``einsum_tf32`` to see what the tensor cores' rounding does to them.
    Returns (dx, ddt, dA, dB, dC, d_init_state), float32, in the inputs'
    shapes; d_init_state (B,H,P,N) is the gradient entering chunk 0."""
    f32, f64 = torch.float32, torch.float64
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, Q = H // G, chunk
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32).movedim(-1, -2)         # (B,nc,H,Q)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).to(f32)
    BH, CH = Bc.repeat_interleave(rep, dim=3), Cc.repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    dyc = (torch.zeros_like(xc) if dy is None else dy.reshape(Bsz, nc, Q, H, P).to(f32))
    A = A.to(f32)

    cs = torch.cumsum((dtc * A[:, None]).to(f64), dim=-1).to(f32)   # (B,nc,H,Q)
    cl = cs[..., -1]                                                 # (B,nc,H)
    w = torch.exp(cl[..., None] - cs) * dtc                          # (B,nc,H,Q)
    live = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = (cs[..., :, None] - cs[..., None, :]).masked_fill(~live, float("-inf"))
    L = torch.exp(diff)                                              # (B,nc,H,Q,Q), 0 above
    CB = torch.einsum("bcqhn,bckhn->bchqk", CH, BH)

    # the forward's states: S_c, and h_c entering each chunk
    own = torch.einsum("bchk,bckhn,bckhp->bchpn", w, BH, xc)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    hs = []
    for c in range(nc):
        hs.append(h)
        h = h * torch.exp(cl[:, c])[..., None, None] + own[:, c]
    hs = torch.stack(hs, dim=1)                                      # (B,nc,H,P,N)

    # (1) the carried term
    ecs = torch.exp(cs)
    dC_h = einsum("bcqhp,bchpn->bcqhn", dyc, hs) * ecs.movedim(-1, -2)[..., None]
    dcs = torch.einsum("bcqhn,bcqhn->bchq", dC_h, CH).to(f64)
    dh = torch.einsum("bchq,bcqhp,bcqhn->bchpn", ecs, dyc, CH)
    # (2) the reverse state pass
    g = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if d_final_state is None
         else d_final_state.to(f32))
    Gs, d_last = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = g
        decay = torch.exp(cl[:, c])                                  # (B,H)
        d_last[c] = decay.to(f64) * (g.to(f64) * hs[:, c].to(f64)).sum((-1, -2))
        g = g * decay[..., None, None] + dh[:, c]
    Gs, d_last = torch.stack(Gs, dim=1), torch.stack(d_last, dim=1)  # (B,nc,H,P,N), (B,nc,H)
    # (3) the chunk states' backward
    U = einsum("bckhn,bchpn->bchkp", BH, Gs)                   # G B_k
    dx = (w[..., None] * U).movedim(2, 3)                            # (B,nc,Q,H,P)
    dB_h = einsum("bckhp,bchpn->bckhn", xc, Gs) * w.movedim(-1, -2)[..., None]
    dw = torch.einsum("bchkp,bckhp->bchk", U, xc)
    ddt = (torch.exp(cl[..., None] - cs) * dw).to(f64)
    wdw = (w * dw).to(f64)
    dcs = dcs - wdw
    d_last = d_last + wdw.sum(-1)
    # (4) the quadratic term's backward
    M = CB * L * dtc[..., None, :]
    D = einsum("bcqhp,bckhp->bchqk", dyc, xc)
    dx = dx + einsum("bchqk,bcqhp->bckhp", M, dyc)
    dCB = (D * L * dtc[..., None, :]).reshape(Bsz, nc, G, rep, Q, Q).sum(3)  # (B,nc,G,Q,Q)
    dC = dC_h.reshape(Bsz, nc, Q, G, rep, N).sum(4) + einsum("bcgqk,bckgn->bcqgn", dCB, Bc)
    dB = dB_h.reshape(Bsz, nc, Q, G, rep, N).sum(4) + einsum("bcgqk,bcqgn->bckgn", dCB, Cc)
    Z = D * CB * L
    ddt = ddt + Z.to(f64).sum(-2)
    T = (Z * dtc[..., None, :]).to(f64)
    dcs = dcs + T.sum(-1) - T.sum(-2)
    # (5) every d cs gathered (cs_last's own terms at the last position), then
    # (6) through the cumsum: da_t = sum_{q >= t} dcs_q
    dcs = torch.cat([dcs[..., :-1], dcs[..., -1:] + d_last[..., None]], dim=-1)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = ddt + da * A.to(f64)[:, None]
    dA = (da * dtc.to(f64)).sum((0, 1, 3))
    return (dx.reshape(Bsz, S, H, P).to(f32), ddt.movedim(-1, -2).reshape(Bsz, S, H).to(f32),
            dA.to(f32), dB.reshape(Bsz, S, G, N).to(f32), dC.reshape(Bsz, S, G, N).to(f32),
            g.to(f32))


def attn_scale(hd: int) -> float:
    """1/sqrt(hd) computed in float32, as the JAX package does."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _flash_logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
                  softcap: Optional[float], einsum=torch.einsum):
    """(logits (B,KH,G,S,Sk) float32 with the masked ones at -2e38, the live
    mask (S,Sk) or None, tanh(u / softcap) of the scaled logits u or None):
    the logits are ``q . k / sqrt(hd)``, then ``softcap * tanh(. /
    softcap)`` with a softcap, as the JAX package's ``sdpa`` applies it
    before the mask."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    check_key_length(S, Sk, causal, window)
    qg = q.reshape(B, S, KH, H // KH, hd)
    logits = einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * attn_scale(hd)
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
                            softcap: Optional[float] = None, einsum=torch.einsum,
                            logits_einsum=None):
    """The gradient of ``flash_attention`` written out, in float32 from the
    forward's output ``out`` (B,S,H,hd_v) and row log-sum-exp ``lse``
    (B,H,S), as the backward kernel computes it, with the logits s of
    ``flash_attention_ref`` (any Sk; the masks as there):

        P  = exp(s - lse), 0 where masked      dV = P^T dO
        D  = rowsum(dO * O)                    dS = P * (dO V^T - D)
        dQ = dS K * scale                      dK = dS^T Q * scale

    with scale = 1/sqrt(hd) of the q/k head dim (v's head dim hd_v may
    differ: MLA's 192 against 128), dS taking the factor ``1 - tanh^2`` of
    the softcap, and dK, dV summed over each kv head's query group.
    ``einsum`` computes the products dO V^T, dV, dQ and dK, and the logits
    too unless ``logits_einsum`` is given: the tests pass ``einsum_tf32x3``
    or ``einsum_tf32`` to see what the tensor cores' rounding does to the
    gradients, and ``logits_einsum=torch.einsum`` for the float32 kernel
    with a softcap, which forms its logits in float32 on the CUDA cores.
    Returns (dq, dk, dv) in the dtypes of q, k and v, dq and dk at hd, dv at
    hd_v."""
    B, S, H, hd = q.shape
    Sk, KH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    logits, ok, t = _flash_logits(q, k, causal, window, softcap, logits_einsum or einsum)
    p = torch.exp(logits - lse.float().reshape(B, KH, G, S, 1))
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    do = dout.float().reshape(B, S, KH, G, hd_v)
    dv = einsum("bkgqs,bqkgh->bskh", p, do)
    d = (do * out.float().reshape(B, S, KH, G, hd_v)).sum(-1)       # (B,S,KH,G)
    dp = einsum("bqkgh,bskh->bkgqs", do, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1 - t * t)
    scale = attn_scale(hd)
    dq = einsum("bkgqs,bskh->bqkgh", ds, k.float()).reshape(B, S, H, hd) * scale
    dk = einsum("bkgqs,bqkgh->bskh", ds, q.float().reshape(B, S, KH, G, hd)) * scale
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


# ------------------------------------------------------------------ TF32
# The backward kernels and the dense-product kernel (``linear_tf32x3``) run
# their float32 products on tensor cores in split precision: x = big + small
# with big = tf32(x) and small = tf32(x - big), a.b = big.big + big.small +
# small.big, each product exact in float32 and summed in float32
# (small.small, ~2^-22 |a||b|, is dropped).  These plain versions let the
# tests measure what that does; ``linear_tf32x3_ref`` is also the
# dense-product kernel's plain version.
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` does: 0x1000 added to the
    bits of the magnitude through an int32 view, then the 13 low bits
    cleared.  Finite inputs only."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def einsum_tf32x3(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two float32 operands as the split-precision
    tensor-core product computes it: small.big + big.small + big.big."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_big, b_big = round_tf32(a), round_tf32(b)
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    return (torch.einsum(equation, a_small, b_big) + torch.einsum(equation, a_big, b_small)
            + torch.einsum(equation, a_big, b_big))


def linear_tf32x3_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (a (M, K), w (K, N), float32) as ``linear_tf32x3`` computes
    it on the card: the split-precision tensor-core product."""
    return einsum_tf32x3("mk,kn->mn", a, w)


def einsum_tf32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two float32 operands as one TF32 tensor-core
    product computes it: both rounded to TF32, the products summed in
    float32."""
    return torch.einsum(equation, round_tf32(a), round_tf32(b))
