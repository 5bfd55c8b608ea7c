"""Grouped-query attention with biases, qk-norm, rotary embeddings and a
per-layer sliding window, and DeepSeek's multi-head latent attention (MLA)
with the absorbed decode (counterpart of the JAX package's
``models/attention.py``).

``attn_forward`` (prefill) calls ``kernels.ops.flash_attention`` and
``attn_decode`` calls ``kernels.ops.decode_attention``; whisper's
cross-attention (``attn_forward`` with ``kv_memory``) calls
``ops.flash_attention`` over the memory's keys for a query sequence and
``ops.decode_attention`` for one query a row; ``mla_forward`` calls
``ops.flash_attention`` with q/k heads of nope + rope and v heads of
``v_head_dim``, and ``mla_decode`` calls ``ops.decode_attention_latent`` on
the latent cache.  On the card those are the CUDA kernels, on the CPU their
plain versions.  A logit softcap (``cfg.attn_logit_softcap``) goes to both
kernels, which apply it as the JAX package's ``sdpa`` does.

The kernels build their masks from row and column indices, the JAX functions
from ``positions[0]``; the two agree because the model's positions are
``arange(S)`` in prefill, and in decode each row's own ``cache_index``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.ref import attn_scale
from ..sharding.ctx import (hold_grad, merge_heads, model_size, on_local_shards, sharded,
                             write_rows)
from .layers import apply_rope, rmsnorm, stacked_normal

GLOBAL_WINDOW = 2**30  # "window" value meaning full attention

KV = Tuple[torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------- params
def init_attention(cfg, generator: torch.Generator, device, dtype=torch.float32,
                   layers: int = 0) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions (normal /
    sqrt(fan_in), fan_in the first axis of the per-layer shape; biases and
    qk-norm scales zero); with ``layers > 0`` stacked along a leading axis."""
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lead = (layers,) if layers else ()
    w = lambda shape: stacked_normal(shape, layers, generator, device, dtype)  # noqa: E731
    zeros = lambda shape, dt=dtype: torch.zeros(lead + shape, dtype=dt, device=device)  # noqa: E731
    p = {"wq": w((d, H, hd)), "wk": w((d, KH, hd)), "wv": w((d, KH, hd)), "wo": w((H, hd, d))}
    if cfg.use_bias:
        p.update(bq=zeros((H, hd)), bk=zeros((KH, hd)), bv=zeros((KH, hd)), bo=zeros((d,)))
    if cfg.qk_norm:
        p.update(q_norm=zeros((hd,), torch.float32), k_norm=zeros((hd,), torch.float32))
    return p


def init_mla(cfg, generator: torch.Generator, device, dtype=torch.float32,
             layers: int = 0) -> Dict[str, torch.Tensor]:
    """MLA's parameters with the JAX package's keys, shapes and
    distributions: the q and kv down-projections ``wq_a`` (d, q_lora) and
    ``wkv_a`` (d, kv_lora + rope), their rmsnorm scales ``q_norm`` and
    ``kv_norm`` (zeros, float32), the up-projections ``wq_b`` (q_lora, H,
    nope + rope) and ``wkv_b`` (kv_lora, H, nope + v), and ``wo`` (H, v, d);
    with ``layers > 0`` stacked along a leading axis."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    lead = (layers,) if layers else ()
    w = lambda shape: stacked_normal(shape, layers, generator, device, dtype)  # noqa: E731
    zeros = lambda n: torch.zeros(lead + (n,), dtype=torch.float32, device=device)  # noqa: E731
    return {
        "wq_a": w((d, m.q_lora_rank)),
        "q_norm": zeros(m.q_lora_rank),
        "wq_b": w((m.q_lora_rank, H, m.qk_nope_head_dim + m.qk_rope_head_dim)),
        "wkv_a": w((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": zeros(m.kv_lora_rank),
        "wkv_b": w((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)),
        "wo": w((H, m.v_head_dim, d)),
    }


# -------------------------------------------------------------------- core
def _kernel_window(window: int) -> Optional[int]:
    return None if window >= GLOBAL_WINDOW else int(window)


def _project_heads(x: torch.Tensor, *ws: torch.Tensor):
    """``einsum("bsd,dhe->bshe")`` of ``x`` with each of ``ws``, as a list:
    ``ops.dense`` of x and each weight's heads flattened, so that the
    projections of one input share its launches.  On ``DTensor``s each rank
    projects its own rows onto its own heads (all of them where they do not
    split over "model"): ``DTensor``'s own einsum may split the flattened
    heads where they cannot be unflattened."""
    if sharded(x, *ws):
        return [on_local_shards(lambda a, b: torch.einsum("bsd,dhe->bshe", a, b), [x, w],
                                [(0, None), (None, 1)], [(0, 2)],
                                w.shape[1] % model_size(x, w) == 0) for w in ws]
    ys = ops.dense(x, *(w.reshape(w.shape[0], -1) for w in ws))
    return [y.unflatten(-1, w.shape[1:]) for y, w in zip([ys] if len(ws) == 1 else ys, ws)]


def _qkv(p, x: torch.Tensor, src: torch.Tensor):
    if src is x:
        q, k, v = _project_heads(x, p["wq"], p["wk"], p["wv"])
    else:
        (q,), (k, v) = _project_heads(x, p["wq"]), _project_heads(src, p["wk"], p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def _positions(cache_index, B: int, device):
    """(cache_index on ``device`` if a tensor, else the int; its (B,) long
    positions) for a decode step."""
    if isinstance(cache_index, torch.Tensor):
        cache_index = cache_index.to(device)
        return cache_index, cache_index.to(torch.long).reshape(-1).expand(B)
    return cache_index, torch.full((B,), int(cache_index), dtype=torch.long, device=device)


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd")`` as one matmul over (h, e) flattened: the
    einsum copies ``wo`` into (e, h, d) order first, a whole weight a call."""
    H, hd, d = p["wo"].shape
    y = hold_grad(ops.dense(merge_heads(out), p["wo"].reshape(H * hd, d)))
    return y + p["bo"] if "bo" in p else y


# --------------------------------------------------------------- GQA paths
def attn_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,          # (B, S, d)
    cfg,
    positions: torch.Tensor,  # (B, S): arange(S) in every row
    window: Optional[int] = None,   # None or GLOBAL_WINDOW -> full
    theta: Optional[float] = None,
    causal: bool = True,
    kv_memory: Optional[KV] = None,  # cross-attention: (memory (B,T,d), its positions (B,T))
) -> Tuple[torch.Tensor, KV]:
    """Prefill/full-sequence attention.  Returns (y (B,S,d), (k, v)) with
    k, v (B,S,KH,hd) for the cache.

    With ``kv_memory`` this is cross-attention, as in the JAX package: K and
    V are projected from the memory (cast to x's dtype), with no rope and no
    mask (every one of the T memory rows is live; ``positions``, ``window``,
    ``theta`` and ``causal`` are not read), and (k, v) are (B,T,KH,hd).  A
    query sequence goes to ``ops.flash_attention`` with keys of length T,
    one query a row (decode) to ``ops.decode_attention`` over the T
    projected rows with ``valid_len`` T-1, a Python int, so a decode step
    that holds it can be captured in a CUDA graph.  It applies no logit
    softcap: no encoder-decoder config sets one.

    In train mode under autograd the gradient goes through
    ``ops.flash_attention``'s backward kernel on the card."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    if kv_memory is not None:
        return _cross_forward(p, x, cfg, kv_memory[0].to(x.dtype))
    q, k, v = _qkv(p, x, x)
    if cfg.rope:
        th = theta if theta is not None else cfg.rope_theta
        q = apply_rope(q, positions, th)
        k = apply_rope(k, positions, th)
    w = window if window is not None else GLOBAL_WINDOW
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                              _kernel_window(w), cfg.attn_logit_softcap)
    return _out_proj(p, out.reshape(B, S, H, hd)), (k, v)


def _cross_forward(p, x: torch.Tensor, cfg, memory: torch.Tensor) -> Tuple[torch.Tensor, KV]:
    """``attn_forward``'s cross-attention over ``memory`` (B,T,d)."""
    B, S, _ = x.shape
    T = memory.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    q, k, v = _qkv(p, x, memory)
    if S == 1:
        out = ops.decode_attention(q.reshape(B, H, hd).contiguous(), k.contiguous(),
                                   v.contiguous(), T - 1)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    return _out_proj(p, out.reshape(B, S, H, hd)), (k, v)


def attn_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d)
    cache: KV,        # k/v: (B, S_cache, KH, hd)
    cfg,
    cache_index,      # Python int, 0-d integer tensor, or (B,) per-row positions
    window: Optional[int] = None,
    theta: Optional[float] = None,
) -> Tuple[torch.Tensor, KV]:
    """One-token decode.  Writes the new K/V into ``cache`` in place at
    ``min(cache_index, S-1)`` (the JAX version returns new arrays; writing in
    place spares a copy of the cache per layer and step) and attends to the
    positions ``<= cache_index`` (unclamped, as in the JAX package), within
    the window.  ``cache_index`` may be one position for the whole batch (a
    Python int or a 0-d tensor) or a ``(B,)`` tensor, each row at its own
    position.  A tensor position stays on the device: the step makes no host
    sync, so it can be captured in a CUDA graph and replayed with new
    positions.  On the card the kernel reads the cache in its own dtype; on
    the CPU the cache is cast to q's dtype first, as the JAX function does.
    Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    cache_index, idx_vec = _positions(cache_index, B, x.device)
    q, k_new, v_new = _qkv(p, x, x)
    if cfg.rope:
        th = theta if theta is not None else cfg.rope_theta
        q = apply_rope(q, idx_vec[:, None], th)
        k_new = apply_rope(k_new, idx_vec[:, None], th)
    rows, wr = torch.arange(B, device=x.device), idx_vec.clamp(max=S - 1)
    write_rows(k_cache, rows, wr, k_new[:, 0])
    write_rows(v_cache, rows, wr, v_new[:, 0])
    w = window if window is not None else GLOBAL_WINDOW
    kc, vc = (k_cache, v_cache) if x.is_cuda else (k_cache.to(q.dtype), v_cache.to(q.dtype))
    out = ops.decode_attention(q.reshape(B, H, hd).contiguous(), kc, vc, cache_index,
                               _kernel_window(w), cfg.attn_logit_softcap)
    return _out_proj(p, out.reshape(B, 1, H, hd)), (k_cache, v_cache)


# --------------------------------------------------------------- MLA paths
def _mla_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora), k_rope
    (B,S,rope)): the low-rank projections, rmsnorm on both latents and the
    rotary embedding on the rope dims only."""
    m, H = cfg.mla, cfg.n_heads
    q = rmsnorm(hold_grad(x @ p["wq_a"]), p["q_norm"])
    q = hold_grad(q @ p["wq_b"].reshape(m.q_lora_rank, -1)).reshape(*x.shape[:2], H, -1)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = hold_grad(x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(m) -> float:
    """1/sqrt(nope + rope) in float32, the JAX package's MLA scale."""
    return attn_scale(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor) -> Tuple[torch.Tensor, KV]:
    """Train/prefill MLA with expanded per-head K/V: k = [k_nope | k_rope
    broadcast over the heads], v the tail of each head's ``c_kv @ wkv_b``
    row, read in place by the kernel; causal.  Returns (y (B,S,d), (c_kv
    (B,S,kv_lora), k_rope (B,S,rope))), the latent cache the absorbed decode
    reads."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    kv = hold_grad(c_kv @ p["wkv_b"].reshape(m.kv_lora_rank, -1)).reshape(B, S, H, -1)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # the kernel's 1/sqrt(hd) of q's head dim nope + rope is _mla_scale(m)
    out = ops.flash_attention(q, k, v, causal=True)
    return _out_proj(p, out), (c_kv, k_rope)


def _per_head(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of x (B, H, .) and w (r, H, .) head by head.  On
    ``DTensor``s each rank takes its own rows and heads: ``DTensor``'s own
    einsum may leave the rows split in a way the next product cannot take."""
    if sharded(x, w):
        return on_local_shards(lambda a, b: torch.einsum(eq, a, b), [x, w], [(0, 1), (None, 1)],
                               [(0, 1)], w.shape[1] % model_size(x, w) == 0)
    return torch.einsum(eq, x, w)


def mla_decode(p, x: torch.Tensor, cache: KV, cfg, cache_index) -> Tuple[torch.Tensor, KV]:
    """Absorbed MLA decode: writes the new latent row and rope key into
    ``cache`` = (c_cache (B,S,kv_lora), r_cache (B,S,rope)) in place at
    ``min(cache_index, S-1)`` and attends to the positions ``<=
    cache_index``, with q absorbed through W_UK and the output through W_UV,
    so no per-head K/V is formed.  ``cache_index`` as in ``attn_decode`` (an
    int, a 0-d or a (B,) tensor; no host sync).  Returns (y (B,1,d),
    cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    c_cache, r_cache = cache
    S = c_cache.shape[1]
    cache_index, idx_vec = _positions(cache_index, B, x.device)
    q_nope, q_rope, c_new, r_new = _mla_qkv(p, x, cfg, idx_vec[:, None])
    rows, wr = torch.arange(B, device=x.device), idx_vec.clamp(max=S - 1)
    write_rows(c_cache, rows, wr, c_new[:, 0])
    write_rows(r_cache, rows, wr, r_new[:, 0])
    w_uk, w_uv = p["wkv_b"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = _per_head("bhe,rhe->bhr", q_nope[:, 0], w_uk)
    c, r = (c_cache, r_cache) if x.is_cuda else (c_cache.to(x.dtype), r_cache.to(x.dtype))
    o_lat = ops.decode_attention_latent(q_lat.contiguous(), q_rope[:, 0].contiguous(), c, r,
                                        cache_index, _mla_scale(m))
    out = _per_head("bhr,rhe->bhe", o_lat, w_uv)
    return _out_proj(p, out[:, None]), (c_cache, r_cache)
