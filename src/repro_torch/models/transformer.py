"""Transformer blocks and the layer stacks of the dense, vlm, moe, hybrid and
encoder-decoder families, with GQA or MLA attention (counterpart of the JAX
package's ``models/transformer.py``).

The JAX package scans a stack over parameters stacked on a leading layer
axis; here ``run_stack`` loops over that axis in Python, as the ssm family's
``Model._run_ssm`` does.  gemma3's local:global pattern rides along as
per-layer Python values from ``layer_meta`` (window ``GLOBAL_WINDOW`` means a
global layer), so each layer passes its own window and rope theta.  A block
of a MoE stack has ``moe`` (``models/moe.py``) in place of ``mlp``, and its
load-balancing aux is summed over the stack.  A block of whisper's decoder
has ``ln_cross`` and ``cross``: cross-attention over the encoded memory
after its self-attention, in every mode.  With ``remat`` a stack's blocks run
in train mode through ``torch.utils.checkpoint`` (``remat_call``), the
counterpart of the JAX package's ``jax.checkpoint`` around its scan body.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (GLOBAL_WINDOW, attn_decode, attn_forward, init_attention, init_mla,
                        mla_decode, mla_forward)
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .moe import apply_moe, init_moe


def layer_meta(cfg, n_layers: Optional[int] = None) -> Tuple[List[int], List[float]]:
    """Per-layer (windows, thetas): ``GLOBAL_WINDOW`` (2**30) for a global
    layer, ``cfg.sliding_window`` for a local one."""
    L = n_layers or cfg.n_layers
    windows, thetas = [], []
    for i in range(L):
        is_global = cfg.global_every is not None and (i + 1) % cfg.global_every == 0
        if cfg.sliding_window is not None and not is_global:
            windows.append(cfg.sliding_window)
            thetas.append(cfg.rope_theta)
        else:
            windows.append(GLOBAL_WINDOW)
            thetas.append(cfg.rope_theta_global or cfg.rope_theta)
    return windows, thetas


def init_block(cfg, generator: torch.Generator, device, dtype=torch.float32,
               layers: int = 0, moe_layer: bool = False, cross: bool = False) -> Dict[str, Any]:
    """One block's parameters, or ``layers`` blocks stacked on a leading axis,
    with the JAX package's keys: ln1, attn (MLA's where ``cfg.mla`` is set),
    with ``cross`` ``ln_cross`` and ``cross`` (a GQA attention's parameters),
    [ln2], then ``moe`` for a MoE layer, else ``mlp`` (of width
    ``moe.dense_dff`` in the leading dense layers of a MoE model that has
    them)."""
    init_attn = init_mla if cfg.mla is not None else init_attention
    p: Dict[str, Any] = {"ln1": init_norm(cfg, device, layers=layers),
                         "attn": init_attn(cfg, generator, device, dtype, layers)}
    if cross:
        p["ln_cross"] = init_norm(cfg, device, layers=layers)
        p["cross"] = init_attention(cfg, generator, device, dtype, layers)
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, device, layers=layers)
    if moe_layer:
        p["moe"] = init_moe(cfg, generator, device, dtype, layers)
    else:
        d_ff = cfg.moe.dense_dff if (cfg.moe and cfg.moe.n_dense_layers) else cfg.d_ff
        p["mlp"] = init_mlp(cfg, generator, device, dtype, layers, d_ff)
    return p


def block_forward(p: Dict, x: torch.Tensor, cfg, positions: Optional[torch.Tensor],
                  window: Optional[int] = None, theta: Optional[float] = None,
                  mode: str = "train", cache=None, cache_index=None, kv_memory=None,
                  causal: bool = True):
    """Returns (x', cache entry, aux): the layer's (k, v) in prefill (MLA's
    (c_kv, k_rope)), its updated cache in decode; aux is the MoE
    load-balancing loss (a float32 0-d tensor) of a MoE block, else 0.0.
    Pre-norm residual block, or Cohere's parallel block ``x + (attn(n(x)) +
    mlp(n(x))) * depth_scale``; MiniCPM's ``depth_scale`` scales both
    residual branches.  MLA takes no window and its own rope theta.
    ``causal=False`` makes the self-attention bidirectional (whisper's
    encoder); a block with ``cross`` adds cross-attention over ``kv_memory``
    (memory (B,T,d), its positions) after the self-attention."""
    ds = cfg.depth_scale
    h = apply_norm(p["ln1"], x, cfg)
    if cfg.mla is not None:
        a, new_cache = (mla_decode(p["attn"], h, cache, cfg, cache_index) if mode == "decode"
                        else mla_forward(p["attn"], h, cfg, positions))
    elif mode == "decode":
        a, new_cache = attn_decode(p["attn"], h, cache, cfg, cache_index, window, theta)
    else:
        a, new_cache = attn_forward(p["attn"], h, cfg, positions, window, theta, causal)
    if cfg.parallel_block:
        return x + _scaled(a + apply_mlp(p["mlp"], h, cfg), ds), new_cache, 0.0
    x = x + _scaled(a, ds)
    if "cross" in p:
        hc = apply_norm(p["ln_cross"], x, cfg)
        c, _ = attn_forward(p["cross"], hc, cfg, positions, kv_memory=kv_memory)
        x = x + _scaled(c, ds)
    h2 = apply_norm(p["ln2"], x, cfg)
    aux = 0.0
    if "moe" in p:
        m, aux = apply_moe(p["moe"], h2, cfg)
    else:
        m = apply_mlp(p["mlp"], h2, cfg)
    return x + _scaled(m, ds), new_cache, aux


def _scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    return t * s if s != 1.0 else t


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``; with ``enabled`` and grad mode on, through
    ``torch.utils.checkpoint`` (non-reentrant): the backward pass recomputes
    ``fn``'s activations instead of keeping them, with the same gradients."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def run_stack(stack: Dict, x: torch.Tensor, cfg, positions: Optional[torch.Tensor],
              windows: List[int], thetas: List[float], mode: str = "train", caches=None,
              cache_index=None, kv_memory=None, causal: bool = True, remat: bool = False):
    """Run the layers of a stacked parameter tree in order.  Returns (x,
    caches, aux): in prefill the layers' (k, v) stacked to (L,B,S,KH,hd)
    each (MLA: (c_kv, k_rope) to (L,B,S,kv_lora) and (L,B,S,rope)); in
    decode ``caches`` itself, written in place; else None.  aux is the sum
    of the blocks' MoE aux (0.0 for a stack without MoE).  ``kv_memory``
    and ``causal`` go to every block (``block_forward``).  With ``remat``
    each block runs in train mode through ``remat_call``."""
    ks, vs = [], []
    aux = 0.0
    layers = _unstack(stack, len(windows))
    for i, (w, th) in enumerate(zip(windows, thetas)):
        if mode == "train":
            def body(x, p=layers[i], w=w, th=th):
                y, _, a = block_forward(p, x, cfg, positions, w, th, mode, kv_memory=kv_memory,
                                        causal=causal)
                return y, a

            x, a = remat_call(remat, body, x)
            aux = aux + a
            continue
        c_l = (caches[0][i], caches[1][i]) if mode == "decode" else None
        x, new_c, a = block_forward(layers[i], x, cfg, positions, w, th, mode, c_l,
                                    cache_index, kv_memory, causal)
        aux = aux + a
        if mode == "prefill":
            ks.append(new_c[0])
            vs.append(new_c[1])
    if mode == "prefill":
        return x, (torch.stack(ks), torch.stack(vs)), aux
    return x, (caches if mode == "decode" else None), aux


def _unstack(tree, n: int) -> List[Dict]:
    """The ``n`` per-layer trees of a stacked parameter tree, from one
    ``torch.unbind`` of each leaf: views, as ``_index`` gives, but under
    autograd the layers' gradients go back into a stacked leaf in one
    ``stack``, where indexing it layer by layer writes a whole zero leaf and
    adds it into the gradient once a layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree)[:n])


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
