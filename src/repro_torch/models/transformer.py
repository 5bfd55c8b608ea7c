"""Transformer blocks and the layer stack of the dense family (counterpart
of the JAX package's ``models/transformer.py``).

The JAX package scans a stack over parameters stacked on a leading layer
axis; here ``run_stack`` loops over that axis in Python, as the ssm family's
``Model._run_ssm`` does.  gemma3's local:global pattern rides along as
per-layer Python values from ``layer_meta`` (window ``GLOBAL_WINDOW`` means a
global layer), so each layer passes its own window and rope theta.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .attention import GLOBAL_WINDOW, attn_decode, attn_forward, init_attention
from .layers import apply_mlp, apply_norm, init_mlp, init_norm


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
               layers: int = 0) -> Dict[str, Any]:
    """One block's parameters, or ``layers`` blocks stacked on a leading axis,
    with the JAX package's keys: ln1, attn, [ln2], mlp."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks are not ported yet: ROADMAP Queue 1 item 7")
    if cfg.enc_dec:
        raise NotImplementedError("cross-attention blocks (encoder-decoder) are not ported yet: "
                                  "ROADMAP Queue 1 item 5")
    if cfg.mla is not None:
        raise NotImplementedError("MLA is not ported yet: ROADMAP Queue 1 item 7")
    p: Dict[str, Any] = {"ln1": init_norm(cfg, device, layers=layers),
                         "attn": init_attention(cfg, generator, device, dtype, layers)}
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, device, layers=layers)
    p["mlp"] = init_mlp(cfg, generator, device, dtype, layers)
    return p


def block_forward(p: Dict, x: torch.Tensor, cfg, positions: Optional[torch.Tensor],
                  window: Optional[int] = None, theta: Optional[float] = None,
                  mode: str = "train", cache=None, cache_index=None) -> Tuple[torch.Tensor, Any]:
    """Returns (x', cache entry): the layer's (k, v) in prefill, its updated
    cache in decode.  Pre-norm residual block, or Cohere's parallel block
    ``x + (attn(n(x)) + mlp(n(x))) * depth_scale``; MiniCPM's
    ``depth_scale`` scales both residual branches."""
    ds = cfg.depth_scale
    h = apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, new_cache = attn_decode(p["attn"], h, cache, cfg, cache_index, window, theta)
    else:
        a, new_cache = attn_forward(p["attn"], h, cfg, positions, window, theta)
    if cfg.parallel_block:
        return x + _scaled(a + apply_mlp(p["mlp"], h, cfg), ds), new_cache
    x = x + _scaled(a, ds)
    m = apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x + _scaled(m, ds), new_cache


def _scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    return t * s if s != 1.0 else t


def run_stack(stack: Dict, x: torch.Tensor, cfg, positions: Optional[torch.Tensor],
              windows: List[int], thetas: List[float], mode: str = "train", caches=None,
              cache_index=None):
    """Run the layers of a stacked parameter tree in order.  Returns (x,
    caches): in prefill the layers' (k, v) stacked to (L,B,S,KH,hd) each; in
    decode ``caches`` itself, written in place; else None."""
    ks, vs = [], []
    for i, (w, th) in enumerate(zip(windows, thetas)):
        c_l = (caches[0][i], caches[1][i]) if mode == "decode" else None
        x, new_c = block_forward(_index(stack, i), x, cfg, positions, w, th, mode, c_l,
                                 cache_index)
        if mode == "prefill":
            ks.append(new_c[0])
            vs.append(new_c[1])
    if mode == "prefill":
        return x, (torch.stack(ks), torch.stack(vs))
    return x, (caches if mode == "decode" else None)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
