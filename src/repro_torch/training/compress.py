"""Int8 block-quantized gradient compression (counterpart of the JAX
package's ``training/compress.py``): each block of 256 values becomes int8
values and one float32 scale (max |x| / 127), ~4x fewer bytes at < 1e-2
relative error; optional error feedback carries the quantization residual
into the next step.  ``compressed_psum``, the all-reduce over a mesh axis,
waits for ROADMAP Queue 1 item 9."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .optimizer import tree_leaves, tree_map

BLOCK = 256


def quantize(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values (n_blocks, block), float32 per-block scales)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, block: int = BLOCK) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_roundtrip_error(x: torch.Tensor) -> float:
    """max |dequantize(quantize(x)) - x| / max |x|."""
    q, s = quantize(x)
    y = dequantize(q, s, x.shape)
    denom = torch.clamp(x.abs().max(), min=1e-12)
    return float((y - x.to(torch.float32)).abs().max() / denom)


def compressed_grad_tree(grads, residual: Optional[Any] = None):
    """Quantize a gradient tree with error feedback: (dequantized gradients
    in their own dtypes, the new float32 residual)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    res = iter(tree_leaves(residual))
    pairs = []

    def one(g):
        corrected = g.to(torch.float32) + next(res)
        q, s = quantize(corrected)
        deq = dequantize(q, s, g.shape)
        pairs.append(corrected - deq)
        return deq.to(g.dtype)

    deq = tree_map(one, grads)
    new_res = iter(pairs)
    return deq, tree_map(lambda _: next(new_res), grads)
