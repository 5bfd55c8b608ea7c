"""Common layers as plain functions on tensors (counterpart of the JAX
package's ``models/layers.py``): RMSNorm, token embedding and the tied
unembedding; layernorm and untied heads come with the attention families.
Parameters are nested dicts of tensors with the same keys and layouts as the
JAX package's value trees (see ``models/convert.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def normal_param(shape: Sequence[int], generator: torch.Generator, device,
                 scale: Optional[float] = None, dtype=torch.float32) -> torch.Tensor:
    """``normal * scale`` with the JAX package's default scale
    1/sqrt(fan_in) (fan_in = shape[0], or the last dim for a vector)."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        scale = 1.0 / fan_in ** 0.5
    v = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (v * scale).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def _check_norm(cfg) -> None:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError("layernorm comes with the attention families (ROADMAP Queue 1 item 5)")


def init_norm(cfg, device, dim: Optional[int] = None) -> Dict:
    _check_norm(cfg)
    dim = dim if dim is not None else cfg.d_model
    return {"scale": torch.zeros(dim, device=device)}  # (1 + scale) form


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    _check_norm(cfg)
    return rmsnorm(x, p["scale"])


def init_embedding(cfg, generator: torch.Generator, device, dtype=torch.float32) -> Dict:
    if not cfg.tied_embeddings:
        raise NotImplementedError("untied embeddings come with the attention families (ROADMAP Queue 1 item 5)")
    return {"tokens": normal_param((cfg.vocab, cfg.d_model), generator, device, 0.02, dtype)}


def embed_tokens(p, tokens: torch.Tensor, cfg, dtype) -> torch.Tensor:
    x = p["tokens"][tokens.long()].to(dtype)
    return x * cfg.scale_emb if cfg.scale_emb != 1.0 else x


def unembed(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Tied unembedding (the only form the ported families use)."""
    logits = x @ p["tokens"].to(x.dtype).T
    if cfg.scale_emb != 1.0:
        logits = logits / cfg.scale_emb
    if cfg.logit_soft_cap:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits
