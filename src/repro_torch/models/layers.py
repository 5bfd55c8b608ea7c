"""Common layers as plain functions on tensors (counterpart of the JAX
package's ``models/layers.py``): RMSNorm and LayerNorm, activations, the
(gated) MLP, rotary embeddings, token embedding and the tied or untied
unembedding.  Parameters are nested dicts of tensors with the same keys and
layouts as the JAX package's value trees (see ``models/convert.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def normal_param(shape: Sequence[int], generator: torch.Generator, device,
                 scale: Optional[float] = None, dtype=torch.float32) -> torch.Tensor:
    """``normal * scale`` with the JAX package's default scale
    1/sqrt(fan_in) (fan_in = shape[0], or the last dim for a vector)."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        scale = 1.0 / fan_in ** 0.5
    v = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return v.mul_(scale).to(dtype)


def stacked_normal(shape: Sequence[int], layers: int, generator: torch.Generator, device,
                   dtype=torch.float32) -> torch.Tensor:
    """``normal_param(shape)`` for each of ``layers`` layers, stacked into one
    ``(layers, *shape)`` tensor; ``layers == 0`` gives one unstacked tensor.
    The scale is the per-layer 1/sqrt(fan_in).  Drawn layer by layer into the
    stack, so the float32 draw is one layer at a time: drawing the whole stack
    first would hold a float32 copy of it (mixtral-8x22b's stacked experts at
    8 layers: 25.8 GB beside the 12.9 GB bfloat16 result)."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
    if not layers:
        return normal_param(shape, generator, device, fan_in ** -0.5, dtype)
    out = torch.empty((layers, *shape), dtype=dtype, device=device)
    for i in range(layers):
        out[i] = normal_param(shape, generator, device, fan_in ** -0.5, dtype)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def init_norm(cfg, device, dim: Optional[int] = None, layers: int = 0) -> Dict:
    """Norm parameters; with ``layers > 0`` stacked along a leading axis."""
    shape = ((layers,) if layers else ()) + (dim if dim is not None else cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, device=device)}  # (1 + scale) form
    out = {"scale": torch.ones(shape, device=device)}
    if cfg.norm_bias:
        out["bias"] = torch.zeros(shape, device=device)
    return out


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p.get("bias"))


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """silu, or gelu in its tanh form (``jax.nn.gelu(approximate=True)``)."""
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# --------------------------------------------------------------------- MLP
def init_mlp(cfg, generator: torch.Generator, device, dtype=torch.float32,
             layers: int = 0, d_ff: Optional[int] = None) -> Dict:
    """MLP parameters of width ``d_ff`` (``cfg.d_ff`` when None or 0, as in
    the JAX package); with ``layers > 0`` stacked for that many layers
    (leading axis), with the per-layer fan-in."""
    d, d_ff = cfg.d_model, d_ff or cfg.d_ff
    lead = (layers,) if layers else ()
    w = lambda shape: stacked_normal(shape, layers, generator, device, dtype)  # noqa: E731
    p = {}
    if cfg.gated_mlp:
        p["wi_gate"] = w((d, d_ff))
    p["wi_up"] = w((d, d_ff))
    p["wo"] = w((d_ff, d))
    if cfg.use_bias:
        p["bi"] = torch.zeros(lead + (d_ff,), dtype=dtype, device=device)
        p["bo"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    act = act_fn(cfg.act)
    up = x @ p["wi_up"]
    if "bi" in p:
        up = up + p["bi"]
    h = act(x @ p["wi_gate"]) * up if "wi_gate" in p else act(up)
    y = h @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


# -------------------------------------------------------------------- RoPE
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, computed in float32 as the JAX
    package does (``theta`` arrives there as a float32 per-layer value).
    Computed once per (head_dim, theta, device) and kept: building them
    copies ``theta`` from the host, which a stream that is capturing a CUDA
    graph may not do."""
    key = (head_dim, float(theta), torch.device(device or "cpu"))
    freqs = _FREQS.get(key)
    if freqs is None:
        exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
        freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponents)
        _FREQS[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: (..., S, H, head_dim); positions:
    (..., S) integer; angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------- embeddings
def init_embedding(cfg, generator: torch.Generator, device, dtype=torch.float32) -> Dict:
    p = {"tokens": normal_param((cfg.vocab, cfg.d_model), generator, device, 0.02, dtype)}
    if not cfg.tied_embeddings:
        p["unembed"] = normal_param((cfg.d_model, cfg.vocab), generator, device, dtype=dtype)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg, dtype) -> torch.Tensor:
    x = p["tokens"][tokens.long()].to(dtype)
    return x * cfg.scale_emb if cfg.scale_emb != 1.0 else x


def unembed(p, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tied_embeddings:
        logits = x @ p["tokens"].to(x.dtype).T
        if cfg.scale_emb != 1.0:  # MiniCPM: 1/scale_emb folded into the tied head
            logits = logits / cfg.scale_emb
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.logit_soft_cap:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits
