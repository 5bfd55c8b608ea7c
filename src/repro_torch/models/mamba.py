"""Mamba2 (SSD) block: chunked prefill through the ``ssd_scan`` kernel and an
O(1) decode step (counterpart of the JAX package's ``models/mamba.py``).

``ssd_chunked`` is the plain PyTorch form of the SSD chunked scan: the
reference of the CUDA kernel (``kernels/ref.py::ssd_scan_ref``) and what
``kernels.ops.ssd_scan`` runs for tensors on the CPU.  ``mamba_forward`` calls
``ops.ssd_scan``, so on the card prefill goes through the kernel.
``mamba_decode`` is plain PyTorch: no TPU kernel covers it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import default_device
from ..kernels import ops
from ..sharding import shard
from ..sharding.ctx import hold_grad, merge_heads, model_size, on_local_shards, sharded
from .layers import normal_param, rmsnorm


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim)
    ssm: torch.Tensor   # (B, H, P, N) float32


def _dims(cfg):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.nheads(cfg.d_model), s.headdim, s.d_state, s.ngroups


def init_mamba(cfg, generator: torch.Generator, device, dtype=torch.float32) -> Dict:
    """Random block parameters with the JAX package's distributions."""
    s, d_in, H, P, N, G = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_in + 2 * G * N
    in_dim = 2 * d_in + 2 * G * N + H  # [z, x, B, C, dt]
    f32 = torch.float32
    return {
        "in_proj": normal_param((d, in_dim), generator, device, dtype=dtype),
        "conv_w": normal_param((s.d_conv, conv_dim), generator, device, 0.5, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.zeros(H, dtype=f32, device=device),
        "D": torch.ones(H, dtype=f32, device=device),
        "dt_bias": torch.zeros(H, dtype=f32, device=device),
        "norm": torch.zeros(d_in, dtype=f32, device=device),
        "out_proj": normal_param((d_in, d), generator, device, dtype=dtype),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    s, d_in, H, P, N, G = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * G * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, S, C); ``prev``: (B, K-1, C) history."""
    K = w.shape[0]
    if prev is None:
        prev = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[-1]))
    xpad = torch.cat([prev.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xpad[:, i: i + S] * w[i] for i in range(K))
    new_prev = xpad[:, xpad.shape[1] - (K - 1):]
    return F.silu(out + b), new_prev


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = sum_{k=j+1..i} dA_k for i >= j else -inf. dA: (..., Q)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (post-softplus, > 0)
    A: torch.Tensor,   # (H,) negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan in float32, or in float64 when ``x`` is float64.
    Returns (y (B,S,H,P), final state (B,H,P,N)) in that dtype.  ``S`` must
    be a multiple of ``chunk``."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = S // chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

    xc = x.reshape(B_, nc, chunk, H, P).to(acc)
    dtc = dt.reshape(B_, nc, chunk, H).to(acc)
    BH = Bm.reshape(B_, nc, chunk, G, N).to(acc).repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    CH = Cm.reshape(B_, nc, chunk, G, N).to(acc).repeat_interleave(rep, dim=3)

    dA_t = (dtc * A.to(acc)).movedim(-1, -2)  # (B,nc,H,Q)
    L = torch.exp(_segsum(dA_t))              # (B,nc,H,Q,Q)

    # intra-chunk (quadratic) term   (c = chunk idx, s = state dim)
    scores = torch.einsum("bcqhs,bckhs->bchqk", CH, BH) * L
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc)

    # chunk states: decay from position j to chunk end
    cs = torch.cumsum(dA_t, dim=-1)
    decay_to_end = torch.exp(cs[..., -1:] - cs)  # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqh,bcqhs,bcqhp->bchps", decay_to_end, dtc, BH, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cs[..., -1])  # (B,nc,H)
    h = x.new_zeros((B_, H, P, N), dtype=acc) if init_state is None else init_state.to(acc)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,nc,H,P,N) state entering each chunk

    # inter-chunk contribution: C_i . (decay_from_start * h_prev)
    y_inter = torch.einsum("bcqhs,bchps,bchq->bcqhp", CH, h_prev, torch.exp(cs))
    y = (y_intra + y_inter).reshape(B_, S, H, P)
    return y, h


def mamba_forward(p, x: torch.Tensor, cfg, init_state: Optional[MambaState] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence Mamba2 block. x: (B, S, d)."""
    s, d_in, H, P, N, G = _dims(cfg)
    B_, S, _ = x.shape
    z, xBC, dt = _split_proj(cfg, hold_grad(x @ p["in_proj"]))
    prev = init_state.conv if init_state is not None else None
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], prev)
    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, S, H, P)
    Bm = Bm.reshape(B_, S, G, N)
    Cm = Cm.reshape(B_, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = shard(xs, ("batch", "seq", "ssm_heads", None))
    ssm0 = init_state.ssm if init_state is not None else None
    # ops.ssd_scan pads S to the chunk and cuts y back to S
    y, h = ops.ssd_scan(xs.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                        chunk=s.chunk, init_state=ssm0)
    y = y + xs * p["D"][None, None, :, None]  # skip connection (D term)
    y = merge_heads(y).to(x.dtype)  # (B, S, d_in)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return hold_grad(y @ p["out_proj"]), MambaState(conv_state, h)


def _ssm_step(h, dA, dt, BH, CH, xs, D):
    """The SSM state's one-token update and the output read from it, per
    (row, head): (y (B,H,P), h' (B,H,P,N) float32)."""
    h = h * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, BH.float(), xs.float())
    return torch.einsum("bhn,bhpn->bhp", CH.float(), h) + xs * D[None, :, None], h


def mamba_decode(p, x: torch.Tensor, cfg, state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, 1, d); O(1) state update."""
    s, d_in, H, P, N, G = _dims(cfg)
    B_ = x.shape[0]
    z, xBC, dt = _split_proj(cfg, x[:, 0] @ p["in_proj"])  # (B, in_dim)
    conv = torch.cat([state.conv.to(xBC.dtype), xBC[:, None, :]], dim=1)  # (B,K,C)
    xBC = F.silu(torch.einsum("bkc,kc->bc", conv, p["conv_w"]) + p["conv_b"])
    new_conv = conv[:, 1:]
    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, H, P)
    rep = H // G
    # head h reads group h // rep (a view and a copy: nothing the host must compute)
    BH = Bm.reshape(B_, G, 1, N).expand(B_, G, rep, N).reshape(B_, H, N)  # (B,H,N)
    CH = Cm.reshape(B_, G, 1, N).expand(B_, G, rep, N).reshape(B_, H, N)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)
    args = (state.ssm, dA, dt, BH, CH, xs, p["D"])
    if sharded(*args):  # each head's update on its own shard (DTensor leaves)
        y, h = on_local_shards(_ssm_step, args, [(0, 1)] * 6 + [(None, 0)], [(0, 1)] * 2,
                               H % model_size(*args) == 0)
    else:
        y, h = _ssm_step(*args)
    y = y.reshape(B_, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"])[:, None, :], MambaState(new_conv, h)


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None) -> MambaState:
    """Zero decode state on ``device`` (the card unless ``device="cpu"``)."""
    device = default_device(device)
    s, d_in, H, P, N, G = _dims(cfg)
    conv_dim = d_in + 2 * G * N
    return MambaState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    )
