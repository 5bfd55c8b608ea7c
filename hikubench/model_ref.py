"""The plain reference of the served model, the dense family (MiniCPM), in
float32 with TF32 off, written from the configuration's widths
(``configs/<name>.json``) with plain ``torch`` operations and nothing of the
program under test.

Weights.  An endpoint's weights are a function of its seed: the served path
draws them on the card from a ``torch.Generator`` seeded with it, leaf after
leaf, each a float32 standard normal times a scale (1/sqrt(fan in), 0.02
for the embedding), the norms' scales at their start.  ``make_params`` draws the same leaves in the same
order and so works the same weights out again.

Requests.  A served request is a prompt of S tokens and ``gen_len`` greedy
tokens.  Token 0 is the argmax of the prompt's last logits.  The decode
steps start from a zero state at position ``idx = min(S, max_cache_len -
gen_len - 1)``: step t reads token t at position ``idx + t`` and gives
token t + 1, its attention spanning the ``idx`` zero rows below ``idx`` and
the steps' own keys.
``request_logits`` gives the reference's logits at every served position
and the keys and values the decode steps write.

``control=True`` rounds every matrix product's operands to TF32 (10
mantissa bits, to nearest), the precision a float32 product takes on the
card's tensor cores: the control that the check must refuse.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ weights
def _normal(shape, gen, device, scale):
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32).mul_(scale)


def _layers(shape, n, gen, device) -> List[torch.Tensor]:
    """``n`` layers of one leaf, drawn one after another at 1/sqrt(fan in),
    fan in the leaf's first axis."""
    return [_normal(shape, gen, device, shape[0] ** -0.5) for _ in range(n)]


def _block(cfg, gen, device, n: int) -> List[Dict]:
    """``n`` transformer blocks' weights (leaf by leaf over the blocks, in
    the served path's order: the attention's q, k, v, o, then the MLP's
    gate, up and down projections)."""
    d, H, KH, hd, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    leaves = {"wq": _layers((d, H, hd), n, gen, device),
              "wk": _layers((d, KH, hd), n, gen, device),
              "wv": _layers((d, KH, hd), n, gen, device),
              "wo": _layers((H, hd, d), n, gen, device),
              "wg": _layers((d, f), n, gen, device),
              "wu": _layers((d, f), n, gen, device),
              "wd": _layers((f, d), n, gen, device)}
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


@torch.no_grad()
def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The weights of the endpoint with weight seed ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg["d_model"]
    p: Dict = {"embed": _normal((cfg["vocab"], d), gen, device, 0.02)}
    p["blocks"] = _block(cfg, gen, device, cfg["n_layers"])
    return p


# ------------------------------------------------------------------ algebra
def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Ops:
    def __init__(self, control: bool):
        self.control = control

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = tf32(a), tf32(b)
        return a @ b


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with its scale at the served path's start, (1 + 0)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (S, heads, hd) at positions pos (S,),
    angles in float32."""
    hd = x.shape[-1]
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=x.device)
                   ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(o: _Ops, b: Dict, h: torch.Tensor, cfg: Dict, pos: torch.Tensor,
               zeros_below: int, kv: Optional[list]) -> torch.Tensor:
    """Causal attention of the rows h (S, d) at positions ``pos``, over
    themselves and ``zeros_below`` rows of zero keys and values before them
    (a zero key scores 0 and adds nothing to the output).  Appends the rows'
    (rotated k, v) to ``kv`` where given."""
    S, d = h.shape
    H, KH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = o.mm(h, b["wq"].reshape(d, H * hd)).reshape(S, H, hd)
    k = o.mm(h, b["wk"].reshape(d, KH * hd)).reshape(S, KH, hd)
    v = o.mm(h, b["wv"].reshape(d, KH * hd)).reshape(S, KH, hd)
    q, k = _rope(q, pos, cfg["rope_theta"]), _rope(k, pos, cfg["rope_theta"])
    if kv is not None:
        kv.append((k, v))
    k, v = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    scale = float(1.0 / math.sqrt(hd))
    s = o.mm(q.transpose(0, 1), k.permute(1, 2, 0)) * scale           # (H, S, S)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=h.device).tril(), float("-inf"))
    if zeros_below:
        s = torch.cat([s.new_full((H, S, 1), math.log(zeros_below)), s], dim=-1)
    p = torch.softmax(s, dim=-1)[..., -S:]
    out = o.mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(S, H * hd)
    return o.mm(out, b["wo"].reshape(H * hd, d))


def _block_delta(o: _Ops, b: Dict, x: torch.Tensor, cfg: Dict, pos, zeros_below,
                 kv) -> torch.Tensor:
    """What a pre-norm transformer block adds to its input x: the attention
    branch and the gated MLP branch, each times the depth scale."""
    ds = cfg["depth_scale"]
    a = _attention(o, b, _rms(x), cfg, pos, zeros_below, kv) * ds
    h = _rms(x + a)
    m = o.mm(F.silu(o.mm(h, b["wg"])) * o.mm(h, b["wu"]), b["wd"]) * ds
    return a + m


def _hidden(o: _Ops, p: Dict, cfg: Dict, tokens: torch.Tensor, pos: torch.Tensor,
            zeros_below: int, kv: Optional[list] = None) -> torch.Tensor:
    """The final normed hidden states of the rows ``tokens`` at ``pos``
    (each attention application's (k, v) appended to ``kv``)."""
    x = p["embed"][tokens] * cfg["scale_emb"]
    for b in p["blocks"]:
        x = x + _block_delta(o, b, x, cfg, pos, zeros_below, kv)
    return _rms(x)


def _logits(o: _Ops, p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    return o.mm(h, p["embed"].T) / cfg["scale_emb"]


@torch.no_grad()
def request_logits(p: Dict, cfg: Dict, prompt: torch.Tensor, served: torch.Tensor,
                   max_cache_len: int, control: bool = False):
    """One request's reference: (logits (gen_len, vocab) at each served
    position, row 0 at the prompt's last position and row t + 1 at decode
    step t, which reads ``served[t]``; the decode steps' keys and values,
    each (attention applications, gen_len - 1, kv heads, head dim), the keys
    rotated)."""
    o = _Ops(control)
    dev = p["embed"].device
    prompt, served = prompt.to(dev).long(), served.to(dev).long()
    S, gen = prompt.shape[0], served.shape[0]
    first = _hidden(o, p, cfg, prompt, torch.arange(S, device=dev), 0)[-1:]
    idx = min(S, max_cache_len - gen - 1)
    kv: list = []
    steps = _hidden(o, p, cfg, served[:-1], torch.arange(idx, idx + gen - 1, device=dev), idx, kv)
    keys = torch.stack([k for k, _ in kv]) if kv else None
    values = torch.stack([v for _, v in kv]) if kv else None
    return _logits(o, p, cfg, torch.cat([first, steps])), (keys, values)


def logit_gaps(logits: torch.Tensor, tokens: torch.Tensor,
               choose: Optional[torch.Tensor] = None) -> torch.Tensor:
    """By how much each served token's logit lies below the row's best
    (``choose``: the tokens whose gaps are read, the served ones unless
    given)."""
    t = tokens if choose is None else choose
    t = t.to(logits.device).long()
    return logits.max(-1).values - logits.gather(-1, t[:, None])[:, 0]


def setup_precision() -> None:
    """Full float32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_count(cfg: Dict) -> int:
    """Parameters of ``make_params``' tree, from the widths alone."""
    d, H, KH, hd, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    block = d * hd * (H + 2 * KH) + H * hd * d + 3 * d * f
    return cfg["vocab"] * d + cfg["n_layers"] * block
