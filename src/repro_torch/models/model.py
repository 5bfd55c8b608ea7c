"""Model assembly for the ported families (counterpart of the JAX package's
``models/model.py``).

So far the ``ssm`` family (mamba2-130m), the ``dense`` family (minicpm-2b,
gemma3-4b, command-r-35b, command-r-plus-104b) and the ``vlm`` family's dense
backbone (llava-next-mistral-7b, whose forward splices precomputed patch
embeddings over the first token embeddings): ``init``, ``forward``,
``prefill``, ``decode_step`` and ``init_cache`` with the JAX package's
signatures and parameter/cache layouts, so the two can be held against each
other on the same weights.
Parameters are a nested dict of tensors whose per-layer entries are stacked
along a leading layer axis, as in the JAX value tree; the layers run in a
Python loop over that axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import default_device
from .layers import apply_norm, embed_tokens, init_embedding, init_norm, unembed
from .mamba import MambaState, init_mamba, init_mamba_state, mamba_decode, mamba_forward
from .transformer import _index, init_block, layer_meta, run_stack

FAMILIES = ("ssm", "dense", "vlm")  # vlm: a dense backbone


def build_model(cfg, param_dtype=torch.float32, device=None) -> "Model":
    return Model(cfg, param_dtype, device)


class Model:
    def __init__(self, cfg, param_dtype=torch.float32, device=None):
        if cfg.family not in FAMILIES or cfg.moe is not None or cfg.mla is not None:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) is not ported yet: MLA, MoE, hybrid and "
                "encoder-decoder models are ROADMAP Queue 1 item 7"
            )
        self.cfg = cfg
        self.dtype = param_dtype
        self.device = default_device(device)

    # ================================================================ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters on ``self.device`` from ``generator`` (which
        must live on that device), with the JAX package's distributions:
        normal / sqrt(fan_in), embeddings x 0.02, ``conv_w`` x 0.5, zeros and
        ones where the JAX package has them.  The dense stack is drawn
        layer-stacked at once (``stack``, leading axis of ``n_layers``)."""
        cfg, dev = self.cfg, self.device
        if cfg.family != "ssm":
            return {
                "embed": init_embedding(cfg, generator, dev, self.dtype),
                "final_norm": init_norm(cfg, dev),
                "stack": init_block(cfg, generator, dev, self.dtype, layers=cfg.n_layers),
            }
        layers = [
            {"ln": init_norm(cfg, dev), "mamba": init_mamba(cfg, generator, dev, self.dtype)}
            for _ in range(cfg.n_layers)
        ]
        return {
            "embed": init_embedding(cfg, generator, dev, self.dtype),
            "final_norm": init_norm(cfg, dev),
            "layers": _stack(layers),
        }

    # ============================================================= forward
    def forward(self, params, batch: Dict[str, torch.Tensor], mode: str = "train"):
        """Full-sequence forward.  Returns (logits, aux, caches_or_None).  A
        vlm batch may carry ``patches`` (B, n_img, d): they replace the first
        ``n_img`` token embeddings."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg, self.dtype)
        if cfg.family == "vlm" and "patches" in batch:
            n_img = batch["patches"].shape[1]
            x = torch.cat([batch["patches"].to(x.dtype), x[:, n_img:]], dim=1)
        if cfg.family == "ssm":
            x, caches = self._run_ssm(params, x, mode)
        else:
            B, S = tokens.shape
            positions = torch.arange(S, device=x.device).expand(B, S)
            x, caches = self._run_lm_stacks(params, x, positions, mode)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["embed"], x, cfg), torch.zeros((), device=x.device), caches

    def _run_lm_stacks(self, params, x, positions, mode, cache_index=None, caches=None):
        w, t = layer_meta(self.cfg)
        x, c = run_stack(params["stack"], x, self.cfg, positions, w, t, mode,
                         caches["stack"] if caches else None, cache_index)
        return x, ({"stack": c} if mode in ("prefill", "decode") else None)

    def _run_ssm(self, params, x, mode, states: Optional[Dict] = None):
        cfg = self.cfg
        layers = params["layers"]
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            p_l = _index(layers, i)
            hn = apply_norm(p_l["ln"], x, cfg)
            if mode == "decode":
                st = MambaState(states["layers"].conv[i], states["layers"].ssm[i])
                y, new_st = mamba_decode(p_l["mamba"], hn, cfg, st)
            else:
                y, new_st = mamba_forward(p_l["mamba"], hn, cfg)
            x = x + y
            if mode in ("prefill", "decode"):
                convs.append(new_st.conv)
                ssms.append(new_st.ssm)
        caches = None
        if mode in ("prefill", "decode"):
            caches = {"layers": MambaState(torch.stack(convs), torch.stack(ssms))}
        return x, caches

    # ============================================================ serving
    def prefill(self, params, batch):
        """Forward + cache build.  Returns (cache, last-position logits)."""
        logits, _, caches = self.forward(params, batch, mode="prefill")
        return caches, logits[:, -1]

    def decode_step(self, params, tokens, cache, cache_index):
        """tokens: (B, 1) — one token per row.  ``cache_index``: the
        attention families' write position, a Python int or a 0-d integer
        tensor for the whole batch, or a (B,) tensor of per-slot positions;
        a tensor stays on the device (no host sync), so the step can be
        captured in a CUDA graph.  The K/V cache is written in place.  The
        SSM state needs no position."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg, self.dtype)
        if cfg.family == "ssm":
            x, cache = self._run_ssm(params, x, "decode", states=cache)
        else:
            x, cache = self._run_lm_stacks(params, x, None, "decode", cache_index, cache)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["embed"], x, cfg)[:, 0], cache

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16):
        """Zero decode state, one entry per layer stacked along axis 0: the
        attention families' (k, v) pair of (L, B, seq, KH, hd)."""
        cfg = self.cfg
        if cfg.family != "ssm":
            shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim_)
            return {"stack": (torch.zeros(shape, dtype=dtype, device=self.device),
                              torch.zeros(shape, dtype=dtype, device=self.device))}
        st = init_mamba_state(self.cfg, batch, dtype, self.device)
        L = self.cfg.n_layers
        return {"layers": MambaState(*(torch.stack([a] * L) for a in st))}


def _stack(trees):
    """Stack per-layer dicts along a new leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)

