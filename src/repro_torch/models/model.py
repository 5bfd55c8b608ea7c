"""Model assembly for the ported families (counterpart of the JAX package's
``models/model.py``).

So far the ``ssm`` family (mamba2-130m), the ``dense`` family (minicpm-2b,
gemma3-4b, command-r-35b, command-r-plus-104b), the ``vlm`` family's dense
backbone (llava-next-mistral-7b, whose forward splices precomputed patch
embeddings over the first token embeddings), the ``moe`` family
(mixtral-8x22b; a stack of MoE blocks, or leading dense blocks and then MoE
blocks, as deepseek-v3-671b has them, with MLA attention and a depth-1
multi-token-prediction head), the ``hybrid`` family (zamba2-2.7b: groups of Mamba2 layers,
each followed by one application of a shared attention block) and the
encoder-decoder ``audio`` family (whisper-small: a bidirectional encoder over
post-conv frames, learned positions, and a decoder whose blocks
cross-attend to the encoded memory):
``init``, ``forward``, ``loss``, ``prefill``, ``decode_step`` and
``init_cache`` with the JAX package's signatures and parameter/cache
layouts, so the two can be held against each other on the same weights.
Parameters are a nested dict of tensors whose per-layer entries are stacked
along a leading layer axis, as in the JAX value tree; the layers run in a
Python loop over that axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import default_device
from .attention import _positions
from .layers import apply_norm, embed_tokens, init_embedding, init_norm, normal_param, unembed
from .mamba import MambaState, init_mamba, init_mamba_state, mamba_decode, mamba_forward
from .transformer import _index, block_forward, init_block, layer_meta, remat_call, run_stack

FAMILIES = ("ssm", "dense", "vlm", "moe", "hybrid", "audio")  # vlm: a dense backbone


def build_model(cfg, param_dtype=torch.float32, device=None, remat: bool = True) -> "Model":
    return Model(cfg, param_dtype, device, remat)


class Model:
    """``remat`` (on by default, as in the JAX package) runs each layer body
    of a train-mode forward under autograd through ``torch.utils.checkpoint``
    (``transformer.remat_call``): the backward pass recomputes the layer's
    activations, so only each layer's input is kept; the gradients are the
    same either way."""

    def __init__(self, cfg, param_dtype=torch.float32, device=None, remat: bool = True):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg
        self.dtype = param_dtype
        self.device = default_device(device)
        self.remat = remat

    # ================================================================ init
    def init(self, generator: torch.Generator, max_seq: int = 4096) -> Dict[str, Any]:
        """Random parameters on ``self.device`` from ``generator`` (which
        must live on that device), with the JAX package's tree and
        distributions: normal / sqrt(fan_in), embeddings x 0.02, ``conv_w`` x
        0.5, zeros and ones where the JAX package has them; norms (MLA's
        ``q_norm`` and ``kv_norm`` too), the MoE router and the Mamba block's
        A_log, D, dt_bias and norm in float32 whatever ``param_dtype`` is.
        Stacks are drawn layer by layer into tensors with a leading layer
        axis.  With ``mtp_depth`` the tree has ``mtp``: ``proj`` (2d, d), a
        dense ``block`` and the norms ``norm_h`` and ``norm_e``.  An
        encoder-decoder model has ``enc_pos`` and ``dec_pos`` (``max_seq``, d)
        (normal x 0.02), the ``encoder`` stack, ``enc_norm`` and a decoder
        ``stack`` with cross-attention; the other families ignore
        ``max_seq``."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        p: Dict[str, Any] = {"embed": init_embedding(cfg, generator, dev, dt),
                             "final_norm": init_norm(cfg, dev)}
        if cfg.family == "ssm":
            p["layers"] = _stack([self._init_mamba_layer(generator)
                                  for _ in range(cfg.n_layers)])
        elif cfg.family == "hybrid":
            p.update(self._init_hybrid(generator))
        elif cfg.enc_dec:
            pos = lambda: normal_param((max_seq, cfg.d_model), generator, dev, 0.02, dt)  # noqa: E731
            p.update(enc_pos=pos(), dec_pos=pos(),
                     encoder=init_block(cfg, generator, dev, dt, layers=cfg.n_encoder_layers),
                     enc_norm=init_norm(cfg, dev),
                     stack=init_block(cfg, generator, dev, dt, layers=cfg.n_layers, cross=True))
        elif cfg.moe is not None and cfg.moe.n_dense_layers > 0:
            nd = cfg.moe.n_dense_layers
            p["dense_stack"] = init_block(cfg, generator, dev, dt, layers=nd)
            p["moe_stack"] = init_block(cfg, generator, dev, dt, layers=cfg.n_layers - nd,
                                        moe_layer=True)
        else:
            p["stack"] = init_block(cfg, generator, dev, dt, layers=cfg.n_layers,
                                    moe_layer=cfg.moe is not None)
        if cfg.mtp_depth:
            p["mtp"] = {"proj": normal_param((2 * cfg.d_model, cfg.d_model), generator, dev,
                                             dtype=dt),
                        "block": init_block(cfg, generator, dev, dt),
                        "norm_h": init_norm(cfg, dev), "norm_e": init_norm(cfg, dev)}
        return p

    def _init_mamba_layer(self, generator):
        return {"ln": init_norm(self.cfg, self.device),
                "mamba": init_mamba(self.cfg, generator, self.device, self.dtype)}

    def _init_hybrid(self, generator):
        """Zamba2: ``mamba_groups`` stacked (n_groups, every, ...) and the
        ``shared_blocks`` stacked (n_shared_blocks, ...), each a projection
        of the concatenated [hidden, embedding] and a transformer block."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        h = cfg.hybrid
        if cfg.n_layers % h.every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of every {h.every}")
        groups = [_stack([self._init_mamba_layer(generator) for _ in range(h.every)])
                  for _ in range(cfg.n_layers // h.every)]
        in_dim = 2 * cfg.d_model if h.concat_embedding else cfg.d_model
        shared = [{"proj": normal_param((in_dim, cfg.d_model), generator, dev, dtype=dt),
                   "block": init_block(cfg, generator, dev, dt)}
                  for _ in range(h.n_shared_blocks)]
        return {"mamba_groups": _stack(groups), "shared_blocks": _stack(shared)}

    # ============================================================= forward
    def forward(self, params, batch: Dict[str, torch.Tensor], mode: str = "train"):
        """Full-sequence forward.  Returns (logits, aux, caches_or_None): aux
        is the MoE load-balancing loss summed over the layers (a float32 0-d
        tensor, zero for the families without MoE); with ``mtp_depth`` and
        ``mode="train"`` it is (that loss, the MTP head's hidden states (B,
        S, d)), as in the JAX package, which ``loss`` reads.  A vlm batch may
        carry ``patches`` (B, n_img, d): they replace the first ``n_img``
        token embeddings.  An encoder-decoder batch carries
        ``frames`` (B, T, d) too (``_forward_encdec``)."""
        cfg = self.cfg
        if cfg.enc_dec:
            return self._forward_encdec(params, batch, mode)
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg, self.dtype)
        if cfg.family == "vlm" and "patches" in batch:
            n_img = batch["patches"].shape[1]
            x = torch.cat([batch["patches"].to(x.dtype), x[:, n_img:]], dim=1)
        x_emb = x
        aux = 0.0
        if cfg.family == "ssm":
            x, caches = self._run_ssm(params, x, mode)
        else:
            B, S = tokens.shape
            positions = torch.arange(S, device=x.device).expand(B, S)
            if cfg.family == "hybrid":
                x, caches = self._run_hybrid(params, x, x_emb, positions, mode)
            else:
                x, aux, caches = self._run_lm_stacks(params, x, positions, mode)
        h_final = apply_norm(params["final_norm"], x, cfg)
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), device=x.device)
        if cfg.mtp_depth and mode == "train":
            aux = (aux, self._mtp_hidden(params, x_emb, h_final))
        return unembed(params["embed"], h_final, cfg), aux, caches

    def _mtp_hidden(self, params, x_emb, h_final):
        """DeepSeek-V3's depth-1 MTP head: the final hidden state at t and the
        embedding of token t+1 (the last position repeats its own), each
        normed, concatenated and projected, through one dense block."""
        cfg, m = self.cfg, params["mtp"]
        e_next = torch.cat([x_emb[:, 1:], x_emb[:, -1:]], dim=1)
        hcat = torch.cat([apply_norm(m["norm_h"], h_final, cfg),
                          apply_norm(m["norm_e"], e_next, cfg)], dim=-1)
        h = hcat @ m["proj"]
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        return block_forward(m["block"], h, cfg, positions, mode="train")[0]

    def _forward_encdec(self, params, batch, mode):
        """Whisper: ``enc_pos[:T]`` added to the frames, the encoder stack
        (bidirectional) and ``enc_norm`` make the memory; ``dec_pos[:S]``
        added to the token embeddings, the decoder stack cross-attends to
        the memory.  Returns (logits, aux (a float32 0), caches): in
        prefill ``stack`` (the self-attention (k, v) of (L,B,S,KH,hd)),
        ``memory`` (B,T,d) and ``enc_pos`` (B,T), else None."""
        cfg, dt = self.cfg, self.dtype
        frames, tokens = batch["frames"], batch["tokens"]
        B, T, _ = frames.shape
        S = tokens.shape[1]
        memory = frames.to(dt) + params["enc_pos"][:T].to(dt)
        enc_pos = torch.arange(T, device=memory.device).expand(B, T)
        w, t = layer_meta(cfg, cfg.n_encoder_layers)
        memory, _, _ = run_stack(params["encoder"], memory, cfg, enc_pos, w, t, "train",
                                 causal=False, remat=self.remat)
        memory = apply_norm(params["enc_norm"], memory, cfg)
        x = embed_tokens(params["embed"], tokens, cfg, dt)
        x = x + params["dec_pos"][:S].to(x.dtype)
        dec_pos = torch.arange(S, device=x.device).expand(B, S)
        w, t = layer_meta(cfg)
        x, c, _ = run_stack(params["stack"], x, cfg, dec_pos, w, t, mode,
                            kv_memory=(memory, enc_pos), remat=self.remat)
        logits = unembed(params["embed"], apply_norm(params["final_norm"], x, cfg), cfg)
        caches = None
        if mode == "prefill":
            caches = {"stack": c, "memory": memory,
                      "enc_pos": enc_pos.to(torch.int32).contiguous()}
        return logits, torch.zeros((), device=x.device), caches

    def _run_lm_stacks(self, params, x, positions, mode, cache_index=None, caches=None):
        """The dense, vlm and moe stacks: ``stack``, or ``dense_stack`` then
        ``moe_stack`` (caches ``dense`` and ``moe``).  Returns (x, aux,
        caches in prefill and decode, else None)."""
        cfg = self.cfg
        if "dense_stack" in params:
            nd = cfg.moe.n_dense_layers
            parts = (("dense_stack", "dense", nd), ("moe_stack", "moe", cfg.n_layers - nd))
        else:
            parts = (("stack", "stack", cfg.n_layers),)
        aux, out = 0.0, {}
        for name, key, n in parts:
            w, t = layer_meta(cfg, n)
            x, out[key], a = run_stack(params[name], x, cfg, positions, w, t, mode,
                                       caches[key] if caches else None, cache_index,
                                       remat=self.remat)
            aux = aux + a
        return x, aux, (out if mode in ("prefill", "decode") else None)

    def _run_ssm(self, params, x, mode, states: Optional[Dict] = None):
        cfg = self.cfg
        layers = params["layers"]
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            p_l = _index(layers, i)
            if mode == "train":
                x = remat_call(self.remat, lambda x, p_l=p_l: x + mamba_forward(
                    p_l["mamba"], apply_norm(p_l["ln"], x, cfg), cfg)[0], x)
                continue
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

    def _run_hybrid(self, params, x, x_emb, positions, mode, cache_index=None, caches=None):
        """Zamba2: for each group, ``every`` Mamba2 layers, then shared block
        ``g % n_shared_blocks`` applied to ``[hidden, x_emb] @ proj`` and its
        delta added to the hidden state (``_hybrid_group``; in train mode
        through ``remat_call``).  Returns (x, caches in prefill and decode,
        else None): ``mamba`` states stacked (n_groups, every, B, ...), new
        tensors, and ``shared_kv``, one (k, v) cache per group application
        (n_groups, B, S, KH, hd), written in place in decode."""
        cfg = self.cfg
        h = cfg.hybrid
        convs, ssms, ks, vs = [], [], [], []
        for g in range(cfg.n_layers // h.every):
            pg = _index(params["mamba_groups"], g)
            sb = _index(params["shared_blocks"], g % h.n_shared_blocks)
            if mode == "train":
                x = remat_call(self.remat, lambda x, pg=pg, sb=sb: self._hybrid_group(
                    pg, sb, x, x_emb, positions, mode)[0], x)
                continue
            states = kv = None
            if mode == "decode":
                states = MambaState(caches["mamba"].conv[g], caches["mamba"].ssm[g])
                kv = (caches["shared_kv"][0][g], caches["shared_kv"][1][g])
            x, new_states, kv = self._hybrid_group(pg, sb, x, x_emb, positions, mode,
                                                   cache_index, states, kv)
            convs += [st.conv for st in new_states]
            ssms += [st.ssm for st in new_states]
            if mode == "prefill":
                ks.append(kv[0])
                vs.append(kv[1])
        if mode not in ("prefill", "decode"):
            return x, None
        shape = (cfg.n_layers // h.every, h.every)
        mamba = MambaState(*(torch.stack(t).reshape(shape + t[0].shape) for t in (convs, ssms)))
        kv = caches["shared_kv"] if mode == "decode" else (torch.stack(ks), torch.stack(vs))
        return x, {"mamba": mamba, "shared_kv": kv}

    def _hybrid_group(self, pg, sb, x, x_emb, positions, mode, cache_index=None, states=None,
                      kv=None):
        """One zamba2 group: (x, the Mamba2 layers' new states, the shared
        block's (k, v)); in decode ``states`` (every, B, ...) and ``kv`` are
        the group's caches."""
        cfg = self.cfg
        new_states = []
        for e in range(cfg.hybrid.every):
            p_l = _index(pg, e)
            hn = apply_norm(p_l["ln"], x, cfg)
            if mode == "decode":
                y, st = mamba_decode(p_l["mamba"], hn, cfg,
                                     MambaState(states.conv[e], states.ssm[e]))
            else:
                y, st = mamba_forward(p_l["mamba"], hn, cfg)
            x = x + y
            new_states.append(st)
        inp = torch.cat([x, x_emb], dim=-1) if cfg.hybrid.concat_embedding else x
        hb = inp @ sb["proj"]
        yb, kv, _ = block_forward(sb["block"], hb, cfg, positions, mode=mode, cache=kv,
                                  cache_index=cache_index)
        return x + (yb - hb), new_states, kv  # the block returns hb + delta; add only the delta

    # ================================================================ loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The JAX package's training loss: next-token cross-entropy over
        ``forward("train")``'s logits (the last position, and a vlm batch's
        image positions but the last, carry no loss), plus
        ``router_aux_weight * moe_aux / n_layers`` for a MoE model and ``0.1
        * mtp_ce`` (tokens two ahead) with ``mtp_depth``.  Returns (total,
        metrics: ``ce``, ``moe_aux`` and ``mtp_ce`` where they apply,
        ``loss``), 0-d float32 tensors in the autograd graph."""
        cfg = self.cfg
        logits, aux, _ = self.forward(params, batch, mode="train")
        tokens = batch["tokens"].long()
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
        mask[:, -1] = 0.0
        if cfg.family == "vlm" and "patches" in batch:
            mask[:, : batch["patches"].shape[1] - 1] = 0.0  # no loss on image positions
        ce = _xent(logits, labels, mask)
        metrics = {"ce": ce}
        total = ce
        if cfg.moe is not None:
            moe_aux = aux[0] if isinstance(aux, tuple) else aux
            total = total + cfg.moe.router_aux_weight * moe_aux / max(cfg.n_layers, 1)
            metrics["moe_aux"] = moe_aux
        if cfg.mtp_depth and isinstance(aux, tuple):
            mtp_ce = self._mtp_loss(params, aux[1], tokens)
            total = total + 0.1 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, params, h_mtp, tokens):
        """Cross-entropy of the MTP head's logits against the tokens two
        ahead; the last two positions carry no loss."""
        logits = unembed(params["embed"], h_mtp, self.cfg)
        labels = torch.cat([tokens[:, 2:], tokens[:, -1:], tokens[:, -1:]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
        mask[:, -2:] = 0.0
        return _xent(logits, labels, mask)

    # ============================================================ serving
    def prefill(self, params, batch):
        """Forward + cache build.  Returns (cache, last-position logits)."""
        logits, _, caches = self.forward(params, batch, mode="prefill")
        return caches, logits[:, -1]

    def decode_step(self, params, tokens, cache, cache_index):
        """tokens: (B, 1) — one token per row.  ``cache_index``: the
        attention layers' write position, a Python int or a 0-d integer
        tensor for the whole batch, or a (B,) tensor of per-slot positions;
        a tensor stays on the device (no host sync), so the step can be
        captured in a CUDA graph.  The K/V cache is written in place; the
        SSM state comes back as new tensors and needs no position.  An
        encoder-decoder model adds ``dec_pos`` at ``min(cache_index,
        max_seq - 1)`` and its decoder cross-attends to ``cache["memory"]``,
        projecting its K and V anew in every layer, as the JAX package
        does."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg, self.dtype)
        if cfg.enc_dec:
            dec_pos = params["dec_pos"]
            _, idx_vec = _positions(cache_index, x.shape[0], x.device)
            x = x + dec_pos[idx_vec.clamp(max=dec_pos.shape[0] - 1)][:, None].to(x.dtype)
            w, t = layer_meta(cfg)
            x, c, _ = run_stack(params["stack"], x, cfg, None, w, t, "decode", cache["stack"],
                                cache_index, kv_memory=(cache["memory"], cache["enc_pos"]))
            cache = {**cache, "stack": c}
        elif cfg.family == "ssm":
            x, cache = self._run_ssm(params, x, "decode", states=cache)
        elif cfg.family == "hybrid":
            x, cache = self._run_hybrid(params, x, x, None, "decode", cache_index, cache)
        else:
            x, _, cache = self._run_lm_stacks(params, x, None, "decode", cache_index, cache)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["embed"], x, cfg)[:, 0], cache

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16, memory_t: int = 1500):
        """Zero decode state, one entry per layer stacked along axis 0: the
        attention families' (k, v) pair of (L, B, seq, KH, hd) (``dense`` and
        ``moe`` pairs for a MoE model with leading dense layers, the layout
        its decode reads and its prefill returns); the ssm family's Mamba
        state; the hybrid family's Mamba state (n_groups, every, B, ...) and
        one (k, v) pair of (n_groups, B, seq, KH, hd) for the shared block's
        applications; MLA's latent pair (c, r) of (L, B, seq, kv_lora) and
        (L, B, seq, rope) in place of (k, v); for an encoder-decoder model
        the decoder's (k, v) pair as ``stack``, ``memory`` (B, memory_t, d)
        zeros in ``dtype`` and ``enc_pos`` (B, memory_t) int32 zeros (the
        other families ignore ``memory_t``)."""
        cfg, dev = self.cfg, self.device
        tails = ((cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_head_dim,)) if cfg.mla is not None \
            else ((cfg.n_kv_heads, cfg.head_dim_),) * 2
        kv = lambda L: tuple(torch.zeros((L, batch, seq, *tail), dtype=dtype, device=dev)  # noqa: E731
                             for tail in tails)
        if cfg.family in ("ssm", "hybrid"):
            st = init_mamba_state(cfg, batch, dtype, dev)
            if cfg.family == "ssm":
                return {"layers": MambaState(*(a.expand(cfg.n_layers, *a.shape).contiguous()
                                               for a in st))}
            lead = (cfg.n_layers // cfg.hybrid.every, cfg.hybrid.every)
            return {"mamba": MambaState(*(a.expand(*lead, *a.shape).contiguous() for a in st)),
                    "shared_kv": kv(lead[0])}
        if cfg.moe is not None and cfg.moe.n_dense_layers:
            nd = cfg.moe.n_dense_layers
            return {"dense": kv(nd), "moe": kv(cfg.n_layers - nd)}
        if cfg.enc_dec:
            return {"stack": kv(cfg.n_layers),
                    "memory": torch.zeros((batch, memory_t, cfg.d_model), dtype=dtype, device=dev),
                    "enc_pos": torch.zeros((batch, memory_t), dtype=torch.int32, device=dev)}
        return {"stack": kv(cfg.n_layers)}

    def decode_attention_calls(self) -> int:
        """Attention-kernel launches of one ``decode_step``: one an attention
        layer (``decode_attention``, or MLA's ``decode_attention_latent``).
        A hybrid model's attention layers are its shared-block applications,
        one a group; an encoder-decoder's decoder layers attend twice, to
        themselves and to the memory; an SSM has none."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0
        if cfg.enc_dec:
            return 2 * cfg.n_layers
        return cfg.n_layers // cfg.hybrid.every if cfg.family == "hybrid" else cfg.n_layers


def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy in float32: (logsumexp - gold logit) over
    the positions where ``mask`` is 1, divided by their count (at least 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)


def _stack(trees):
    """Stack per-layer dicts along a new leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)

