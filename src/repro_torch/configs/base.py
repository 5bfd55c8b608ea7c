"""Model configs: a copy of the JAX package's ``configs/base.py`` dataclasses.

``ModelConfig`` covers every family the reference supports, so that a config
reads the same in both packages and ``reduced()`` / ``n_params()`` give the
same numbers.  Every architecture of ``ARCH_IDS`` has a module here and a
model in this package: the ``ssm`` family (mamba2-130m), the ``dense``
family (minicpm-2b, gemma3-4b, command-r-35b, command-r-plus-104b), the
``vlm`` backbone (llava-next-mistral-7b), the ``hybrid`` family
(zamba2-2.7b), the ``moe`` family (mixtral-8x22b, and deepseek-v3-671b with
MLA and MTP) and the ``audio`` encoder-decoder (whisper-small).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    expert_dff: int = 0
    router: str = "softmax"
    n_dense_layers: int = 0
    dense_dff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    every: int = 6
    n_shared_blocks: int = 2
    concat_embedding: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_bias: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    use_bias: bool = False
    parallel_block: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None
    learned_pos: bool = False
    tied_embeddings: bool = True
    scale_emb: float = 1.0
    depth_scale: float = 1.0
    logit_soft_cap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    mtp_depth: int = 0
    lr_schedule: str = "cosine"
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        emb = self.vocab * self.d_model * (1 if self.tied_embeddings else 2)
        total = emb + sum(self._layer_params(layer) for layer in range(self.n_layers))
        if self.enc_dec:
            total += self.n_encoder_layers * (self._attn_params() + self._mlp_params(self.d_ff))
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim_
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_hd
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

    def _mlp_params(self, d_ff: int) -> int:
        return (3 if self.gated_mlp else 2) * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s, d = self.ssm, self.d_model
        d_in = s.d_inner(d)
        nh = s.nheads(d)
        conv_dim = d_in + 2 * s.ngroups * s.d_state
        p = d * (2 * d_in + 2 * s.ngroups * s.d_state + nh)  # in_proj
        p += conv_dim * s.d_conv + d_in * d + 2 * nh  # conv, out_proj, A/D/dt_bias
        return p

    def _layer_params(self, layer: int) -> int:
        if self.family in ("ssm", "hybrid"):
            return self._ssm_params()
        p = self._attn_params()
        if self.moe is not None and layer >= self.moe.n_dense_layers:
            m = self.moe
            p += (m.n_experts + m.n_shared) * self._mlp_params(m.expert_dff)
            p += self.d_model * m.n_experts  # router
        elif self.moe is not None:
            p += self._mlp_params(self.moe.dense_dff)
        else:
            p += self._mlp_params(self.d_ff)
        return p

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = {}
        kw["n_layers"] = min(self.n_layers, 4 if self.family not in ("hybrid",) else 6)
        kw["d_model"] = 64
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4
        kw["head_dim"] = 16
        kw["d_ff"] = 128
        kw["vocab"] = 256
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_dff=64,
                dense_dff=128 if self.moe.n_dense_layers else 0,
                n_dense_layers=min(self.moe.n_dense_layers, 1),
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, headdim=16, chunk=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, every=3)
            kw["n_layers"] = 6
        if self.enc_dec:
            kw["n_encoder_layers"] = 2
            kw["n_layers"] = 2
        if self.sliding_window is not None:
            kw["sliding_window"] = 16
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 8
        return dataclasses.replace(self, name=self.name + "-reduced", **kw)


#: every architecture of the reference, each with a module in this package
ARCH_IDS = [
    "gemma3_4b",
    "command_r_35b",
    "minicpm_2b",
    "command_r_plus_104b",
    "whisper_small",
    "mixtral_8x22b",
    "deepseek_v3_671b",
    "zamba2_2p7b",
    "llava_next_mistral_7b",
    "mamba2_130m",
]
ARCH_ALIASES = {a.replace("_", "-").replace("-2p7b", "-2.7b"): a for a in ARCH_IDS}

_REGISTRY: Dict[str, ModelConfig] = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    key = ARCH_ALIASES.get(name, name).replace("-", "_")
    if key not in _REGISTRY:
        try:
            importlib.import_module(f"{__package__}.{key}")
        except ModuleNotFoundError:
            raise KeyError(f"unknown config {name!r}") from None
    return _REGISTRY[key]
