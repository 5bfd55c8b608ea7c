"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

Same hyperparameters as the JAX package's ``configs/gemma3_4b.py``.

5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt; unverified]
Derived (DESIGN.md §4): head_dim=256 (Gemma3 card), sliding window 1024,
local rope theta 1e4 / global 1e6, GeGLU, RMSNorm, qk-norm, tied embeddings.
"""

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="gemma3_4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_ff=10240,
        vocab=262144,
        head_dim=256,
        sliding_window=1024,
        global_every=6,          # 5 local : 1 global
        act="gelu",
        gated_mlp=True,
        norm="rmsnorm",
        qk_norm=True,
        rope=True,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        tied_embeddings=True,
        source="hf:google/gemma-3-1b-pt; unverified",
    )
)
