"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

Same hyperparameters as the JAX package's ``configs/command_r_35b.py``.

GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
Derived: head_dim=128, Cohere parallel attn+FFN residual block, LayerNorm
(no bias), RoPE, tied embeddings (Cohere ties input/output embeddings).
"""

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="command_r_35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab=256000,
        head_dim=128,
        norm="layernorm",
        norm_bias=False,
        use_bias=False,
        parallel_block=True,
        act="silu",
        gated_mlp=True,
        rope=True,
        rope_theta=8_000_000.0,
        tied_embeddings=True,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
)
