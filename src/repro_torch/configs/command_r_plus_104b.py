"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.

Same hyperparameters as the JAX package's ``configs/command_r_plus_104b.py``.

GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
Derived: head_dim=128, Cohere parallel residual block family (see
command_r_35b).
"""

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="command_r_plus_104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab=256000,
        head_dim=128,
        norm="layernorm",
        norm_bias=False,
        use_bias=False,
        parallel_block=True,
        act="silu",
        gated_mlp=True,
        rope=True,
        rope_theta=75_000_000.0,
        tied_embeddings=True,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
)
