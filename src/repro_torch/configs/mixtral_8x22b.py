"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.

Same hyperparameters as the JAX package's ``configs/mixtral_8x22b.py``.

MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf]
Derived: head_dim=128, SWA window 4096, softmax router, SwiGLU experts,
RMSNorm, RoPE, untied embeddings (Mistral family).
"""

from .base import ModelConfig, MoEConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="mixtral_8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        head_dim=128,
        sliding_window=4096,
        act="silu",
        gated_mlp=True,
        norm="rmsnorm",
        rope=True,
        rope_theta=1_000_000.0,
        tied_embeddings=False,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            expert_dff=16384,
            router="softmax",
        ),
        source="arXiv:2401.04088; hf",
    )
)
