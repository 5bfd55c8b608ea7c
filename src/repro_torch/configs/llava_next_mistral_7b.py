"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Same hyperparameters as the JAX package's ``configs/llava_next_mistral_7b.py``.

Anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Derived: Mistral-7B backbone (head_dim=128, SwiGLU, RMSNorm, RoPE, full
attention — LLaVA-1.6 disables SWA).  The anyres vision tower is a stub: the
model takes pre-projected patch embeddings (B, 2880, 4096) = (4 tiles + 1
base) x 576 patches; see ``models/frontends.py``.
"""

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="llava_next_mistral_7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        head_dim=128,
        act="silu",
        gated_mlp=True,
        norm="rmsnorm",
        rope=True,
        rope_theta=1_000_000.0,
        tied_embeddings=False,
        frontend="vision",
        n_frontend_tokens=2880,   # anyres: (4 + 1) tiles x 576 patches
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )
)
