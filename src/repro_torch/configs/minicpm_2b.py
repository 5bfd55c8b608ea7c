"""minicpm-2b [dense]: 40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.

Same hyperparameters as the JAX package's ``configs/minicpm_2b.py``.

WSD schedule, llama-like. [arXiv:2404.06395; hf]
Derived: head_dim=64, SwiGLU, RMSNorm, RoPE; MiniCPM mup-style knobs:
scale_emb=12, depth-scaled residual 1.4/sqrt(40), tied embeddings.
``lr_schedule="wsd"`` names the warmup-stable-decay schedule that
``training.make_train_step`` takes by default for it.
"""

import math

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="minicpm_2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab=122753,
        head_dim=64,
        act="silu",
        gated_mlp=True,
        norm="rmsnorm",
        rope=True,
        rope_theta=10_000.0,
        tied_embeddings=True,
        scale_emb=12.0,
        depth_scale=1.4 / math.sqrt(40),
        lr_schedule="wsd",
        source="arXiv:2404.06395; hf",
    )
)
