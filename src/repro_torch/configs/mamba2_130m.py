"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) vocab=50280, ssm_state=128.

Same hyperparameters as the JAX package's ``configs/mamba2_130m.py``:
d_inner=1536 (expand 2), headdim=64 -> 24 ssm heads, d_state=128, conv=4,
chunk=256, ngroups=1, RMSNorm, no positional embedding, tied embeddings.
"""

from .base import ModelConfig, SSMConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="mamba2_130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,               # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,                  # no MLP: Mamba2 block only
        vocab=50280,
        head_dim=64,
        rope=False,
        norm="rmsnorm",
        tied_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1, chunk=256),
        source="arXiv:2405.21060; unverified",
    )
)
