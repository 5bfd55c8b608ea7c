"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.

Same hyperparameters as the JAX package's ``configs/zamba2_2p7b.py``.

Mamba2 + shared attention blocks. [arXiv:2411.15242; hf]
Derived: 54 Mamba2 layers (d_inner=5120, headdim=64 -> 80 ssm heads,
d_state=64, conv=4); 2 *shared* transformer blocks (32 heads, d_ff=10240)
applied after every 6th Mamba layer, alternating; shared-block input is
concat(hidden, embedding) -> down-projection (Zamba2 scheme; per-application
LoRA deltas omitted, as in the JAX package).
"""

from .base import HybridConfig, ModelConfig, SSMConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="zamba2_2p7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        head_dim=80,             # shared attention block: 2560/32
        act="silu",
        gated_mlp=True,
        norm="rmsnorm",
        rope=True,
        rope_theta=10_000.0,
        tied_embeddings=True,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, ngroups=1, chunk=256),
        hybrid=HybridConfig(every=6, n_shared_blocks=2, concat_embedding=True),
        source="arXiv:2411.15242; hf",
    )
)
