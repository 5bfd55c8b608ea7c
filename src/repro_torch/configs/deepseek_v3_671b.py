"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280.

Same hyperparameters as the JAX package's ``configs/deepseek_v3_671b.py``.

MLA, MoE 1 shared + 256 routed top-8, MTP. [arXiv:2412.19437; hf]
Derived (DeepSeek-V3 paper): MLA q_lora=1536, kv_lora=512, qk_nope=128,
qk_rope=64, v_head=128; first 3 layers dense with d_ff=18432; sigmoid router
with top-8 routing; 1 shared expert; MTP depth 1 (training feature).
The assigned d_ff=2048 is the per-expert (routed) FFN width.
"""

from .base import MLAConfig, ModelConfig, MoEConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="deepseek_v3_671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,          # MLA is effectively MHA over a shared latent
        d_ff=2048,
        vocab=129280,
        head_dim=128,
        act="silu",
        gated_mlp=True,
        norm="rmsnorm",
        rope=True,
        rope_theta=10_000.0,
        tied_embeddings=False,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            n_shared=1,
            expert_dff=2048,
            router="sigmoid",
            n_dense_layers=3,
            dense_dff=18432,
        ),
        mtp_depth=1,
        source="arXiv:2412.19437; hf",
    )
)
