"""whisper-small [audio]: 12L d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865.

Same hyperparameters as the JAX package's ``configs/whisper_small.py``.

Encoder-decoder, conv frontend (STUB). [arXiv:2212.04356; unverified]
Derived: 12 encoder + 12 decoder layers, learned positions, GELU MLP
(non-gated), LayerNorm with bias, cross-attention in the decoder.  The conv
frontend is a stub: the model takes post-conv frame embeddings (B, T, 768);
see models/frontends.py.
"""

from .base import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="whisper_small",
        family="audio",
        n_layers=12,              # decoder layers
        n_encoder_layers=12,
        enc_dec=True,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        head_dim=64,
        norm="layernorm",
        norm_bias=True,
        use_bias=True,
        act="gelu",
        gated_mlp=False,
        rope=False,
        learned_pos=True,
        tied_embeddings=True,
        frontend="audio",
        source="arXiv:2212.04356; unverified",
    )
)
