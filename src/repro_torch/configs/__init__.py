from .base import (
    ARCH_ALIASES,
    ARCH_IDS,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    register_config,
)

__all__ = [
    "ARCH_ALIASES",
    "ARCH_IDS",
    "HybridConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "register_config",
]
