from .convert import opt_state_from_numpy, params_from_numpy
from .model import Model, build_model
from .moe import apply_moe, init_moe, route

__all__ = ["Model", "apply_moe", "build_model", "init_moe", "opt_state_from_numpy",
           "params_from_numpy", "route"]
