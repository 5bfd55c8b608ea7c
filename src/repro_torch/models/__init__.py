from .convert import params_from_numpy
from .model import Model, build_model

__all__ = ["Model", "build_model", "params_from_numpy"]
