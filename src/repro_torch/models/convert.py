"""Carry parameters across from the JAX package.

The JAX model's parameters are a tree of ``Param`` leaves; its
``models/layers.py::unzip`` gives the value tree, and ``numpy.asarray`` on
each leaf gives plain arrays.  ``params_from_numpy`` turns that tree of
numpy arrays into the port's parameters: the same nested dict, each leaf a
tensor on ``device``.  The layouts already agree (layer-stacked leading
axis, ``(in, out)`` projection matrices), so nothing is transposed.
``opt_state_from_numpy`` carries an optimizer state (``m``, ``v``, ``step``)
across the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import default_device
from ..training.optimizer import OptState

#: leaves that the JAX init makes in float32 whatever ``param_dtype`` is (and
#: the port's ``Model.init`` too): norm scales and biases (``scale``,
#: ``bias``; attention's ``q_norm``/``k_norm`` and MLA's ``kv_norm``), the MoE
#: ``router`` and ``router_bias``, and the Mamba block's ``A_log``, ``D``,
#: ``dt_bias`` and ``norm``.  Projection biases are ``b*`` and ``conv_b``.
FLOAT32_LEAVES = frozenset({"scale", "bias", "q_norm", "k_norm", "kv_norm", "router",
                            "router_bias", "A_log", "D", "dt_bias", "norm"})


def params_from_numpy(tree: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """Map a nested dict/list/tuple of numpy arrays to tensors on ``device``
    (the card unless ``device="cpu"``).  With ``dtype``, every leaf that the
    JAX init makes in ``param_dtype`` is cast to it, and the leaves of
    ``FLOAT32_LEAVES`` stay float32, so the result has the leaf dtypes of
    ``Model(cfg, param_dtype=dtype).init``."""
    return _to_tensors(tree, default_device(device), dtype, None)


def opt_state_from_numpy(m: Any, v: Any, step, device=None) -> OptState:
    """The port's ``OptState`` from the JAX package's moments ``m`` and
    ``v`` (trees of numpy arrays, float32) and ``step``: the moments as
    tensors on ``device`` (the card unless ``device="cpu"``), the step a 0-d
    int32 tensor there."""
    device = default_device(device)
    return OptState(m=_to_tensors(m, device, None, None), v=_to_tensors(v, device, None, None),
                    step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device))


def _to_tensors(tree: Any, device: torch.device, dtype: torch.dtype | None, key) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to_tensors(v, device, dtype, key) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is None:
        return t.to(device)
    return t.to(device=device, dtype=torch.float32 if key in FLOAT32_LEAVES else dtype)
