"""Carry parameters across from the JAX package.

The JAX model's parameters are a tree of ``Param`` leaves; its
``models/layers.py::unzip`` gives the value tree, and ``numpy.asarray`` on
each leaf gives plain arrays.  ``params_from_numpy`` turns that tree of
numpy arrays into the port's parameters: the same nested dict, each leaf a
tensor on ``device``.  The layouts already agree (layer-stacked leading
axis, ``(in, out)`` projection matrices), so nothing is transposed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import default_device


def params_from_numpy(tree: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """Map a nested dict/list/tuple of numpy arrays to tensors on ``device``
    (the card unless ``device="cpu"``), optionally cast to ``dtype``."""
    return _to_tensors(tree, default_device(device), dtype)


def _to_tensors(tree: Any, device: torch.device, dtype: torch.dtype | None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to_tensors(v, device, dtype) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)
