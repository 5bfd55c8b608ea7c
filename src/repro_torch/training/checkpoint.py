"""Checkpoint and restart in the JAX package's on-disk format (counterpart of
its ``training/checkpoint.py``): atomic, integrity-checked, async.

Layout per step:  <dir>/step_0000042/
    manifest.json   — step, wall time, and for each leaf its sha256[:16],
                      shape and dtype name
    arrays.npz      — the leaves, keyed by their path in the tree

A leaf's key joins its path with ``/`` as the JAX package's does: a dict key
as it is, a sequence index as its number, a named-tuple field as ``.`` and
its name (an ``OptState``'s ``.m``, ``.v``, ``.step``).  bfloat16 is stored
as its ``uint16`` bits and the fp8 types as ``uint8``, under the dtype names
``bfloat16``, ``float8_e4m3fn`` and ``float8_e5m2`` (no ``ml_dtypes``
needed), so each package restores the other's checkpoints.

* atomic publish: written to ``.tmp-…`` then renamed, so a crashed writer
  never corrupts the latest checkpoint;
* integrity: the sha256 of each leaf's stored bytes, checked on restore;
* async: ``save_async`` copies the leaves to host memory before it returns
  (the train step updates the parameters in place) and writes them in a
  background thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import default_device
from .optimizer import tree_map

# stored as raw bits: (torch dtype, numpy view of the bits)
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}


def _paths(tree, prefix=()):
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from _paths(sub, prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_storable(leaf) -> tuple:
    """(array as stored, dtype name) of a tensor or array; a copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXT_DTYPES:
            raw = _EXT_DTYPES[name][1]
            bits = torch.int16 if raw == np.uint16 else torch.uint8
            return t.view(bits).numpy().view(raw), name
        return t.numpy(), name
    a = np.array(leaf, copy=True)
    if a.dtype.name in _EXT_DTYPES:  # an ml_dtypes array
        return a.view(_EXT_DTYPES[a.dtype.name][1]), a.dtype.name
    return a, a.dtype.name


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXT_DTYPES:
        torch_dtype, raw = _EXT_DTYPES[dtype_name]
        bits = a.view(np.int16) if raw == np.uint16 else a
        return torch.from_numpy(bits.copy()).view(torch_dtype)
    return torch.from_numpy(a.copy())


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _snapshot(tree) -> Dict[str, tuple]:
    return {key: _to_storable(leaf) for key, leaf in _paths(tree)}


def _write(ckpt_dir: Path, step: int, flat: Dict[str, tuple], keep: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp-step_{step:08d}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"sha": _sha(a), "shape": list(a.shape), "dtype": name}
                   for k, (a, name) in flat.items()},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str | os.PathLike, step: int, tree, keep: int = 3) -> Path:
    """Synchronous atomic checkpoint write; returns the published path.  The
    ``keep`` newest steps stay, older ones are removed."""
    return _write(Path(ckpt_dir), step, _snapshot(tree), keep)


_PENDING: Dict[str, threading.Thread] = {}


def save_async(ckpt_dir: str | os.PathLike, step: int, tree, keep: int = 3) -> threading.Thread:
    """Copy the leaves to host memory now, write them in a background thread;
    returns the writer thread (``wait_pending`` joins it)."""
    flat = _snapshot(tree)
    t = threading.Thread(target=_write, args=(Path(ckpt_dir), step, flat, keep), daemon=True)
    t.start()
    _PENDING[str(ckpt_dir)] = t
    return t


def wait_pending(ckpt_dir: str | os.PathLike) -> None:
    t = _PENDING.pop(str(ckpt_dir), None)
    if t is not None:
        t.join()


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, like, step: Optional[int] = None, device=None,
            verify: bool = True):
    """Restore into the structure of ``like`` (any tree whose leaves stand
    for tensors): (tree of tensors on ``device``, the card unless
    ``device="cpu"``; step).  The latest step unless ``step`` is given;
    with ``verify`` each leaf's sha256 is checked first (``IOError`` on a
    mismatch)."""
    d = Path(ckpt_dir)
    step = latest_step(d) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {d}")
    path = d / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as arrays:
        arrays = {k: arrays[k] for k in arrays.files}
    if verify:
        for k, meta in manifest["leaves"].items():
            got = _sha(arrays[k])
            if got != meta["sha"]:
                raise IOError(f"checkpoint corruption at leaf {k}: {got} != {meta['sha']}")
    device = default_device(device)
    keys = iter([key for key, _ in _paths(like)])  # tree_map visits the leaves in this order
    restored = tree_map(lambda _: _from_storable(
        arrays[k := next(keys)], manifest["leaves"][k]["dtype"]).to(device), like)
    return restored, step


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(ckpt_dir.glob("step_*"), key=lambda p: p.name)
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
