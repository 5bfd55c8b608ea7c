"""Decode steps captured once in a CUDA graph and replayed.

The JAX package's ``Instance`` and ``ContinuousBatcher`` compile
``decode_step`` with ``jax.jit``; here a step is captured in a CUDA graph,
which takes away the host's launch cost: one replay runs every kernel of
the step.  A step is a function of no arguments that reads and writes only
tensors that stay where they are: the parameters, and static input, state
and output buffers that the caller fills before each replay.  Positions live
in those buffers too (``Model.decode_step`` takes them as device tensors),
so one capture serves every position and every mix of per-row lengths.

``ops.LAUNCHES`` counts the kernels a wrapper launches; a replay does not
pass through the wrappers, so each ``CapturedStep`` records the launches of
one replay when it is captured, and ``REPLAYED`` adds them up on every
replay, by kernel and (``REPLAYED_SHAPES``) by the call's shape, as
``ops.SHAPE_LAUNCHES`` keys it.  ``launches()`` and ``launches_by_shape()``
are the sums of the two.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch

from ..kernels import ops

#: replays of captured steps (``"steps"``), and the kernel launches they
#: made, by kernel, since the last ``reset_replays()``
REPLAYED: Dict[str, int] = {"steps": 0, **dict.fromkeys(ops.LAUNCHES, 0)}
#: the same launches by shape
REPLAYED_SHAPES: Dict[tuple, int] = {}


def reset_replays() -> None:
    for k in REPLAYED:
        REPLAYED[k] = 0
    REPLAYED_SHAPES.clear()


def launches() -> Dict[str, int]:
    """Kernel launches since the counters were last reset: the wrappers'
    own (``ops.LAUNCHES``) plus those of the replays (``REPLAYED``)."""
    return {k: n + REPLAYED[k] for k, n in ops.LAUNCHES.items()}


def launches_by_shape() -> Dict[tuple, int]:
    """``launches()`` by the call's shape (``ops.SHAPE_LAUNCHES``' keys)."""
    out = dict(ops.SHAPE_LAUNCHES)
    for k, n in REPLAYED_SHAPES.items():
        out[k] = out.get(k, 0) + n
    return out


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict / tuple (a model's cache)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def copy_into(dst: Any, src: Any) -> None:
    """Copy each leaf of ``src`` into the same leaf of ``dst`` unless it is
    that tensor already (a cache written in place)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


class CapturedStep:
    """``fn`` captured in a CUDA graph on ``device``.  It is called once
    eagerly first, on a side stream: that loads the kernels, warms the
    libraries and makes the allocations a first call makes (the decode
    kernel's ticket buffer among them), none of which may happen inside a
    capture.  Then it is captured; ``out`` is what the captured call
    returned, tensors in the graph's own memory that every replay
    overwrites.  The eager call's side effects on the static buffers stay:
    the caller sets them before each replay."""

    def __init__(self, fn: Callable[[], Any], device: torch.device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        # the capture recorded these launches; they run on each replay
        self.launches = {k: ops.LAUNCHES[k] - before[0][k] for k in before[0]}
        self.shape_launches = {k: n - before[1].get(k, 0)
                               for k, n in ops.SHAPE_LAUNCHES.items() if n != before[1].get(k, 0)}
        ops.restore_launches(before)
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        REPLAYED["steps"] += 1
        for k, n in self.launches.items():
            REPLAYED[k] += n
        for k, n in self.shape_launches.items():
            REPLAYED_SHAPES[k] = REPLAYED_SHAPES.get(k, 0) + n
