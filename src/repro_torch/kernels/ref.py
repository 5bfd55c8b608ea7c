"""Plain PyTorch versions of the CUDA kernels, with the kernels' contracts.

  sched_step_ref   <-> csrc/sched.cu, ARRIVAL-only specialisation
  sched_events_ref <-> csrc/sched.cu (mixed ARRIVAL|FINISH|EVICT bursts)
  ssd_scan_ref     <-> csrc/ssd_scan.cu (the chunked SSD of models/mamba.py)

``kernels/ops.py`` takes these for tensors on the CPU; the tests and
``chip_smoke.py`` hold each kernel against its plain version on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensors4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sched_step_ref(funcs: torch.Tensor, idle: torch.Tensor, conns: torch.Tensor) -> Tensors4:
    """ARRIVAL-only burst with lowest-index ties.

    funcs (R,) int32; idle (F, W) int32; conns (W,) int32.  Returns
    (assign (R,) int32, warm (R,) bool, idle', conns'); inputs untouched.
    """
    kinds = torch.zeros_like(funcs)
    workers = torch.full_like(funcs, -1)
    a, warm, idle2, conns2 = sched_events_ref(kinds, funcs, workers, idle, conns)
    return a, warm.bool(), idle2, conns2


def sched_events_ref(
    kinds: torch.Tensor,    # (R,) int32 — 0 ARRIVAL / 1 FINISH / 2 EVICT / >=3 no-op
    funcs: torch.Tensor,    # (R,) int32
    workers: torch.Tensor,  # (R,) int32 (-1 for ARRIVAL)
    idle: torch.Tensor,     # (F, W) int32
    conns: torch.Tensor,    # (W,) int32
) -> Tensors4:
    """Mixed-event burst: ``core.sched.sched_many`` with lowest-index ties.

    Returns (assign (R,) int32, -1 for non-ARRIVAL; warm (R,) int32; idle';
    conns').  Inputs untouched.
    """
    from ..core.sched import JIQState, sched_many  # deferred: core imports ops

    events = torch.stack([kinds, funcs, workers], dim=1).to(torch.int32)
    state, (ws, warm) = sched_many(JIQState(idle, conns), events)
    return ws, warm.to(torch.int32), state.idle, state.conns


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD oracle: the model's plain implementation."""
    from ..models.mamba import ssd_chunked  # deferred: models import ops

    return ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)
