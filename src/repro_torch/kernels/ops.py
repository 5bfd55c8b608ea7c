"""Wrappers around the CUDA kernels, each with a launch counter.

A tensor on the card goes to the kernel (built at first use by
``kernels/build.py``) or the wrapper raises; a tensor on the CPU goes to the
plain version in ``kernels/ref.py``.  There is no other fallback.  Each
wrapper checks device, dtype, shape and contiguity, allocates the outputs,
launches on PyTorch's current stream, raises if the launch returned a CUDA
error, and adds one to ``LAUNCHES[name]``, only where it launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build, ref

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"sched_events": 0, "sched_step": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sched_launch(kinds, funcs, workers, idle, conns, arrival_only: bool):
    R = funcs.shape[0]
    F_, W = idle.shape
    if W < 1:
        raise ValueError("need at least one worker")
    for nm, t in (("funcs", funcs), ("kinds", kinds), ("workers", workers)):
        if t is not None:
            _check(nm, t, torch.int32, (R,))
    _check("idle", idle, torch.int32, (F_, W))
    _check("conns", conns, torch.int32, (W,))
    idle_out, conns_out = idle.clone(), conns.clone()
    assign = torch.empty((R,), dtype=torch.int32, device=idle.device)
    warm = torch.empty((R,), dtype=torch.int32, device=idle.device)
    lib = build.load("sched")
    with torch.cuda.device(idle.device):
        err = lib.sched_events_launch(
            kinds.data_ptr() if kinds is not None else None,
            funcs.data_ptr(),
            workers.data_ptr() if workers is not None else None,
            idle_out.data_ptr(), conns_out.data_ptr(), assign.data_ptr(), warm.data_ptr(),
            R, F_, W, int(arrival_only), _stream(idle),
        )
    _raise_on(err, "sched_events")
    return assign, warm, idle_out, conns_out


def sched_events(kinds, funcs, workers, idle, conns):
    """One mixed (ARRIVAL|FINISH|EVICT) burst.  Returns (assign (R,) int32,
    -1 for non-ARRIVAL; warm (R,) int32; idle'; conns').  Inputs untouched.
    Precondition: ``idle`` and ``conns`` non-negative, conns below 2**30."""
    if not _on_cuda(kinds, funcs, workers, idle, conns):
        return ref.sched_events_ref(kinds, funcs, workers, idle, conns)
    out = _sched_launch(kinds, funcs, workers, idle, conns, arrival_only=False)
    LAUNCHES["sched_events"] += 1
    return out


def sched_step(funcs, idle, conns):
    """ARRIVAL-only burst.  Returns (assign (R,) int32, warm (R,) int32,
    idle', conns').  Inputs untouched."""
    if not _on_cuda(funcs, idle, conns):
        a, warm, i2, c2 = ref.sched_step_ref(funcs, idle, conns)
        return a, warm.to(torch.int32), i2, c2
    out = _sched_launch(None, funcs, None, idle, conns, arrival_only=True)
    LAUNCHES["sched_step"] += 1
    return out


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD chunked scan.  x (B,S,H,P) float32 or bfloat16; dt (B,S,H)
    float32 post-softplus; A (H,) float32; Bm, Cm (B,S,G,N) in x's dtype;
    init_state (B,H,P,N) float32 or None (zeros).  Returns (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) float32).  ``S`` is padded to a
    multiple of ``chunk``.  The kernel covers ngroups G == 1 and raises on
    the card for any other G."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    on_cuda = _on_cuda(*(t for t in (x, dt, A, Bm, Cm, init_state) if t is not None))
    pad = (-S) % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    if not on_cuda:
        y, st = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state)
        return (y[:, :S] if pad else y), st
    if G != 1:
        raise ValueError(f"ssd_scan kernel covers ngroups=1, got {G} (ROADMAP Queue 3)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    Sp = S + pad
    _check("x", x, x.dtype, (Bsz, Sp, H, P))
    _check("dt", dt, torch.float32, (Bsz, Sp, H))
    _check("A", A, torch.float32, (H,))
    _check("Bm", Bm, x.dtype, (Bsz, Sp, 1, N))
    _check("Cm", Cm, x.dtype, (Bsz, Sp, 1, N))
    if init_state is not None:
        _check("init_state", init_state, torch.float32, (Bsz, H, P, N))
    lib = build.load("ssd_scan")
    if N > lib.ssd_scan_max_n():
        raise ValueError(f"ssd_scan kernel takes d_state <= {lib.ssd_scan_max_n()}, got {N}")
    y = torch.empty_like(x)
    st = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), st.data_ptr(),
            Bsz, Sp, H, P, N, chunk, int(x.dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return (y[:, :S] if pad else y), st
