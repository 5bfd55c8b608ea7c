"""Wrappers around the CUDA kernels, each with a launch counter.

A tensor on the card goes to the kernel (built at first use by
``kernels/build.py``) or the wrapper raises; a tensor on the CPU goes to the
plain version in ``kernels/ref.py``.  There is no other fallback.  Each
wrapper checks device, dtype, shape and contiguity, allocates the outputs,
launches on PyTorch's current stream, raises if the launch returned a CUDA
error, and adds one to ``LAUNCHES[name]``, only where it launches; the same
launch counts in ``SHAPE_LAUNCHES`` under the call's shape.  A call
recorded into a CUDA graph counts too; its replays do not pass through the
wrapper (``serving/captured.py`` counts them).

Gradients.  On the card ``flash_attention`` and ``ssd_scan`` are
``torch.autograd.Function``s when grad mode is on and an input requires a
gradient: their forwards launch the same kernels (``flash_attention`` then
also writes the rows' log-sum-exp, ``ssd_scan`` keeps its scratch: C.B^T,
the chunk cumsums and the states entering the chunks), and their backwards
launch ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) and
``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``).  With no gradient wanted the
calls are exactly the serving path's.  The wrappers that have no backward
kernel (``decode_attention`` and ``decode_attention_latent``: no train step
decodes) raise ``NotImplementedError`` on the card under autograd, so no
gradient is cut silently; on the CPU the plain versions are torch
operations and differentiate as they are.

The model kernels take their inputs in any of ``FLOAT_DTYPES``, as the
Pallas kernels cast each tile to float32: the combinations a kernel is
instantiated for run as they are, any other is cast to float32 first and
the output cast back to q's (or x's) dtype, which is the Pallas kernels'
arithmetic exactly.

Twins.  On tensors that hold no data (the ``meta`` device, or fake tensors
under ``FakeTensorMode``), on whatever device they claim, each wrapper is
its kernel's twin: it makes the checks the card's path makes (dtypes, head
dims, shapes, layout; not the storage's alignment, which such a tensor
lacks), returns empty outputs of the kernel's shapes and dtypes (under
autograd through the same ``autograd.Function``s, whose backwards reach the
backward twins), adds the kernel's least work (``kernels/counts.py``) to the
active accounting (``counts.account``: the dry run's), and counts nothing in
``LAUNCHES`` or ``SHAPE_LAUNCHES``.  Where a twin's work depends on data it
cannot read (a decode's ``valid_len`` as a tensor, a burst's kinds), it
counts the most: every cache row, every event an ARRIVAL.

Dense products.  ``dense`` is the models' projections (q/k/v, o, the MLP,
the unembedding): a product that ``tc_refusal`` lets through (float32 on
the card, no gradient, at least ``LINEAR_MIN_ROWS`` rows, strides TMA
reads, at least ``LINEAR_MIN_TILES`` tiles) runs on ``linear_tf32x3``; any
other keeps ``torch.matmul``, the path such products took before the
kernel, so the CPU, bfloat16 models, decode steps, train steps,
``DTensor``s and the dry run's twins see the same arithmetic as then.
``linear_tf32x3`` itself has no twin.

Sharded inputs.  The model kernels take ``DTensor``s too: sharded only on
the batch dim over the data axes ("pod", "data") and on the head dim over
"model" (where each rank then holds whole GQA query groups, or SSM head
groups), each rank runs the wrapper on its local shards
(``torch.distributed.tensor.experimental.local_map``); any other placement
is first redistributed to those.
"""

from __future__ import annotations

import operator
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.ctx import model_size, on_local_shards, sharded
from . import build, counts, ref

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"sched_events": 0, "sched_step": 0, "ssd_scan": 0,
                            "ssd_scan_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0,
                            "decode_attention": 0, "decode_attention_latent": 0,
                            "linear_tf32x3": 0}

#: head dims the attention kernels are instantiated for (the repo's attention
#: configs, plus 16 and 32 for the tiny serving and test configs)
ATTN_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: (q/k head dim, v head dim) pairs the prefill kernel is instantiated for
#: beside the equal ones: MLA's expanded heads (deepseek-v3: nope 128 + rope
#: 64 against v 128)
FLASH_SPLIT_DIMS = ((192, 128),)
#: (latent, rope) dims the absorbed-MLA decode kernel is instantiated for
#: (deepseek-v3: kv_lora 512, qk_rope 64).  Its tensor-core kernel
#: (bfloat16 q and caches) carries ``LATENT_HEADS`` query heads a CTA (one
#: wgmma M tile; the heads past H of the last group are zeros), reads the
#: cache in tiles of ``LATENT_ROWS`` rows (also the granule of a CTA's
#: share), aims for ``LATENT_CTAS_PER_SM`` CTAs per SM (~217 KB of shared
#: memory each) and takes at most ``LATENT_MAX_SPLITS`` splits a unit (a
#: split's partial is 64 x 512 float32, merged by a second launch).  The
#: CUDA-core kernel (float32 or mixed types) has its own: 16 heads a CTA,
#: 16-row tiles, 2 CTAs per SM, at most 16 splits (its last CTA merges
#: splits x 32 KB of partials).  H is a multiple of ``LATENT_F32_HEADS``
#: for both.
LATENT_DIMS = ((512, 64),)
LATENT_HEADS = 64
LATENT_ROWS = 64
LATENT_CTAS_PER_SM = 1
LATENT_MAX_SPLITS = 32
LATENT_F32_HEADS = 16
LATENT_F32_ROWS = 16
LATENT_F32_CTAS_PER_SM = 2
LATENT_F32_MAX_SPLITS = 16
#: the decode kernel's geometry (``decode_geometry``): CTAs it aims for per
#: SM, the granule of cache rows a CTA's share is made of, the float32
#: partial columns (splits x heads x hd) that one CTA may merge before the
#: rule stops adding splits beyond one CTA per SM, and the most splits a unit
DECODE_CTAS_PER_SM = 4
DECODE_SHARE_ROWS = 16
DECODE_MERGE_FLOATS = 16384
DECODE_MAX_SPLITS = 1024

#: the longest ``ssd_scan`` chunk and the most query heads a kv head that
#: the kernels take (``csrc/ssd_scan.cu``'s ``kMaxQ``,
#: ``csrc/decode_attention.cu``'s ``kMaxG``), for the twins' checks
SSD_MAX_CHUNK = 1024
DECODE_MAX_GROUP = 32

#: the most products of one A that one ``linear_tf32x3`` launch runs
#: (``csrc/linear_tf32x3.cu``'s ``kMaxGroup``), and the fewest rows (after
#: the leading dims are flattened) that ``dense`` sends to it: one wgmma's
#: 64-row M tile
LINEAR_MAX_GROUP = 3
LINEAR_MIN_ROWS = 64
#: the kernel's tile of C (a CTA each, one CTA an SM), and the fewest tiles
#: that ``dense`` sends to it: about half of the H100's 132 SMs.  With fewer
#: most SMs idle, where cuBLAS's float32 GEMMs spread the product over the
#: whole card.  Device time in CUDA graphs against float32 ``torch.matmul``:
#: 1.7-2.3 x at 24 tiles (whisper-small's o and down at 440 rows), 0.89 x at
#: 48, 0.47-0.78 x at 72 to 216; whisper-small's 440-token prefill 8.96 ms
#: with this rule, 11.09 with every product on the kernel
LINEAR_TILE = 128
LINEAR_MIN_TILES = 64

#: input dtypes the model kernels' wrappers take
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                torch.float8_e5m2)
#: q (and x) dtypes the attention and scan kernels are instantiated for, and
#: the decode kernel's cache dtypes; the codes the C interface takes
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

#: the same launches by the call's shape: ``(name, *shape_key(args))`` ->
#: launches, so that calls of one kernel at different shapes count apart
SHAPE_LAUNCHES: Dict[tuple, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def launch_counts() -> Tuple[Dict[str, int], Dict[tuple, int]]:
    """Copies of ``LAUNCHES`` and ``SHAPE_LAUNCHES``, for ``restore_launches``."""
    return dict(LAUNCHES), dict(SHAPE_LAUNCHES)


def restore_launches(counts: Tuple[Dict[str, int], Dict[tuple, int]]) -> None:
    """Set both counters back to ``launch_counts()``'s copies."""
    LAUNCHES.update(counts[0])
    SHAPE_LAUNCHES.clear()
    SHAPE_LAUNCHES.update(counts[1])


def shape_key(*args) -> tuple:
    """The shape of a call, by which ``SHAPE_LAUNCHES`` counts it: each
    tensor argument's shape and dtype, any other argument as it is (the
    wrappers leave out ``valid_len``, which is data)."""
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a for a in args)


def _launched(name: str, *args) -> None:
    """Count one launch of ``name``: by name, and by the shape of ``args``."""
    LAUNCHES[name] += 1
    key = (name, *shape_key(*args))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1


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


def _abstract(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether any of ``tensors`` holds no data: on ``meta``, or fake."""
    from torch._subclasses.fake_tensor import is_fake

    return any(t is not None and (t.device.type == "meta" or is_fake(t)) for t in tensors)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether the storage of each of ``tensors`` is 16-byte aligned (a twin's
    tensors have none to check)."""
    return _abstract(*tensors) or not any(t.data_ptr() % 16 for t in tensors)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_floats(**tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is not None and t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name}: expected one of {FLOAT_DTYPES}, got {t.dtype}")


def _wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, lifted_by: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} has no backward kernel: on the card it does not run under autograd, so that no "
        f"gradient is cut silently ({lifted_by})")


def _softcap_arg(softcap: Optional[float]) -> float:
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return float(softcap or 0.0)


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sched_checks(kinds, funcs, workers, idle, conns) -> int:
    """The burst's shapes, dtypes and strides; returns the event columns'
    element stride."""
    R = funcs.shape[0]
    F_, W = idle.shape
    if W < 1:
        raise ValueError("need at least one worker")
    cols = {nm: t for nm, t in (("kinds", kinds), ("funcs", funcs), ("workers", workers))
            if t is not None}
    for nm, t in cols.items():  # any stride: the columns of one (R, 3) tensor are views
        if t.dtype != torch.int32:
            raise TypeError(f"{nm}: expected torch.int32, got {t.dtype}")
        if tuple(t.shape) != (R,):
            raise ValueError(f"{nm}: expected shape ({R},), got {tuple(t.shape)}")
    stride = funcs.stride(0) if R > 1 else 1
    if R > 1 and any(t.stride(0) != stride for t in cols.values()):
        raise ValueError("kinds, funcs and workers must share one element stride, got "
                         f"{[t.stride(0) for t in cols.values()]}")
    _check("idle", idle, torch.int32, (F_, W))
    _check("conns", conns, torch.int32, (W,))
    return stride


def _sched_outputs(idle, conns, R: int):
    """(assign, warm, idle', conns'), empty."""
    assign = torch.empty((R,), dtype=torch.int32, device=idle.device)
    warm = torch.empty((R,), dtype=torch.int32, device=idle.device)
    return assign, warm, torch.empty_like(idle), torch.empty_like(conns)


def _sched_twin(name: str, kinds, funcs, workers, idle, conns):
    """A burst's twin: every event counted an ARRIVAL (its kinds are not
    read)."""
    import numpy as np

    _sched_checks(kinds, funcs, workers, idle, conns)
    R = funcs.shape[0]
    counts.account(name, *counts.sched_counts(np.zeros(R, np.int32), *idle.shape))
    return _sched_outputs(idle, conns, R)


def _sched_launch(kinds, funcs, workers, idle, conns, arrival_only: bool):
    stride = _sched_checks(kinds, funcs, workers, idle, conns)
    R = funcs.shape[0]
    F_, W = idle.shape
    assign, warm, idle_out, conns_out = _sched_outputs(idle, conns, R)
    lib = build.load("sched")
    with torch.cuda.device(idle.device):
        err = lib.sched_events_launch(
            kinds.data_ptr() if kinds is not None else None,
            funcs.data_ptr(),
            workers.data_ptr() if workers is not None else None,
            stride, idle.data_ptr(), conns.data_ptr(), idle_out.data_ptr(), conns_out.data_ptr(),
            assign.data_ptr(), warm.data_ptr(), R, F_, W, int(arrival_only), _stream(idle),
        )
    _raise_on(err, "sched_events")
    return assign, warm, idle_out, conns_out


def sched_events(kinds, funcs, workers, idle, conns):
    """One mixed (ARRIVAL|FINISH|EVICT) burst.  Returns (assign (R,) int32,
    -1 for non-ARRIVAL; warm (R,) int32; idle'; conns').  Inputs untouched.
    Precondition: ``idle`` and ``conns`` non-negative, conns below 2**30.
    The event columns may be strided views (the columns of one (R, 3)
    tensor); on the card they must share one element stride."""
    if _abstract(kinds, funcs, workers, idle, conns):
        return _sched_twin("sched_events", kinds, funcs, workers, idle, conns)
    if not _on_cuda(kinds, funcs, workers, idle, conns):
        return ref.sched_events_ref(kinds, funcs, workers, idle, conns)
    out = _sched_launch(kinds, funcs, workers, idle, conns, arrival_only=False)
    _launched("sched_events", kinds, funcs, workers, idle, conns)
    return out


def sched_step(funcs, idle, conns):
    """ARRIVAL-only burst.  Returns (assign (R,) int32, warm (R,) int32,
    idle', conns').  Inputs untouched."""
    if _abstract(funcs, idle, conns):
        return _sched_twin("sched_step", None, funcs, None, idle, conns)
    if not _on_cuda(funcs, idle, conns):
        a, warm, i2, c2 = ref.sched_step_ref(funcs, idle, conns)
        return a, warm.to(torch.int32), i2, c2
    out = _sched_launch(None, funcs, None, idle, conns, arrival_only=True)
    _launched("sched_step", funcs, idle, conns)
    return out


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128, init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD chunked scan.  x (B,S,H,P); dt (B,S,H) post-softplus; A
    (H,); Bm, Cm (B,S,G,N), G dividing H (head h reads group h // (H/G));
    init_state (B,H,P,N) or None (zeros); each in any of ``FLOAT_DTYPES``.
    The kernel is instantiated for x, Bm and Cm in float32 or bfloat16 alike
    with dt, A and init_state in float32; any other mix is cast to float32
    first and y cast back to x's dtype.  Returns (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) float32).  ``S`` is padded to a multiple of
    ``chunk``.

    On the card the kernel runs in three launches (chunk scores and chunk
    states, state passing, chunk outputs) on float32 scratch allocated here;
    they count as one.  Under autograd on the card (grad mode on, an input
    requiring a gradient) the call is ``_SsdScan``, whose backward is
    ``ssd_scan_bwd``; the padding and the casts stay torch operations."""
    _check_floats(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, init_state=init_state)
    if sharded(x, dt, A, Bm, Cm, init_state):
        H, G = x.shape[2], Bm.shape[2]
        n = model_size(x, dt, A, Bm, Cm, init_state)
        g_dim = 2 if G > 1 else None  # one group: every rank's heads read it whole
        ts = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None else [])
        dims = [(0, 2), (0, 2), (None, 0), (0, g_dim), (0, g_dim), (0, 1)][:len(ts)]
        return on_local_shards(lambda *loc: ssd_scan(*loc[:5], chunk, *loc[5:]), ts, dims,
                               [(0, 2), (0, 1)], H % n == 0 and (G == 1 or G % n == 0))
    f32 = torch.float32
    if not (x.dtype in _Q_CODES and Bm.dtype == Cm.dtype == x.dtype and dt.dtype == A.dtype == f32
            and (init_state is None or init_state.dtype == f32)):
        y, st = ssd_scan(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(), chunk,
                         init_state.float() if init_state is not None else None)
        return y.to(x.dtype), st
    S = x.shape[1]
    given = [t for t in (x, dt, A, Bm, Cm, init_state) if t is not None]
    kernel = _abstract(*given) or _on_cuda(*given)  # the card's route, or its twin
    pad = (-S) % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    if kernel and _wants_grad(x, dt, A, Bm, Cm, init_state):
        y, st = _SsdScan.apply(x, dt, A, Bm, Cm, chunk, init_state)
    else:
        y, st, _ = _ssd_forward(x, dt, A, Bm, Cm, chunk, init_state, keep=False)
    return (y[:, :S] if pad else y), st


def _ssd_checks(x, dt, A, Bm, Cm, chunk: int, init_state) -> None:
    """Shapes, dtypes and contiguity of a kernel call (S a multiple of chunk)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G < 1 or H % G:
        raise ValueError(f"n_heads {H} is not a multiple of ngroups {G}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    _check("x", x, x.dtype, (Bsz, S, H, P))
    _check("dt", dt, torch.float32, (Bsz, S, H))
    _check("A", A, torch.float32, (H,))
    _check("Bm", Bm, x.dtype, (Bsz, S, G, N))
    _check("Cm", Cm, x.dtype, (Bsz, S, G, N))
    if init_state is not None:
        _check("init_state", init_state, torch.float32, (Bsz, H, P, N))


def _ssd_forward(x, dt, A, Bm, Cm, chunk: int, init_state, keep: bool):
    """The forward kernel's launch on inputs padded to the chunk: (y, final
    state, and with ``keep`` the scratch the backward starts from: (scores
    C.B^T (B,nc,G,Q,Q), cumsum (B,nc,H,Q), states (B,nc,H,N,P), the state
    entering each chunk), else None).  On the CPU the plain version, with
    no scratch; the twin's scratch is empty."""
    given = [t for t in (x, dt, A, Bm, Cm, init_state) if t is not None]
    twin = _abstract(*given)
    if not twin and not _on_cuda(*given):
        y, st = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk, init_state)
        return y, st, None
    _ssd_checks(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib = None if twin else build.load("ssd_scan")
    most = SSD_MAX_CHUNK if twin else lib.ssd_scan_max_chunk()
    if chunk > most:
        raise ValueError(f"ssd_scan kernel takes chunk <= {most}, got {chunk}")
    nc = S // chunk
    y = torch.empty_like(x)
    st = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    scores = torch.empty((Bsz, nc, G, chunk, chunk), dtype=torch.float32, device=x.device)
    cumsum = torch.empty((Bsz, nc, H, chunk), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, N, P), dtype=torch.float32, device=x.device)
    if twin:
        counts.account("ssd_scan", *counts.ssd_counts(Bsz, S, H, P, N, chunk, x.element_size()))
        return y, st, ((scores, cumsum, states) if keep else None)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), st.data_ptr(), scores.data_ptr(), cumsum.data_ptr(), states.data_ptr(),
            Bsz, S, H, G, P, N, chunk, _Q_CODES[x.dtype], _stream(x),
        )
    _raise_on(err, "ssd_scan")
    _launched("ssd_scan", x, dt, A, Bm, Cm, chunk, init_state)
    return y, st, ((scores, cumsum, states) if keep else None)


class _SsdScan(torch.autograd.Function):
    """``ssd_scan`` with a gradient, on inputs padded to the chunk in the
    kernel's dtypes: the forward kernel's launch, keeping its scratch (C.B^T,
    the chunk cumsums and the states entering the chunks; recomputed with the
    forward under ``torch.utils.checkpoint``), and ``ssd_scan_bwd``.  A
    gradient of y or of the final state that no caller uses comes as None
    (zero).  On CPU tensors it runs the plain versions both ways."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, init_state):
        y, st, saved = _ssd_forward(x, dt, A, Bm, Cm, chunk, init_state, keep=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *(saved or ()))
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, Bm, Cm, init_state, *saved = ctx.saved_tensors
        if dy is not None:
            dy = dy.to(x.dtype).contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        dx, ddt, dA, dB, dC, d_init = ssd_scan_bwd(x, dt, A, Bm, Cm, ctx.chunk, init_state, dy,
                                                   d_state, tuple(saved) or None)
        return dx, ddt, dA, dB, dC, None, (d_init if init_state is not None else None)


def ssd_scan_bwd(x, dt, A, Bm, Cm, chunk: int, init_state, dy, d_final_state, saved=None):
    """The gradient of ``ssd_scan`` on inputs padded to the chunk: (dx, ddt,
    dA, dB, dC, d_init_state), dx, dB and dC in the dtypes of x, Bm and Cm,
    the rest float32; ``dy`` (B,S,H,P) in x's dtype and ``d_final_state``
    (B,H,P,N) float32 are the gradients of y and of the final state, either
    None for zero.  On the card ``saved`` is the forward's scratch
    (``_ssd_forward(..., keep=True)``), x, Bm and Cm float32 or bfloat16
    alike, dt and A float32, all contiguous, and the kernel runs in six
    launches (five when G == H; dC and dB are summed over slices of 8
    heads) on float32 scratch allocated here, counted as one under
    ``ssd_scan_bwd``.  On the CPU this is
    ``ref.ssd_scan_bwd_ref``, its float32 results cast to the inputs'
    dtypes."""
    tensors = [t for t in (x, dt, A, Bm, Cm, init_state, dy, d_final_state) if t is not None]
    twin = _abstract(*tensors)
    if not twin and not _on_cuda(*tensors):
        dx, ddt, dA, dB, dC, d_init = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, chunk, init_state, dy,
                                                           d_final_state)
        return dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), \
            d_init
    if x.dtype not in _Q_CODES:
        raise TypeError(f"x: expected one of {tuple(_Q_CODES)}, got {x.dtype}")
    _ssd_checks(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    if saved is None:
        raise ValueError("ssd_scan_bwd on the card starts from the forward's scratch: pass "
                         "saved=_ssd_forward(..., keep=True)[2]")
    scores, cumsum, states = saved
    _check("scores", scores, torch.float32, (Bsz, nc, G, chunk, chunk))
    _check("cumsum", cumsum, torch.float32, (Bsz, nc, H, chunk))
    _check("states", states, torch.float32, (Bsz, nc, H, N, P))
    if dy is None:
        dy = torch.zeros_like(x)
    _check("dy", dy, x.dtype, (Bsz, S, H, P))
    if d_final_state is not None:
        _check("d_final_state", d_final_state, torch.float32, (Bsz, H, P, N))
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    d_init = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if twin:
        counts.account("ssd_scan_bwd", *counts.ssd_bwd_counts(
            Bsz, S, H, P, N, G, chunk, x.element_size(), d_final_state is not None))
        return dx, ddt, dA, dB, dC, d_init
    lib = build.load("ssd_scan_bwd")
    work = torch.empty((lib.ssd_scan_bwd_scratch_floats(Bsz, S, H, G, P, N, chunk),),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
            d_final_state.data_ptr() if d_final_state is not None else None,
            scores.data_ptr(), cumsum.data_ptr(), states.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), d_init.data_ptr(),
            work.data_ptr(), Bsz, S, H, G, P, N, chunk, _Q_CODES[x.dtype], _stream(x),
        )
    _raise_on(err, "ssd_scan_bwd")
    _launched("ssd_scan_bwd", x, dt, A, Bm, Cm, chunk, init_state)
    return dx, ddt, dA, dB, dC, d_init


def _attn_checks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_shape, kv_shape) -> None:
    """Shapes, contiguity and head counts; the dtypes were settled by the
    caller (q in ``_Q_CODES``, k and v alike)."""
    _check("q", q, q.dtype, q_shape)
    _check("k", k, k.dtype, kv_shape)
    _check("v", v, k.dtype, kv_shape)
    H, KH, hd = q_shape[-2], kv_shape[-2], q_shape[-1]
    if KH < 1 or H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KH}")
    if hd not in ATTN_HEAD_DIMS:
        raise ValueError(f"attention kernels take head_dim in {ATTN_HEAD_DIMS}, got {hd}")


def _head_stride(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> int:
    """The element stride between the heads of a (B, S, heads, hd) tensor
    that the flash kernel reads in place: contiguous, or a slice of the last
    dim of a contiguous tensor (MLA's v, the tail of each head's [k_nope |
    v] row), each head's row 16-byte aligned."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    B, S, KH, hd = shape
    ld = t.stride(2) if KH > 1 else t.stride(1) if S > 1 else t.stride(0) if B > 1 else hd
    if ld < hd or t.stride(3) != 1 or (KH > 1 and S > 1 and t.stride(1) != KH * ld) or \
            (B > 1 and t.stride(0) != S * KH * ld) or (ld * t.element_size()) % 16:
        raise ValueError(f"{name}: the kernel reads rows of {hd} at a head stride of 16-byte "
                         f"multiples, got strides {t.stride()}")
    return ld


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Attention of a whole query sequence over a whole key sequence
    (prefill, training; cross-attention).  q (B,S,H,hd); k (B,Sk,KH,hd); v
    (B,Sk,KH,hd_v) with hd_v == hd, or (hd, hd_v) one of
    ``FLASH_SPLIT_DIMS`` (MLA); each in any of ``FLOAT_DTYPES``: float32 or
    bfloat16 alike run as they are, any other mix is cast to float32 first
    and the output cast back to q's dtype.  Query head h reads kv head
    h // (H/KH).  Key j is live for query i when ``j <= i`` (causal) and
    ``i - j < window`` (window set): the kernel takes positions from row and
    column indices, so callers' positions must be ``arange(S)``.  Sk is S
    for self-attention; keys of another length (whisper's decoder over the
    encoded audio) take neither mask and are all live, and a causal mask or
    a window with Sk != S raises.  The logits are scaled by ``1/sqrt(hd)``,
    the q/k head dim (the Pallas kernel's), and with ``softcap`` capped to
    ``softcap * tanh(logit / softcap)`` before the mask.  Any S and Sk.  On
    the card q must be contiguous; k and v may also be a slice of the last
    dim of a contiguous tensor (read in place, at their head stride); all
    16-byte aligned.  Returns (B,S,H,hd_v) in q's dtype.

    Under autograd on the card (grad mode on, an input requiring a
    gradient) the call is ``_FlashAttention``, at every head-dim pair the
    forward takes, k and v read in place as the forward reads them."""
    _check_floats(q=q, k=k, v=v)
    if sharded(q, k, v):
        return on_local_shards(lambda *loc: flash_attention(*loc, causal, window, softcap),
                               [q, k, v], [(0, 2)] * 3, [(0, 2)],
                               k.shape[2] % model_size(q, k, v) == 0)
    if not (q.dtype in _Q_CODES and k.dtype == v.dtype == q.dtype):
        return flash_attention(q.float(), k.float(), v.float(), causal, window,
                               softcap).to(q.dtype)
    if not _abstract(q, k, v) and not _on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal, window, softcap)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _flash_forward(q, k, v, causal, window, softcap, want_lse=False)[0]


def _flash_layout(name: str, q, k, v, causal: bool, window: Optional[int]):
    """The checks both flash kernels make of q, k, v and the masks: head
    counts, head dims (equal in ``ATTN_HEAD_DIMS`` or one of
    ``FLASH_SPLIT_DIMS``), q contiguous, k and v contiguous or at a head
    stride, 16-byte storage.  Returns (ldk, ldv), their head strides."""
    B, S, H, hd = q.shape
    Sk, KH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    ref.check_key_length(S, Sk, causal, window)
    if KH < 1 or H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KH}")
    if hd_v != hd and (hd, hd_v) not in FLASH_SPLIT_DIMS:
        raise ValueError(f"{name} kernel takes head dims (q/k, v) equal in "
                         f"{ATTN_HEAD_DIMS} or one of {FLASH_SPLIT_DIMS}, got ({hd}, {hd_v})")
    if hd_v == hd and hd not in ATTN_HEAD_DIMS:
        raise ValueError(f"attention kernels take head_dim in {ATTN_HEAD_DIMS}, got {hd}")
    _check("q", q, q.dtype, (B, S, H, hd))
    ldk = _head_stride("k", k, q.dtype, (B, Sk, KH, hd))
    ldv = _head_stride("v", v, q.dtype, (B, Sk, KH, hd_v))
    if not _aligned(q, k, v):
        raise ValueError(f"{name} kernel copies q, k and v 16 bytes at a time: their storage "
                         "must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    return ldk, ldv


def _flash_forward(q, k, v, causal: bool, window: Optional[int], softcap: Optional[float],
                   want_lse: bool):
    """The forward kernel's launch: (out, lse (B,H,S) float32 or None)."""
    B, S, H, hd = q.shape
    Sk, KH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    ldk, ldv = _flash_layout("flash_attention", q, k, v, causal, window)
    cap = _softcap_arg(softcap)
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if want_lse else None
    if _abstract(q, k, v):
        counts.account("flash_attention", *counts.flash_counts(
            B, S, H, KH, hd, causal, window, q.element_size(), hd_v, Sk))
        return out, lse
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, B, S, Sk, H, KH, hd, hd_v, ldk, ldv,
            int(causal), window or 0, _Q_CODES[q.dtype], cap, _stream(q),
        )
    _raise_on(err, "flash_attention")
    _launched("flash_attention", q, k, v, causal, window, *((cap,) if cap else ()))
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient on the card: the forward kernel
    also writes the rows' log-sum-exp, saved with q, k, v (as the views they
    are: MLA's v stays the tail of each head's [k_nope | v] row) and the
    output (``torch.utils.checkpoint`` recomputes all of them with the
    forward), and the backward is ``flash_attention_bwd``, which reads k and
    v at their head stride too."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _flash_forward(q, k, v, causal, window, softcap, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.to(q.dtype).contiguous(),
                                         *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """The gradient of ``flash_attention``: (dq, dk, dv) in the dtypes and
    shapes of q, k and v (contiguous), from the forward's output ``out``
    (B,S,H,hd_v) and rows' log-sum-exp ``lse`` (B,H,S) float32, and the
    output's gradient ``dout``; masks and softcap as the forward's.  On the
    card q, out and dout are contiguous, k and v contiguous or read at a
    head stride as the forward reads them, float32 or bfloat16 alike, q, k,
    v and dout 16-byte aligned; (hd, hd_v) equal in ``ATTN_HEAD_DIMS`` or
    one of ``FLASH_SPLIT_DIMS``.  The kernel runs in three launches (D =
    rowsum(dout * out) into float32 scratch allocated here, dk and dv, dq),
    counted as one.  On the CPU this is ``ref.flash_attention_bwd_ref``."""
    twin = _abstract(q, k, v, out, lse, dout)
    if not twin and not _on_cuda(q, k, v, out, lse, dout):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal, window, softcap)
    B, S, H, hd = q.shape
    Sk, KH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q: expected one of {tuple(_Q_CODES)}, got {q.dtype}")
    ldk, ldv = _flash_layout("flash_attention_bwd", q, k, v, causal, window)
    _check("out", out, q.dtype, (B, S, H, hd_v))
    _check("dout", dout, q.dtype, (B, S, H, hd_v))
    _check("lse", lse, torch.float32, (B, H, S))
    if not _aligned(dout):
        raise ValueError("flash_attention_bwd kernel copies dout 16 bytes at a time: its "
                         "storage must be 16-byte aligned")
    cap = _softcap_arg(softcap)
    dq = torch.empty_like(q)
    dk = torch.empty((B, Sk, KH, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, KH, hd_v), dtype=v.dtype, device=v.device)
    if twin:
        counts.account("flash_attention_bwd", *counts.flash_bwd_counts(
            B, S, H, KH, hd, causal, window, q.element_size(), Sk, hd_v)[:2])
        return dq, dk, dv
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, Sk, H, KH, hd, hd_v, ldk, ldv, int(causal), window or 0, _Q_CODES[q.dtype],
            cap, _stream(q),
        )
    _raise_on(err, "flash_attention_bwd")
    _launched("flash_attention_bwd", q, k, v, causal, window, *((cap,) if cap else ()))
    return dq, dk, dv


def decode_heads_per_pass(hd: int, elem: int) -> int:
    """Query heads the decode kernel carries in one pass over the rows, so
    that q and acc stay within ~32 registers a lane (``Cfg::GB`` in
    ``csrc/decode_attention.cu``): a cache row is read 16 bytes a lane, by at
    most 32 lanes; ``elem`` is the cache's element size (4, 2 or 1)."""
    vec = 16 // elem
    chunks = hd // vec
    lanes = 32 if chunks >= 32 else 1 << (chunks - 1).bit_length()
    per_lane = -(-chunks // lanes) * vec
    return 1 if per_lane >= 16 else 16 // per_lane


def decode_geometry(B: int, KH: int, G: int, hd: int, elem: int, n_sm: int) -> Tuple[int, int, int]:
    """(heads per pass, head groups, splits) of the decode kernel: the grid is
    (splits, KH x head groups, B), from the shapes, the cache's element size
    ``elem`` and the SM count alone
    (never ``valid_len``, so a captured call can be replayed with another).
    Splits fill ``DECODE_CTAS_PER_SM`` CTAs per SM in one wave, but beyond one
    CTA per SM only while the last CTA's merge reads at most
    ``DECODE_MERGE_FLOATS`` partial columns."""
    gb = decode_heads_per_pass(hd, elem)
    n_hg = -(-G // gb)
    units = B * KH * n_hg
    want = DECODE_CTAS_PER_SM * n_sm // units
    cap = max(n_sm // units, DECODE_MERGE_FLOATS // (gb * hd))
    return gb, n_hg, max(1, min(want, cap, DECODE_MAX_SPLITS))


def decode_share(valid_len: int, S: int, window: Optional[int], splits: int,
                 split: int, g: int = DECODE_SHARE_ROWS) -> Tuple[int, int]:
    """Cache rows ``[begin, end)`` that CTA ``split`` of a unit reads: an
    equal share of the live range ``[lo, hi]`` in whole ``g``-row granules
    (``DECODE_SHARE_ROWS``; the latent kernel's tile rows for
    ``decode_attention_latent``); empty (``begin == end``) past its end
    or when no position is live.  The kernels compute the same on the card."""
    lo = max(0, valid_len - window + 1) if window else 0
    hi = min(valid_len, S - 1)
    if hi < lo:
        return 0, 0
    per = -(-(-(-(hi - lo + 1) // g)) // splits) * g
    begin = lo + split * per
    end = min(hi + 1, begin + per)
    return (begin, end) if end > begin else (0, 0)


_n_sm: Dict[torch.device, int] = {}
_tickets: Dict[torch.device, torch.Tensor] = {}
_held_tickets: List[torch.Tensor] = []


def _sm_count(device: torch.device) -> int:
    n_sm = _n_sm.get(device)
    if n_sm is None:
        n_sm = _n_sm[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n_sm


def _decode_tickets(device: torch.device, units: int) -> torch.Tensor:
    """The decode kernel's int32 tickets for ``device``, one per unit: zeroed
    once here and left at zero by every call, so repeat calls and graph
    replays need no memset.  Make the first call of a shape before capturing
    it in a graph, so that this allocation is not captured.  A larger shape
    gets a larger buffer; the one it replaces is kept alive, never freed,
    because a graph captured with it still writes there on every replay."""
    t = _tickets.get(device)
    if t is None or t.numel() < units:
        if t is not None:
            _held_tickets.append(t)
        t = torch.zeros(max(units, 4096), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def _valid_len_args(valid_len, q: torch.Tensor, B: int, S: int, window: Optional[int]):
    """(valid_dev, valid_host) for a decode kernel: an int32 copy of a 0-d
    or (B,) integer tensor on q's device (read by the kernel, so a captured
    call replays with new values), else None and the checked Python int."""
    if isinstance(valid_len, torch.Tensor):
        if tuple(valid_len.shape) not in ((), (B,)):
            raise ValueError(f"valid_len: expected a 0-d or a ({B},) tensor, got shape "
                             f"{tuple(valid_len.shape)}")
        if valid_len.dtype.is_floating_point or valid_len.dtype.is_complex or \
                valid_len.dtype == torch.bool:
            raise TypeError(f"valid_len: expected an integer tensor, got {valid_len.dtype}")
        if valid_len.device != q.device:
            raise ValueError(f"valid_len on {valid_len.device}, q on {q.device}")
        return valid_len.to(torch.int32).contiguous(), 0
    valid_host = operator.index(valid_len)
    lo = max(0, valid_host - window + 1) if window is not None else 0
    if min(valid_host, S - 1) < lo:
        raise ValueError(f"no live cache position: valid_len {valid_host}, window {window}, "
                         f"cache length {S}")
    if valid_host >= 2**31:
        raise ValueError(f"valid_len {valid_host} does not fit the kernel's int32")
    return None, valid_host


def decode_attention(q, k_cache, v_cache, valid_len, window: Optional[int] = None,
                     softcap: Optional[float] = None):
    """One new token per sequence against a cache.  q (B,H,hd); caches
    (B,S,KH,hd).  The kernel is instantiated for q in float32 or bfloat16
    and both caches in float32, bfloat16 or float8_e4m3fn: it reads the
    cache in its own dtype and converts each value to float32 in registers,
    as the Pallas kernel upcasts each tile.  Any other mix of
    ``FLOAT_DTYPES`` is cast to float32 first and the output cast back.
    Positions ``<= valid_len`` are live, and with a window only those with
    ``valid_len - pos < window``.  ``valid_len`` is a Python int, or an
    integer tensor on q's device, 0-d (one length for the batch) or ``(B,)``
    (each row its own), which the kernel reads on the card (no host sync; a
    captured call replays with the tensor's new values).  An int with no
    live position raises; a tensor row with none gives zeros, as the Pallas
    kernel does.  With ``softcap`` the scaled logits are capped to ``softcap
    * tanh(logit / softcap)`` before the mask.  Returns (B,H,hd) in q's
    dtype.  It has no backward: under autograd on the card it raises.

    On the card this is one launch of ``decode_geometry``'s grid, from the
    shapes and the cache's element size: each CTA takes its share of its
    row's live range, and the last CTA of each (batch, kv head, head group)
    merges the float32 partials (scratch allocated here) by a ticket kept
    per device (``_decode_tickets``).  Calls on one device share those
    tickets, so they must run on one stream."""
    _check_floats(q=q, k_cache=k_cache, v_cache=v_cache)
    if sharded(q, k_cache, v_cache, valid_len):
        ts, dims = [q, k_cache, v_cache], [(0, 1), (0, 2), (0, 2)]
        if isinstance(valid_len, torch.Tensor):
            ts.append(valid_len)
            dims.append((0 if valid_len.ndim else None, None))
        return on_local_shards(
            lambda *loc: decode_attention(*loc[:3], loc[3] if len(loc) > 3 else valid_len,
                                          window, softcap),
            ts, dims, [(0, 1)], k_cache.shape[2] % model_size(q, k_cache, v_cache) == 0)
    if not (q.dtype in _Q_CODES and k_cache.dtype == v_cache.dtype
            and k_cache.dtype in _CACHE_CODES):
        return decode_attention(q.float(), k_cache.float(), v_cache.float(), valid_len,
                                window, softcap).to(q.dtype)
    twin = _abstract(q, k_cache, v_cache)
    if not twin and not _on_cuda(q, k_cache, v_cache):
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_len, window, softcap)
    if _wants_grad(q, k_cache, v_cache):
        raise _no_backward("decode_attention", "ROADMAP Queue 1 item 8: no train step decodes; "
                                               "training attends through flash_attention")
    cap = _softcap_arg(softcap)
    B, S, KH, hd = k_cache.shape
    H = q.shape[1]
    _attn_checks(q, k_cache, v_cache, (B, H, hd), (B, S, KH, hd))
    if not _aligned(k_cache, v_cache):
        raise ValueError("decode_attention kernel reads the caches 16 bytes at a time: "
                         "their storage must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    valid_dev, valid_host = _valid_len_args(valid_len, q, B, S, window)
    lib = None if twin else build.load("decode_attention")
    G = H // KH
    most = DECODE_MAX_GROUP if twin else lib.decode_attention_max_group()
    if G > most:
        raise ValueError(f"decode kernel takes at most {most} query heads per kv head, got {G}")
    if twin:
        lengths = [S - 1 if valid_dev is not None else valid_host] * B
        counts.account("decode_attention", *counts.decode_counts(
            S, H, KH, hd, lengths, window, q.element_size(), k_cache.element_size()))
        return torch.empty_like(q)
    gb, n_hg, splits = decode_geometry(B, KH, G, hd, k_cache.element_size(), _sm_count(q.device))
    units = B * KH * n_hg
    out = torch.empty_like(q)
    part = torch.empty(units * splits * gb * (hd + 2), dtype=torch.float32, device=q.device)
    tickets = _decode_tickets(q.device, units)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(),
            valid_dev.data_ptr() if valid_dev is not None else None,
            valid_dev.ndim if valid_dev is not None else 0, valid_host,
            B, S, H, KH, hd, window or 0, gb, splits, _Q_CODES[q.dtype],
            _CACHE_CODES[k_cache.dtype], cap, _stream(q),
        )
    _raise_on(err, "decode_attention")
    _launched("decode_attention", q, k_cache, v_cache, window, *((cap,) if cap else ()))
    return out


def latent_geometry(B: int, H: int, S: int, n_sm: int,
                    tensor_cores: bool = True) -> Tuple[int, int, int, int]:
    """(heads a CTA, tile rows, head groups, splits) of the latent decode
    kernel: the grid is (splits, head groups, B), each CTA that many query
    heads over its share of the row's live range (``decode_share`` in
    granules of the tile rows), from the shapes and the SM count alone
    (never ``valid_len``, so a captured call replays with new lengths).
    ``tensor_cores`` (bfloat16 q and caches) picks the tensor-core kernel's
    ``LATENT_*`` constants, else the CUDA-core kernel's ``LATENT_F32_*``.
    Splits fill the kernel's CTAs per SM in one wave, up to its most
    splits, and never outnumber the cache's tiles."""
    if tensor_cores:
        heads, rows, per_sm, most = (LATENT_HEADS, LATENT_ROWS, LATENT_CTAS_PER_SM,
                                     LATENT_MAX_SPLITS)
    else:
        heads, rows, per_sm, most = (LATENT_F32_HEADS, LATENT_F32_ROWS, LATENT_F32_CTAS_PER_SM,
                                     LATENT_F32_MAX_SPLITS)
    n_hg = -(-H // heads)
    tiles = -(-S // rows)
    return heads, rows, n_hg, max(1, min(per_sm * n_sm // (B * n_hg), tiles, most))


_LATENT_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_latent(q_lat, q_rope, c_cache, r_cache, valid_len, scale: float):
    """Absorbed MLA decode (DeepSeek-V2/V3): one new token per sequence,
    every query head against the one latent cache row a position.  q_lat
    (B,H,dc), the query absorbed through W_UK; q_rope (B,H,dr); c_cache
    (B,S,dc) and r_cache (B,S,dr), read in place (never joined into one
    (B,S,dc+dr) copy).  Scores ``(q_lat . c + q_rope . r) * scale``, values
    the latent rows ``c``; ``valid_len`` as in ``decode_attention`` (an int,
    or a 0-d or (B,) integer tensor on the card, read there), no window.
    The kernel is instantiated for (dc, dr) in ``LATENT_DIMS``, H a multiple
    of ``LATENT_F32_HEADS``, q in float32 or bfloat16 and both caches in
    float32 or bfloat16; any other mix of ``FLOAT_DTYPES`` is cast to
    float32 first and the output cast back.  Returns (B,H,dc) in q_lat's
    dtype.

    On the card, bfloat16 q and caches (every timed path: deepseek-v3
    serves in bfloat16) run the tensor-core kernel: a CTA of
    ``latent_geometry``'s grid holds ``LATENT_HEADS`` heads of q in shared
    memory and ``LATENT_ROWS``-row tiles of its share of c and r (by TMA,
    the share's last part-tile by cp.async, so no row past ``valid_len``
    is read), computes the scores and the values with ``wgmma`` on
    bfloat16 tensor cores in float32 sums (P rounded to bfloat16), and
    writes its float32 partial; a second launch merges the splits (one
    call counted).  Float32 and
    mixed types run the CUDA-core kernel, 16 heads a CTA, whose last CTA of
    each (batch, head group) merges the splits through the tickets that
    ``decode_attention`` uses (one stream per device)."""
    _check_floats(q_lat=q_lat, q_rope=q_rope, c_cache=c_cache, r_cache=r_cache)
    if sharded(q_lat, q_rope, c_cache, r_cache, valid_len):
        ts, dims = [q_lat, q_rope, c_cache, r_cache], [(0, 1), (0, 1), (0, None), (0, None)]
        if isinstance(valid_len, torch.Tensor):
            ts.append(valid_len)
            dims.append((0 if valid_len.ndim else None, None))
        n, H = model_size(*ts), q_lat.shape[1]
        return on_local_shards(
            lambda *loc: decode_attention_latent(*loc[:4], loc[4] if len(loc) > 4 else valid_len,
                                                 scale),
            ts, dims, [(0, 1)], H % n == 0 and (H // n) % LATENT_F32_HEADS == 0)
    if not (q_lat.dtype in _Q_CODES and q_rope.dtype == q_lat.dtype
            and c_cache.dtype == r_cache.dtype and c_cache.dtype in _LATENT_CACHE_CODES):
        return decode_attention_latent(q_lat.float(), q_rope.float(), c_cache.float(),
                                       r_cache.float(), valid_len, scale).to(q_lat.dtype)
    twin = _abstract(q_lat, q_rope, c_cache, r_cache)
    if not twin and not _on_cuda(q_lat, q_rope, c_cache, r_cache):
        return ref.decode_attention_latent_ref(q_lat, q_rope, c_cache, r_cache, valid_len, scale)
    if _wants_grad(q_lat, q_rope, c_cache, r_cache):
        raise _no_backward("decode_attention_latent", "ROADMAP Queue 1 item 8: no train step "
                                                      "decodes; training attends through "
                                                      "flash_attention")
    B, S, dc = c_cache.shape
    H, dr = q_lat.shape[1], r_cache.shape[-1]
    if (dc, dr) not in LATENT_DIMS:
        raise ValueError(f"latent decode kernel takes (latent, rope) dims in {LATENT_DIMS}, "
                         f"got ({dc}, {dr})")
    if H < 1 or H % LATENT_F32_HEADS:
        raise ValueError(f"latent decode kernel takes a multiple of {LATENT_F32_HEADS} query "
                         f"heads, got {H}")
    _check("q_lat", q_lat, q_lat.dtype, (B, H, dc))
    _check("q_rope", q_rope, q_lat.dtype, (B, H, dr))
    _check("c_cache", c_cache, c_cache.dtype, (B, S, dc))
    _check("r_cache", r_cache, c_cache.dtype, (B, S, dr))
    tensor_cores = q_lat.dtype == c_cache.dtype == torch.bfloat16
    copied = (c_cache, r_cache, q_lat, q_rope) if tensor_cores else (c_cache, r_cache)
    if not _aligned(*copied):
        raise ValueError("latent decode kernel copies the caches (and bfloat16 q) 16 bytes at "
                         "a time: their storage must be 16-byte aligned")
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    valid_dev, valid_host = _valid_len_args(valid_len, q_lat, B, S, None)
    if twin:
        lengths = [S - 1 if valid_dev is not None else valid_host] * B
        counts.account("decode_attention_latent", *counts.latent_counts(
            H, dc, dr, lengths, S, q_lat.element_size(), c_cache.element_size()))
        return torch.empty_like(q_lat)
    lib = build.load("decode_attention")
    heads, _, n_hg, splits = latent_geometry(B, H, S, _sm_count(q_lat.device), tensor_cores)
    units = B * n_hg
    out = torch.empty_like(q_lat)
    part = torch.empty(units * splits * heads * (dc + 2), dtype=torch.float32,
                       device=q_lat.device)
    tickets = None if tensor_cores else _decode_tickets(q_lat.device, units)
    with torch.cuda.device(q_lat.device):
        err = lib.decode_attention_latent_launch(
            q_lat.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(), r_cache.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr() if tickets is not None else None,
            valid_dev.data_ptr() if valid_dev is not None else None,
            valid_dev.ndim if valid_dev is not None else 0, valid_host,
            B, S, H, dc, dr, splits, float(scale), _Q_CODES[q_lat.dtype],
            _LATENT_CACHE_CODES[c_cache.dtype], _stream(q_lat),
        )
    _raise_on(err, "decode_attention_latent")
    _launched("decode_attention_latent", q_lat, q_rope, c_cache, r_cache, scale)
    return out


# ------------------------------------------------------- dense products
#: dense products since the process started, by route: on ``linear_tf32x3``
#: ("tc") and on ``torch.matmul`` ("other"); ``serving/telemetry.py`` keeps
#: each request's share
PRODUCTS: Dict[str, int] = {"tc": 0, "other": 0}


def _rows(x: torch.Tensor) -> Optional[torch.Tensor]:
    """``x`` (..., K), at least 2-D, as an (M, K) view with unit steps along
    K, or None where it has none."""
    if x.ndim < 2:
        return None
    try:
        a = x.view(-1, x.shape[-1])
    except RuntimeError:
        return None
    return a if a.stride(1) == 1 else None


def _weight_layout(w: torch.Tensor) -> Optional[Tuple[bool, int]]:
    """(nk, ldb) of a (K, N) float32 weight: ``nk`` False where its rows
    (K) lie ``ldb`` apart with unit steps along N, True where it is the
    transpose of an (N, K) table whose rows lie ``ldb`` apart; None for any
    other layout."""
    if w.ndim != 2:
        return None
    if w.stride(1) == 1:
        return False, w.stride(0)
    if w.stride(0) == 1:
        return True, w.stride(1)
    return None


def _tma_layouts(a: torch.Tensor, ws) -> Optional[List[Tuple[bool, int]]]:
    """Each weight's ``_weight_layout`` where ``a`` (M, K) and ``ws`` lie as
    TMA reads them: ``a``'s rows and each weight's rows (or its table's) a
    multiple of 16 bytes apart with unit steps inside, every weight with K
    rows and all in one layout; None otherwise."""
    layouts = [_weight_layout(w) for w in ws]
    if (a.stride(1) != 1 or a.stride(0) % 4
            or any(lay is None or lay[1] % 4 or w.shape[0] != a.shape[1]
                   for lay, w in zip(layouts, ws))
            or len({lay[0] for lay in layouts}) > 1):
        return None
    return layouts


def _tc_plan(x: torch.Tensor, ws) -> Tuple[Optional[str], Optional[torch.Tensor], Optional[list]]:
    """(None, ``x`` as (M, K) rows, the weights' ``_tma_layouts``) where
    ``dense`` sends ``x @ w`` for each of ``ws`` to ``linear_tf32x3``, else
    (``tc_refusal``'s reason, None, None)."""
    ts = (x, *ws)
    if not ws or any(type(t) not in (torch.Tensor, torch.nn.Parameter) for t in ts):
        return "type", None, None
    if any(t.dtype != torch.float32 for t in ts):
        return "dtype", None, None
    if _wants_grad(*ts):
        return "grad", None, None
    a = _rows(x)
    if a is None or a.shape[0] < LINEAR_MIN_ROWS:
        return "rows", None, None
    layouts = _tma_layouts(a, ws)
    if layouts is None or not _aligned(*ts):
        return "strides", None, None
    if (-(-a.shape[0] // LINEAR_TILE) * sum(-(-w.shape[1] // LINEAR_TILE) for w in ws)
            < LINEAR_MIN_TILES):
        return "tiles", None, None
    if any(t.device.type != "cuda" for t in ts) or _abstract(*ts):
        return "device", None, None
    return None, a, layouts


def tc_refusal(x: torch.Tensor, *ws: torch.Tensor) -> Optional[str]:
    """Why ``dense`` keeps ``x @ w`` for each of ``ws`` on ``torch.matmul``,
    or None where they go to the tensor-core kernel ``linear_tf32x3``.  The
    first of these that fails: "type" (every operand a plain tensor or
    parameter, no ``DTensor``), "dtype" (float32), "grad" (no gradient
    wanted), "rows" (``x`` at least 2-D with ``LINEAR_MIN_ROWS`` rows once
    its leading dims are flattened), "strides" (``_tma_layouts``, and every
    base 16-byte aligned), "tiles" (the products' ``LINEAR_TILE`` tiles of
    C at least ``LINEAR_MIN_TILES``), "device" (data on the card: not the
    CPU, not fake or ``meta``).  Decode steps (a row a slot), bfloat16
    models, train steps, sharded weights and products too small to fill
    half the card are refused."""
    return _tc_plan(x, ws)[0]


def linear_tf32x3(a: torch.Tensor, *ws: torch.Tensor) -> List[torch.Tensor]:
    """``a @ w`` for each of ``ws`` in split-precision TF32 on the tensor
    cores (``csrc/linear_tf32x3.cu``): a (M, K) float32, rows at a stride
    with unit steps along K; each w (K, N_w) float32, its rows at a stride
    with unit steps along N_w, or the transpose of an (N_w, K) table (all of
    ``ws`` alike).  Returns the (M, N_w) float32 products, contiguous.  Up to
    ``LINEAR_MAX_GROUP`` weights share one launch; more take several.  On the
    CPU each is ``ref.linear_tf32x3_ref``."""
    if not ws:
        raise ValueError("linear_tf32x3 needs at least one weight")
    for name, t in (("a", a), *((f"w{i}", w) for i, w in enumerate(ws))):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise TypeError(f"linear_tf32x3: {name} must be a 2-D float32 tensor, got "
                            f"{t.dtype} of {tuple(t.shape)}")
    if any(w.shape[0] != a.shape[1] for w in ws):
        raise ValueError(f"linear_tf32x3: a is {tuple(a.shape)}, the weights "
                         f"{[tuple(w.shape) for w in ws]}: each must have a's K rows")
    layouts = None
    if _on_cuda(a, *ws):
        layouts = _tma_layouts(a, ws)
        if layouts is None:
            raise ValueError("linear_tf32x3: a's rows and each weight's rows (or its table's) "
                             "must lie a multiple of 4 floats apart with unit steps inside, all "
                             "weights in one layout")
        if not _aligned(a, *ws):
            raise ValueError("linear_tf32x3 reads its operands by TMA: their storage must be "
                             "16-byte aligned")
        if a.shape[0] == 0:
            return [a.new_empty((0, w.shape[1])) for w in ws]
    return _linear_launch(a, ws, layouts)


def _linear_launch(a: torch.Tensor, ws, layouts) -> List[torch.Tensor]:
    """``linear_tf32x3`` without its checks: ``a`` and ``ws`` as
    ``_tc_plan`` or ``linear_tf32x3`` found them, ``layouts`` theirs.  On
    the CPU each product is the plain version."""
    if a.device.type == "cpu":
        return [ref.linear_tf32x3_ref(a, w) for w in ws]
    M, K = a.shape
    lib = build.load("linear_tf32x3")
    outs = []
    for i in range(0, len(ws), LINEAR_MAX_GROUP):
        group, lay = ws[i:i + LINEAR_MAX_GROUP], layouts[i:i + LINEAR_MAX_GROUP]
        cs = [torch.empty((M, w.shape[1]), dtype=torch.float32, device=a.device) for w in group]
        pad = LINEAR_MAX_GROUP - len(group)
        with torch.cuda.device(a.device):
            err = lib.linear_tf32x3_launch(
                a.data_ptr(), *(w.data_ptr() for w in group), *(None,) * pad,
                *(c.data_ptr() for c in cs), *(None,) * pad,
                *(w.shape[1] for w in group), *(0,) * pad, *(ly[1] for ly in lay), *(0,) * pad,
                len(group), M, K, a.stride(0), int(lay[0][0]), _stream(a))
        _raise_on(err, "linear_tf32x3")
        _launched("linear_tf32x3", a, *group)
        outs += cs
    return outs


def dense(x: torch.Tensor, *ws: torch.Tensor):
    """``x @ w`` for each of ``ws`` (each (K, N_w), ``x`` (..., K)): one
    tensor for one weight, a list for several.  Where ``tc_refusal`` finds
    nothing against them, the products run on ``linear_tf32x3`` (weights
    that share ``x`` share its launches); otherwise each is
    ``torch.matmul``, as on the CPU.  ``PRODUCTS`` counts them by route."""
    why, a, layouts = _tc_plan(x, ws)
    if why is None:
        outs = [c.view(*x.shape[:-1], c.shape[1]) for c in _linear_launch(a, ws, layouts)]
        PRODUCTS["tc"] += len(ws)
    else:
        outs = [x @ w for w in ws]
        PRODUCTS["other"] += len(ws)
    return outs[0] if len(ws) == 1 else outs
