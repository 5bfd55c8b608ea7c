"""Worker host: the function-instance lifecycle (Figure 2) on real models
(counterpart of the JAX package's ``serving/worker.py``).

A worker owns a memory pool and a table of idle *instances*: one endpoint's
parameters materialised on the worker's device.  Cold start = parameter
materialisation + on the card the capture of the decode step at the
request's batch size (one eager call, then a CUDA graph: the counterpart of
the JAX package's XLA compile of ``decode_step``); warm start = reuse of a
resident idle instance.  Prefill runs eagerly.  The evictor implements
keep-alive timeouts and LRU force-eviction under memory pressure, emitting
the scheduler notifications of Section IV-A.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import default_device
from ..models import build_model
from . import telemetry
from .captured import CapturedStep, copy_into, tree_leaves


@dataclasses.dataclass
class Endpoint:
    """A deployable function type: model config + weight seed, and the
    parameters' dtype (float32, as in the JAX package, unless a model too
    large for that is served in bfloat16), which the decode cache takes too."""

    name: str
    cfg: object  # ModelConfig
    seed: int = 0
    max_cache_len: int = 128
    param_dtype: torch.dtype = torch.float32

    def est_bytes(self) -> int:
        p = self.cfg.n_params() * self.param_dtype.itemsize
        return int(p * 1.2) + 64 * self.max_cache_len * 1024


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _DecodeLoop:
    """``generate``'s decode loop on the card for one batch size: static
    token, position and cache buffers and the step captured on them, which
    decodes one token, writes its argmax back as the next input token and
    advances the position."""

    def __init__(self, model, params, batch: int, cache, device: torch.device):
        self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.index = torch.zeros((), dtype=torch.int32, device=device)
        self.cache = cache

        def step():
            logits, new = model.decode_step(params, self.tokens, self.cache, self.index)
            copy_into(self.cache, new)  # the SSM state comes back as new tensors
            self.tokens.copy_(logits.argmax(-1, keepdim=True))
            self.index.add_(1)

        self.step = CapturedStep(step, device)

    def run(self, first: torch.Tensor, idx: int, steps: int) -> List[torch.Tensor]:
        """Tokens ``first`` and then ``steps`` more, decoded from a zero cache
        at positions ``idx, idx + 1, ...``: one replay each."""
        for t in tree_leaves(self.cache):
            t.zero_()
        self.tokens.copy_(first[:, None])
        self.index.fill_(idx)
        out = [first]
        for _ in range(steps):
            self.step.replay()
            out.append(self.tokens[:, 0].clone())
        return out


class Instance:
    """One warm sandbox: an endpoint's parameters on a device, and on the
    card its captured decode loops, one per batch size (``prepare``).

    Parameters are drawn from a ``torch.Generator`` on the device seeded with
    ``endpoint.seed`` (an encoder-decoder model's position tables with
    ``endpoint.max_cache_len`` rows); pass ``params`` to use given ones
    instead (a test hands in the JAX package's, converted by
    ``models.params_from_numpy``).
    """

    __slots__ = ("endpoint", "device", "model", "params", "last_used", "_loops", "_events")

    def __init__(self, endpoint: Endpoint, device=None, params: Optional[Dict] = None):
        with telemetry.span("materialise"):
            self.endpoint = endpoint
            self.device = default_device(device)
            self.model = build_model(endpoint.cfg, param_dtype=endpoint.param_dtype,
                                     device=self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(endpoint.seed)
                params = self.model.init(gen, max_seq=endpoint.max_cache_len)
            self.params = params
            self._loops: Dict[int, _DecodeLoop] = {}
            # generate's device intervals: before the prefill, after its
            # argmax, after the last replay
            self._events = (tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
                            if self.device.type == "cuda" else None)
            _sync(self.device)
            self.last_used = time.monotonic()

    @torch.no_grad()
    def prepare(self, batch: int) -> None:
        """On the card, allocate the decode loop's buffers for ``batch`` rows
        and capture its step (cold start does this at the request's batch
        size; ``generate`` does it for a size it has not seen).  Nothing on
        the CPU, where ``generate`` runs eagerly, but the ``capture`` span."""
        if batch in self._loops:
            return
        with telemetry.span("capture"):
            if self.device.type == "cuda":
                self._loops[batch] = _DecodeLoop(self.model, self.params, batch,
                                                 self.decode_cache(batch), self.device)
                _sync(self.device)

    def prefill_batch(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``generate``'s prefill input: the tokens, and for an
        encoder-decoder model zero frames (B, S, d) in the parameters' dtype,
        as the JAX package's ``Instance`` feeds them."""
        cfg = self.endpoint.cfg
        if not cfg.enc_dec:
            return {"tokens": tokens}
        frames = torch.zeros((*tokens.shape, cfg.d_model), dtype=self.endpoint.param_dtype,
                             device=tokens.device)
        return {"frames": frames, "tokens": tokens}

    def decode_cache(self, batch: int):
        """``generate``'s zero decode cache for ``batch`` rows: the endpoint's
        ``max_cache_len`` positions in the parameters' dtype, and for an
        encoder-decoder model 8 rows of zero memory, as in the JAX package."""
        return self.model.init_cache(batch, self.endpoint.max_cache_len,
                                     dtype=self.endpoint.param_dtype, memory_t=8)

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, gen_len: int = 4) -> torch.Tensor:
        """Prefill + a few greedy decode steps (the 'function execution').

        As in the JAX package, decoding starts from a zero cache: the cache
        that prefill builds is discarded, so the tokens after the first
        depend only on the previous token, and an encoder-decoder model
        encodes zero frames and decodes over zero memory (ROADMAP Queue 3).
        Kept so that the two packages generate the same tokens.  On the card
        each decode step is one replay of the captured step; on the CPU it
        runs eagerly.  On the card the open request record gets the
        prefill's and the replays' device intervals.
        """
        with telemetry.span("generate"):
            model, ep = self.model, self.endpoint
            tokens = tokens.to(self.device)
            B, S = tokens.shape
            ev = self._events
            on_card = self.device.type == "cuda"
            if on_card:
                ev[0].record()
            _, last_logits = model.prefill(self.params, self.prefill_batch(tokens))
            out = [last_logits.argmax(-1)]
            idx = min(S, ep.max_cache_len - gen_len - 1)
            if on_card:
                ev[1].record()
                self.prepare(B)
                loop = self._loops[B]
                replays = loop.step.replays
                out = loop.run(out[0], idx, gen_len - 1)
                replays = loop.step.replays - replays
                ev[2].record()
            else:
                cache = self.decode_cache(B)
                for i in range(gen_len - 1):
                    logits, cache = model.decode_step(self.params, out[-1][:, None], cache,
                                                      idx + i)
                    out.append(logits.argmax(-1))
            result = torch.stack(out, 1)
            _sync(self.device)
            rec = telemetry.current()
            if on_card and rec is not None:
                rec.prefill_ms = ev[0].elapsed_time(ev[1])
                rec.decode_ms = ev[1].elapsed_time(ev[2])
                rec.replays = replays
            return result


@dataclasses.dataclass
class ExecutionRecord:
    func: str
    worker: int
    cold: bool
    init_ms: float
    exec_ms: float

    @property
    def total_ms(self) -> float:
        return self.init_ms + self.exec_ms


class WorkerHost:
    def __init__(self, wid: int, mem_pool_bytes: int = 2 * 2**30, keep_alive_s: float = 60.0,
                 device=None):
        self.wid = wid
        self.device = default_device(device)
        self.pool = mem_pool_bytes
        self.keep_alive_s = keep_alive_s
        self.idle: Dict[str, List[Instance]] = {}
        self.used_bytes = 0
        self.on_evict: Optional[Callable[[int, str], None]] = None

    # ------------------------------------------------------------- memory
    def _evict_lru(self) -> bool:
        lru_key, lru_i, lru_t = None, -1, float("inf")
        for name, lst in self.idle.items():
            for i, inst in enumerate(lst):
                if inst.last_used < lru_t:
                    lru_key, lru_i, lru_t = name, i, inst.last_used
        if lru_key is None:
            return False
        inst = self.idle[lru_key].pop(lru_i)
        if not self.idle[lru_key]:
            del self.idle[lru_key]
        self.used_bytes -= inst.endpoint.est_bytes()
        if self.on_evict:
            self.on_evict(self.wid, lru_key)
        return True

    def sweep(self) -> None:
        now = time.monotonic()
        for name in list(self.idle):
            keep = []
            for inst in self.idle[name]:
                if now - inst.last_used > self.keep_alive_s:
                    self.used_bytes -= inst.endpoint.est_bytes()
                    if self.on_evict:
                        self.on_evict(self.wid, name)
                else:
                    keep.append(inst)
            if keep:
                self.idle[name] = keep
            else:
                del self.idle[name]

    # ------------------------------------------------------------ execute
    def execute(self, ep: Endpoint, tokens: torch.Tensor, gen_len: int = 4) -> ExecutionRecord:
        """Serve one request on this worker; ``init_ms`` runs from the
        start of the ``execute`` span to that of ``generate`` (cold starts
        only), ``exec_ms`` is the ``generate`` span."""
        with telemetry.request(ep.name) as rec, telemetry.span("execute") as sp:
            cold = not self.idle.get(ep.name)
            rec.worker, rec.cold = self.wid, cold
            if cold:
                need = ep.est_bytes()
                while self.used_bytes + need > self.pool and self._evict_lru():
                    pass
                inst = Instance(ep, self.device)  # materialise ...
                inst.prepare(tokens.shape[0])     # ... + capture decode == cold start
                self.used_bytes += need
            else:
                inst = self.idle[ep.name].pop()
            inst.generate(tokens, gen_len)
            inst.last_used = time.monotonic()
            self.idle.setdefault(ep.name, []).append(inst)
            g0, g1 = rec.span("generate")
            return ExecutionRecord(
                func=ep.name, worker=self.wid, cold=cold,
                init_ms=telemetry.ms(sp.start, g0) if cold else 0.0,
                exec_ms=telemetry.ms(g0, g1),
            )
