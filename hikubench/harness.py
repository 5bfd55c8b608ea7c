"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``: the model's widths as run, its source and the
port's config it replaces the widths of) and a traffic mix
(``traffic/<traffic>.json``: the deployment and the stream's shape); its own
file ``cells/<cell>.json`` holds what was fixed for it on the card: the
offered rate, the requests the output check compares, the traced seconds
and the limits of the check.  A metric is ``metrics/<name>.py``, whose
``read(run)`` returns a number or None.  Nothing here names a cell, a
configuration, a mix or a metric.

The run drives the port's serving path as a user does: an open-loop
client submits each request to ``ServingEngine.submit`` at its due time
(the engine is serial; every worker shares the card) and times it from
that due time to the return.  The harness wraps, from this file, the
calls the engine makes into the worker and instance layers, to record
each request's outcome, its served tokens and, in a traced run, a span
around each layer's call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, traffic
from . import trace as tracemod

BENCH = Path(__file__).resolve().parent
#: the checkout's root
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict        # configs/<config>.json
    mix: traffic.Mix
    spec: Dict          # cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = ROOT   # the checkout the cell's files are in

    @property
    def model(self) -> Dict:
        return self.config["model"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    here = root / "hikubench"
    config = json.loads((here / "configs" / f"{w['config']}.json").read_text())
    mix = traffic.Mix.load(here / "traffic" / f"{w['traffic']}.json")
    spec = json.loads((here / "cells" / f"{name}.json").read_text())
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]  # noqa: E731
    return Cell(name, config, mix, spec, mine(bench["end_to_end"]), mine(bench["per_layer"]),
                root)


def port_config(config: Dict):
    """The port's ``ModelConfig`` of ``config``: its ``port_config`` with the
    file's widths."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(config["port_config"]),
                               name=config["name"], **config["model"])


def load_metric(name: str, root: Path = ROOT):
    path = root / "hikubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hikubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- recording
@dataclasses.dataclass
class Served:
    """One served request as the harness saw it (seconds from the window's
    start; ms as the program's records give them)."""
    func: int
    prompt_len: int
    gen_len: int
    due_s: float = 0.0
    start_s: float = 0.0
    end_s: float = 0.0
    worker: int = -1
    cold: bool = False
    built: int = 0          # instances the harness saw built during it
    init_ms: float = 0.0
    exec_ms: float = 0.0
    sched_ms: float = 0.0
    failed: bool = False
    traced: bool = False
    tokens: object = None   # the served tokens (gen_len,), as generate returned them
    first_logits: object = None  # the prefill's last-position logits (vocab,)
    decode_kv: object = None     # [keys, values] the decode steps wrote, see ``Recorder``
    kv_source: object = None     # the decode cache the request's instance was given


def _seq_leaves(tree, seq: int) -> List:
    """The tensors of a decode cache that hold one row a position: those of
    five dims whose third is ``seq`` (the attention caches' (k, v), laid out
    (applications, batch, positions, kv heads, head dim))."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _seq_leaves(v, seq)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _seq_leaves(v, seq)]
    return [tree] if tree.ndim == 5 and tree.shape[2] == seq else []


class Recorder:
    """Wraps the worker and instance layers' methods for the duration of a
    ``with``: each call is tied to the request being served (``current``),
    and, while ``spans`` is set, runs inside a ``hikubench.<layer>`` span.

    Besides the outcome it keeps what the served path produced: the tokens
    ``Instance.generate`` returned, the logits the prefill returned, and the
    keys and values its decode steps wrote into the decode cache that
    ``Instance.decode_cache`` handed the instance (the rows of the request's
    decode positions, copied once ``generate`` returns; the cache of a warm
    instance is found again through a weak reference, so an evicted
    instance's cache is freed with it)."""

    def __init__(self):
        self.current: Optional[Served] = None
        self.spans = False
        self._saved = []
        self._caches: Dict[int, List] = {}   # id(instance) -> weak refs to its cache's rows

    def _span(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(tracemod.SPAN_PREFIX + name)

    def _wrap(self, cls, attr, span, after=None):
        orig = getattr(cls, attr)
        rec = self

        def wrapped(*args, **kw):
            with rec._span(span):
                out = orig(*args, **kw)
            if after is not None and rec.current is not None:
                after(rec.current, args, out)
            return out

        self._saved.append((cls, attr, orig))
        setattr(cls, attr, wrapped)

    def __enter__(self):
        from repro_torch.models.model import Model
        from repro_torch.serving import worker

        def on_execute(cur, args, rec):
            cur.worker, cur.cold = rec.worker, rec.cold
            cur.init_ms, cur.exec_ms = rec.init_ms, rec.exec_ms

        def on_cache(cur, args, out):
            cur.kv_source = out
            maxlen = args[0].endpoint.max_cache_len
            self._caches[id(args[0])] = [weakref.ref(t) for t in _seq_leaves(out, maxlen)]

        def on_generate(cur, args, out):
            cur.tokens = out[0]
            inst, maxlen = args[0], args[0].endpoint.max_cache_len
            if cur.kv_source is not None:
                leaves = _seq_leaves(cur.kv_source, maxlen)
            else:
                leaves = [r() for r in self._caches.get(id(inst), [])]
            idx = min(cur.prompt_len, maxlen - cur.gen_len - 1)
            if leaves and all(t is not None for t in leaves):
                cur.decode_kv = [t[:, 0, idx:idx + cur.gen_len - 1].clone() for t in leaves]
            cur.kv_source = None

        def on_build(cur, args, out):
            cur.built += 1

        def on_prefill(cur, args, out):
            cur.first_logits = out[1][0].clone()  # a copy: the view holds every position's

        self._wrap(worker.WorkerHost, "execute", "execute", on_execute)
        self._wrap(worker.Instance, "__init__", "materialise", on_build)
        self._wrap(worker.Instance, "prepare", "capture")
        self._wrap(worker.Instance, "decode_cache", "decode_cache", on_cache)
        self._wrap(worker.Instance, "generate", "generate", on_generate)
        self._wrap(Model, "prefill", "prefill", on_prefill)
        self._wrap(worker._DecodeLoop, "run", "decode")
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in reversed(self._saved):
            setattr(cls, attr, orig)
        self._saved.clear()
        return False


# --------------------------------------------------------------------- run
@dataclasses.dataclass
class Run:
    """What a metric's ``read`` gets."""
    cell: Cell
    seconds: float
    setup_s: float
    requests: List[Served]          # the window's, in due order
    trace: Optional[tracemod.Trace]

    @property
    def model(self) -> Dict:
        return self.cell.model

    @property
    def max_cache_len(self) -> int:
        return self.cell.config["max_cache_len"]

    @property
    def workers(self) -> int:
        return self.cell.mix.workers

    def untraced(self) -> List[Served]:
        """The requests served with the profiler off (all of them in a run
        without ``--trace``)."""
        return [r for r in self.requests if not r.traced]


def _log(msg: str) -> None:
    print(f"[hikubench] {msg}", file=sys.stderr, flush=True)


class Session:
    """The program under test for one cell: the engine over the mix's
    endpoints, with the harness's wrappers installed until ``close``."""

    def __init__(self, cell: Cell, device: str):
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.worker import Endpoint

        self.cell, self.device = cell, device
        mix, maxlen = cell.mix, cell.config["max_cache_len"]
        pcfg = port_config(cell.config)
        self.names = [f"f{i:02d}" for i in range(mix.functions)]
        endpoints = [Endpoint(n, pcfg, seed=mix.weight_seed_base + i, max_cache_len=maxlen)
                     for i, n in enumerate(self.names)]
        self.engine = ServingEngine(endpoints, n_workers=mix.workers, scheduler=mix.scheduler,
                                    mem_pool_bytes=mix.pool_bytes,
                                    keep_alive_s=mix.keep_alive_s, seed=mix.stream_seed,
                                    device=device)
        self.rec = Recorder().__enter__()
        self.served: List[Served] = []    # every request, warm-up and windows, in order

    def submit(self, req: traffic.Request, r: Served, prompt) -> None:
        self.rec.current = r
        try:
            res = self.engine.submit(self.names[req.func], prompt, req.gen_len)
            r.sched_ms = res.sched_overhead_ms
        except (RuntimeError, ValueError) as e:  # a CUDA out-of-memory error is a RuntimeError
            r.failed = True
            _log(f"request failed: {type(e).__name__}: {e}")
        finally:
            self.rec.current = None
            self.served.append(r)

    def warm_up(self, seed: int) -> None:
        """Serve the mix's warm-up until its rule holds: the pools' state."""
        mix = self.cell.mix
        done = []
        for req in traffic.warmup(mix, seed, self.cell.model["vocab"]):
            r = Served(req.func, len(req.tokens), req.gen_len)
            self.submit(req, r, _prompt(req))
            r.tokens = r.first_logits = r.decode_kv = None  # the check reads the window's
            done.append((r.func, r.cold))
            holders = [[f for f, lst in h.idle.items() if lst]
                       for h in self.engine.workers.values()]
            if r.failed or traffic.warmup_done(mix, done, holders):
                return

    def window(self, reqs: List[traffic.Request], trace_from: float = float("inf")):
        """Serve ``reqs`` open loop, each at its due time from now; the
        profiler runs from the first request due at ``trace_from`` on.
        Returns (the requests as served, the trace or None)."""
        prompts = [_prompt(r) for r in reqs]
        out = [Served(r.func, len(r.tokens), r.gen_len, due_s=r.due_s) for r in reqs]
        prof, rec = None, self.rec
        _sync(self.device)
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            for req, r, prompt in zip(reqs, out, prompts):
                if prof is None and req.due_s >= trace_from:
                    prof = _start_profiler(rec, self.device)
                due = t0 + req.due_s
                now = time.perf_counter()
                if now < due:
                    with rec._span("wait"):
                        time.sleep(due - now)
                r.traced = prof is not None
                r.start_s = time.perf_counter() - t0
                with rec._span("request"):
                    self.submit(req, r, prompt)
                r.end_s = time.perf_counter() - t0
        finally:
            gc.enable()
        self.t0 = t0
        tr = _stop_profiler(prof, rec) if prof is not None else None
        for r in out:
            if r.tokens is not None:
                r.tokens = r.tokens.cpu()
            if r.first_logits is not None:
                r.first_logits = r.first_logits.cpu()
            if r.decode_kv is not None:
                r.decode_kv = [t.cpu() for t in r.decode_kv]
        return out, tr

    def close(self) -> None:
        """Uninstall the wrappers and free the program's state."""
        import torch

        self.rec.__exit__(None, None, None)
        self.engine = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def _prompt(req: traffic.Request):
    import torch

    return torch.from_numpy(req.tokens[None].astype(np.int32))


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             process_start: float) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    import torch

    t_start = time.perf_counter()
    sess = Session(cell, device)
    t_engine = time.perf_counter()
    sess.warm_up(seed)
    reqs = traffic.window(cell.mix, seed, seconds, cell.spec["rate_per_s"], cell.model["vocab"])
    trace_from = seconds - cell.spec["trace_seconds"] if trace else float("inf")
    window, tr = sess.window(reqs, trace_from)
    setup_s = sess.t0 - process_start
    t_end = time.perf_counter()
    warm_n = len(sess.served) - len(window)
    _log(f"set-up {setup_s:.2f} s (to the harness {t_start - process_start:.2f}, engine "
         f"{t_engine - t_start:.2f}, warm-up {sess.t0 - t_engine:.2f} s: {warm_n} requests, "
         f"{sum(r.cold for r in sess.served[:warm_n])} cold), window {t_end - sess.t0:.2f} s")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    warm = sess.served[: len(sess.served) - len(window)]
    sess.close()

    checks = check.run_checks(cell, warm, window, reqs, device)
    _log(f"check {time.perf_counter() - t_end:.2f} s")
    run = Run(cell, seconds, setup_s, window, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"], cell.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r.failed for r in window)
    result = {
        "correct": failed == 0 and check.passed(checks),
        "attempted": len(window),
        "failed": failed,
        "metrics": metrics,
        "device": _device(device, peak, tr),
    }
    if tr is not None:
        result["breakdown"] = {"device_ops": tracemod.top_ops(tr),
                               "idle_gaps": tracemod.idle_gaps(tr)}
    result["checks"] = checks
    return result


def _start_profiler(rec: Recorder, device: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    prof = profile(activities=acts)
    prof.start()
    rec.spans = True
    rec._traced = rec._span("traced")
    rec._traced.__enter__()
    return prof


def _stop_profiler(prof, rec: Recorder) -> tracemod.Trace:
    rec._traced.__exit__(None, None, None)
    rec.spans = False
    prof.stop()
    spans = tracemod.from_profiler(prof, (0.0, 0.0))
    win = tracemod.span_intervals(spans, "traced")
    spans.window = (win[0][0], win[-1][1])
    return spans


def _device(device: str, peak: int, tr: Optional[tracemod.Trace]) -> Dict:
    import torch

    if device == "cpu":
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
               "memory_peak_bytes": peak}
    if tr is not None:
        out["busy_s"] = tracemod.busy(tr)
        out["window_s"] = tr.window_s
    return out
