"""Serving launcher CLI: the paper's system end to end on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler hiku \
        --workers 3 --endpoints 4 --requests 24 [--fail-at 12] [--device cpu]

The counterpart of the JAX package's ``launch/serve.py``, with the same
arguments and printout plus ``--device`` (default: the card).  Deploys N
endpoints (tiny minicpm-2b models with random weights from their seeds) over
worker hosts, drives a seeded Azure-skewed request stream through the chosen
scheduler, and prints per-request outcomes and a summary.  ``--fail-at``
kills the worker of that request after it ran and elastically joins a
replacement (fault-tolerance demo).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..core.scheduler import available_schedulers
from ..core.trace import azure_like_weights
from ..serving import Endpoint, ServingEngine


def _endpoint(name, seed):
    cfg = get_config("minicpm_2b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                              head_dim=16, d_ff=64, vocab=64)
    return Endpoint(name, cfg, seed=seed, max_cache_len=48)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="hiku", choices=available_schedulers())
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--endpoints", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help='device to serve on (default: the card; "cpu" runs the plain path)')
    args = ap.parse_args(argv)

    eps = [_endpoint(f"fn-{i}", i) for i in range(args.endpoints)]
    eng = ServingEngine(eps, n_workers=args.workers, scheduler=args.scheduler,
                        seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    weights = azure_like_weights(args.endpoints, args.seed)
    print(f"scheduler={args.scheduler} workers={args.workers} "
          f"endpoints={args.endpoints} (Azure-skewed popularity) device={eng.device}")
    for i in range(args.requests):
        f = f"fn-{rng.choice(args.endpoints, p=weights)}"
        tokens = torch.ones((args.batch, 8), dtype=torch.int32)
        r = eng.submit(f, tokens=tokens, gen_len=2)
        print(f"  [{i:03d}] {r.func:6s} -> w{r.worker} "
              f"{'COLD' if r.cold else 'warm'} {r.latency_ms:9.1f} ms "
              f"(sched {r.sched_overhead_ms*1e3:.1f} us)")
        if args.fail_at is not None and i == args.fail_at:
            victim = r.worker
            eng.fail_worker(victim)
            new_id = max(eng.workers) + 1
            eng.add_worker(new_id)
            print(f"  !! worker {victim} failed; worker {new_id} joined")
    s = eng.summary()
    print(f"summary: n={s['n']} mean={s['mean_latency_ms']:.1f}ms "
          f"cold_rate={s['cold_rate']:.0%} sched_overhead={s['sched_overhead_ms']:.4f}ms")


if __name__ == "__main__":
    main()
