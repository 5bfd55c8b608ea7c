"""Quickstart on the PyTorch port: pull-based scheduling in 60 seconds.

Runs Hiku vs the paper's baselines on (a) the port's discrete-event cluster
simulator and (b) the port's real-model serving engine, and prints the §V
metrics.  The simulated table is the same, byte for byte, as
``examples/quickstart.py``'s.

    PYTHONPATH=src python examples/quickstart_torch.py              # serves on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu # the plain path
"""

import argparse
import dataclasses

from repro_torch import default_device
from repro_torch.configs import get_config
from repro_torch.core import SimConfig, Simulator, make_scheduler, summarize
from repro_torch.serving import Endpoint, ServingEngine


def simulated():
    print("== simulated cluster (5 workers, 40 functions, 50 VUs, 60s) ==")
    print(f"{'scheduler':<20}{'mean ms':>9}{'p99 ms':>9}{'cold':>7}{'CV':>7}{'rps':>7}")
    for name in ("hiku", "ch_bl", "least_connections", "random"):
        sched = make_scheduler(name, 5, seed=7)
        sim = Simulator(sched, cfg=SimConfig(), seed=7)
        recs = sim.run(n_vus=50, duration_s=60.0)
        m = summarize(recs, sim.assignments, list(range(5)), 60.0)
        print(f"{name:<20}{m.mean_latency_ms:>9.0f}{m.p99_ms:>9.0f}"
              f"{m.cold_rate:>7.1%}{m.load_cv:>7.2f}{m.throughput_rps:>7.1f}")


def real_models(device="cuda"):
    """Tiny mamba2 endpoints behind hiku on ``device``: the card by default
    (an error without one), ``"cpu"`` for the plain path."""
    device = default_device(None if device == "cuda" else device)
    print(f"\n== real PyTorch models on the serving engine (cold vs warm), {device} ==")
    cfg = get_config("mamba2_130m").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=32, vocab=64,
                              ssm=dataclasses.replace(cfg.ssm, d_state=8, headdim=8))
    eps = [Endpoint(f"fn{i}", cfg, seed=i, max_cache_len=32) for i in range(3)]
    eng = ServingEngine(eps, n_workers=2, scheduler="hiku", device=device)
    for i in range(6):
        r = eng.submit(f"fn{i % 3}")
        print(f"  req {i}: {r.func} -> worker {r.worker} "
              f"{'COLD' if r.cold else 'warm'} {r.latency_ms:8.1f} ms")
    s = eng.summary()
    print(f"  engine summary: {s['n']} reqs, cold_rate={s['cold_rate']:.0%}, "
          f"sched_overhead={s['sched_overhead_ms']:.4f} ms")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help='device to serve on (default: the card; "cpu" runs the plain path)')
    args = ap.parse_args(argv)
    simulated()
    real_models(args.device)


if __name__ == "__main__":
    main()
