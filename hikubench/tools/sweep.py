"""Find a cell's knee: serve its traffic at several fixed rates in one
process, one window each, after one set-up, and print each window's
latencies and whether its backlog grew.

    python3 hikubench/tools/sweep.py --workload <cell> --seed <n> --seconds 30 \
        --rates 2,2.5,3,3.5

The knee is the highest rate whose client lateness does not grow through
the window (``late_last_third_ms`` about ``late_first_third_ms``); a cell's
``rate_per_s`` is a fixed share of it.  Needs the card.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from hikubench import harness, traffic  # noqa: E402
from hikubench.run import CACHES  # noqa: E402


def summary(rate, out):
    lat = np.array([(r.end_s - r.due_s) * 1e3 for r in out])
    late = np.array([(r.start_s - r.due_s) * 1e3 for r in out])
    k = max(1, len(out) // 3)
    return {"rate_per_s": rate, "requests": len(out), "cold": int(sum(r.cold for r in out)),
            "mean_ms": float(lat.mean()), "p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90)),
            "late_first_third_ms": float(late[:k].mean()),
            "late_last_third_ms": float(late[-k:].mean()),
            "service_ms": float(np.mean([(r.end_s - r.start_s) * 1e3 for r in out])),
            "warm_exec_ms": float(np.mean([r.exec_ms for r in out if not r.cold])),
            "cold_init_ms": float(np.mean([r.init_ms for r in out if r.cold] or [0.0]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    cell = harness.load_cell(args.workload, ROOT)
    sess = harness.Session(cell, "cuda")
    sess.warm_up(args.seed)
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        reqs = traffic.window(cell.mix, args.seed + i, args.seconds, rate, cell.model["vocab"])
        out, _ = sess.window(reqs)
        print(json.dumps(summary(rate, out)), flush=True)
    sess.close()


if __name__ == "__main__":
    main()
