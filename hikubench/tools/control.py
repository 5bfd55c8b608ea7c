"""The check's two readings on the card, at a cell's own size and load:
the program's ``logit_gap`` and ``prefill_logit_err`` on each of
``--seeds``, and on each of ``--control-seeds`` the control's (the plain
reference with TF32 products in the program's place: at each served
position the gap under the float32 reference of the token the TF32
reference puts first, its prefill logits' error and its decode keys' and
values' error) and the gap of a
served token altered where it is produced (``check.FAULT_POSITION``).  One process: one set-up, then one
window a seed at the cell's rate, then the readings once the program's
state is freed.

    python3 hikubench/tools/control.py --workload <cell> --seconds 51 \
        --seeds 11,12,13 --control-seeds 11,12,13

Prints one JSON line a seed.  Needs the card.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hikubench import check, harness, traffic  # noqa: E402
from hikubench.run import CACHES  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    seeds = [int(x) for x in args.seeds.split(",")]
    controls = {int(x) for x in args.control_seeds.split(",") if x}
    cell = harness.load_cell(args.workload, ROOT)
    sess = harness.Session(cell, "cuda")
    sess.warm_up(seeds[0])
    runs = []
    for seed in seeds:
        reqs = traffic.window(cell.mix, seed, args.seconds, cell.spec["rate_per_s"],
                              cell.model["vocab"])
        runs.append((seed, reqs, sess.window(reqs)[0]))
    served = sess.served
    sess.close()
    print(json.dumps({"placements_wrong": check.placements_wrong(cell, served),
                      "requests": len(served)}), flush=True)
    for seed, reqs, out in runs:
        idx = list(range(len(reqs)))
        got = check.readings(cell, reqs, out, idx, "cuda")
        line = {"seed": seed, "requests": len(idx), "program_gap": float(got["gap"].max()),
                "program_prefill_err": float(got["prefill"].max()),
                "program_decode_kv_err": float(got["decode_kv"].max())}
        if seed in controls:
            low = check.readings(cell, reqs, out, idx, "cuda", control=True)
            line.update(control_gap=float(low["gap"].max()),
                        control_gap_requests=int((low["gap"] > 0).sum()),
                        control_prefill_err=float(low["prefill"].max()),
                        control_decode_kv_err=float(low["decode_kv"].max()),
                        token_fault_gap=float(low["fault"].max()))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
