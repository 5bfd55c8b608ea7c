"""Run one benchmark cell on the card and print its result line.

    python3 hikubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last); the numbers the check compared follow
on standard error, each beside its limit.  Without a card, with fewer cards
than the cell asks for, without the port's package beside this folder, or
with JAX or the JAX package loaded, it exits with another code than 0 and
prints no result.  See ``hikubench/README.md``.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: build and kernel caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "hikubench" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "hikubench" / "torch_extensions"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is the port, not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from hikubench import harness

    cell = harness.load_cell(args.workload, ROOT)
    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[hikubench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one host thread: the program's host work is serial
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              PROCESS_START)
    bad = forbidden_modules()
    if bad:
        print(f"[hikubench] modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"[hikubench] check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
