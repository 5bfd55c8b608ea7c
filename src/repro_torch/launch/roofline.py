"""Roofline aggregation: dry-run JSONs -> per-cell table + hillclimb picks
(counterpart of the JAX package's ``launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        [--dir benchmarks/results/local/dryrun_torch] [--mesh single] [--md]

Terms (seconds/step, one device's work — NVIDIA H100 SXM data-sheet
constants, ``launch/dryrun.py``):
  compute    = FLOPs / 989e12 (dense bf16)
  memory     = (input bytes read + output bytes written)/dev / 3.35e12
               (analytic floor; the sum of every op's bytes kept as x-check)
  collective = modeled ring traffic / 450e9 (NVLink 4; a floor across nodes)
Roofline fraction = compute / max(terms): 1.0 = compute-bound (ideal).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List


def load_cells(dirpath: str, mesh: str = "single") -> List[Dict]:
    out = []
    for p in sorted(Path(dirpath).glob(f"*__{mesh}.json")):
        d = json.loads(p.read_text())
        out.append(d)
    return out


def summarize_cell(d: Dict) -> Dict:
    if d.get("skipped"):
        return {"arch": d["arch"], "shape": d["shape"], "skipped": True, "note": d["note"]}
    r = d["roofline"]
    terms = {"compute": r["compute_s"], "memory": r["memory_s"], "collective": r["collective_s"]}
    tmax = max(terms.values())
    frac = terms["compute"] / tmax if tmax > 0 else 1.0
    return {
        "arch": d["arch"],
        "shape": d["shape"],
        "plan": d.get("plan", "?"),
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "dominant": r["dominant"],
        "roofline_fraction": frac,
        "useful_flops_ratio": r.get("useful_flops_ratio", 0.0),
        "hbm_gb_per_dev": (d.get("arg_bytes_per_device", 0) + 0.0) / 1e9,
        # the dry run's trace seconds, under the reference's key
        "compile_s": d.get("trace_s", d.get("compile_s", 0)),
    }


LEVERS = {
    ("collective", "moe"): "expert-parallel all-to-all dispatch (apply_moe_sharded) instead of "
                           "the replicated dispatch",
    ("collective", "any"): "reduce-scatter+all-gather instead of all-reduce; overlap with compute",
    ("memory", "decode"): "shard KV heads / ring-buffer SWA cache / int8 KV",
    ("memory", "train"): "saveable-dots remat policy; fused optimizer update",
    ("compute", "any"): "already compute-bound: larger per-chip batch or faster kernels",
}


def lever_for(row: Dict, kind_hint: str) -> str:
    dom = row["dominant"]
    if dom == "collective" and "moe" in kind_hint:
        return LEVERS[("collective", "moe")]
    if dom == "collective":
        return LEVERS[("collective", "any")]
    if dom == "memory" and "decode" in kind_hint:
        return LEVERS[("memory", "decode")]
    if dom == "memory":
        return LEVERS[("memory", "train")]
    return LEVERS[("compute", "any")]


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | plan | compute s | memory s | collective s | dominant "
           "| roofline frac | useful flops | HBM GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | SKIP | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} | {r['compute_s']:.2e} "
            f"| {r['memory_s']:.2e} | {r['collective_s']:.2e} | {r['dominant']} "
            f"| {r['roofline_fraction']:.3f} | {r['useful_flops_ratio']:.2f} "
            f"| {r['hbm_gb_per_dev']:.1f} |"
        )
    return hdr + "\n".join(lines)


def pick_hillclimb(rows: List[Dict]) -> Dict[str, Dict]:
    """Three DISTINCT cells: worst fraction, most collective-bound, and the
    serving-decode cell most representative of the paper's technique."""
    live = [r for r in rows if not r.get("skipped")]
    key = lambda r: (r["arch"], r["shape"])
    coll = max(live, key=lambda r: r["collective_s"])
    worst = min((r for r in live if key(r) != key(coll)),
                key=lambda r: r["roofline_fraction"])
    taken = {key(coll), key(worst)}
    serving = [r for r in live if r["shape"] in ("decode_32k", "long_500k")
               and key(r) not in taken]
    rep = max(serving, key=lambda r: max(r["memory_s"], r["collective_s"]))
    return {"worst_fraction": worst, "most_collective_bound": coll, "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="benchmarks/results/local/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    rows = [summarize_cell(d) for d in load_cells(args.dir, args.mesh)]
    if args.md:
        print(markdown_table(rows))
    else:
        for r in rows:
            print(json.dumps(r))
    picks = pick_hillclimb(rows)
    print("\n## hillclimb picks")
    for k, v in picks.items():
        print(f"- {k}: {v['arch']} x {v['shape']} (dominant={v['dominant']}, "
              f"frac={v['roofline_fraction']:.4f})")


if __name__ == "__main__":
    main()
