"""Fixtures of the benchmark's CPU tests: a checkout-shaped folder whose
cells run the real harness at a tiny size on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark's files in which every configuration keeps its
    family at tiny widths, every mix has short prompts and pools that hold
    one instance, and every cell runs at 20 requests/s."""
    bench = dest / "hikubench"
    for sub in ("metrics", "traffic", "configs", "cells"):
        shutil.copytree(ROOT / "hikubench" / sub, bench / sub)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for p in (bench / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        m = c["model"]
        m.update(TINY, n_layers=2)
        c["max_cache_len"] = 96
        p.write_text(json.dumps(c))
    for p in (bench / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(prompt_len={"dist": "loguniform", "min": 8, "max": 48}, gen_len=6,
                 pool_gib=0.01)
        p.write_text(json.dumps(d))
    for p in (bench / "cells").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(rate_per_s=20.0, trace_seconds=0.3)
        p.write_text(json.dumps(d))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("hikubench_tiny"))


@pytest.fixture(scope="session")
def cell_names():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
