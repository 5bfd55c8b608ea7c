"""The benchmark's shape: driven by data found by name, importing nothing
of JAX or the JAX package, its references importing nothing of the program,
and its command refusing to run without a card."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, make_tiny_root
from hikubench import harness

BENCH = ROOT / "hikubench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if "tests" not in path.relative_to(BENCH).parts:  # no path into the JAX benchmarks
        assert "benchmarks/" not in path.read_text().replace("hikubench/", "")


@pytest.mark.parametrize("name", ["model_ref.py", "cluster_ref.py", "counts.py",
                                  "population.py", "traffic.py", "check.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert not any(m.split(".")[0] == "repro_torch" for m in _imports(BENCH / name))


def test_a_run_loads_no_jax(tiny_root, cell_names):
    """A whole tiny run in a fresh process leaves no module of JAX or the
    JAX package in ``sys.modules``."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from hikubench import harness\n"
            "from hikubench.run import forbidden_modules\n"
            f"cell = harness.load_cell({cell_names[0]!r}, __import__('pathlib').Path({str(tiny_root)!r}))\n"
            "harness.run_cell(cell, 1, 1.0, True, 'cpu', 0.0)\n"
            "print('FORBIDDEN', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """Run from a folder with only BENCHMARK.json and the benchmark's files:
    no card here, so it exits with another code than 0 and prints nothing on
    standard output."""
    shutil.copytree(BENCH, tmp_path / "hikubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    name = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "hikubench/run.py", "--workload", name, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_every_cell_metric_and_file_is_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(harness.load_metric(m["name"]), "read")


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_new_mix_and_metric_are_files_and_an_entry(tmp_path):
    """A throwaway mix, a throwaway metric and a cell using both, added as
    new files and new entries of a copied BENCHMARK.json, run without an
    edit to any file that was there."""
    root = make_tiny_root(tmp_path / "copy")
    (root / "hikubench" / "cells").mkdir(exist_ok=True)
    before = _digests(root / "hikubench")
    mix = json.loads((root / "hikubench/traffic/warm4.json").read_text())
    mix.update(functions=2, invocation_weights=[0.5, 0.5], stream_seed=3)
    (root / "hikubench/traffic/throwaway.json").write_text(json.dumps(mix))
    (root / "hikubench/metrics/requests_served.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    (root / "hikubench/cells/minicpm-2b.throwaway.json").write_text(json.dumps(
        {"rate_per_s": 10.0, "trace_seconds": 0.2,
         "limits": {"logit_gap": 0.03, "prefill_logit_err": 1e-4, "decode_kv_err": 1e-4}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "minicpm-2b.throwaway", "config": "minicpm-2b",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_served", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "request_mean_ms",
                               "workloads": ["minicpm-2b.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell(harness.load_cell("minicpm-2b.throwaway", root), 4, 1.0, True,
                           "cpu", 0.0)
    assert res["correct"] and res["metrics"]["requests_served"]["value"] == 10.0
    after = _digests(root / "hikubench")
    assert all(after[p] == d for p, d in before.items())
