"""``repro_torch.launch.roofline`` against the JAX package's copy on
synthetic dry-run cells (one skipped): the same rows, table and picks; the
levers' wording is the one difference allowed."""

import json

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro.launch import roofline as ref
from repro_torch.launch import roofline as port


def _cell(arch, shape, c, m, coll, compile_s=1.5, plan="tp"):
    dom = max(("compute", c), ("memory", m), ("collective", coll), key=lambda kv: kv[1])[0]
    return {"arch": arch, "shape": shape, "mesh": "single", "plan": plan,
            "arg_bytes_per_device": int(1e9 * (c + m)), "compile_s": compile_s,
            "roofline": {"compute_s": c, "memory_s": m, "collective_s": coll, "dominant": dom,
                         "useful_flops_ratio": 0.5 + c}}


CELLS = [
    _cell("mamba2_130m", "train_4k", 0.09, 0.001, 5.0),
    _cell("mamba2_130m", "decode_32k", 4e-6, 5e-4, 4.8e-4),
    _cell("minicpm_2b", "prefill_32k", 0.8, 0.007, 1.6, plan="fsdp+tp"),
    _cell("mixtral_8x22b", "decode_32k", 0.01, 0.2, 0.05),
    _cell("mixtral_8x22b", "train_4k", 6.0, 0.01, 3.0),
    _cell("command_r_35b", "long_500k", 0.0, 0.0, 0.0),
    {"arch": "gemma3_4b", "shape": "long_500k", "mesh": "single", "skipped": True,
     "note": "pure full-attention arch; see DESIGN.md §4"},
]


def test_summarize_cell_matches_reference():
    for d in CELLS:
        assert port.summarize_cell(d) == ref.summarize_cell(d)


def test_summarize_cell_reads_the_trace_seconds():
    d = dict(CELLS[0], trace_s=12.5)
    del d["compile_s"]
    assert port.summarize_cell(d)["compile_s"] == 12.5


def test_markdown_table_matches_reference():
    rows = [ref.summarize_cell(d) for d in CELLS]
    assert port.markdown_table(rows) == ref.markdown_table(rows)


def test_pick_hillclimb_matches_reference():
    rows = [ref.summarize_cell(d) for d in CELLS]
    assert port.pick_hillclimb(rows) == ref.pick_hillclimb(rows)


@pytest.mark.parametrize("row, hint", [
    ({"dominant": "collective"}, "mixtral moe"), ({"dominant": "collective"}, "dense"),
    ({"dominant": "memory"}, "decode"), ({"dominant": "memory"}, "train"),
    ({"dominant": "compute"}, "any")])
def test_lever_for_picks_the_same_lever(row, hint):
    key = {v: k for k, v in ref.LEVERS.items()}[ref.lever_for(row, hint)]
    assert port.lever_for(row, hint) == port.LEVERS[key]
    assert set(port.LEVERS) == set(ref.LEVERS)


def test_main_reads_a_directory(tmp_path, capsys):
    for d in CELLS:
        (tmp_path / f"{d['arch']}__{d['shape']}__single.json").write_text(json.dumps(d))
    port.main(["--dir", str(tmp_path), "--md"])
    got = capsys.readouterr().out
    ref.main(["--dir", str(tmp_path), "--md"])
    assert got == capsys.readouterr().out
