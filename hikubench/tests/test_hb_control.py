"""The control of the output check: the plain reference with TF32 products
(10 mantissa bits, the precision a float32 product takes on the card's
tensor cores) put in the program's place must fail the check where the
program passes.  On the CPU at a tiny size; on the card at each cell's own
size (``-m gpu``), as ``tools/control.py`` reads it for PERF.md."""

import pytest
import torch

from hikubench import check, harness, traffic


def _readings(cell, device, seconds):
    sess = harness.Session(cell, device)
    sess.warm_up(11)
    reqs = traffic.window(cell.mix, 11, seconds, cell.spec["rate_per_s"], cell.model["vocab"])
    out, _ = sess.window(reqs)
    sess.close()
    idx = list(range(len(reqs)))
    return (check.readings(cell, reqs, out, idx, device),
            check.readings(cell, reqs, out, idx, device, control=True))


def test_control_separates_on_the_cpu(tiny_root, cell_names):
    for name in cell_names:
        cell = harness.load_cell(name, tiny_root)
        prog, ctrl = _readings(cell, "cpu", 1.0)
        assert prog["gap"].max() == 0.0
        for key in ("prefill", "decode_kv"):
            assert ctrl[key].max() > 30 * max(prog[key].max(), 1e-9), (name, key)
        assert ctrl["fault"].max() > cell.spec["limits"]["logit_gap"]


@pytest.mark.gpu
def test_control_fails_each_cell_on_the_card(cell_names):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' own sizes run on the card")
    for name in cell_names:
        cell = harness.load_cell(name)
        prog, ctrl = _readings(cell, "cuda", 12.0)
        lim = cell.spec["limits"]
        pairs = (("gap", "logit_gap"), ("prefill", "prefill_logit_err"),
                 ("decode_kv", "decode_kv_err"))
        assert all(prog[k].max() <= lim[n] for k, n in pairs), name
        assert any(ctrl[k].max() > lim[n] for k, n in pairs), name
