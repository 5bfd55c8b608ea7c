"""``examples/quickstart_torch.py`` against ``examples/quickstart.py`` and
``examples/serve_cluster_torch.py`` against ``examples/serve_cluster.py``: the
simulated sections printed byte for byte the same (the host's wall-clock
rates masked), and the real-model parts on the CPU's plain path.
``examples/pull_training_torch.py`` prints ``examples/pull_training.py``'s
table, and ``examples/train_wsd_torch.py`` trains, checkpoints and resumes on
the CPU."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*a, **kw)
    return out.getvalue(), ret


def test_simulated_table_is_the_reference_table():
    got, _ = _printed(_load("quickstart_torch").simulated)
    want, _ = _printed(_load("quickstart").simulated)
    assert got == want
    assert len(got.splitlines()) == 6


def test_real_models_on_the_cpu():
    text, eng = _printed(_load("quickstart_torch").real_models, device="cpu")
    lines = text.strip().splitlines()
    assert "cpu" in lines[0] and len(lines) == 8
    assert eng.device.type == "cpu"
    s = eng.summary()
    assert s["n"] == 6 and 0.0 < s["cold_rate"] < 1.0


def test_real_models_has_no_silent_cpu_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("quickstart_torch").real_models()


# ------------------------------------------------------------ serve_cluster
#: the wall-clock figures the sharded section prints: a shard's events/s, the
#: makespan and the two rates
_WALL = re.compile(r"@ [\d,]+ ev/s|makespan [\d.]+s \([\d,]+ ev/s end-to-end\), "
                   r"aggregate capacity [\d,]+ ev/s")


@pytest.mark.parametrize("section", ["replay_paper_protocol", "sharded_scale_out",
                                     "admission_tier", "work_stealing", "policy_comparison"])
def test_serve_cluster_simulated_sections_are_the_reference_output(section):
    port, ref = _load("serve_cluster_torch"), _load("serve_cluster")
    args = (True,) if section == "replay_paper_protocol" else (True, 4)
    got, _ = _printed(getattr(port, section), *args)
    want, _ = _printed(getattr(ref, section), *args)
    assert len(got.splitlines()) >= 3
    if section == "sharded_scale_out":
        assert len(_WALL.findall(got)) == 5 == len(_WALL.findall(want))
        got, want = _WALL.sub("<wall>", got), _WALL.sub("<wall>", want)
    assert got == want


def test_serve_cluster_real_models_on_the_cpu():
    text, eng = _printed(_load("serve_cluster_torch").serve_real_batched, True, device="cpu")
    lines = text.strip().splitlines()
    assert "cpu" in lines[0] and eng.device.type == "cpu"
    assert any("failing worker" in ln for ln in lines) and any("worker 99" in ln for ln in lines)
    s = eng.summary()
    assert s["n"] == 8 and 0.0 < s["cold_rate"] < 1.0
    assert 99 in eng.workers
    assert any(ln.strip().startswith("mean spans: materialise ") and "capture " in ln
               and "generate " in ln for ln in lines)


def test_serve_cluster_real_models_has_no_silent_cpu_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("serve_cluster_torch").serve_real_batched(True)


# ------------------------------------------------------- training examples
def test_pull_training_prints_the_reference_output():
    got, _ = _printed(_load("pull_training_torch").main)
    want, _ = _printed(_load("pull_training").main)
    assert got == want and len(got.splitlines()) == 10


def test_train_wsd_resumes_on_a_fresh_mesh_on_the_cpu(tmp_path):
    """``examples/train_wsd_torch.py`` at 60 steps on the CPU: it checkpoints,
    resumes from step 30 on a fresh host mesh and the loss falls."""
    text, loss = _printed(_load("train_wsd_torch").main, 60, device="cpu", ckpt_dir=str(tmp_path))
    lines = text.splitlines()
    assert "   resumed from step 30" in lines
    first = float(lines[2].split("loss=")[1].split()[0])
    assert loss < first
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000000", "step_00000030"]


def test_train_wsd_has_no_silent_cpu_fallback(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("train_wsd_torch").main(2)
