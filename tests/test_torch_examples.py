"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``: the
simulated §V table printed byte for byte the same, and the real-model part
on the CPU's plain path."""

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

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
