"""The port's serving launcher against the JAX one, in process, with the
same arguments: the same routing decisions line by line (function, worker,
COLD/warm), the same failure/join line and the same cold rate.  Latencies
differ and are not compared."""

import re

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

REQ = re.compile(r"^\s+\[(\d{3})\] (\S+)\s+-> w(\d+) (COLD|warm) ")


def _run(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.splitlines()
    reqs = [REQ.match(ln).groups() for ln in lines if REQ.match(ln)]
    fails = [ln.strip() for ln in lines if ln.strip().startswith("!!")]
    cold = re.search(r"cold_rate=(\d+)%", lines[-1]).group(1)
    return reqs, fails, cold


@pytest.mark.parametrize("extra", [["--fail-at", "2"], [], ["--scheduler", "least_connections",
                                                             "--workers", "3", "--fail-at", "4"]],
                         ids=["fail-at-2", "no-failure", "least-connections"])
def test_launcher_routes_like_jax(extra, capsys):
    argv = ["--workers", "2", "--endpoints", "2", "--requests", "5", *extra]
    want = _run(jax_serve.main, argv, capsys)
    got = _run(serve.main, [*argv, "--device", "cpu"], capsys)
    assert len(got[0]) == 5
    assert got == want
    assert bool(got[1]) == ("--fail-at" in extra)


def test_launcher_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
