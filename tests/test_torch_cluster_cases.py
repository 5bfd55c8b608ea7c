"""Shared parity helpers for the port's multi-cluster tier (no tests of the
tier itself live here; the other ``test_torch_*`` files import these).

``canon`` turns whatever a driver returns — ``MergedRun``, ``AdmissionRun``,
``RunMetrics``, estimator snapshots, event-plane logs, autoscaler decisions —
into plain, comparable Python: dataclasses by field name, numpy arrays by
dtype, shape and bytes, floats by their hex form (so NaN equals NaN and -0.0
differs from 0.0).  Wall-clock fields (``wall_s``) differ between any two
runs and are dropped; every other field is compared.

``same(build)`` runs ``build(core)`` once with the JAX package's ``repro.core``
and once with the port's ``repro_torch.core`` and asserts the two canonical
forms are equal.
"""

import dataclasses
from collections.abc import Mapping

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

import repro.core as REF
import repro_torch.core as PORT

#: fields that hold wall-clock time: they differ between any two runs
WALL_FIELDS = frozenset({"wall_s"})

_RECORD_COLUMNS = ("t_submit", "t_done", "func", "worker", "cold", "vu", "migrated")


def canon(obj, ignore=WALL_FIELDS):
    """A plain, exactly comparable form of ``obj`` (see the module doc)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return ("f", obj.hex())
    if isinstance(obj, np.ndarray):
        return ("nd", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, np.generic):
        return ("np", obj.dtype.str, obj.tobytes())
    if type(obj).__name__ == "RecordColumns":
        return ("RecordColumns",) + tuple(
            canon(getattr(obj, name), ignore) for name in _RECORD_COLUMNS
        )
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, canon(getattr(obj, f.name), ignore))
            for f in dataclasses.fields(obj)
            if f.name not in ignore
        )
    if isinstance(obj, Mapping):
        return ("map",) + tuple(
            sorted(((canon(k, ignore), canon(v, ignore)) for k, v in obj.items()), key=repr)
        )
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = [canon(v, ignore) for v in obj]
        if isinstance(obj, (set, frozenset)):
            items.sort(key=repr)
        return ("seq",) + tuple(items)
    raise TypeError(f"canon: no rule for {type(obj).__name__}")


def same(build, ignore=WALL_FIELDS):
    """Run ``build(core)`` on the reference package and on the port and assert
    equal canonical forms; returns the port's result."""
    want = build(REF)
    got = build(PORT)
    assert canon(got, ignore) == canon(want, ignore)
    return got


# ----------------------------------------------------------- the helpers' own
def test_canon_drops_wall_clock_and_keeps_the_rest():
    def run():
        driver = PORT.ShardedSimulator(2, 4, scheduler="hiku", seed=0, backend="serial")
        return driver.run(n_vus=6, duration_s=3.0)

    r1, r2 = run(), run()
    r2.wall_s = r1.wall_s + 1.0  # the makespan and each shard's wall are not compared
    r2.shards[0].wall_s = r1.shards[0].wall_s + 1.0
    assert canon(r1) == canon(r2)
    r2.records.cold[0] = not r2.records.cold[0]
    assert canon(r1) != canon(r2)


@pytest.mark.parametrize(
    "a, b",
    [
        (float("nan"), float("nan")),
        (np.arange(3, dtype=np.int64), np.arange(3, dtype=np.int64)),
        ({"x": 1.5, "y": [1, 2]}, {"y": [1, 2], "x": 1.5}),
    ],
)
def test_canon_equal_cases(a, b):
    assert canon(a) == canon(b)


@pytest.mark.parametrize(
    "a, b",
    [
        (0.0, -0.0),
        (np.arange(3, dtype=np.int64), np.arange(3, dtype=np.int32)),
        (np.zeros(2), np.zeros(3)),
    ],
)
def test_canon_unequal_cases(a, b):
    assert canon(a) != canon(b)
