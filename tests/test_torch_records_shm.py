"""The shared-memory columnar transport under the port's process backend: the
cases of ``tests/test_records_shm.py`` on the port's ``core.records`` and
``core.shard``.  Segment names carry the port's own prefix
(``repro_torch-shm-``, not the JAX package's), and the leak checks count the
segments this process named, so test processes running side by side never
see each other's live segments.  Plus parity: a process-backend run over the
shared-memory transport gives the JAX package's merged run.
"""

import os

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core.records import (
    REC_DTYPE,
    RecordColumns,
    read_columns_shm,
    shm_layout,
    unlink_columns_shm,
    write_columns_shm,
)
from repro_torch.core.shard import SHM_PREFIX, ShardedSimulator
from repro.core import shard as ref_shard
from test_torch_cluster_cases import same

pytestmark = pytest.mark.shard

_SHM_DIR = "/dev/shm"


def _segments():
    """Live segment names carrying the port's transport prefix that this
    process named: its drivers' (``<prefix><pid>-``) and its tests'
    (``<prefix>test-<pid>-``)."""
    if not os.path.isdir(_SHM_DIR):  # non-POSIX-shm platform
        return set()
    mine = (f"{SHM_PREFIX}{os.getpid()}-", f"{SHM_PREFIX}test-{os.getpid()}-")
    return {f for f in os.listdir(_SHM_DIR) if f.startswith(mine)}


def _sample_columns():
    """A small stream with every column exercised, including migrated rows."""
    return RecordColumns(
        t_submit=[0.125, 0.25, 1.5, 2.75],
        t_done=[0.5, 1.0, 2.0, 3.5],
        func=[0, 3, 1, 2],
        worker=[2, 0, 1, 3],
        cold=[True, False, False, True],
        vu=[0, 1, 2, 1],
        migrated=[False, True, False, True],
    )


def test_shm_layout_is_aligned_and_exact():
    at_off, aw_off, total = shm_layout(n_rec=3, n_asg=5)
    assert at_off % 8 == 0 and aw_off % 8 == 0
    assert at_off >= 3 * REC_DTYPE.itemsize  # rows fit before the pad
    assert aw_off == at_off + 5 * 8
    assert total == aw_off + 5 * 8
    assert shm_layout(0, 0) == (0, 0, 0)  # nothing to ship -> no segment


def test_round_trip_preserves_structured_view_and_migrated(tmp_path):
    from multiprocessing import shared_memory

    cols = _sample_columns()
    at = np.array([0.1, 0.2, 0.3])
    aw = np.array([2, 0, 1], np.int64)
    name = f"{SHM_PREFIX}test-{os.getpid()}-rt"
    try:
        assert write_columns_shm(name, cols, at, aw) == name
        # the row section *is* the packed structured layout, byte for byte
        shm = shared_memory.SharedMemory(name=name)
        try:
            view = np.ndarray(len(cols), dtype=REC_DTYPE, buffer=shm.buf)
            np.testing.assert_array_equal(np.array(view), cols.as_structured())
        finally:
            del view
            shm.close()
        out, at2, aw2 = read_columns_shm(name, len(cols), len(at))
        assert out.equals(cols)
        np.testing.assert_array_equal(out.migrated, cols.migrated)
        np.testing.assert_array_equal(at2, at)
        np.testing.assert_array_equal(aw2, aw)
        # the copies own their memory: still valid after the segment is gone
        unlink_columns_shm(name)
        assert out.migrated.tolist() == [False, True, False, True]
        assert aw2.sum() == 3
    finally:
        unlink_columns_shm(name)
    assert name not in _segments()


def test_zero_row_shard_creates_no_segment():
    name = f"{SHM_PREFIX}test-{os.getpid()}-empty"
    assert write_columns_shm(name, RecordColumns.empty(), [], []) is None
    assert name not in _segments()
    # reading the degenerate shape needs no segment either
    unlink_columns_shm(name)  # idempotent on a never-created name
    unlink_columns_shm(None)  # and on the no-segment sentinel


def test_unlink_is_idempotent():
    name = f"{SHM_PREFIX}test-{os.getpid()}-idem"
    write_columns_shm(name, _sample_columns(), [0.5], [1])
    unlink_columns_shm(name)
    unlink_columns_shm(name)  # second pass: already gone, not an error
    assert name not in _segments()


def test_unlink_raced_between_attach_and_unlink_stays_tracker_balanced(
    monkeypatch,
):
    """The double-unlink race: a concurrent cleanup wins between our attach
    and our ``unlink()``.  The failed unlink must not raise — and it must
    still unregister the attach-time ``resource_tracker`` registration
    (attaching registers on Python <= 3.12): left unbalanced, the tracker
    re-unlinks the *name* at interpreter exit, clobbering any later segment
    that reused it."""
    from multiprocessing import shared_memory

    from repro_torch.core import records as records_mod

    name = f"{SHM_PREFIX}test-{os.getpid()}-race"
    write_columns_shm(name, _sample_columns(), [0.5], [1])
    untracked = []
    real_untrack = records_mod._untrack_shm
    monkeypatch.setattr(
        records_mod, "_untrack_shm",
        lambda shm: (untracked.append(shm._name), real_untrack(shm))[-1],
    )

    class _RacedShm(shared_memory.SharedMemory):
        def unlink(self):
            super().unlink()  # the racing winner removes the segment...
            raise FileNotFoundError(self._name)  # ...and we observe the loss

    monkeypatch.setattr(shared_memory, "SharedMemory", _RacedShm)
    unlink_columns_shm(name)  # must swallow the race AND untrack
    assert [n.lstrip("/") for n in untracked] == [name]
    assert name not in _segments()
    unlink_columns_shm(name)  # and stays idempotent afterwards


def _crash_after_write(spec):
    """Stand-in pool entry simulating a writer that dies after creating its
    segment but before shipping the metadata back (the orphan hazard)."""
    from repro_torch.core.records import write_columns_shm as _write

    cols = RecordColumns([0.0], [1.0], [0], [0], [False], [0])
    _write(spec.shm_name, cols, np.zeros(1), np.zeros(1, np.int64))
    raise RuntimeError("writer crashed before shipping metadata")


def test_writer_crash_before_merge_leaves_no_orphans(monkeypatch):
    """The driver names every segment up front and unlinks them all in its
    ``finally`` — a child crash between segment creation and metadata
    shipment must not orphan anything in /dev/shm."""
    from repro_torch.core import shard as shard_mod

    monkeypatch.setattr(shard_mod, "_run_shard_shipped", _crash_after_write)
    before = _segments()
    driver = ShardedSimulator(2, 4, scheduler="hiku", seed=0, backend="process")
    with pytest.raises(RuntimeError, match="writer crashed"):
        driver.run(n_vus=4, duration_s=2.0)
    assert _segments() - before == set()


# ----------------------------------------------- parity with the JAX package
def test_prefix_is_the_ports_own():
    assert SHM_PREFIX == "repro_torch-shm-"
    assert not SHM_PREFIX.startswith(ref_shard.SHM_PREFIX)
    assert not ref_shard.SHM_PREFIX.startswith(SHM_PREFIX)


@pytest.mark.parametrize("seed", [1, 2])
def test_process_run_over_shm_equals_the_reference(seed):
    before = _segments()
    merged = same(lambda core: core.ShardedSimulator(3, 9, scheduler="hiku", seed=seed,
                                                     backend="process").run(15, 10.0))
    assert len(merged.records) > 0
    assert _segments() - before == set()
