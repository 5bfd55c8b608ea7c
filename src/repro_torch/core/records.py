"""Columnar request-record store (the scale-out substrate of the sharded driver).

A copy of the JAX package's ``core/records.py`` (pure numpy), the
shared-memory transport included; the port keeps its own so that it
imports nothing from ``repro``.

The simulator historically accumulated one ``RequestRecord`` NamedTuple per
completed request and one ``(t, worker)`` tuple per assignment — fine for the
paper's 5-worker protocol, hostile to production-scale runs: per-record
Python objects dominate memory at millions of requests, every metric pays a
Python-loop extraction, and shipping shard results between processes pickles
object graphs instead of buffers.

This module stores the same stream as seven parallel columns::

    t_submit  float64   submission time (s)
    t_done    float64   completion time incl. scheduler overhead (s)
    func      int32     function index
    worker    int32     worker id (shard-local until merged)
    cold      bool      cold-start flag
    vu        int32     virtual-user id (shard-local until merged)
    migrated  bool      completed on a shard other than the binding one
                        (cross-shard work stealing; always False without it)

Contracts:

* **Byte fidelity** — conversion ``records <-> columns`` is lossless:
  float64 columns hold the exact same doubles the NamedTuples carried, so
  the frozen-seed-engine equivalence suite keeps byte-for-byte guarantees
  through the columnar path (tests/test_records*.py pin the round-trip).
* **Order preservation** — columns keep the engine's completion order;
  ``concat``/``take`` are the only reordering primitives and both are
  explicit.
* **Zero-copy views** — ``as_structured`` reinterprets nothing; it copies
  once into a packed structured array for storage/IPC, and ``columns`` of a
  ``RecordColumns`` are the live numpy arrays (no per-access copies).

``RecordAccumulator`` is the growable form the simulator appends into
(plain Python lists per column — the cheapest exact append available to the
interpreter), snapshotting to ``RecordColumns`` on demand.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Union

import numpy as np


class RequestRecord(NamedTuple):
    """One completed request (the legacy row API, kept as the adapter).

    ``migrated`` defaults to False so 6-field legacy rows (the frozen seed
    engine's NamedTuples, pre-stealing pickles) adapt losslessly."""

    t_submit: float
    t_complete: float
    func: int
    worker: int
    cold: bool
    vu: int
    migrated: bool = False

    @property
    def latency_ms(self) -> float:
        return (self.t_complete - self.t_submit) * 1e3


#: packed on-disk / IPC layout of one record row
REC_DTYPE = np.dtype(
    [
        ("t_submit", "<f8"),
        ("t_done", "<f8"),
        ("func", "<i4"),
        ("worker", "<i4"),
        ("cold", "?"),
        ("vu", "<i4"),
        ("migrated", "?"),
    ]
)

_FIELDS = ("t_submit", "t_done", "func", "worker", "cold", "vu", "migrated")
_COL_DTYPES = (np.float64, np.float64, np.int32, np.int32, np.bool_, np.int32, np.bool_)


class RecordColumns:
    """Seven parallel numpy columns over a request-record stream.

    Column units: times in seconds (float64 — the exact doubles the engine
    produced; byte-fidelity contract), memory-free ids as int32, ``cold``/
    ``migrated`` as bool.  Completion order is preserved; only ``concat``/
    ``take`` (and the searchsorted-based ``window`` view) reorder,
    explicitly.  Worker and VU ids are shard-local until remapped
    (``remap``/``remap_vus``).  ``migrated`` defaults to all-False so
    6-column call sites (pre-work-stealing streams) stay valid."""

    __slots__ = _FIELDS

    def __init__(self, t_submit, t_done, func, worker, cold, vu, migrated=None):
        self.t_submit = np.asarray(t_submit, np.float64)
        self.t_done = np.asarray(t_done, np.float64)
        self.func = np.asarray(func, np.int32)
        self.worker = np.asarray(worker, np.int32)
        self.cold = np.asarray(cold, np.bool_)
        self.vu = np.asarray(vu, np.int32)
        n = self.t_submit.shape[0]
        self.migrated = (
            np.zeros(n, np.bool_) if migrated is None else np.asarray(migrated, np.bool_)
        )
        for name in _FIELDS[1:]:
            if getattr(self, name).shape != (n,):
                raise ValueError(f"column {name!r} length != {n}")

    # ------------------------------------------------------------ conversion
    @classmethod
    def from_records(
        cls, records: Union["RecordColumns", Sequence[RequestRecord]]
    ) -> "RecordColumns":
        """Adapter: list-of-``RequestRecord`` (or any row 6-tuples) -> columns."""
        if isinstance(records, RecordColumns):
            return records
        if not len(records):
            return cls.empty()
        return cls(*zip(*records))

    def to_records(self) -> List[RequestRecord]:
        """Columns -> list of ``RequestRecord`` with native Python scalars.

        ``ndarray.tolist`` yields the exact doubles/ints/bools stored, so the
        round-trip is bit-lossless.
        """
        return [
            RequestRecord(*row)
            for row in zip(
                self.t_submit.tolist(),
                self.t_done.tolist(),
                self.func.tolist(),
                self.worker.tolist(),
                self.cold.tolist(),
                self.vu.tolist(),
                self.migrated.tolist(),
            )
        ]

    @classmethod
    def empty(cls) -> "RecordColumns":
        return cls((), (), (), (), (), ())

    def as_structured(self) -> np.ndarray:
        """Packed structured array (``REC_DTYPE``) — one buffer for IPC/disk."""
        out = np.empty(len(self), REC_DTYPE)
        for name in _FIELDS:
            out[name] = getattr(self, name)
        return out

    @classmethod
    def from_structured(cls, arr: np.ndarray) -> "RecordColumns":
        """Unpack a structured array, matching fields by name.

        Only ``migrated`` may be absent (pre-work-stealing captures default
        it to False); any other missing field is data corruption and raises.
        """
        names = arr.dtype.names or ()
        missing = [n for n in _FIELDS[:6] if n not in names]
        if missing:
            raise ValueError(f"structured record array lacks fields {missing}")
        return cls(
            *(
                arr[name] if name in names else np.zeros(len(arr), dt)
                for name, dt in zip(_FIELDS, _COL_DTYPES)
            )
        )

    # -------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return self.t_submit.shape[0]

    def __iter__(self) -> Iterator[RequestRecord]:
        return iter(self.to_records())

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return RequestRecord(
                float(self.t_submit[i]),
                float(self.t_done[i]),
                int(self.func[i]),
                int(self.worker[i]),
                bool(self.cold[i]),
                int(self.vu[i]),
                bool(self.migrated[i]),
            )
        return RecordColumns(*(getattr(self, name)[i] for name in _FIELDS))

    def equals(self, other: "RecordColumns") -> bool:
        return len(self) == len(other) and all(
            np.array_equal(getattr(self, name), getattr(other, name)) for name in _FIELDS
        )

    # --------------------------------------------------------------- derived
    @property
    def latency_ms(self) -> np.ndarray:
        """Vectorized ``RequestRecord.latency_ms``: identical doubles."""
        return (self.t_done - self.t_submit) * 1e3

    # ---------------------------------------------------------------- reshaping
    @staticmethod
    def concat(parts: Sequence["RecordColumns"]) -> "RecordColumns":
        parts = [p for p in parts if len(p)]
        if not parts:
            return RecordColumns.empty()
        return RecordColumns(
            *(np.concatenate([getattr(p, name) for p in parts]) for name in _FIELDS)
        )

    def take(self, idx: np.ndarray) -> "RecordColumns":
        return RecordColumns(*(getattr(self, name)[idx] for name in _FIELDS))

    def remap(self, worker_offset: int = 0, vu_offset: int = 0) -> "RecordColumns":
        """Shift shard-local worker/VU ids into a global id range (merge step)."""
        if not worker_offset and not vu_offset:
            return self
        return RecordColumns(
            self.t_submit,
            self.t_done,
            self.func,
            self.worker + np.int32(worker_offset),
            self.cold,
            self.vu + np.int32(vu_offset),
            self.migrated,
        )

    def remap_vus(self, vu_map: np.ndarray) -> "RecordColumns":
        """Translate local VU ids through an explicit id table (``vu_map[local]
        -> global``) — the merge step for dynamically admitted VUs, where
        local ids are admission-order positions rather than a contiguous
        offset range."""
        vu_map = np.asarray(vu_map, np.int32)
        return RecordColumns(
            self.t_submit, self.t_done, self.func, self.worker, self.cold,
            vu_map[self.vu], self.migrated,
        )

    def window(self, t_lo: float, t_hi: float) -> "RecordColumns":
        """Records completing in the half-open-from-above window
        ``t_lo < t_done <= t_hi``.

        Requires the stream to be sorted by ``t_done`` (engine completion
        order and merged-run order both are); the slice is then two binary
        searches, so windowed metrics over a merged run pay O(log n) per
        window instead of a mask per call.  Pass ``t_lo=-inf`` for the first
        window of a stream (includes records completing exactly at the
        stream start)."""
        lo = int(np.searchsorted(self.t_done, t_lo, side="right"))
        hi = int(np.searchsorted(self.t_done, t_hi, side="right"))
        return self[lo:hi]


class RecordAccumulator:
    """Growable columnar accumulator the simulator hot loop appends into.

    Per-column Python lists: a list append is the cheapest exact way to grow
    from the interpreter, and the values stored are the *same* Python floats
    /bools the legacy NamedTuple stream carried, so ``to_records`` is exact
    by construction (no float round-trip at all on the list path).
    """

    __slots__ = ("t_submit", "t_done", "func", "worker", "cold", "vu", "migrated")

    def __init__(self):
        self.t_submit: List[float] = []
        self.t_done: List[float] = []
        self.func: List[int] = []
        self.worker: List[int] = []
        self.cold: List[bool] = []
        self.vu: List[int] = []
        self.migrated: List[bool] = []

    def append(self, t_submit, t_done, func, worker, cold, vu, migrated=False) -> None:
        self.t_submit.append(t_submit)
        self.t_done.append(t_done)
        self.func.append(func)
        self.worker.append(worker)
        self.cold.append(cold)
        self.vu.append(vu)
        self.migrated.append(migrated)

    def extend(self, cols: RecordColumns) -> None:
        """Append a columnar chunk (the streaming-merge consumer path).

        ``ndarray.tolist`` yields the exact stored doubles/ints/bools, so
        accumulating stream chunks and snapshotting with :meth:`columns`
        reproduces the batch-merged stream byte-for-byte."""
        self.t_submit.extend(cols.t_submit.tolist())
        self.t_done.extend(cols.t_done.tolist())
        self.func.extend(cols.func.tolist())
        self.worker.extend(cols.worker.tolist())
        self.cold.extend(cols.cold.tolist())
        self.vu.extend(cols.vu.tolist())
        self.migrated.extend(cols.migrated.tolist())

    def __len__(self) -> int:
        return len(self.t_submit)

    def columns(self) -> RecordColumns:
        return RecordColumns(
            self.t_submit, self.t_done, self.func, self.worker, self.cold, self.vu,
            self.migrated,
        )

    def to_records(self) -> List[RequestRecord]:
        return [
            RequestRecord(*row)
            for row in zip(
                self.t_submit, self.t_done, self.func, self.worker, self.cold, self.vu,
                self.migrated,
            )
        ]

    def clear(self) -> None:
        for name in self.__slots__:
            getattr(self, name).clear()


# -------------------------------------------------- shared-memory transport
# One POSIX shared-memory segment per shard result: the packed REC_DTYPE
# record rows, then the float64 assignment times, then the int64 assignment
# worker ids (each section 8-byte aligned).  A shard child writes its columns
# straight into the segment and ships only the (name, row counts) metadata
# through the process pool; the parent reattaches and copies the columns out
# in one memcpy per section instead of pickling object graphs.
#
# Lifetime contract (docs/ARCHITECTURE.md §13; pinned by
# tests/test_records_shm.py and the leak check in tests/test_shard.py):
# segments are *explicitly* managed — both sides immediately detach the
# segment from Python's ``resource_tracker`` (whose exit-time cleanup is
# process-scoped and double-unlinks under fork pools) and the pool driver
# unlinks every segment it named in a ``finally``, so a writer crash before
# the merge leaves nothing behind in ``/dev/shm``.

def shm_layout(n_rec: int, n_asg: int) -> "tuple[int, int, int]":
    """``(assign_t offset, assign_w offset, total bytes)`` of a segment
    holding ``n_rec`` records and ``n_asg`` assignments.  Offsets are
    8-byte aligned so the float64/int64 views are aligned regardless of the
    packed record section's odd itemsize."""
    at_off = -(-(n_rec * REC_DTYPE.itemsize) // 8) * 8
    aw_off = at_off + 8 * n_asg
    return at_off, aw_off, aw_off + 8 * n_asg


def _untrack_shm(shm) -> None:
    """Detach a segment from ``resource_tracker`` exit-time cleanup: this
    module owns segment lifetime explicitly (create/attach both register on
    Python <= 3.12, so without this every attaching process unlinks the
    segment again at exit)."""
    from multiprocessing import resource_tracker

    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass  # tracker already gone (interpreter teardown) — nothing to undo


def write_columns_shm(
    name: str, records: RecordColumns, assign_t, assign_w
) -> "Union[str, None]":
    """Create segment ``name`` and fill it with one shard's columns.

    Writes each column directly into an aligned view over the segment (one
    memcpy per column, no intermediate structured array) and detaches the
    mapping before returning.  Returns ``name``, or ``None`` without
    creating anything when there are no rows at all (POSIX shm rejects
    zero-byte segments, and there is nothing to ship)."""
    from multiprocessing import shared_memory

    assign_t = np.asarray(assign_t, np.float64)
    assign_w = np.asarray(assign_w, np.int64)
    n_rec, n_asg = len(records), len(assign_t)
    if len(assign_w) != n_asg:
        raise ValueError("assign_t/assign_w length mismatch")
    at_off, aw_off, total = shm_layout(n_rec, n_asg)
    if total == 0:
        return None
    shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    try:
        _untrack_shm(shm)
        if n_rec:
            rows = np.ndarray(n_rec, dtype=REC_DTYPE, buffer=shm.buf)
            for field in _FIELDS:
                rows[field] = getattr(records, field)
            del rows  # release the buffer export before close()
        if n_asg:
            np.ndarray(n_asg, np.float64, buffer=shm.buf, offset=at_off)[:] = assign_t
            np.ndarray(n_asg, np.int64, buffer=shm.buf, offset=aw_off)[:] = assign_w
    finally:
        shm.close()
    return name


def read_columns_shm(
    name: str, n_rec: int, n_asg: int
) -> "tuple[RecordColumns, np.ndarray, np.ndarray]":
    """Attach segment ``name``, copy its columns out, and detach.

    The returned arrays own their memory (one memcpy per section), so the
    caller may unlink the segment immediately.  Row counts travel out of
    band (the shipment metadata) — the segment itself is headerless."""
    from multiprocessing import shared_memory

    at_off, aw_off, _total = shm_layout(n_rec, n_asg)
    shm = shared_memory.SharedMemory(name=name)
    try:
        _untrack_shm(shm)
        if n_rec:
            rows = np.empty(n_rec, REC_DTYPE)
            rows[:] = np.ndarray(n_rec, dtype=REC_DTYPE, buffer=shm.buf)
            cols = RecordColumns.from_structured(rows)
        else:
            cols = RecordColumns.empty()
        if n_asg:
            at = np.array(np.ndarray(n_asg, np.float64, buffer=shm.buf, offset=at_off))
            aw = np.array(np.ndarray(n_asg, np.int64, buffer=shm.buf, offset=aw_off))
        else:
            at, aw = np.zeros(0, np.float64), np.zeros(0, np.int64)
        return cols, at, aw
    finally:
        shm.close()


def unlink_columns_shm(name: "Union[str, None]") -> None:
    """Remove segment ``name`` if it exists (idempotent crash-safe cleanup:
    attach, detach from the tracker, unlink; a missing segment — never
    created, or already unlinked — is not an error)."""
    from multiprocessing import shared_memory

    if name is None:
        return
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    try:
        # no _untrack_shm on success: unlink() itself unregisters the name,
        # which balances the register the attach above performed
        shm.unlink()
    except FileNotFoundError:
        # raced with another cleanup (writer-crash salvage vs the parent's
        # finally-unlink): the segment is already gone, but the failed
        # unlink never unregistered the attach — balance it explicitly or
        # resource_tracker re-unlinks the *name* at exit, clobbering any
        # later segment that reused it
        _untrack_shm(shm)
    finally:
        shm.close()
