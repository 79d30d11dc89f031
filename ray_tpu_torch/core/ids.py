"""Unique identifiers for jobs, tasks, objects, actors, nodes and workers.

Equivalent role to the reference's `src/ray/common/id.h` (JobID/TaskID/
ObjectID/ActorID/NodeID byte-string ids with embedded structure). We keep the
same structural idea — ObjectIDs embed the creating TaskID plus a return/put
index so ownership and lineage can be derived from the id itself — but the
representation is a plain bytes-backed value type; there is no need for the
reference's C++ bit-packing.
"""

from __future__ import annotations

import os
import threading

_UNIQUE_LEN = 16  # bytes of entropy for "root" ids


class BaseID:
    """A bytes-backed, hashable, comparable unique id."""

    __slots__ = ("_bytes",)
    _NIL: "BaseID | None" = None

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes):
            raise TypeError(f"{type(self).__name__} requires bytes, got {type(id_bytes)}")
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_UNIQUE_LEN))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _UNIQUE_LEN)

    def is_nil(self) -> bool:
        return all(b == 0 for b in self._bytes)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    __slots__ = ()


class NodeID(BaseID):
    __slots__ = ()


class WorkerID(BaseID):
    __slots__ = ()


class ActorID(BaseID):
    __slots__ = ()


class PlacementGroupID(BaseID):
    __slots__ = ()


class TaskID(BaseID):
    __slots__ = ()


class FunctionID(BaseID):
    """Content hash of an exported function/class pickle (reference
    `python/ray/_private/function_manager.py` function ids): the same blob
    always maps to the same id, so the export-once function table is
    content-addressed — re-decorating an identical function dedupes to one
    GCS entry."""

    __slots__ = ()

    @classmethod
    def for_blob(cls, blob: bytes) -> "FunctionID":
        import hashlib

        return cls(hashlib.blake2b(blob, digest_size=_UNIQUE_LEN).digest())


class ObjectID(BaseID):
    """ObjectID = TaskID bytes + 4-byte big-endian index.

    Index semantics (cf. reference ObjectID::ForTaskReturn / FromIndex):
      - return values of a task use indices 1..n
      - `put` objects use indices starting at PUT_INDEX_BASE
    """

    __slots__ = ()
    PUT_INDEX_BASE = 1 << 24
    DYNAMIC_INDEX_BASE = 1 << 16  # dynamic (generator) returns, < PUT base

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls.for_task_return(task_id, cls.PUT_INDEX_BASE + put_index)

    @classmethod
    def for_dynamic_return(cls, task_id: TaskID, item_index: int) -> "ObjectID":
        """Id of the item_index-th object streamed out of a generator task
        (num_returns='dynamic'). Deterministic in (task, index) so a
        re-executed generator regenerates the SAME ids — lineage
        reconstruction of dynamically-created objects falls out for free
        (cf. reference ObjectID::FromIndex use in _raylet.pyx:997)."""
        return cls.for_task_return(task_id, cls.DYNAMIC_INDEX_BASE + item_index)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:-4])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[-4:], "big")


class _TaskIDCounter:
    """Per-worker deterministic task id generation: parent task id + counter.

    Mirrors the reference's TaskID::ForNormalTask(job, parent, counter) so ids
    are reproducible for lineage reconstruction.
    """

    def __init__(self, worker_id: WorkerID):
        self._worker_id = worker_id
        self._count = 0
        self._lock = threading.Lock()

    def next_task_id(self) -> TaskID:
        with self._lock:
            self._count += 1
            c = self._count
        # Derive from worker id + counter; hash to fixed width.
        import hashlib

        h = hashlib.blake2b(
            self._worker_id.binary() + c.to_bytes(8, "big"), digest_size=_UNIQUE_LEN
        )
        return TaskID(h.digest())
