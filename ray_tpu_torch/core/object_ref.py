"""ObjectRef: a future-like handle to an object in the cluster.

Mirrors the reference's `python/ray/includes/object_ref.pxi` ObjectRef:
hashable, comparable, awaitable via `get()`, and pickling one registers a
borrow with the serialization context so the ownership layer can track
nested/borrowed references (reference `reference_count.h:220`).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import ObjectID


class ObjectRef:
    # _counted: this instance holds one unit of the distributed refcount and
    # releases it on GC (reference RemoveLocalReference). Only instances
    # created through a counting path (task returns, put, deserialization)
    # set it; ad-hoc internal ObjectRef(...) constructions never release.
    __slots__ = ("id", "owner_address", "_call_site", "_counted")

    def __init__(self, object_id: ObjectID, owner_address: Optional[str] = None, call_site: str = ""):
        self.id = object_id
        self.owner_address = owner_address
        self._call_site = call_site
        self._counted = False

    def __del__(self):
        if not getattr(self, "_counted", False):
            return
        try:
            from ray_tpu_torch.core import worker as _worker_mod

            w = _worker_mod.current_worker()
            if w is not None and not w._shutdown.is_set():
                w.reference_counter.remove_local(self)
        except Exception:
            pass  # interpreter teardown

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self):
        return self.id.task_id()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __reduce__(self):
        # Record the borrow (no-op outside an active serialize()).
        from ray_tpu_torch.core import serialization

        serialization.record_contained_ref(self)
        return (_rebuild_ref, (self.id, self.owner_address, self._call_site))

    def future(self):
        """Return a concurrent.futures.Future resolving to the object value."""
        from ray_tpu_torch.core.api import _global_worker
        return _global_worker().get_async(self)


class ObjectRefGenerator:
    """Iterator over the ObjectRefs streamed out of a num_returns="dynamic"
    task (reference ObjectRefGenerator, _raylet.pyx:178,997).

    On the task's OWNER it streams: each __next__ blocks until the executor
    reports the next yielded object (or the task finishes/fails), so items
    are consumable while the task still runs. Serialized (e.g. nested in a
    return value or fetched by a borrower) it carries the final ref list —
    borrowers iterate the completed sequence."""

    def __init__(self, refs=None, task_id=None, done: bool = True):
        self._refs = list(refs or [])
        self._task_id = task_id
        self._done = done
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        if self._done:
            if self._i >= len(self._refs):
                raise StopIteration
            r = self._refs[self._i]
            self._i += 1
            return r
        from ray_tpu_torch.core import worker as _worker_mod

        w = _worker_mod.current_worker()
        ref, done, err = w.next_dynamic_return(self._task_id, self._i)
        if ref is not None:
            self._refs.append(ref)
            self._i += 1
            return ref
        self._done = True
        if err is not None:
            raise err
        raise StopIteration

    def __len__(self):
        if not self._done:
            raise TypeError("streaming generator has no length until consumed")
        return len(self._refs)

    def completed_refs(self):
        """Refs yielded so far (all of them once done)."""
        return list(self._refs)

    def __reduce__(self):
        if not self._done:
            raise TypeError(
                "a streaming ObjectRefGenerator can only be serialized "
                "after the task completes; iterate it (or pass individual "
                "item refs) instead")
        # pickling the refs records the contained-ref borrows (ObjectRef
        # __reduce__), so a generator nested in a stored object keeps its
        # items alive for the container's lifetime
        return (_rebuild_generator, (list(self._refs),))


def _rebuild_generator(refs):
    return ObjectRefGenerator(refs, done=True)


def _rebuild_ref(object_id, owner_address, call_site):
    ref = ObjectRef(object_id, owner_address, call_site)
    # Register the materialized instance with the ownership layer: borrowed
    # (+notify owner) off-owner, a plain local ref on the owner. Either way
    # this instance now holds one refcount unit and releases it on GC.
    from ray_tpu_torch.core import worker as _worker_mod

    w = _worker_mod.current_worker()
    if w is not None:
        if owner_address and owner_address == w.address:
            w.add_local_ref(object_id)
        else:
            w.reference_counter.add_borrowed(ref)
        ref._counted = True
    return ref
