"""Per-node shared-memory object store + per-process in-memory store.

Equivalent role to the reference's plasma store
(`src/ray/object_manager/plasma/store.h:55`): immutable objects in shared
memory, one store per node, zero-copy reads from any worker process on that
node, LRU eviction and disk spilling when over budget
(cf. `ray_config_def.h:557-599`).

Redesign rationale (deliberate, documented per SURVEY §2.1): instead of one
mmap'd dlmalloc arena with fd passing over a unix socket (`plasma/fling.cc`),
each object is a named POSIX shared-memory segment (a /dev/shm tmpfs file,
see `ShmSegment`), created by whichever process produces the object and
attached by name from any process on the node. The kernel plays
the role of the arena allocator; eviction/spilling policy stays in the store
daemon. This removes an entire custom allocator + fd-passing protocol while
keeping the zero-copy property that matters on TPU hosts: a worker maps the
segment and hands `jax.device_put` a numpy view with no host-side copy.

Two tiers, matching reference semantics (SURVEY appendix C):
  - objects <= max_direct_call_object_size (100 KiB) travel inline in RPC
    replies into the owner's in-process object table (worker.py) — no shm
    round-trip;
  - larger objects land in the node `SharedObjectStore`, and only their
    location travels on the wire.
"""

from __future__ import annotations

import errno
import logging
import mmap
import os
import shutil
import struct
import threading
import time
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.exceptions import ObjectLostError, ObjectStoreFullError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import SerializedObject

logger = logging.getLogger(__name__)

_SHM_DIR = "/dev/shm"

# ---------------------------------------------------------------------------
# Spill envelope (storage failure domain): every spilled object is framed
#   magic(4) version(1) pad(3) payload_len(8) crc32(4) | payload
# written to a tmp name and committed with fsync + os.replace, so a spill
# file either exists complete-and-verifiable or not at all. _restore
# verifies magic, length AND checksum before attaching; any mismatch
# (torn write that raced a crash, bit rot, truncation, missing file) marks
# that copy LOST — a typed outcome that routes into lineage reconstruction
# instead of a raw buffer error (cf. reference local_object_manager.h spill
# IO workers + ObjectLostError semantics).

SPILL_MAGIC = b"RTSP"
SPILL_VERSION = 1
_SPILL_HDR = struct.Struct("<4sB3xQI")
SPILL_HEADER_SIZE = _SPILL_HDR.size


class SpillCorruptionError(ObjectLostError):
    """A spilled copy failed envelope verification (short read, bad magic,
    checksum mismatch, missing file). The copy is gone; whether the OBJECT
    is lost depends on lineage — callers route into reconstruction. Carries
    `reason` ("missing"/"torn"/"corrupt"/"io") for observability."""

    def __init__(self, message: str, reason: str = "corrupt"):
        super().__init__(message)
        self.reason = reason


def spill_pack_header(payload) -> bytes:
    mv = memoryview(payload)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return _SPILL_HDR.pack(SPILL_MAGIC, SPILL_VERSION, mv.nbytes,
                           zlib.crc32(mv) & 0xFFFFFFFF)


def spill_read_verified(path: str, expect_size: Optional[int] = None) -> bytes:
    """Read + verify a spill envelope; returns the payload. Raises
    SpillCorruptionError on ANY defect (typed reason attached)."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(SPILL_HEADER_SIZE)
            if len(hdr) < SPILL_HEADER_SIZE:
                raise SpillCorruptionError(
                    f"spill file {path}: short header "
                    f"({len(hdr)}/{SPILL_HEADER_SIZE} bytes)", reason="torn")
            magic, version, length, crc = _SPILL_HDR.unpack(hdr)
            if magic != SPILL_MAGIC or version != SPILL_VERSION:
                raise SpillCorruptionError(
                    f"spill file {path}: bad magic/version "
                    f"({magic!r} v{version})", reason="corrupt")
            if expect_size is not None and length != expect_size:
                raise SpillCorruptionError(
                    f"spill file {path}: envelope length {length} != "
                    f"expected {expect_size}", reason="corrupt")
            payload = f.read(length)
    except FileNotFoundError:
        raise SpillCorruptionError(
            f"spill file {path}: missing", reason="missing") from None
    except OSError as e:
        raise SpillCorruptionError(
            f"spill file {path}: read failed: {e}", reason="io") from e
    if len(payload) != length:
        raise SpillCorruptionError(
            f"spill file {path}: short payload ({len(payload)}/{length} "
            f"bytes)", reason="torn")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise SpillCorruptionError(
            f"spill file {path}: checksum mismatch", reason="corrupt")
    return payload


def _fs_fault(site: str) -> Optional[str]:
    """Seeded filesystem fault injection at named storage-IO sites
    (rpc.FaultInjector `fs:<site>:<mode>` rules). None when uninjected."""
    from ray_tpu_torch.core.rpc import fs_fault

    return fs_fault(site)


class _PrivateMapping(mmap.mmap):
    """A copy-on-write (MAP_PRIVATE) mapping of a segment: reads share the
    store's pages, a write lands in pages of the writer's own. The
    serializer lets a CPU torch tensor alias only such a mapping
    (`copy_on_write`), since torch has no read-only flag."""

    copy_on_write = True


class ShmSegment:
    """A named shared-memory segment backed by a /dev/shm file.

    We deliberately bypass `multiprocessing.shared_memory`: its per-process
    resource tracker assumes single-process ownership and unlinks (or
    complains about) segments owned by the store daemon. A plain tmpfs file
    + mmap gives identical performance with explicit lifetime control —
    the store daemon alone unlinks.
    """

    def __init__(self, name: str, size: int, create: bool = False,
                 readonly: bool = False, file_size: Optional[int] = None,
                 copy_on_write: bool = False):
        self.name = name
        self._copy_on_write = copy_on_write
        path = os.path.join(_SHM_DIR, name)
        if readonly or copy_on_write:
            fd = os.open(path, os.O_RDONLY)
        else:
            flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
            fd = os.open(path, flags, 0o600)
        try:
            if create:
                # file_size may exceed the mapped size: the store sizes
                # files to page-rounded buckets so the reuse pool can hand
                # a segment to any object in the same bucket
                os.ftruncate(fd, max(file_size or size, 1))
            if copy_on_write:
                self._mmap = _PrivateMapping(fd, max(size, 1),
                                             access=mmap.ACCESS_COPY)
            elif readonly:
                # PROT_READ mapping: every view (and every numpy array
                # reconstructed over one) is read-only — the aliasing
                # contract for zero-copy get()
                self._mmap = mmap.mmap(fd, max(size, 1),
                                       prot=mmap.PROT_READ)
            else:
                self._mmap = mmap.mmap(fd, max(size, 1))
        finally:
            os.close(fd)

    @property
    def buf(self) -> memoryview:
        view = memoryview(self._mmap)
        # a private mapping is writable, but its views are not: numpy
        # arrays over one stay read-only, as over a PROT_READ mapping
        return view.toreadonly() if self._copy_on_write else view

    def close(self) -> None:
        try:
            self._mmap.close()
        except (BufferError, ValueError):
            pass  # exported views still alive; kernel reclaims at unmap

    @staticmethod
    def unlink(name: str) -> None:
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
        except FileNotFoundError:
            pass


class SharedBuffer:
    """A zero-copy view of an object living in a shared-memory segment."""

    def __init__(self, shm: ShmSegment, size: int):
        self._shm = shm
        self.view = shm.buf[:size]
        self.name = shm.name
        self.size = size

    def close(self):
        try:
            self.view.release()
        except Exception:
            pass
        self._shm.close()


class ArenaBuffer:
    """A zero-copy view of an object living inside the C++ shared arena."""

    def __init__(self, view: memoryview, name: str, size: int):
        self.view = view
        self.name = name
        self.size = size

    @property
    def buf(self) -> memoryview:  # writer-side API parity with ShmSegment
        return self.view

    def close(self):
        try:
            self.view.release()
        except Exception:
            pass


@dataclass
class _Entry:
    name: str           # shm segment name, or "@<arena_path>:<offset>"
    size: int
    sealed: bool = False
    spilled_path: Optional[str] = None
    pinned: int = 0     # pin count (live zero-copy reader views)
    doomed: bool = False  # deleted while pinned: unlink deferred to last unpin
    arena_offset: Optional[int] = None
    created_at: float = field(default_factory=time.monotonic)


class SharedObjectStore:
    """Node-local store daemon state: segment registry + eviction + spill.

    Thread-safe; lives inside the raylet process. Producer workers create and
    write segments directly (zero-copy path) and then `seal()` them here;
    consumer workers `get()` the segment name and attach read-only.
    """

    def __init__(self, capacity: Optional[int] = None, spill_dir: Optional[str] = None):
        cfg = get_config()
        self.capacity = capacity or cfg.object_store_memory
        self.spill_dir = spill_dir or os.path.join(cfg.session_dir_root, "spill", str(os.getpid()))
        # disk-full degradation ladder: a spill write that fails with
        # ENOSPC/EIO retries down this dir list under backoff; when EVERY
        # dir fails the store goes spill-degraded (stops spilling, puts
        # flip to backpressure) and a periodic probe self-heals it
        self.spill_dirs: List[str] = [self.spill_dir] + [
            os.path.join(d, str(os.getpid()))
            for d in cfg.object_spill_dirs.split(":") if d.strip()]
        self._spill_degraded = False
        self._degraded_since = 0.0
        self._last_probe = 0.0
        self._entries: "OrderedDict[ObjectID, _Entry]" = OrderedDict()  # LRU order
        self._lock = threading.RLock()
        # waiters for admission headroom (bounded put backpressure):
        # notified whenever bytes are freed or the degraded state heals
        self._space = threading.Condition(self._lock)
        self._used = 0
        self._pinned_bytes = 0  # bytes of entries with >=1 reader pin
        # storage failure-domain counters (mirrored into stats() and the
        # ray_tpu_torch_object_* metrics): spilled/restored byte totals, spill
        # failures by reason, lost spilled copies, admission rejections,
        # pin-cap refusals, degraded transitions
        self.counters: Dict[str, Any] = {
            "spilled_bytes": 0, "restored_bytes": 0,
            "spill_failures": {}, "lost_spills": 0,
            "put_backpressure": 0, "pin_cap_refusals": 0,
            "degraded_enters": 0, "degraded_heals": 0,
        }
        try:
            from ray_tpu_torch.util import metrics as _m

            self._m_spilled = _m.get_or_create(
                "counter", "ray_tpu_torch_object_spilled_bytes_total",
                "Bytes spilled to disk (committed envelopes)")
            self._m_restored = _m.get_or_create(
                "counter", "ray_tpu_torch_object_restored_bytes_total",
                "Bytes restored from spill (verified envelopes)")
            self._m_spill_fail = _m.get_or_create(
                "counter", "ray_tpu_torch_object_spill_failures_total",
                "Spill/restore failures by reason",
                tag_keys=("reason",))
            self._m_pinned = _m.get_or_create(
                "gauge", "ray_tpu_torch_object_pinned_bytes",
                "Bytes held by reader pins (excluded from eviction)")
        except Exception:  # metrics are never load-bearing
            self._m_spilled = self._m_restored = None
            self._m_spill_fail = self._m_pinned = None
        # Segment-reuse pool: deleted (unpinned, unspilled) file segments
        # park here instead of unlinking, bucketed by their page-rounded
        # file size. Reusing a segment hands the writer ALREADY-FAULTED
        # tmpfs pages — a large put costs one memcpy into hot pages
        # (~4-5x the fresh-page path, which pays allocation + zeroing).
        # Safe against stale readers because consumers confirm a pin of
        # the ObjectID (and the segment name it maps to) before trusting
        # an attached view; a recycled inode fails that confirmation.
        self._pool: Dict[int, list] = {}   # file_size -> [names]
        self._pool_bytes = 0
        # never let idle pooled segments crowd out live objects: the pool
        # is capped at a quarter of the store even when the knob is larger
        self._pool_cap = min(cfg.object_segment_pool_bytes,
                             self.capacity // 4)
        # unique per store instance: several raylets (and their stores) can
        # share one process in in-process test clusters
        self._prefix = f"rtt-{os.getpid()}-{os.urandom(3).hex()}-"
        self._seq = 0
        # C++ arena for small objects: one mmap, sub-allocated (plasma's
        # dlmalloc-arena design); file-per-object remains the big-object path
        self.arena_threshold = 1 << 20  # 1 MiB
        self._arena = None
        try:
            from ray_tpu_torch.core.arena import Arena

            arena_cap = max(64 << 20, min(self.capacity // 4, 512 << 20))
            self._arena = Arena.create(
                os.path.join(_SHM_DIR, f"{self._prefix}arena"), arena_cap)
        except Exception:
            logger.debug("arena unavailable", exc_info=True)

    # ---- producer API ----------------------------------------------------
    @staticmethod
    def _bucket(size: int) -> int:
        return (max(size, 1) + 4095) & ~4095  # page-rounded file size

    def create(self, object_id: ObjectID, size: int,
               info: Optional[dict] = None) -> ShmSegment:
        """Allocate a segment for `object_id`; caller writes then seals.
        `info`, when given, is filled with {"recycled": bool} so the writer
        can pick its write strategy (mmap memcpy into hot recycled pages vs
        writev into a fresh file).

        Admission is honest: when eviction + spilling + pool drain cannot
        make `size` fit under capacity (every evictable entry is pinned or
        unsealed, or the store is spill-degraded), this raises typed
        ObjectStoreFullError instead of silently overcommitting `_used`
        past capacity. Callers bound their own wait (`put_full_timeout_s`)
        on headroom before surfacing it."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                if e.doomed and e.sealed:
                    # re-put of an object deleted while readers were still
                    # pinned (lineage re-execution): the immutable old copy
                    # IS the object — resurrect it instead of reallocating
                    e.doomed = False
                raise FileExistsError(f"object {object_id} already exists")
            self._maybe_evict(size)
            self._admit(size)
            if self._arena is not None and size <= self.arena_threshold:
                off = self._arena.alloc(size)
                if off is not None:
                    name = f"@{self._arena.path}:{off}"
                    self._entries[object_id] = _Entry(
                        name=name, size=size, arena_offset=off)
                    self._used += size
                    return ArenaBuffer(self._arena.view(off, size), name, size)
            shm, recycled = self._alloc_file_segment(size)
            if info is not None:
                info["recycled"] = recycled
            self._entries[object_id] = _Entry(name=shm.name, size=size)
            self._used += size
            return shm

    def _alloc_file_segment(self, size: int):
        """Caller holds _lock. Returns (ShmSegment, recycled)."""
        bucket = self._bucket(size)
        names = self._pool.get(bucket)
        while names:
            name = names.pop()
            self._pool_bytes -= bucket
            try:
                return ShmSegment(name, size), True
            except OSError:
                continue  # swept by an external cleaner; fall through
        shm = None
        for _ in range(1000):
            self._seq += 1
            name = f"{self._prefix}{self._seq}"
            try:
                shm = ShmSegment(name, size, create=True, file_size=bucket)
                break
            except FileExistsError:
                continue  # stale segment from a crashed prior run
        if shm is None:
            raise RuntimeError("could not allocate shm segment")
        return shm, False

    def seal(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                raise KeyError(f"object {object_id} not found")
            e.sealed = True
            self._entries.move_to_end(object_id)

    def put_bytes(self, object_id: ObjectID, data: bytes | memoryview,
                  timeout_s: float = 0.0) -> None:
        """Copy `data` in and seal. `timeout_s` > 0 waits bounded for
        eviction/unpin headroom before raising ObjectStoreFullError (the
        server-internal materialization paths: pulls, pushes)."""
        n = len(data) if isinstance(data, (bytes, bytearray)) else data.nbytes
        if timeout_s > 0:
            shm = self.create_blocking(object_id, n, timeout_s)
        else:
            shm = self.create(object_id, n)
        try:
            if shm.name.startswith("@"):
                shm.buf[:n] = data
            else:
                # fd write, not the mapping: populates tmpfs pages directly
                # instead of zero-faulting a fresh mapping first (and on a
                # recycled segment skips repopulating the page table)
                fd = os.open(os.path.join(_SHM_DIR, shm.name), os.O_WRONLY)
                try:
                    mv = memoryview(data)
                    if mv.format != "B" or mv.ndim != 1:
                        mv = mv.cast("B")
                    off = 0
                    while off < n:
                        off += os.write(fd, mv[off:])
                finally:
                    os.close(fd)
        finally:
            shm.close()
        self.seal(object_id)

    def adopt_local_copy(self, object_id: ObjectID, src_name: str,
                         size: int) -> bool:
        """Same-host 'transfer' fast path: both raylets share this host's
        /dev/shm, so materializing the object is a KERNEL-side file copy
        (copy_file_range, parallelized across ranges on multi-core hosts) —
        no sockets, no serialization, and no mmap fault-zeroing pass (file
        writes populate fresh tmpfs pages directly). This is the moral
        equivalent of the reference's same-node plasma sharing: one store
        per node means local consumers never stream bytes at all.

        Returns False (leaving no entry behind) if the source segment is
        not visible locally or vanished mid-copy; raises FileExistsError
        like create() if the object is already materializing here."""
        if src_name.startswith("@"):
            return False  # arena-resident (small) objects: not a shm file
        src_path = os.path.join(_SHM_DIR, src_name)
        try:
            if os.path.getsize(src_path) < size:
                return False
        except OSError:
            return False
        dst = self.create(object_id, size)  # may raise FileExistsError
        ok = False
        try:
            if not hasattr(dst, "name") or dst.name.startswith("@"):
                # landed in the arena: copy through the mapping
                with open(src_path, "rb") as f:
                    dst.buf[:size] = f.read(size)
                ok = True
                return True
            dst_path = os.path.join(_SHM_DIR, dst.name)
            sfd = os.open(src_path, os.O_RDONLY)
            try:
                dfd = os.open(dst_path, os.O_RDWR)
                try:
                    n_par = min(os.cpu_count() or 1, 4,
                                max(1, size // (64 << 20)))
                    ok = self._copy_ranges(sfd, dfd, size, n_par)
                finally:
                    os.close(dfd)
            finally:
                os.close(sfd)
            return ok
        finally:
            dst.close()
            if ok:
                self.seal(object_id)
            else:
                self.delete(object_id)

    @staticmethod
    def _copy_ranges(sfd: int, dfd: int, size: int, n_par: int) -> bool:
        def copy_range(off: int, end: int) -> None:
            while off < end:
                r = os.copy_file_range(sfd, dfd, end - off, off, off)
                if r == 0:
                    raise OSError("source segment truncated mid-copy")
                off += r

        from ray_tpu_torch.core.data_plane import fan_out

        step = -(-size // max(1, n_par))
        errors = fan_out([lambda o=o: copy_range(o, min(o + step, size))
                          for o in range(0, size, step)])
        return not errors

    # ---- consumer API ----------------------------------------------------
    def status(self, object_id: ObjectID) -> Optional[str]:
        """"sealed" | "unsealed" | None (absent or deleted-while-pinned)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or e.doomed:
                return None
            return "sealed" if e.sealed else "unsealed"

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed and not e.doomed

    def lookup(self, object_id: ObjectID) -> Optional[tuple[str, int]]:
        """Return (segment_name, size) for a sealed object, restoring from
        spill if needed; None if absent (or deleted-but-pinned, or the
        spilled copy failed envelope verification — the entry is dropped
        and the caller's absent-handling routes into reconstruction)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed or e.doomed:
                return None
            if e.spilled_path is not None:
                try:
                    self._restore(object_id, e)
                except SpillCorruptionError:
                    return None  # copy LOST; _restore dropped the entry
            self._entries.move_to_end(object_id)
            return (e.name, e.size)

    # ---- pin protocol ----------------------------------------------------
    def pin(self, object_id: ObjectID,
            transient: bool = False) -> Optional[tuple[str, int]]:
        """Pin a sealed object for a zero-copy reader and return its
        CURRENT (segment_name, size); None if absent/unsealed/doomed (or
        the pin-cap refused — see pin_ex to distinguish).
        While pinned the entry is excluded from spill and eviction, and a
        delete() defers the unlink until the last unpin — so reader views
        into the segment stay valid (and accounted) for their lifetime.
        Restores from spill first: pinning declares intent to attach.

        Pin-cap accounting: indefinite reader pins (`transient=False`) may
        collectively hold at most `max_pinned_fraction` of capacity — the
        FIRST pin of an entry that would cross the cap is refused, so
        pinned entries can never wedge eviction entirely. `transient=True`
        (scoped reads: pinned_view, bounded copy windows) bypasses the cap
        — those pins are released within one operation."""
        loc, _ = self.pin_ex(object_id, transient=transient)
        return loc

    def pin_ex(self, object_id: ObjectID, transient: bool = False
               ) -> tuple[Optional[tuple[str, int]], Optional[str]]:
        """pin() with a reason channel: (loc, None) on success,
        (None, "absent" | "lost" | "pin_cap") on refusal. "pin_cap" means
        the object IS resident — the caller may fall back to a transient
        pin + bounded copy instead of treating it as gone."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed or e.doomed:
                return None, "absent"
            if e.spilled_path is not None:
                try:
                    self._restore(object_id, e)
                except SpillCorruptionError:
                    return None, "lost"  # copy LOST; entry dropped
            if (not transient and e.pinned == 0
                    and e.arena_offset is None
                    and self._pinned_bytes + e.size
                    > get_config().max_pinned_fraction * self.capacity):
                self.counters["pin_cap_refusals"] += 1
                return None, "pin_cap"
            if e.pinned == 0:
                self._pinned_bytes += e.size
                if self._m_pinned is not None:
                    self._m_pinned.set(self._pinned_bytes)
            e.pinned += 1
            self._entries.move_to_end(object_id)
            return (e.name, e.size), None

    def unpin(self, object_id: ObjectID) -> None:
        """Release one pin; finishes a deferred delete at the last one.
        Unknown ids are ignored (a reader's compensating unpin after a
        failed attach may race the owner's delete)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return
            was = e.pinned
            e.pinned = max(0, e.pinned - 1)
            if was == 1 and e.pinned == 0:
                self._pinned_bytes = max(0, self._pinned_bytes - e.size)
                if self._m_pinned is not None:
                    self._m_pinned.set(self._pinned_bytes)
                # newly unpinned bytes are spillable again: wake admission
                # waiters parked in create_blocking
                self._space.notify_all()
            if e.doomed and e.pinned == 0:
                self._entries.pop(object_id, None)
                if e.arena_offset is not None:
                    if self._arena is not None:
                        self._arena.free(e.arena_offset)
                    self._used -= e.size
                else:
                    self._reclaim(e)

    def get_buffer(self, object_id: ObjectID):
        """In-process zero-copy read (same process as the store). The
        buffer holds a PIN until close() — under the segment-reuse pool an
        unpinned attach would be unsafe (a concurrent delete could recycle
        and overwrite the inode beneath the view), so callers MUST close.
        Scoped readers should prefer pinned_view."""
        loc = self.pin(object_id, transient=True)
        if loc is None:
            return None
        try:
            buf = attach_object(*loc)
        except (FileNotFoundError, OSError):
            self.unpin(object_id)
            return None
        inner_close = buf.close
        released = []

        def close():
            if not released:
                released.append(True)
                inner_close()
                self.unpin(object_id)

        buf.close = close
        return buf

    @contextmanager
    def pinned_view(self, object_id: ObjectID):
        """Pin + attach + release in one scope: the shared from-view read
        used by every server-side consumer (data-plane fetch, RPC chunk
        serves). The pin keeps the segment out of spill/eviction for the
        duration, so a long transfer can't race a spill into a
        double-IO restore (or a recycled inode). Yields the buffer, or
        None when the object is absent (or its spilled copy is lost).
        Transient: scoped pins bypass the `max_pinned_fraction` cap."""
        loc = self.pin(object_id, transient=True)
        if loc is None:
            yield None
            return
        buf = None
        try:
            try:
                buf = attach_object(*loc, readonly=True)
            except (FileNotFoundError, OSError):
                yield None
                return
            yield buf
        finally:
            if buf is not None:
                buf.close()
            self.unpin(object_id)

    def read_bytes(self, object_id: ObjectID) -> Optional[bytes]:
        """Materializing read — ONLY for callers that need owned bytes
        (the wire). Consumers that immediately deserialize should use
        pinned_view + serialization.loads instead (no intermediate copy)."""
        with self.pinned_view(object_id) as buf:
            if buf is None:
                return None
            return bytes(buf.view)

    # ---- lifecycle -------------------------------------------------------
    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return
            if e.pinned > 0 and e.spilled_path is None:
                # zero-copy (or pinned_view) readers still hold views into
                # the segment / arena slot: hide the entry (lookup/contains
                # say gone) but defer the reclaim — the last unpin runs it
                e.doomed = True
                return
            self._entries.pop(object_id, None)
            if e.pinned > 0:
                # deleting a pinned-but-spilled entry: its pin bytes leave
                # the cap accounting with it
                self._pinned_bytes = max(0, self._pinned_bytes - e.size)
            if e.arena_offset is not None:
                if self._arena is not None:
                    self._arena.free(e.arena_offset)
                self._used -= e.size
                self._space.notify_all()
            elif e.spilled_path is None:
                self._reclaim(e)
            elif os.path.exists(e.spilled_path):
                try:
                    os.unlink(e.spilled_path)
                except OSError:
                    pass

    def _reclaim(self, e: _Entry) -> None:
        """Caller holds _lock. Retire a live file segment: park it in the
        reuse pool (pages stay hot for the next same-bucket create),
        evicting older pooled segments to make room — the workload's
        CURRENT object size wins the pool. Oversized segments unlink."""
        self._used -= e.size
        bucket = self._bucket(e.size)
        if bucket > self._pool_cap:
            self._unlink(e)
            return
        need = self._pool_bytes + bucket - self._pool_cap
        if need > 0:
            self._drain_pool(need)
        self._pool.setdefault(bucket, []).append(e.name)
        self._pool_bytes += bucket
        self._space.notify_all()  # freed live bytes: wake admission waiters

    def _drain_pool(self, want: int) -> int:
        """Caller holds _lock. Unlink pooled segments until `want` bytes
        are freed (memory pressure beats reuse warmth). Returns freed."""
        freed = 0
        for bucket in sorted(self._pool, reverse=True):
            names = self._pool[bucket]
            while names and freed < want:
                ShmSegment.unlink(names.pop())
                self._pool_bytes -= bucket
                freed += bucket
            if freed >= want:
                break
        return freed

    def stats(self) -> dict:
        with self._lock:
            spilled = sum(1 for e in self._entries.values() if e.spilled_path)
            spilled_bytes = sum(e.size for e in self._entries.values()
                                if e.spilled_path)
            pinned = sum(1 for e in self._entries.values() if e.pinned > 0)
            c = self.counters
            return {
                "num_objects": len(self._entries),
                "used_bytes": self._used,
                "capacity_bytes": self.capacity,
                "num_spilled": spilled,
                "spilled_bytes": spilled_bytes,
                "num_pinned": pinned,
                "pinned_refs": sum(e.pinned for e in self._entries.values()),
                "pinned_bytes": self._pinned_bytes,
                "pool_bytes": self._pool_bytes,
                "spill_degraded": self._spill_degraded,
                "spilled_bytes_total": c["spilled_bytes"],
                "restored_bytes_total": c["restored_bytes"],
                "spill_failures": dict(c["spill_failures"]),
                "lost_spills": c["lost_spills"],
                "put_backpressure": c["put_backpressure"],
                "pin_cap_refusals": c["pin_cap_refusals"],
                "degraded_enters": c["degraded_enters"],
                "degraded_heals": c["degraded_heals"],
            }

    def shutdown(self) -> None:
        with self._lock:
            for oid, e in list(self._entries.items()):
                e.pinned = 0  # process exiting: force-reclaim
                e.doomed = False
                self.delete(oid)
            self._pinned_bytes = 0
            self._drain_pool(self._pool_bytes)
            if self._arena is not None:
                self._arena.close()
                self._arena.unlink()
                self._arena = None

    # ---- internals -------------------------------------------------------
    def _unlink(self, e: _Entry) -> None:
        ShmSegment.unlink(e.name)

    def _admit(self, incoming: int) -> None:
        """Caller holds _lock, after _maybe_evict. Typed store-full check:
        live bytes + pooled segments + the incoming object must fit under
        capacity. The pool is drained first (idle warmth never causes a
        rejection); what remains over budget is genuine — pinned or
        unsealed entries that cannot move, or a spill-degraded store."""
        deficit = self._used + self._pool_bytes + incoming - self.capacity
        if deficit > 0:
            self._drain_pool(deficit)
        if self._used + self._pool_bytes + incoming <= self.capacity:
            return
        self.counters["put_backpressure"] += 1
        raise ObjectStoreFullError(
            f"object store cannot admit {incoming} bytes: "
            f"used={self._used} pinned={self._pinned_bytes} "
            f"pool={self._pool_bytes} capacity={self.capacity}"
            + (" [spill-degraded: every spill dir is failing]"
               if self._spill_degraded else ""))

    def create_blocking(self, object_id: ObjectID, size: int,
                        timeout_s: float, info: Optional[dict] = None):
        """create() with a bounded wait for eviction/unpin headroom: parks
        on the store's space condition (notified by delete/unpin/heal)
        until admission succeeds or `timeout_s` expires, then re-raises the
        typed ObjectStoreFullError. For server-internal materialization
        paths (pulls, data-plane pushes) that run on their own threads;
        the worker put path does its own client-side bounded retry."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._space:
            while True:
                try:
                    return self.create(object_id, size, info=info)
                except ObjectStoreFullError:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or size > self.capacity:
                        raise
                    self._space.wait(min(remaining, 0.1))

    def _maybe_evict(self, incoming: int) -> None:
        """Spill least-recently-used sealed objects until there is room.

        Mirrors the reference's threshold-triggered spilling
        (`object_spilling_threshold` 0.8, `ray_config_def.h:583`). A
        spill-degraded store (every spill dir failing) skips spilling
        entirely — after a probe-period attempt to self-heal — and only
        drains the pool; admission then backpressures puts.
        """
        threshold = get_config().object_spilling_threshold
        budget = self.capacity * threshold - self._pool_bytes
        if self._used + incoming <= budget:
            return
        # reclaim idle pooled segments before spilling LIVE objects: pool
        # warmth never costs a spill
        self._drain_pool(int(self._used + incoming - budget))
        budget = self.capacity * threshold - self._pool_bytes
        if self._spill_degraded and not self._probe_spill_dirs():
            return
        for oid in list(self._entries):
            if self._used + incoming <= budget:
                break
            e = self._entries[oid]
            if (not e.sealed or e.spilled_path is not None or e.pinned > 0
                    or e.arena_offset is not None):
                continue  # pinned entries hold reader views; arena objects
                # are small — only idle file segments spill
            if not self._spill(oid, e) and self._spill_degraded:
                return  # every dir just failed: stop burning IO this pass

    def _probe_spill_dirs(self) -> bool:
        """Caller holds _lock. Self-healing probe for the spill-degraded
        state: at most once per `spill_degraded_probe_period_s`, try a
        tiny committed write in each spill dir (through the same fault
        points as a real spill). One healthy dir clears degradation and
        wakes admission waiters. Returns the healthy/healed state."""
        if not self._spill_degraded:
            return True
        period = get_config().spill_degraded_probe_period_s
        now = time.monotonic()
        if period <= 0 or now - self._last_probe < period:
            return False
        self._last_probe = now
        for d in self.spill_dirs:
            try:
                if _fs_fault("spill_write") in ("enospc", "eio"):
                    continue  # injected window still open for this probe
                os.makedirs(d, exist_ok=True)
                probe = os.path.join(d, ".probe")
                with open(probe + ".tmp", "wb") as f:
                    f.write(b"rtt-probe")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(probe + ".tmp", probe)
                os.unlink(probe)
            except OSError:
                continue
            self._spill_degraded = False
            self.counters["degraded_heals"] += 1
            logger.warning("object store spill path healed (dir %s); "
                           "resuming spilling", d)
            self._space.notify_all()
            return True
        return False

    def _count_spill_failure(self, reason: str) -> None:
        fails = self.counters["spill_failures"]
        fails[reason] = fails.get(reason, 0) + 1
        if self._m_spill_fail is not None:
            self._m_spill_fail.inc(tags={"reason": reason})

    def _spill(self, object_id: ObjectID, e: _Entry) -> bool:
        """Caller holds _lock. Durable spill: checksummed envelope, tmp
        write, fsync, os.replace — the file is either complete and
        verifiable or absent. ENOSPC/EIO retries down `spill_dirs` under
        backoff; when every dir fails the store enters the spill-degraded
        state (spilling stops, puts flip to backpressure) until a probe
        heals it. Returns True when the object moved to disk."""
        cfg = get_config()
        try:
            shm = ShmSegment(e.name, e.size)
        except FileNotFoundError:
            return False  # segment swept externally; nothing to spill
        try:
            payload = bytes(shm.buf[: e.size])
        finally:
            shm.close()
        header = spill_pack_header(payload)
        injected = _fs_fault("spill_write")
        if injected == "bitflip" and e.size > 0:
            # corrupt ONE payload byte after checksumming: the envelope
            # commits "successfully" and the defect is only caught by
            # _restore's verification — the silent-bit-rot scenario
            corrupt = bytearray(payload)
            corrupt[len(corrupt) // 2] ^= 0x40
            payload = bytes(corrupt)
        for d in self.spill_dirs:
            path = os.path.join(d, object_id.hex())
            tmp = path + ".tmp"
            for attempt in range(max(1, cfg.spill_write_retries)):
                try:
                    if injected in ("enospc", "eio"):
                        raise OSError(
                            errno.ENOSPC if injected == "enospc"
                            else errno.EIO,
                            f"[fault-injection] {injected} on spill_write")
                    os.makedirs(d, exist_ok=True)
                    with open(tmp, "wb") as f:
                        f.write(header)
                        if injected == "torn":
                            # commit a half-written payload: a crash that
                            # raced the write — caught by length/crc checks
                            f.write(payload[: max(0, e.size // 2)])
                        else:
                            f.write(payload)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, path)
                except OSError as err:
                    self._count_spill_failure(
                        "enospc" if err.errno == errno.ENOSPC else "io")
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    if attempt + 1 < max(1, cfg.spill_write_retries):
                        time.sleep(cfg.spill_retry_backoff_ms / 1000.0
                                   * (attempt + 1))
                    # next attempt re-rolls the injector: a probabilistic
                    # ENOSPC window can clear mid-retry like a real disk
                    injected = _fs_fault("spill_write")
                    continue
                self._unlink(e)
                e.spilled_path = path
                self._used -= e.size
                self.counters["spilled_bytes"] += e.size
                if self._m_spilled is not None:
                    self._m_spilled.inc(e.size)
                logger.debug("spilled %s (%d bytes) to %s",
                             object_id, e.size, path)
                return True
            injected = _fs_fault("spill_write")
        if not self._spill_degraded:
            self._spill_degraded = True
            self._degraded_since = time.monotonic()
            self._last_probe = time.monotonic()
            self.counters["degraded_enters"] += 1
            logger.error(
                "object store is SPILL-DEGRADED: every spill dir failed "
                "(%s); spilling stops and puts backpressure until a probe "
                "heals", self.spill_dirs)
        return False

    def _restore(self, object_id: ObjectID, e: _Entry) -> None:
        """Caller holds _lock. Verified restore: the envelope's magic,
        length and crc32 must all check out before the payload re-enters
        shm. ANY defect (torn, short, corrupt, missing, unreadable) marks
        this copy LOST — the entry is dropped and SpillCorruptionError
        (an ObjectLostError) raised; callers surface absent and lineage
        reconstruction takes over."""
        assert e.spilled_path is not None
        path = e.spilled_path
        try:
            injected = _fs_fault("spill_restore")
            if injected in ("eio", "torn"):
                raise SpillCorruptionError(
                    f"spill file {path}: [fault-injection] {injected} on "
                    f"restore", reason="torn" if injected == "torn"
                    else "io")
            payload = spill_read_verified(path, expect_size=e.size)
            if injected == "bitflip":
                raise SpillCorruptionError(
                    f"spill file {path}: [fault-injection] bitflip on "
                    f"restore", reason="corrupt")
        except SpillCorruptionError as err:
            # the copy is gone: drop the entry + the bad file so repeated
            # lookups don't re-verify a corpse, count it, surface typed
            self._entries.pop(object_id, None)
            try:
                os.unlink(path)
            except OSError:
                pass
            self.counters["lost_spills"] += 1
            self._count_spill_failure(err.reason)
            logger.error("spilled copy of %s LOST (%s): %s",
                         object_id, err.reason, err)
            raise
        self._maybe_evict(e.size)
        shm, _ = self._alloc_file_segment(e.size)
        name = shm.name
        try:
            shm.buf[: e.size] = payload
        finally:
            shm.close()
        try:
            os.unlink(path)
        except OSError:
            pass
        e.name = name
        e.spilled_path = None
        self._used += e.size
        self.counters["restored_bytes"] += e.size
        if self._m_restored is not None:
            self._m_restored.inc(e.size)
        logger.debug("restored %s from spill", object_id)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


def sweep_stale_spill_dirs(roots: Optional[List[str]] = None,
                           live_pids: Optional[set] = None) -> List[str]:
    """Collect spill dirs leaked by SIGKILLed stores. Spill dirs are keyed
    `<root>/<pid>`; a raylet that dies without shutdown() leaves its dir
    (and every spilled object in it) behind forever — every kill storm
    does this. Sweeps children whose pid no longer runs, mirroring the
    `rtt-worker-*.env` reaper (raylet._sweep_stale_envfiles): called at
    store startup and hourly from the raylet reaper loop. Returns the
    removed paths. `roots` defaults to the session spill root plus every
    configured `object_spill_dirs` entry."""
    cfg = get_config()
    if roots is None:
        roots = [os.path.join(cfg.session_dir_root, "spill")] + [
            d for d in cfg.object_spill_dirs.split(":") if d.strip()]
    live = set(live_pids or ())
    live.add(os.getpid())
    removed: List[str] = []
    for root in roots:
        try:
            children = os.listdir(root)
        except OSError:
            continue
        for child in children:
            if not child.isdigit() or int(child) in live:
                continue
            if _pid_alive(int(child)):
                continue
            path = os.path.join(root, child)
            try:
                shutil.rmtree(path)
                removed.append(path)
            except OSError:
                pass  # raced another sweeper / permissions: next pass
    if removed:
        logger.info("reaped %d stale spill dir(s): %s",
                    len(removed), removed[:4])
    return removed


def attach_object(name: str, size: int, readonly: bool = False,
                  copy_on_write: bool = False):
    """Attach to a sealed object from any process on the node.

    `name` is either a /dev/shm segment name or "@<arena_path>:<offset>"
    for objects living in the C++ shared arena. With `readonly` the
    mapping is PROT_READ, so every view (and numpy array over one) is
    immutable — the aliasing contract for zero-copy get(). With
    `copy_on_write` the views are read-only over a private mapping, so a
    torch tensor aliasing one can be written without touching the object.
    """
    if name.startswith("@"):
        from ray_tpu_torch.core.arena import attached_arena

        path, off = name[1:].rsplit(":", 1)
        arena = attached_arena(path)
        if arena is None:
            raise FileNotFoundError(f"cannot attach arena {path}")
        return ArenaBuffer(arena.view(int(off), size), name, size)
    return SharedBuffer(ShmSegment(name, size, readonly=readonly,
                                   copy_on_write=copy_on_write), size)
