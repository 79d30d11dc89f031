"""Pluggable control-plane snapshot storage.

The role Redis plays for the reference's HA GCS (`gcs_table_storage.h`,
`redis_client.h`): the GCS serializes its durable tables into an opaque
blob and hands it to a `SnapshotStore` — a dumb keyed blob interface
(`put`/`get`/`list_keys`/`delete`) selected by URI, so the storage
backend is swappable without touching the control plane:

    file:///var/lib/ray_tpu_torch/gcs     -> FileSnapshotStore (atomic rename)
    memory://name                   -> MemorySnapshotStore (per-process,
                                       survives a GcsServer object swap —
                                       the in-process test analog of an
                                       external store)

Blobs are written through a checksummed envelope (`encode_blob` /
`decode_blob`: magic + sha256 + payload) and `VersionedSnapshots` layers
monotonically-numbered keys on top, so a restore walks versions newest
first and a torn/corrupt write falls back to the previous good snapshot
instead of silently restoring garbage.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import threading
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# envelope: MAGIC + u32 format version + sha256(payload) + payload
_MAGIC = b"RTTOSNAP"
_FORMAT_VERSION = 1
_HDR = struct.Struct("!8sI32s")


class SnapshotCorruptError(ValueError):
    """Blob failed the envelope checks (magic/version/checksum)."""


def encode_blob(payload: bytes) -> bytes:
    digest = hashlib.sha256(payload).digest()
    return _HDR.pack(_MAGIC, _FORMAT_VERSION, digest) + payload


def decode_blob(blob: bytes) -> bytes:
    if len(blob) < _HDR.size:
        raise SnapshotCorruptError("snapshot blob truncated")
    magic, version, digest = _HDR.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise SnapshotCorruptError("bad snapshot magic")
    if version != _FORMAT_VERSION:
        raise SnapshotCorruptError(f"unsupported snapshot format {version}")
    payload = blob[_HDR.size:]
    if hashlib.sha256(payload).digest() != digest:
        raise SnapshotCorruptError("snapshot checksum mismatch")
    return payload


class SnapshotStore:
    """Keyed blob storage. Implementations must make `put` atomic per key
    (a reader never observes a half-written blob)."""

    def put(self, key: str, blob: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class FileSnapshotStore(SnapshotStore):
    """Directory of blob files; atomic via tmp-write + os.replace — the
    same swap discipline the old single-pickle path used, now per key."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if "/" in key or key.startswith("."):
            raise ValueError(f"invalid snapshot key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, blob: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def list_keys(self, prefix: str = "") -> List[str]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if n.startswith(prefix) and ".tmp" not in n)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class MemorySnapshotStore(SnapshotStore):
    """Process-global named keyspaces: a replacement GcsServer object in
    the same process (tests, embedded heads) restores from the old one's
    writes — the in-process stand-in for an external blob service."""

    _spaces: Dict[str, Dict[str, bytes]] = {}
    _spaces_lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        with MemorySnapshotStore._spaces_lock:
            self._blobs = MemorySnapshotStore._spaces.setdefault(name, {})
        self._lock = threading.Lock()

    def put(self, key: str, blob: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(blob)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get(key)

    def list_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    @classmethod
    def wipe(cls, name: str) -> None:
        """Test helper: drop a named keyspace."""
        with cls._spaces_lock:
            cls._spaces.pop(name, None)


def store_from_uri(uri: str) -> SnapshotStore:
    """`file://<dir>` or `memory://<name>`; a bare path means file."""
    if uri.startswith("file://"):
        return FileSnapshotStore(uri[len("file://"):])
    if uri.startswith("memory://"):
        return MemorySnapshotStore(uri[len("memory://"):])
    if "://" in uri:
        raise ValueError(f"unsupported snapshot store URI {uri!r} "
                         f"(supported: file://, memory://)")
    return FileSnapshotStore(uri)


class VersionedSnapshots:
    """Monotonically-versioned snapshots over a SnapshotStore.

    `save` writes `<prefix>-<seq>` (seq = newest seen + 1) through the
    checksummed envelope and prunes to the newest `keep` versions;
    `load_latest` walks versions newest-first and returns the first blob
    that decodes, logging and skipping corrupt ones.
    """

    def __init__(self, store: SnapshotStore, prefix: str = "gcs",
                 keep: int = 3):
        self.store = store
        self.prefix = prefix
        self.keep = max(1, keep)

    def _seq_of(self, key: str) -> Optional[int]:
        tail = key[len(self.prefix) + 1:]
        try:
            return int(tail)
        except ValueError:
            return None

    def _versions(self) -> List[int]:
        out = []
        for k in self.store.list_keys(prefix=f"{self.prefix}-"):
            seq = self._seq_of(k)
            if seq is not None:
                out.append(seq)
        return sorted(out)

    def save(self, payload: bytes) -> int:
        versions = self._versions()
        seq = (versions[-1] + 1) if versions else 1
        self.store.put(f"{self.prefix}-{seq:016d}", encode_blob(payload))
        for old in versions[:max(0, len(versions) + 1 - self.keep)]:
            self.store.delete(f"{self.prefix}-{old:016d}")
        return seq

    def load_latest(self) -> Optional[bytes]:
        payload, _ = self.load_latest_with_version()
        return payload

    def load_latest_with_version(self) -> tuple[Optional[bytes], int]:
        """Newest decodable payload AND its version number — the standby
        head's tail loop keys its freshness ("≤1 snapshot behind") on the
        version. (None, 0) when no usable snapshot exists."""
        for seq in reversed(self._versions()):
            key = f"{self.prefix}-{seq:016d}"
            blob = self.store.get(key)
            if blob is None:
                continue
            try:
                return decode_blob(blob), seq
            except SnapshotCorruptError as e:
                logger.warning("snapshot %s unusable (%s); trying the "
                               "previous version", key, e)
        return None, 0

    def latest_version(self) -> int:
        """Newest version number present (0 when empty) — a cheap list, no
        blob fetch; the standby polls this before pulling the payload."""
        versions = self._versions()
        return versions[-1] if versions else 0
