"""Export-once function table: pickle a callable once, ship an id forever.

Equivalent of the reference's function manager
(`python/ray/_private/function_manager.py`): on the first submission of a
callable the submitter exports its cloudpickle blob to a GCS table keyed by
a content hash (`FunctionID`), and every TaskSpec afterwards carries only
the 16-byte id. Executors resolve ids through a per-process LRU of
*deserialized* functions, fetching the blob from the GCS exactly once per
process on a miss. Without this, every `f.remote()` re-runs
`cloudpickle.dumps` and ships the full closure, and every execution re-runs
`cloudpickle.loads` — the dominant control-plane cost for closure-heavy
fine-grained tasks (the Podracer/RL workload class).

The blob-in-spec path survives as a fallback: callables that cannot be
weak-referenced (the export cache must not leak one-shot lambdas) and
clusters with `function_table_enabled=False` ship the pickle inline, and
executors accept either form.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import FunctionID

logger = logging.getLogger(__name__)


class FunctionTableClient:
    """Per-CoreWorker client for the GCS function table: export cache on
    the submitting side, deserialized-function LRU on the executing side
    (one process can be both, e.g. an actor that submits subtasks)."""

    def __init__(self, worker):
        self._worker = worker
        # submitter side: callable -> (fid_bytes, blob). Weak keys so the
        # cache dies with the function object instead of pinning it.
        self._exports: "weakref.WeakKeyDictionary[Any, Tuple[bytes, bytes]]" \
            = weakref.WeakKeyDictionary()
        # fids this process has confirmed into the GCS (blocking put once)
        self._exported_ids: set = set()
        # executor side: fid -> deserialized callable, LRU-capped
        self._cache: "OrderedDict[bytes, Any]" = OrderedDict()
        self._lock = threading.RLock()
        # instrumentation (tests + microbenchmark read these)
        self.pickle_count = 0
        self.cache_hits = 0
        self.cache_misses = 0

    def _job_id_bytes(self) -> Optional[bytes]:
        # The GCS job-ownership index tolerates None (unit-test fakes and
        # pre-connect workers have no job id); a missing attribute must not
        # demote the export to the inline-pickle fallback.
        jid = getattr(self._worker, "job_id", None)
        return jid.binary() if jid is not None else None

    # ------------------------------------------------------------ submitter
    def export(self, obj: Any) -> Tuple[Optional[bytes], Optional[bytes]]:
        """Export a callable/class for a spec. Returns (function_id, None)
        when the blob lives in the GCS table, or (None, blob) for the
        inline-pickle fallback."""
        if not get_config().function_table_enabled:
            return None, cloudpickle.dumps(obj)
        with self._lock:
            try:
                entry = self._exports.get(obj)
            except TypeError:  # unhashable callable: cannot cache safely
                self.pickle_count += 1
                return None, cloudpickle.dumps(obj)
            if entry is None:
                blob = cloudpickle.dumps(obj)
                self.pickle_count += 1
                fid = FunctionID.for_blob(blob).binary()
                entry = (fid, blob)
                try:
                    self._exports[obj] = entry
                except TypeError:
                    # not weak-referenceable: treat as one-shot, ship inline
                    return None, blob
        fid, blob = entry
        try:
            self._ensure_exported(fid, blob)
        except Exception:
            # GCS down or mid-restart: submission must not gain a control-
            # plane liveness dependency it never had — ship the pickle
            # inline this time; the next submission retries the export.
            logger.debug("function export deferred (GCS unreachable)",
                         exc_info=True)
            return None, blob
        return fid, None

    def _ensure_exported(self, fid: bytes, blob: bytes) -> None:
        """Blocking put on FIRST export only: the spec may race ahead of the
        blob over a different connection, so the one-time export must land
        before the task can reach an executor."""
        with self._lock:
            if fid in self._exported_ids:
                return
        self._worker.gcs.call(
            "function_put", {"function_id": fid, "blob": blob,
                             "job_id": self._job_id_bytes()},
            timeout=30)
        with self._lock:
            self._exported_ids.add(fid)

    def replay_exports(self, raw_client) -> None:
        """After a GCS restart, the in-memory function table may be gone:
        re-put every export this process still holds (rides the
        reconnecting client's on_reconnect hook, like job/actor state)."""
        with self._lock:
            entries = list(self._exports.values())
        for fid, blob in entries:
            try:
                raw_client.call("function_put",
                                {"function_id": fid, "blob": blob,
                                 "job_id": self._job_id_bytes()},
                                timeout=30)
            except Exception:
                # Un-mark the export: leaving it in _exported_ids would make
                # every future submission ship an id the (healthy, but
                # fresh) GCS cannot resolve. The next .remote() re-attempts
                # the put through _ensure_exported.
                with self._lock:
                    self._exported_ids.discard(fid)
                logger.debug("function export replay failed", exc_info=True)

    # ------------------------------------------------------------- executor
    def resolve(self, function_id: Optional[bytes],
                blob: Optional[bytes]) -> Any:
        """Resolve a spec's callable: inline blob fallback, else LRU of
        deserialized functions with a GCS fetch on miss."""
        if function_id is None:
            return cloudpickle.loads(blob)
        with self._lock:
            fn = self._cache.get(function_id)
            if fn is not None:
                self._cache.move_to_end(function_id)
                self.cache_hits += 1
                return fn
            self.cache_misses += 1
        fn = cloudpickle.loads(self._fetch(function_id, blob))
        with self._lock:
            self._cache[function_id] = fn
            self._cache.move_to_end(function_id)
            cap = max(1, get_config().function_cache_max_entries)
            while len(self._cache) > cap:
                self._cache.popitem(last=False)
        return fn

    def _fetch(self, fid: bytes, fallback_blob: Optional[bytes]) -> bytes:
        """GCS fetch with a short retry ladder: a submitter's export rides a
        different connection than the task dispatch, and a restarted GCS
        may still be waiting on the submitter's replay."""
        delay = 0.05
        for _ in range(6):
            try:
                data = self._worker.gcs.call(
                    "function_get", {"function_id": fid}, timeout=10)
            except Exception:
                data = None
            if data is not None:
                return data
            time.sleep(delay)
            delay = min(delay * 2, 0.5)
        if fallback_blob is not None:
            return fallback_blob
        raise RuntimeError(
            f"function {fid.hex()[:12]} not found in the GCS function table "
            f"(exporter gone and table not replayed?)")
