"""Bulk object-transfer data plane: a dedicated raw-TCP channel per raylet.

The control RPC layer (rpc.py) frames every message as a pickle through one
asyncio loop — fine for control traffic, hopeless for multi-GiB objects (the
reference splits these planes the same way: gRPC control vs. dedicated
ObjectManager chunk streams, `src/ray/object_manager/object_manager.h:117`).

This channel moves object bytes with the minimum copies Python allows:

- FETCH: the server writes straight out of the sealed shm segment with
  ``sendall(memoryview)`` (no serialization, no staging buffer) and the
  puller reads straight into its pre-created destination segment with
  ``recv_into(memoryview)`` — shm -> kernel -> shm.
- Pulls stripe chunks across several persistent connections (the kernel
  copies in parallel with Python-side bookkeeping; on real NICs multiple
  streams also beat one TCP window).
- PUSH: source-initiated transfer for owner-directed broadcast (reference
  `push_manager.h:29`): the source streams an object into a peer's store
  unasked, so N readers don't serialize on one source; the receiver
  registers the new copy with the owner.

Protocol (all integers big-endian):
  request  = op:u8  idlen:u16  offset:u64  length:u64  id:idlen bytes
             (op FETCH: offset/length select the slice;
              op PUSH:  offset unused, length = total object size,
              followed — after a GO reply — by `length` raw bytes)
  reply    = status:u8  length:u64   (+ `length` raw payload bytes for FETCH)
  status   = 0 OK/GO, 1 MISSING/ERROR, 2 SKIP (push target already has it)
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID

logger = logging.getLogger(__name__)


def fan_out(fns: List[Callable[[], None]],
            timeout: Optional[float] = None) -> List[str]:
    """Run callables concurrently on daemon threads and return collected
    error strings (exceptions and timeouts). One shared deadline across all
    joins — per-thread timeouts would compound to N*timeout wall clock.
    Single callable runs inline (no thread). Shared by the transfer fan-out
    sites (striped pulls, multi-target pushes, parallel file copies)."""
    errors: List[str] = []
    if len(fns) == 1:
        try:
            fns[0]()
        except Exception as e:
            errors.append(str(e))
        return errors

    def wrap(fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception as e:
            errors.append(str(e))

    threads = [threading.Thread(target=wrap, args=(fn,),
                                name="dp-fan-out", daemon=True)
               for fn in fns]
    for t in threads:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            errors.append("fan-out worker timed out")
    return errors

OP_FETCH, OP_PUSH = 1, 2
OK, MISSING, SKIP = 0, 1, 2

_REQ = struct.Struct("!BHQQ")
_REP = struct.Struct("!BQ")

# One recv_into syscall cap: large enough to amortize syscall cost, small
# enough to keep the GIL released in long kernel copies without starving
# other threads.
_IO_BLOCK = 4 << 20


def _recv_exactly_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:got + min(_IO_BLOCK, n - got)])
        if r == 0:
            raise ConnectionError("data-plane peer closed mid-transfer")
        got += r


def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exactly_into(sock, memoryview(buf))
    return bytes(buf)


class DataPlaneServer:
    """Serves FETCH/PUSH on a dedicated port, one thread per connection
    (bulk copies release the GIL; connection counts are small — raylets
    hold a few persistent streams per peer)."""

    def __init__(self, store, host: str = "127.0.0.1",
                 on_pushed: Optional[Callable[[ObjectID, dict], None]] = None):
        self._store = store
        self._on_pushed = on_pushed  # called after a pushed object seals
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._stopped = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="data-plane-accept", daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="data-plane-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                hdr = _recv_exactly(conn, _REQ.size)
                op, idlen, offset, length = _REQ.unpack(hdr)
                oid = ObjectID(_recv_exactly(conn, idlen))
                if op == OP_FETCH:
                    self._serve_fetch(conn, oid, offset, length)
                elif op == OP_PUSH:
                    self._serve_push(conn, oid, length)
                else:
                    conn.sendall(_REP.pack(MISSING, 0))
        except (ConnectionError, struct.error, OSError):
            pass
        except Exception:
            if not self._stopped:
                logger.exception("data-plane connection failed")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_fetch(self, conn: socket.socket, oid: ObjectID,
                     offset: int, length: int) -> None:
        # pinned for the whole stream: a spill mid-transfer would unlink
        # the segment under the send and force a restore per stripe
        with self._store.pinned_view(oid) as buf:
            if buf is None:
                conn.sendall(_REP.pack(MISSING, 0))
                return
            view = memoryview(buf.view)[offset:offset + length]
            conn.sendall(_REP.pack(OK, len(view)))
            # zero-copy source: sendall walks the shm mapping directly
            conn.sendall(view)

    def _serve_push(self, conn: socket.socket, oid: ObjectID,
                    size: int) -> None:
        """Receive a source-initiated copy straight into a new segment."""
        from ray_tpu_torch.core.config import get_config

        if self._store.contains(oid):
            conn.sendall(_REP.pack(SKIP, 0))
            return
        try:
            # bounded wait for eviction/unpin headroom (own thread per
            # connection — blocking here stalls only this push); a store
            # still full after the window replies MISSING and the source
            # falls back / retries
            shm = self._store.create_blocking(
                oid, size, min(get_config().put_full_timeout_s, 5.0))
        except FileExistsError:
            conn.sendall(_REP.pack(SKIP, 0))
            return
        except Exception:
            conn.sendall(_REP.pack(MISSING, 0))
            return
        ok = False
        try:
            conn.sendall(_REP.pack(OK, 0))  # GO: stream the body
            _recv_exactly_into(conn, memoryview(shm.buf)[:size])
            ok = True
        finally:
            shm.close()
            if not ok:
                try:
                    self._store.delete(oid)
                except KeyError:
                    pass  # partial create already evicted
        self._store.seal(oid)
        conn.sendall(_REP.pack(OK, 0))  # DONE
        if self._on_pushed is not None:
            try:
                self._on_pushed(oid, {})
            except Exception:
                logger.exception("on_pushed callback failed")

    def stop(self) -> None:
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            pass


class DataPlaneClient:
    """One persistent data-plane connection (NOT thread-safe: each puller
    stripe / pusher owns its own)."""

    def __init__(self, address: str, connect_timeout: float = 10.0):
        from ray_tpu_torch.core.config import get_config

        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=connect_timeout)
        # stall timeout rides the transfer config knob, not a hardcode
        self._sock.settimeout(get_config().object_transfer_chunk_timeout_s * 2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.address = address

    def fetch_into(self, oid: ObjectID, offset: int, length: int,
                   dest: memoryview) -> bool:
        """Pull one slice straight into `dest` (a shm segment slice).
        Returns False if the peer no longer holds the object."""
        idb = oid.binary()
        self._sock.sendall(_REQ.pack(OP_FETCH, len(idb), offset, length) + idb)
        status, n = _REP.unpack(_recv_exactly(self._sock, _REP.size))
        if status != OK:
            return False
        if n != length:
            raise ConnectionError(
                f"data-plane fetch returned {n} bytes, wanted {length}")
        _recv_exactly_into(self._sock, dest[:length])
        return True

    def push_from(self, oid: ObjectID, src: memoryview) -> str:
        """Stream a whole object to the peer. Returns 'ok', 'skip' (peer
        already has it) or raises."""
        idb = oid.binary()
        self._sock.sendall(_REQ.pack(OP_PUSH, len(idb), 0, len(src)) + idb)
        status, _ = _REP.unpack(_recv_exactly(self._sock, _REP.size))
        if status == SKIP:
            return "skip"
        if status != OK:
            raise ConnectionError("data-plane push rejected")
        self._sock.sendall(src)
        status, _ = _REP.unpack(_recv_exactly(self._sock, _REP.size))
        if status != OK:
            raise ConnectionError("data-plane push failed at receiver")
        return "ok"

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class DataPlanePool:
    """Small per-target pool of DataPlaneClient connections, checked out by
    the striped pull workers (connections are persistent; stripes reuse
    them across pulls)."""

    def __init__(self):
        self._free: Dict[str, List[DataPlaneClient]] = {}
        self._lock = threading.Lock()

    def acquire(self, address: str) -> DataPlaneClient:
        with self._lock:
            free = self._free.get(address)
            if free:
                return free.pop()
        return DataPlaneClient(address)

    def release(self, client: DataPlaneClient, broken: bool = False) -> None:
        if broken:
            client.close()
            return
        with self._lock:
            self._free.setdefault(client.address, []).append(client)

    def close(self) -> None:
        with self._lock:
            clients = [c for lst in self._free.values() for c in lst]
            self._free.clear()
        for c in clients:
            c.close()
