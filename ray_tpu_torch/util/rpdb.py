"""Remote pdb: breakpoints inside tasks/actors, attachable from the CLI.

Reference parity: `ray debug` + python/ray/util/rpdb.py — a task calls
`ray_tpu_torch.util.rpdb.set_trace()`, which opens a TCP-bound pdb
session, registers it in the GCS KV (host, port, task context) under the
port's own namespace, and blocks until a client attaches. `python -m
ray_tpu_torch debug --address <gcs>` lists active breakpoints and connects
the terminal to one (plain socket I/O — `nc host port` works too).
"""

from __future__ import annotations

import json
import pdb
import socket
import sys
import threading
from typing import List, Optional

_KV_NS = "ray_tpu_torch_rpdb"


class _SocketIO:
    """File-like adapter binding pdb's stdin/stdout to one connection."""

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._rfile = conn.makefile("r")
        self._wfile = conn.makefile("w")

    def readline(self):
        return self._rfile.readline()

    def write(self, data):
        self._wfile.write(data)
        return len(data)

    def flush(self):
        try:
            self._wfile.flush()
        except OSError:
            pass  # peer hung up mid-session

    def close(self):
        for f in (self._rfile, self._wfile):
            try:
                f.close()
            except OSError:
                pass
        try:
            self._conn.close()
        except OSError:
            pass


class _RemotePdb(pdb.Pdb):
    """pdb over a socket; cleanup (KV deregister + socket close) runs when
    the session ends — NOT in set_trace's own frame, or the debugger would
    stop inside the cleanup code instead of the user's."""

    def __init__(self, io: _SocketIO, on_done=None):
        super().__init__(stdin=io, stdout=io)
        self.use_rawinput = False
        self.prompt = "(rpdb) "
        self._on_done = on_done

    def _cleanup(self):
        cb, self._on_done = self._on_done, None
        if cb:
            try:
                cb()
            except Exception:
                pass

    def do_continue(self, arg):
        out = super().do_continue(arg)
        self._cleanup()
        return out

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        out = super().do_quit(arg)
        self._cleanup()
        return out

    do_q = do_exit = do_quit

    def do_EOF(self, arg):
        out = super().do_EOF(arg)
        self._cleanup()
        return out


def _register(entry: dict) -> Optional[str]:
    """Record the breakpoint in the GCS KV so the CLI can list it."""
    try:
        from ray_tpu_torch.core.worker import current_worker

        w = current_worker()
        if w is None:
            return None
        key = f"bp-{entry['host']}:{entry['port']}".encode()
        w.gcs.call("kv_put", {"namespace": _KV_NS, "key": key,
                              "value": json.dumps(entry).encode()})
        return key.decode()
    except (OSError, RuntimeError, TimeoutError):  # GCS unreachable
        return None


def _unregister(key: Optional[str]) -> None:
    if key is None:
        return
    try:
        from ray_tpu_torch.core.worker import current_worker

        w = current_worker()
        if w is not None:
            w.gcs.call("kv_del", {"namespace": _KV_NS, "key": key.encode()})
    except (OSError, RuntimeError, TimeoutError):
        pass  # breakpoint entry ages out of the KV anyway


def set_trace(frame=None) -> None:
    """Open a remote-attachable breakpoint and block until a debugger
    client connects (reference rpdb behavior)."""
    import os

    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    host, port = server.getsockname()
    entry = {"host": host, "port": port, "pid": os.getpid()}
    try:
        from ray_tpu_torch.core.worker import current_worker

        w = current_worker()
        if w is not None:
            tid = getattr(w._tls, "task_id", None)
            entry["task_id"] = tid.binary().hex() if tid else None
            entry["actor_id"] = (w.actor_id.binary().hex()
                                 if w.actor_id else None)
    except Exception:
        pass
    key = _register(entry)
    sys.stderr.write(
        f"rpdb waiting for attach at {host}:{port} "
        f"(python -m ray_tpu_torch debug --address <gcs>, or "
        f"`nc {host} {port}`)\n")
    conn, _ = server.accept()
    io = _SocketIO(conn)

    def on_done():
        _unregister(key)
        io.close()
        server.close()

    dbg = _RemotePdb(io, on_done=on_done)
    dbg.set_trace(frame or sys._getframe().f_back)
    # the debugger owns the session from here; cleanup fires on c/q/EOF


def list_breakpoints(gcs_client) -> List[dict]:
    """Active breakpoints from the GCS KV (for the CLI)."""
    out = []
    try:
        keys = gcs_client.call("kv_keys", {"namespace": _KV_NS,
                                           "prefix": b""})
        for key in keys:
            value = gcs_client.call("kv_get", {"namespace": _KV_NS,
                                               "key": key})
            if value is None:
                continue
            try:
                out.append(json.loads(bytes(value).decode()))
            except (ValueError, UnicodeDecodeError):
                continue  # stale/corrupt registry entry
    except Exception:
        pass
    return out


def attach(host: str, port: int) -> None:
    """Bridge this terminal to a remote pdb session."""
    conn = socket.create_connection((host, port))
    stop = threading.Event()

    def pump_in():
        try:
            while not stop.is_set():
                line = sys.stdin.readline()
                if not line:
                    break
                conn.sendall(line.encode())
        except (OSError, EOFError, KeyboardInterrupt):
            pass  # debugger detach closes the socket mid-pipe

    t = threading.Thread(target=pump_in, daemon=True)
    t.start()
    try:
        while True:
            data = conn.recv(4096)
            if not data:
                break
            sys.stdout.write(data.decode(errors="replace"))
            sys.stdout.flush()
    finally:
        stop.set()
        conn.close()
