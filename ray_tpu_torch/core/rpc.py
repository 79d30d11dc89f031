"""Message-passing RPC layer used by all framework daemons.

Equivalent role to the reference's gRPC wrappers (`src/ray/rpc/`): every
daemon (GCS, raylet, worker) hosts an `RpcServer`; clients hold persistent
connections with pipelined request/response plus server->client pushes (the
push channel is what pubsub and task dispatch ride on, replacing the
reference's long-poll `src/ray/pubsub/` + streaming gRPC).

Design: an asyncio server running on a dedicated thread per process;
synchronous thread-safe clients (a reader thread demultiplexes responses and
pushes). Frames are length-prefixed pickles — the trust model matches the
reference (cluster-internal, same-user processes).
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

# Frame types
REQ, REP, ERR, PUSH = 0, 1, 2, 3


# --------------------------------------------------------------------------
# Deterministic fault injection (chaos testing without timing luck).
#
# Rules fire at the client SEND boundary of named RPC methods, before the
# bytes reach the socket — the same cut points a real network fault hits.
# The rule spec and RNG seed come from config (RAY_TPU_TORCH_FAULT_INJECTION_SPEC
# / _SEED env vars, so spawned workers inherit them) or from
# install_fault_injector() for in-process tests. Spec grammar (";" or ","
# separated; <method> is an RPC name or "*"):
#
#   drop:<method>[:<prob>]        message lost (a call raises
#                                 RpcDisconnected; a notify vanishes)
#   delay:<method>:<ms>[:<prob>]  sender stalls before the write
#   sever_once:<method>           connection cut at the first match, then
#                                 the rule disarms (one deterministic cut)
#   sever:<method>[:<prob>]       connection cut per matching send
#   partition:<a>|<b>[:<prob>]    bidirectional blackhole between the named
#                                 node GROUPS a and b: any send whose origin
#                                 resolves into one group and destination
#                                 into the other is dropped (every method).
#                                 Group membership = sets of node endpoint
#                                 addresses ("host:port") plus the literal
#                                 "store" (the snapshot/lease store — so a
#                                 head-in-minority partition starves its
#                                 lease renewals and the standby's fencing
#                                 takes over). Members come from
#                                 define_group() (in-process harnesses) or
#                                 the RAY_TPU_TORCH_FAULT_PARTITION_GROUPS env
#                                 ("a=addr+addr;b=addr+store") so spawned
#                                 workers inherit the topology. prob < 1.0
#                                 models a flaky (gray) link rather than a
#                                 clean cut. Heal with FaultInjector.heal().
#   fs:<site>:<mode>[:<prob>]     filesystem fault at a named site in the
#                                 storage plane (object_store.py calls
#                                 fs_fault(site) at its spill IO
#                                 boundaries). Sites: spill_write,
#                                 spill_restore (or "*"). Modes:
#                                   enospc   OSError(ENOSPC) — disk full
#                                   eio      OSError(EIO) — media error
#                                   torn     the committed file is
#                                            truncated mid-payload (a
#                                            crash between write and
#                                            fsync; restore-side: short
#                                            read)
#                                   bitflip  one payload byte corrupted
#                                            after checksumming
#                                 Composable with drop/sever/partition
#                                 rules; seeded like everything else.
#
# Determinism: one seeded RNG drives every probabilistic decision, so a
# single-threaded call sequence replays exactly under the same seed.
# Prob-1.0 rules (drop/sever_once/delay without prob) are deterministic
# regardless of threading.
#
# Partition sidedness: every long-lived client carries the NODE identity of
# its owner (`origin=` — a raylet's own server address; for workers and
# drivers, their raylet's address, so partitioning a node group cuts that
# node's worker traffic too). Destinations resolve by the dialed address.
# A send with an unknown side (an address in neither group) passes through:
# partitions cut between named groups, never "everything else".
#
# Named socket-less points (fault_point below) for boundaries that are not
# a single RPC send:
#   serve_replica_call   router -> replica submission (serve failover)
#   lease_renew          active head's lease-renewal WRITE (head_lease.py):
#                        drop it and the lease expires under a healthy head
#                        — the deterministic trigger for standby promotion.
#                        Carries origin=<head address>, dest="store" so a
#                        partition that cuts the head from the store side
#                        starves the lease exactly like a real net split.
# promote_announce needs no fault_point: it is a real client RPC, so
# drop/sever rules hit its send boundary by method name.


# filesystem fault modes injectable at fs:<site> boundaries
FS_FAULT_MODES = ("enospc", "eio", "torn", "bitflip")


class _FaultRule:
    __slots__ = ("action", "method", "prob", "delay_s", "armed", "hits",
                 "group_a", "group_b", "fs_mode")

    def __init__(self, action: str, method: str, prob: float = 1.0,
                 delay_s: float = 0.0, group_a: str = "", group_b: str = "",
                 fs_mode: str = ""):
        self.action = action
        self.method = method
        self.prob = prob
        self.delay_s = delay_s
        self.armed = True
        self.hits = 0
        self.group_a = group_a
        self.group_b = group_b
        self.fs_mode = fs_mode

    def matches(self, method: str) -> bool:
        if not self.armed:
            return False
        if self.action == "partition":
            return True  # partitions blackhole every method between groups
        return self.method == "*" or self.method == method

    def __repr__(self):
        if self.action == "partition":
            return (f"_FaultRule(partition:{self.group_a}|{self.group_b} "
                    f"prob={self.prob} armed={self.armed} hits={self.hits})")
        if self.action == "fs":
            return (f"_FaultRule(fs:{self.method}:{self.fs_mode} "
                    f"prob={self.prob} armed={self.armed} hits={self.hits})")
        return (f"_FaultRule({self.action}:{self.method} prob={self.prob} "
                f"delay={self.delay_s}s hits={self.hits})")


class FaultInjector:
    def __init__(self, spec: str, seed: int = 0,
                 groups: Optional[Dict[str, set]] = None):
        import random as _random

        self.spec = spec
        self.seed = seed
        self._rng = _random.Random(seed)
        self._lock = threading.Lock()
        # partition group membership: name -> set of node endpoint
        # addresses (+ the literal "store"); env-inherited so worker
        # subprocesses share the topology, define_group() for harnesses
        self.groups: Dict[str, set] = {
            name: set(members) for name, members in (groups or {}).items()}
        self.groups.update(self._parse_groups(
            os.environ.get("RAY_TPU_TORCH_FAULT_PARTITION_GROUPS", "")))
        self.rules = [self._parse_rule(r) for r in
                      spec.replace(",", ";").split(";") if r.strip()]
        self.stats: Dict[str, int] = {"drop": 0, "delay": 0, "sever": 0,
                                      "partition": 0, "fs": 0}

    @staticmethod
    def _parse_groups(text: str) -> Dict[str, set]:
        """"a=host:p1+host:p2;b=host:p3+store" -> {"a": {...}, "b": {...}}
        ("+" separates members because addresses contain ":")."""
        out: Dict[str, set] = {}
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, members = part.partition("=")
            out[name.strip()] = {m.strip() for m in members.split("+")
                                 if m.strip()}
        return out

    @staticmethod
    def _parse_rule(text: str) -> "_FaultRule":
        parts = [p.strip() for p in text.strip().split(":")]
        action = parts[0]
        if action not in ("drop", "delay", "sever", "sever_once",
                          "partition", "fs"):
            raise ValueError(f"unknown fault action {action!r} in {text!r}")
        if len(parts) < 2 or not parts[1]:
            raise ValueError(f"fault rule {text!r} needs a method name")
        if action == "fs":
            if len(parts) < 3 or parts[2] not in FS_FAULT_MODES:
                raise ValueError(
                    f"fs rule {text!r} needs a mode in {FS_FAULT_MODES} "
                    f"('fs:<site>:<mode>[:<prob>]')")
            prob = float(parts[3]) if len(parts) > 3 else 1.0
            return _FaultRule("fs", parts[1], prob=prob, fs_mode=parts[2])
        if action == "partition":
            a, sep, b = parts[1].partition("|")
            if not sep or not a.strip() or not b.strip():
                raise ValueError(
                    f"partition rule {text!r} needs two group names "
                    f"('partition:<a>|<b>[:<prob>]')")
            prob = float(parts[2]) if len(parts) > 2 else 1.0
            return _FaultRule("partition", "*", prob=prob,
                              group_a=a.strip(), group_b=b.strip())
        method = parts[1]
        if action == "delay":
            if len(parts) < 3:
                raise ValueError(f"delay rule {text!r} needs milliseconds")
            return _FaultRule("delay", method,
                             prob=float(parts[3]) if len(parts) > 3 else 1.0,
                             delay_s=float(parts[2]) / 1000.0)
        prob = float(parts[2]) if len(parts) > 2 else 1.0
        return _FaultRule(action, method, prob=prob)

    # ------------------------------------------------------- partition API
    def define_group(self, name: str, members) -> None:
        """(Re)define a partition group's membership: node endpoint
        addresses ("host:port") and/or the literal "store"."""
        with self._lock:
            self.groups[name] = set(members)

    def partition(self, group_a: str, group_b: str,
                  prob: float = 1.0) -> "_FaultRule":
        """Install (or re-arm) a partition rule between two named groups
        at runtime — the harness-side sibling of the spec grammar."""
        with self._lock:
            for rule in self.rules:
                if (rule.action == "partition"
                        and {rule.group_a, rule.group_b}
                        == {group_a, group_b}):
                    rule.armed = True
                    rule.prob = prob
                    return rule
            rule = _FaultRule("partition", "*", prob=prob,
                              group_a=group_a, group_b=group_b)
            self.rules.append(rule)
            return rule

    # ------------------------------------------------------ filesystem API
    def fs(self, site: str, mode: str, prob: float = 1.0) -> "_FaultRule":
        """Install (or re-arm) an fs:<site>:<mode> rule at runtime — the
        harness-side sibling of the spec grammar. Disarm the returned
        rule (.armed = False) to close the fault window."""
        if mode not in FS_FAULT_MODES:
            raise ValueError(f"fs mode {mode!r} not in {FS_FAULT_MODES}")
        with self._lock:
            for rule in self.rules:
                if (rule.action == "fs" and rule.method == site
                        and rule.fs_mode == mode):
                    rule.armed = True
                    rule.prob = prob
                    return rule
            rule = _FaultRule("fs", site, prob=prob, fs_mode=mode)
            self.rules.append(rule)
            return rule

    def fs_fault(self, site: str) -> Optional[str]:
        """Evaluate fs rules at a named storage-IO site; returns the fault
        mode to inject ("enospc"/"eio"/"torn"/"bitflip") or None. First
        armed matching rule that passes its probability roll wins."""
        for rule in self.rules:
            if rule.action != "fs" or not rule.matches(site):
                continue
            with self._lock:
                if not rule.armed:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.hits += 1
                self.stats["fs"] += 1
            return rule.fs_mode
        return None

    def heal(self) -> int:
        """Heal every partition: disarm all partition rules (other rule
        kinds are untouched — partitions compose with drop/delay/sever).
        Returns the number of rules disarmed."""
        healed = 0
        with self._lock:
            for rule in self.rules:
                if rule.action == "partition" and rule.armed:
                    rule.armed = False
                    healed += 1
        if healed:
            logger.warning("fault injection: %d partition rule(s) healed",
                           healed)
        return healed

    def _partition_severed(self, rule: "_FaultRule", origin: Optional[str],
                           dest: Optional[str]) -> bool:
        """Does (origin -> dest) straddle this rule's two groups? Unknown
        sides (None, or an address in neither group) never match."""
        if origin is None or dest is None:
            return False
        a = self.groups.get(rule.group_a, ())
        b = self.groups.get(rule.group_b, ())
        return ((origin in a and dest in b)
                or (origin in b and dest in a))

    def partition_drop(self, origin: Optional[str],
                       dest: Optional[str]) -> bool:
        """THE partition evaluator — shared by client sends (on_send) and
        boundaries that are not client sends (server->client pushes, e.g.
        GCS pubsub fan-out). True when the (origin, dest) pair is
        currently blackholed: a blackhole, not a cut — connections stay
        up and every message into them is lost, the asymmetric-
        reachability model. Never raises."""
        for rule in self.rules:
            if rule.action != "partition" or not rule.armed:
                continue
            if not self._partition_severed(rule, origin, dest):
                continue
            with self._lock:
                if not rule.armed:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.hits += 1
                self.stats["partition"] += 1
            return True
        return False

    def on_send(self, method: str, client: Optional["RpcClient"],
                origin: Optional[str] = None,
                dest: Optional[str] = None) -> Optional[str]:
        """Apply matching rules; returns "drop" when the message must be
        lost, raises RpcDisconnected after severing the connection.
        `client` may be None for socket-less named injection points
        (`fault_point`): sever then cuts nothing but still raises.
        `origin`/`dest` resolve partition sidedness (defaulted from the
        client's origin label and dialed address); partitions are judged
        first — a blackholed send never reaches the per-method rules."""
        if client is not None:
            if origin is None:
                origin = client.origin
            if dest is None:
                dest = client.address
        if self.partition_drop(origin, dest):
            return "drop"
        for rule in self.rules:
            if (rule.action in ("partition", "fs")
                    or not rule.matches(method)):
                continue
            with self._lock:
                if not rule.armed:
                    continue
                fire = rule.prob >= 1.0 or self._rng.random() < rule.prob
                if not fire:
                    continue
                rule.hits += 1
                if rule.action == "sever_once":
                    rule.armed = False
            if rule.action == "delay":
                self.stats["delay"] += 1
                time.sleep(rule.delay_s)
            elif rule.action == "drop":
                self.stats["drop"] += 1
                return "drop"
            else:  # sever / sever_once
                self.stats["sever"] += 1
                addr = "(no socket)"
                if client is not None:
                    client.close()
                    addr = client.address
                raise RpcDisconnected(
                    f"[fault-injection seed={self.seed}] severed "
                    f"{method} to {addr}")
        return None


def read_gcs_address_file() -> Optional[str]:
    """The published GCS address from config `gcs_address_file`, or None
    when unset/unreadable/empty — the shared first hop of every
    control-plane re-resolution chain (raylet, worker, driver). The writer
    (GcsServer._write_address_file) swaps atomically through an fsynced
    tmp file, and an empty/whitespace read here means "no answer yet —
    retry with the last-known address", never "connect to ''": together
    they make a reader racing a mid-failover writer safe."""
    from ray_tpu_torch.core.config import get_config

    path = get_config().gcs_address_file
    if not path:
        return None
    try:
        with open(path) as f:
            addr = f.read().strip()
    except OSError:
        return None
    return addr or None


_fault_injector: Optional[FaultInjector] = None
_fault_checked = False
_fault_lock = threading.Lock()


def install_fault_injector(spec: str, seed: int = 0,
                           groups: Optional[Dict[str, set]] = None
                           ) -> FaultInjector:
    """Programmatic injection for in-process tests. Returns the injector
    (its .stats/.rules expose hit counts for assertions). `groups` seeds
    partition group membership (see FaultInjector.define_group)."""
    global _fault_injector, _fault_checked
    inj = FaultInjector(spec, seed, groups=groups)
    with _fault_lock:
        _fault_injector = inj
        _fault_checked = True
    logger.warning("fault injection ACTIVE: spec=%r seed=%d "
                   "(reproduce with RAY_TPU_TORCH_FAULT_INJECTION_SPEC/"
                   "RAY_TPU_TORCH_FAULT_INJECTION_SEED)", spec, seed)
    return inj


def fault_point(name: str, origin: Optional[str] = None,
                dest: Optional[str] = None) -> None:
    """Named, socket-less injection point for boundaries that are not a
    single RPC send (e.g. the serve router's replica-call submission,
    name `serve_replica_call`). Rules target it exactly like an RPC
    method: `drop`/`sever`/`sever_once` raise RpcDisconnected here (the
    caller's failover path takes over), `delay` stalls the caller. A
    no-op (zero overhead beyond one None check) without an injector.
    `origin`/`dest` give partition rules a sidedness to judge (e.g. the
    head's lease renewal passes origin=<head address>, dest="store")."""
    inj = get_fault_injector()
    if inj is None:
        return
    if inj.on_send(name, None, origin=origin, dest=dest) == "drop":
        raise RpcDisconnected(
            f"[fault-injection seed={inj.seed}] dropped {name}")


def fs_fault(site: str) -> Optional[str]:
    """Named filesystem injection point (sites: spill_write,
    spill_restore). Returns the fault mode the caller must simulate
    ("enospc"/"eio"/"torn"/"bitflip") or None. Unlike fault_point() this
    never raises — the storage plane turns the mode into the right OSError
    or corruption itself, so the fault exercises the REAL error-handling
    path, not an injected exception type. Zero overhead uninjected."""
    inj = get_fault_injector()
    if inj is None:
        return None
    return inj.fs_fault(site)


def clear_fault_injector() -> None:
    global _fault_injector, _fault_checked
    with _fault_lock:
        _fault_injector = None
        _fault_checked = True


def get_fault_injector() -> Optional[FaultInjector]:
    """The active injector, initializing once from config (env-driven:
    spawned worker processes inherit the spec + seed and print the seed,
    so a failing chaos run is reproducible)."""
    global _fault_injector, _fault_checked
    if _fault_checked:
        return _fault_injector
    with _fault_lock:
        if _fault_checked:
            return _fault_injector
        try:
            from ray_tpu_torch.core.config import get_config

            cfg = get_config()
            if cfg.fault_injection_spec:
                _fault_injector = FaultInjector(cfg.fault_injection_spec,
                                                cfg.fault_injection_seed)
                logger.warning(
                    "fault injection ACTIVE from config: spec=%r seed=%d",
                    cfg.fault_injection_spec, cfg.fault_injection_seed)
        except Exception:
            logger.exception("fault injector init failed; disabled")
        _fault_checked = True
        return _fault_injector

# ------------------------------------------------------ rpc latency metrics
# One central instrumentation site for EVERY request/reply RPC in the
# system (reference: per-service gRPC latency metrics; here the single
# client-send boundary makes one histogram cover them all). Observed on
# the reply via a Future callback, so the send path pays one perf_counter
# read; exported through the standard Prometheus registry and scraped by
# the dashboard like any other series.
_rpc_latency_hist = None


def _observe_rpc_latency(method: str, seconds: float) -> None:
    global _rpc_latency_hist
    try:
        h = _rpc_latency_hist
        if h is None:
            from ray_tpu_torch.util.metrics import get_or_create

            h = _rpc_latency_hist = get_or_create(
                "histogram", "ray_tpu_torch_rpc_latency_seconds",
                "request/reply RPC round-trip latency by method",
                boundaries=(0.0005, 0.002, 0.01, 0.05, 0.25, 1, 5, 30),
                tag_keys=("method",))
        h.observe(seconds, tags={"method": method})
    except Exception:  # metrics must never fail an RPC
        logger.debug("rpc latency observe failed", exc_info=True)


_HDR = struct.Struct("!BQI")  # type, request_id, method-name length


def _encode(msg_type: int, req_id: int, method: str, payload: Any) -> bytes:
    m = method.encode()
    body = pickle.dumps(payload, protocol=5)
    frame = _HDR.pack(msg_type, req_id, len(m)) + m + body
    return struct.pack("!Q", len(frame)) + frame


def _decode(frame: bytes):
    msg_type, req_id, mlen = _HDR.unpack_from(frame, 0)
    off = _HDR.size
    method = frame[off : off + mlen].decode()
    payload = pickle.loads(frame[off + mlen :])
    return msg_type, req_id, method, payload


class RpcDisconnected(ConnectionError):
    pass


class ServerConnection:
    """Server-side view of one client connection; supports pushes."""

    def __init__(self, server: "RpcServer", writer: asyncio.StreamWriter, peer: str):
        self._server = server
        self._writer = writer
        self.peer = peer
        self.ident: Any = None  # set by a `hello` handler if the app wants
        # NODE identity the subscriber declared (subscribe payload
        # "origin"): lets server->client pushes (pubsub fan-out) honor
        # partition rules — a blackholed side gets no pushes either
        self.origin: Optional[str] = None
        self.alive = True
        self.on_close: list[Callable[["ServerConnection"], None]] = []

    def push(self, method: str, payload: Any) -> None:
        """Send a one-way message to the client (thread-safe)."""
        data = _encode(PUSH, 0, method, payload)
        self._server._loop.call_soon_threadsafe(self._write, data)

    def reply(self, req_id: int, payload: Any, is_error: bool = False) -> None:
        data = _encode(ERR if is_error else REP, req_id, "", payload)
        self._server._loop.call_soon_threadsafe(self._write, data)

    def _write(self, data: bytes) -> None:
        if self.alive:
            try:
                self._writer.write(data)
            except (OSError, RuntimeError):  # closed transport/loop
                self.alive = False


class RpcServer:
    """Asyncio RPC server on a dedicated thread.

    Handlers: `fn(conn, payload) -> result` (sync, runs on loop — keep fast)
    or `async fn(conn, payload)`. A handler may return `Deferred` to reply
    later via `conn.reply(req_id, ...)` (used for blocking ops like object
    gets and worker leases).
    """

    class Deferred:
        """Sentinel: handler will reply asynchronously via conn.reply(req_id)."""

    DEFERRED = Deferred()

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._requested_port = port
        self._handlers: Dict[str, Callable] = {}
        self._loop: asyncio.AbstractEventLoop = None  # type: ignore
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: int = 0
        self.connections: list[ServerConnection] = []
        self._started = threading.Event()
        self._stopped = False

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    def register(self, method: str, fn: Callable) -> None:
        self._handlers[method] = fn

    def register_all(self, obj: Any, prefix: str = "") -> None:
        """Register every `rpc_*` method of `obj` under its suffix name."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.register(prefix + name[4:], getattr(obj, name))

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="rpc-server", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("RPC server failed to start")

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def _serve():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, self._requested_port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        self._loop.run_until_complete(_serve())
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.run_until_complete(self._loop.shutdown_asyncgens())
            except RuntimeError:
                pass  # loop already stopping
            self._loop.close()

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = str(writer.get_extra_info("peername"))
        conn = ServerConnection(self, writer, peer)
        self.connections.append(conn)
        try:
            while True:
                hdr = await reader.readexactly(8)
                (n,) = struct.unpack("!Q", hdr)
                frame = await reader.readexactly(n)
                msg_type, req_id, method, payload = _decode(frame)
                handler = self._handlers.get(method)
                if handler is None:
                    if msg_type == REQ:
                        conn.reply(req_id, f"no such method: {method}", is_error=True)
                    continue
                try:
                    if asyncio.iscoroutinefunction(handler):
                        result = await handler(conn, req_id, payload)
                    else:
                        result = handler(conn, req_id, payload)
                    if msg_type == REQ and not isinstance(result, RpcServer.Deferred):
                        conn.reply(req_id, result)
                except Exception as e:  # handler error -> error reply
                    logger.exception("handler %s failed", method)
                    if msg_type == REQ:
                        import traceback

                        conn.reply(req_id, f"{e}\n{traceback.format_exc()}", is_error=True)
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            if not self._stopped:
                logger.exception("connection error from %s", peer)
        finally:
            conn.alive = False
            try:
                self.connections.remove(conn)
            except ValueError:
                pass
            for cb in conn.on_close:
                try:
                    cb(conn)
                except Exception:
                    logger.exception("on_close callback failed")
            try:
                writer.close()
            except OSError:
                pass

    def call_soon(self, fn: Callable, *args) -> None:
        """Schedule `fn` on the server loop (thread-safe)."""
        self._loop.call_soon_threadsafe(fn, *args)

    def call_later(self, delay: float, fn: Callable, *args):
        return self._loop.call_soon_threadsafe(
            lambda: self._loop.call_later(delay, fn, *args)
        )

    def stop(self) -> None:
        self._stopped = True
        if self._loop and self._loop.is_running():
            def _shutdown():
                if self._server:
                    self._server.close()
                for conn in list(self.connections):
                    conn.alive = False
                    try:
                        conn._writer.close()
                    except OSError:
                        pass
                self._loop.stop()
            try:
                self._loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass
        if self._thread:
            self._thread.join(timeout=5)


class RpcClient:
    """Thread-safe synchronous client with pipelining and push dispatch."""

    def __init__(self, address: str, push_handler: Optional[Callable[[str, Any], None]] = None,
                 connect_timeout: float = 30.0, on_disconnect: Optional[Callable[[], None]] = None,
                 origin: Optional[str] = None):
        host, port = address.rsplit(":", 1)
        self.address = address
        # NODE identity of this client's owner (a daemon's own server
        # address; a worker's/driver's raylet address) — what partition
        # rules use to decide which side of a net split a send starts from
        self.origin = origin
        self._sock = socket.create_connection((host, int(port)), timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._push_handler = push_handler
        self._on_disconnect = on_disconnect
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, name="rpc-client-reader", daemon=True)
        self._reader.start()

    def _read_loop(self):
        f = self._sock.makefile("rb")
        try:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                (n,) = struct.unpack("!Q", hdr)
                frame = f.read(n)
                if len(frame) < n:
                    break
                msg_type, req_id, method, payload = _decode(frame)
                if msg_type == PUSH:
                    if self._push_handler is not None:
                        try:
                            self._push_handler(method, payload)
                        except Exception:
                            logger.exception("push handler failed for %s", method)
                else:
                    fut = self._pending.pop(req_id, None)
                    if fut is not None:
                        if msg_type == ERR:
                            fut.set_exception(RpcCallError(str(payload)))
                        else:
                            fut.set_result(payload)
        except Exception:
            if not self._closed:
                logger.debug("rpc client read loop ended", exc_info=True)
        finally:
            self._closed = True
            err = RpcDisconnected(f"connection to {self.address} lost")
            for fut in list(self._pending.values()):
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            if self._on_disconnect is not None:
                try:
                    self._on_disconnect()
                except Exception:
                    pass

    def _send(self, data: bytes) -> None:
        if self._closed:
            raise RpcDisconnected(f"connection to {self.address} closed")
        with self._wlock:
            self._sock.sendall(data)

    def call_future(self, method: str, payload: Any = None) -> Future:
        inj = get_fault_injector()
        if inj is not None and inj.on_send(method, self) == "drop":
            # the request never reaches the wire: to the caller that is a
            # lost link (no reply would ever arrive)
            raise RpcDisconnected(
                f"[fault-injection seed={inj.seed}] dropped call "
                f"{method} to {self.address}")
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        fut: Future = Future()
        self._pending[req_id] = fut
        try:
            self._send(_encode(REQ, req_id, method, payload))
        except Exception:
            self._pending.pop(req_id, None)
            raise
        t0 = time.perf_counter()
        fut.add_done_callback(
            lambda f, m=method, t=t0: _observe_rpc_latency(
                m, time.perf_counter() - t))
        return fut

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        return self.call_future(method, payload).result(timeout=timeout)

    def notify(self, method: str, payload: Any = None) -> None:
        """One-way message (no response expected)."""
        inj = get_fault_injector()
        if inj is not None and inj.on_send(method, self) == "drop":
            return  # one-way message silently lost, like the real fault
        self._send(_encode(PUSH, 0, method, payload))

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected / already reset
        try:
            self._sock.close()
        except OSError:
            pass


class RpcCallError(RuntimeError):
    """Remote handler raised; message contains remote traceback."""


class ReconnectingClient:
    """Client that transparently re-establishes a lost connection (reference
    retryable gRPC clients, `src/ray/rpc/grpc_util.h`): `call()` retries
    across one reconnect, `notify()` is best-effort, and `on_reconnect(raw)`
    replays session state (registrations, subscriptions) on every fresh
    connection before other calls proceed. Built for long-lived links to the
    control plane, which may restart (GCS fault tolerance) or be REPLACED on
    a new address (control-plane HA): `resolve()` — when given — is invoked
    before every connection attempt and may return an updated address (from
    the GCS address file, an in-band announce, or the local raylet), so the
    link follows the head wherever it comes back. Reconnect attempts sleep
    with exponential backoff + full jitter (util/backoff.py): a replacement
    head sees the whole fleet re-register without a synchronized stampede."""

    def __init__(self, address: str,
                 push_handler: Optional[Callable[[str, Any], None]] = None,
                 timeout: float = 30.0,
                 on_reconnect: Optional[Callable[["RpcClient"], None]] = None,
                 reconnect_timeout: float = 30.0,
                 resolve: Optional[Callable[[], Optional[str]]] = None,
                 origin: Optional[str] = None):
        self.address = address
        self.origin = origin
        self._push_handler = push_handler
        self._on_reconnect = on_reconnect
        self._reconnect_timeout = reconnect_timeout
        self._resolve = resolve
        self._lock = threading.Lock()
        self._closed = False
        self._reconnecting = False
        self._client = self._connect(timeout)

    def _backoff(self):
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.util.backoff import ExponentialBackoff

        cfg = get_config()
        return ExponentialBackoff(
            base_s=cfg.reconnect_backoff_base_ms / 1000.0,
            cap_s=cfg.reconnect_backoff_cap_ms / 1000.0)

    def _resolved_address(self) -> str:
        if self._resolve is not None:
            try:
                addr = self._resolve()
            except Exception:
                logger.debug("address resolve failed; keeping %s",
                             self.address, exc_info=True)
                addr = None
            if addr and addr != self.address:
                logger.info("control-plane address re-resolved: %s -> %s",
                            self.address, addr)
                self.address = addr
        return self.address

    def _connect(self, timeout: float) -> RpcClient:
        # Eager recovery: a drop triggers a background reconnect so even a
        # process that never initiates calls (an idle actor worker) promptly
        # re-registers with a restarted control plane. The address is
        # RE-resolved on every attempt — a head replacement may publish its
        # new address while we are mid-retry against the old one.
        deadline = time.monotonic() + timeout
        backoff = self._backoff()
        last: Exception | None = None
        while True:
            addr = self._resolved_address()
            try:
                return RpcClient(
                    addr, push_handler=self._push_handler,
                    on_disconnect=self._schedule_reconnect,
                    connect_timeout=min(timeout, 5.0),
                    origin=self.origin)
            except (ConnectionRefusedError, OSError) as e:
                last = e
            remaining = deadline - time.monotonic()
            if self._closed or remaining <= 0:
                raise ConnectionError(
                    f"could not connect to {self.address} within "
                    f"{timeout}s: {last}")
            time.sleep(min(max(0.02, backoff.next_delay()), remaining))

    def _schedule_reconnect(self) -> None:
        if self._closed or self._reconnecting:
            return

        def run():
            self._reconnecting = True
            try:
                backoff = self._backoff()
                backoff.sleep()
                while not self._closed:
                    try:
                        self._live_client()
                        return
                    except Exception:
                        backoff.sleep()
            finally:
                self._reconnecting = False

        threading.Thread(target=run, name="rpc-reconnect", daemon=True).start()

    def _live_client(self) -> RpcClient:
        cli = self._client
        if cli is not None and not cli.closed:
            return cli
        with self._lock:
            if self._closed:
                raise RpcDisconnected(f"client to {self.address} closed")
            cli = self._client
            if cli is not None and not cli.closed:
                return cli
            cli = self._connect(self._reconnect_timeout)
            try:
                if self._closed:
                    # close() raced the reconnect: never install or register
                    # a connection for a torn-down component (ghost nodes).
                    raise RpcDisconnected(f"client to {self.address} closed")
                # Replay registrations while holding the lock so concurrent
                # calls can't race ahead of re-registration on the new link.
                # A FAILED replay must not install the client: the process
                # would be connected-but-unregistered forever (heartbeats
                # accepted, node absent from the cluster view).
                if self._on_reconnect is not None:
                    self._on_reconnect(cli)
            except Exception:
                cli.close()
                raise
            self._client = cli
            return cli

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None) -> Any:
        for attempt in (0, 1):
            try:
                return self._live_client().call(method, payload, timeout=timeout)
            except RpcDisconnected:
                if attempt:
                    raise
        raise RpcDisconnected(f"call {method} to {self.address} failed")

    def notify(self, method: str, payload: Any = None) -> None:
        """Best-effort AND non-blocking: while the link is down the message
        is dropped and a background reconnect is kicked off — callers are
        fire-and-forget paths (task events, resource reports) that must
        never stall an exec thread or RPC loop for a connect timeout."""
        self.try_notify(method, payload)

    def try_notify(self, method: str, payload: Any = None) -> bool:
        """notify() that reports whether the message reached the socket:
        False means the link is down (message dropped, background reconnect
        kicked) so the caller can requeue. Still non-blocking; a write that
        lands in a dying socket's buffer may yet be lost — this detects the
        common down-link window (e.g. a GCS restart), not every loss."""
        cli = self._client
        if cli is None or cli.closed:
            self._schedule_reconnect()
            return False
        try:
            cli.notify(method, payload)
            return True
        except Exception:
            self._schedule_reconnect()
            return False

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        # Deliberately not taking _lock: an in-flight reconnect may hold it
        # for a full connect timeout; it re-checks _closed post-connect and
        # self-closes instead of installing.
        self._closed = True
        cli = self._client
        if cli is not None:
            cli.close()


def connect_with_retry(address: str, timeout: float = 30.0, **kw) -> RpcClient:
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            return RpcClient(address, **kw)
        except (ConnectionRefusedError, OSError) as e:
            last = e
            time.sleep(0.05)
    raise ConnectionError(f"could not connect to {address} within {timeout}s: {last}")
