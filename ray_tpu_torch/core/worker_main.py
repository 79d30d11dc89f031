"""Worker process entry point.

Equivalent of the reference's `python/ray/_private/workers/default_worker.py`
(entry `:165`): spawned by the raylet's worker pool, connects back, then
serves tasks until told to exit.

Two spawn modes share this module:

* cold: `python -m ray_tpu_torch.core.worker_main --raylet ... --gcs ...` boots a
  fresh interpreter per worker (the classic path, and the fallback).
* warm: `--template` parks a fork-template ("zygote") process that preloads
  the heavy imports once and `os.fork()`s a ready worker per granted lease
  (see `worker_pool.py`); each forked child runs the same `run_worker`
  body a cold worker runs.
"""

from __future__ import annotations

import argparse
import logging
import time


def run_worker(raylet_address: str, gcs_address: str,
               log_level: str = "WARNING") -> None:
    """The worker body proper: connect, register, serve until the raylet
    link drops. Runs in cold-spawned processes AND in children forked from
    a template — keep it free of assumptions about interpreter freshness
    beyond what `worker_pool._forked_child_main` resets."""
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s %(levelname)s worker %(name)s: %(message)s",
    )

    # `ray_tpu_torch stack` support: SIGUSR1 dumps every thread's Python stack to
    # a per-pid file (reference `ray stack` uses py-spy; this is dep-free)
    import faulthandler
    import os
    import signal

    import tempfile

    stack_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "stacks")
    os.makedirs(stack_dir, exist_ok=True)
    _stack_file = open(os.path.join(stack_dir, f"{os.getpid()}.txt"), "w")
    faulthandler.register(signal.SIGUSR1, file=_stack_file, all_threads=True)

    # Tee stdout/stderr to the raylet so drivers see task prints
    # (reference log_monitor tail-to-driver). Installed BEFORE the worker
    # connects — tasks can start executing the moment registration lands,
    # so lines buffer until the raylet client exists. logging handlers keep
    # their original stream objects, so runtime logs don't recurse.
    import sys as _sys

    import threading as _threading

    class _Tee:
        def __init__(self, stream, name):
            self._stream = stream
            self._name = name
            self._buf = ""
            self._pending = []
            self._lock = _threading.Lock()
            self.raylet = None  # set once connected

        def write(self, data):
            self._stream.write(data)
            with self._lock:
                self._buf += data
                if "\n" not in self._buf:
                    return
                *lines, self._buf = self._buf.split("\n")
                self._pending.extend(ln for ln in lines if ln.strip())
            self._drain()

        def _current_job(self):
            from ray_tpu_torch.core.worker import current_worker

            w = current_worker()
            if w is None:
                return None
            jid = getattr(w._tls, "job_id", None)
            return jid.binary() if jid is not None else None

        def _drain(self):
            with self._lock:
                if self.raylet is None or not self._pending:
                    return
                lines, self._pending = self._pending, []
            try:
                self.raylet.notify("worker_log", {
                    "pid": os.getpid(), "stream": self._name, "lines": lines,
                    "job_id": self._current_job()})
            except Exception:
                pass

        def flush(self):
            self._stream.flush()

        def __getattr__(self, name):
            return getattr(self._stream, name)

    out_tee = _Tee(_sys.stdout, "stdout")
    err_tee = _Tee(_sys.stderr, "stderr")
    _sys.stdout = out_tee
    _sys.stderr = err_tee

    from ray_tpu_torch.core.worker import CoreWorker, set_current_worker

    try:
        worker = CoreWorker(
            mode="worker", raylet_address=raylet_address,
            gcs_address=gcs_address, connect_timeout=10.0)
    except ConnectionError:
        return  # raylet is gone (e.g. shut down while we were starting)
    set_current_worker(worker)
    out_tee.raylet = err_tee.raylet = worker.raylet
    out_tee._drain()
    err_tee._drain()

    # Serve until the raylet connection drops (raylet died or killed us).
    try:
        while not worker.raylet.closed:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet", required=True)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--log-level", default="WARNING")
    parser.add_argument("--template", action="store_true",
                        help="run as a fork-template (zygote) process")
    parser.add_argument("--reply-fd", type=int, default=-1,
                        help="inherited fd for template protocol replies")
    args = parser.parse_args()

    if args.template:
        from ray_tpu_torch.core.worker_pool import template_main

        template_main(args)
        return
    run_worker(args.raylet, args.gcs, log_level=args.log_level)


if __name__ == "__main__":
    main()
