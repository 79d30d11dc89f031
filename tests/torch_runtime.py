"""Helpers of the port's runtime tests (tests/test_torch_runtime_*.py):
booting ray_tpu and ray_tpu_torch side by side in the pytest process, and
reading which file backs an address. tests/conftest.py stays the JAX
package's."""

import contextlib
import gc
import signal
import subprocess
import sys
import time

import ray_tpu
import ray_tpu_torch
from ray_tpu.core import exceptions as _ref_exc
from ray_tpu_torch.core import exceptions as _port_exc


@contextlib.contextmanager
def both_runtimes(num_cpus: int, accelerators: int):
    """One node of each runtime, alive together: ray_tpu with `accelerators`
    TPU chips, the port with as many GPUs. Yields ray_tpu's init info and
    the port's."""
    ref = ray_tpu.init(num_cpus=num_cpus, resources={"TPU": accelerators})
    try:
        port = ray_tpu_torch.init(num_cpus=num_cpus,
                                  resources={"GPU": accelerators})
        try:
            yield ref, port
        finally:
            ray_tpu_torch.shutdown()
    finally:
        ray_tpu.shutdown()


@contextlib.contextmanager
def one_runtime(rt, **init_kwargs):
    """`rt.init(**init_kwargs)` for the block, then `rt.shutdown()`."""
    info = rt.init(**init_kwargs)
    try:
        yield info
    finally:
        rt.shutdown()


# what a program sees when one of its workers dies; a program that records
# exception types as results lets these through, so a kill is never a result
KILLED = (_ref_exc.ActorDiedError, _ref_exc.WorkerCrashedError,
          _port_exc.ActorDiedError, _port_exc.WorkerCrashedError)
RERUNS = []  # (program, error) of every rerun, in order


def _canary():
    """A process whose command line matches `pkill -f worker_main`."""
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(3600)",
         "worker_main-canary"], stdin=subprocess.DEVNULL)


def rerun_if_killed(program, *args):
    """`program(*args)`, run once more only if a worker it used was killed
    from outside: tests/test_client.py ends with `pkill -f worker_main`,
    which reaches every worker of both runtimes on the host, whichever
    test runs beside it. A canary process whose command line matches that
    pattern runs beside the program; a dead worker counts as killed from
    outside only when the canary died of SIGTERM too. Any other death
    (a crash of the worker itself) fails the test. Each rerun is logged
    and kept in RERUNS. A program that kills its own workers catches
    those errors itself."""
    canary = _canary()
    try:
        return program(*args)
    except KILLED as e:
        try:
            rc = canary.wait(timeout=5)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != -signal.SIGTERM:
            raise
        RERUNS.append((program.__name__, repr(e)))
        print(f"rerun {len(RERUNS)}: {program.__name__} lost a worker to an "
              f"outside pkill ({e!r})", file=sys.stderr)
    finally:
        canary.kill()
        canary.wait()
    _settle()
    return program(*args)


def rerun_if_pkilled(program, *args, reset=None):
    """`program(*args)`, run once more whenever an outside `pkill -f
    worker_main` (see `rerun_if_killed`) struck while it ran, whatever the
    first run returned or raised: a Serve program loses its controller,
    replicas and proxies to such a kill and sees timeouts or failed
    requests, not only the errors in KILLED. `reset()` runs before the
    rerun (e.g. `serve.shutdown`). Any outcome without such a kill stands."""
    canary = _canary()
    try:
        try:
            out, err = program(*args), None
        except Exception as e:
            out, err = None, e
        try:
            rc = canary.wait(timeout=5) if err is not None else canary.poll()
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        canary.kill()
        canary.wait()
    if rc != -signal.SIGTERM:
        if err is not None:
            raise err
        return out
    RERUNS.append((program.__name__, repr(err)))
    print(f"rerun {len(RERUNS)}: {program.__name__} ran through an outside "
          f"pkill ({err!r})", file=sys.stderr)
    _settle()
    if reset is not None:
        reset()
    return program(*args)


def _settle(timeout: float = 30.0):
    """After an outside pkill: let each live runtime see its dead workers
    and take back what they held (the failed run's actors included, once
    their handles are collected) before a program runs again."""
    gc.collect()
    time.sleep(2.0)
    deadline = time.monotonic() + timeout
    for rt in (ray_tpu, ray_tpu_torch):
        while rt.is_initialized() and time.monotonic() < deadline:
            total, free = rt.cluster_resources(), rt.available_resources()
            if all(free.get(k, 0.0) >= v for k, v in total.items()
                   if k in ("CPU", "GPU", "TPU")):
                break
            time.sleep(0.1)


def mapping_of(address: int):
    """The file /proc/self/maps says backs `address`, or None."""
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            if lo <= address < hi:
                return parts[5] if len(parts) > 5 else None
    return None
