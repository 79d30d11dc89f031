"""Job submission: run an entrypoint command on the cluster, supervised.

Mirrors the reference's job flow (`dashboard/modules/job/job_manager.py:507`:
submit -> detached JobSupervisor actor runs the shell entrypoint, streams
logs, records JobInfo): here the supervisor is a plain named actor and job
records live in the GCS KV.

The port's names are its own: the entrypoint finds its cluster through
`RAY_TPU_TORCH_ADDRESS`, records live under the port's KV namespace, and
job ids start with `rtt-job-`. The supervisor holds no CPU and no GPU and
never touches CUDA; an entrypoint asks for a card through its own tasks
and actors (`num_gpus=1`).
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_KV_NS = "ray_tpu_torch_job_submission"
JOB_ID_PREFIX = "rtt-job-"


@ray_tpu_torch.remote
class JobSupervisor:
    """Runs one entrypoint subprocess and captures its output."""

    def __init__(self, job_id: str, entrypoint: str,
                 working_dir: Optional[str], env_vars: Optional[dict]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.working_dir = working_dir
        self.env_vars = env_vars or {}
        self._proc: Optional[subprocess.Popen] = None
        self._log = bytearray()
        self._log_lock = threading.Lock()
        self._log_cap = 16 * 1024 * 1024  # rolling: keep the newest 16 MiB
        self._reader: Optional[threading.Thread] = None
        self._status = "PENDING"

    def start(self, gcs_address: str) -> str:
        env = dict(os.environ)
        env.update({k: str(v) for k, v in self.env_vars.items()})
        env["RAY_TPU_TORCH_ADDRESS"] = gcs_address
        self._proc = subprocess.Popen(
            self.entrypoint, shell=True, cwd=self.working_dir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        # Drain stdout continuously so (a) `logs()` works while the job is
        # RUNNING and (b) a chatty job can never block on a full pipe
        # (reference streams logs while running: job_manager.py:820).
        self._reader = threading.Thread(
            target=self._drain, args=(self._proc.stdout,), daemon=True)
        self._reader.start()
        self._status = "RUNNING"
        return self._status

    def _drain(self, pipe) -> None:
        try:
            # read1: returns as soon as any bytes are available (plain
            # read(n) would block until the full n bytes or EOF).
            for chunk in iter(lambda: pipe.read1(65536), b""):
                with self._log_lock:
                    self._log += chunk
                    if len(self._log) > self._log_cap:
                        del self._log[:len(self._log) - self._log_cap]
        except (OSError, ValueError):
            pass  # pipe closed mid-read during stop()
        finally:
            try:
                pipe.close()
            except OSError:
                pass

    def poll(self) -> str:
        if self._proc is None:
            return self._status
        rc = self._proc.poll()
        if rc is None:
            return "RUNNING"
        if self._status in ("RUNNING",):
            if self._reader is not None:
                self._reader.join(timeout=5)
            self._status = "SUCCEEDED" if rc == 0 else "FAILED"
        return self._status

    def logs(self) -> str:
        self.poll()
        with self._log_lock:
            return self._log.decode(errors="replace")

    def stop(self) -> bool:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            self._status = "STOPPED"
            return True
        return False


class JobSubmissionClient:
    """Client API (reference `python/ray/job_submission/`)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        from ray_tpu_torch.core.api import _global_worker

        self._worker = _global_worker()

    def _kv(self, method: str, **payload):
        payload["namespace"] = _KV_NS
        return self._worker.gcs.call(f"kv_{method}", payload)

    def submit_job(self, *, entrypoint: str, working_dir: Optional[str] = None,
                   env_vars: Optional[dict] = None,
                   submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"{JOB_ID_PREFIX}{uuid.uuid4().hex[:10]}"
        supervisor = JobSupervisor.options(
            name=f"_job_supervisor:{job_id}", num_cpus=0).remote(
            job_id, entrypoint, working_dir, env_vars)
        ray_tpu_torch.get(supervisor.start.remote(self._worker.gcs_address))
        self._kv("put", key=job_id.encode(), value={
            "job_id": job_id, "entrypoint": entrypoint,
            "submit_time": time.time()})
        return job_id

    def _supervisor(self, job_id: str):
        return ray_tpu_torch.get_actor(f"_job_supervisor:{job_id}")

    def get_job_status(self, job_id: str) -> str:
        try:
            return ray_tpu_torch.get(self._supervisor(job_id).poll.remote())
        except ValueError:
            return "UNKNOWN"

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._supervisor(job_id).logs.remote())

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._supervisor(job_id).stop.remote())

    def list_jobs(self) -> List[Dict[str, Any]]:
        keys = self._kv("keys", prefix=b"")
        return [self._kv("get", key=k) for k in keys]

    def wait_until_finish(self, job_id: str, timeout: float = 300) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.5)
        return self.get_job_status(job_id)
