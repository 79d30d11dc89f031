"""Cluster launcher: `python -m ray_tpu_torch up / down / exec / attach /
submit` over a cluster YAML.

Mirrors the reference's cluster launcher (`python/ray/scripts/scripts.py:
1223-1443` + `autoscaler/_private/command_runner.py`): the head runs on the
INVOKING machine (a laptop, a CPU VM in the GPU hosts' VPC, or a GPU host
itself), and workers come from a NodeProvider — in-process raylets from
FakeNodeProvider for tests/dev, or GPU VMs from GceGpuNodeProvider whose
cloud STARTUP SCRIPTS join each host to the head (the role SSH
bootstrapping plays in the reference; no SSH loop to babysit).

Cluster YAML:

    cluster_name: demo
    provider:
      type: fake            # or: gce (+ project: ..., zone: ...)
    head:
      num_cpus: 4           # resources for the head node's raylet
      resources: {GPU: 1}   # the head's own cards, if it has any
      gcs_port: 6380        # fixed so worker startup scripts can join
    workers:
      count: 2
      node_type: h100-8
      resources: {GPU: 8, CPU: 8}

State (head pid, GCS address, provider node ids) persists under
`~/.ray_tpu_torch/clusters/<name>.json` (or `$RAY_TPU_TORCH_CLUSTERS_DIR`)
so `down`/`exec`/`attach` find the cluster from any later invocation.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_STATE_ROOT = (os.environ.get("RAY_TPU_TORCH_CLUSTERS_DIR")
               or os.path.expanduser("~/.ray_tpu_torch/clusters"))


@dataclass
class ClusterConfig:
    cluster_name: str
    provider: Dict[str, Any] = field(default_factory=lambda: {"type": "fake"})
    head: Dict[str, Any] = field(default_factory=dict)
    workers: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "ClusterConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if "cluster_name" not in raw:
            raise ValueError(f"{path}: cluster_name is required")
        return cls(cluster_name=str(raw["cluster_name"]),
                   provider=dict(raw.get("provider") or {"type": "fake"}),
                   head=dict(raw.get("head") or {}),
                   workers=dict(raw.get("workers") or {}))


def _state_path(name: str) -> str:
    return os.path.join(_STATE_ROOT, f"{name}.json")


def load_state(name: str) -> Dict[str, Any]:
    with open(_state_path(name)) as f:
        return json.load(f)


class ClusterLauncher:
    """One cluster's lifecycle. `up()` brings the head + workers to an
    N-node cluster and returns the state dict; the launcher object owns
    FakeNodeProvider raylets, so keep it alive for fake clusters."""

    def __init__(self, config: ClusterConfig):
        self.config = config
        self.provider = None
        self._head_proc: Optional[subprocess.Popen] = None
        self.state: Dict[str, Any] = {}

    # --------------------------------------------------------------- head
    @staticmethod
    def _primary_ip() -> str:
        """This machine's outbound IP — the address cloud workers can
        reach the head on (the classic UDP-connect trick; nothing is
        sent)."""
        import socket

        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def _start_head(self) -> str:
        head = self.config.head
        is_cloud = self.config.provider.get("type") == "gce"
        args = [sys.executable, "-m", "ray_tpu_torch", "start", "--head"]
        if head.get("gcs_port"):
            args += ["--gcs-port", str(head["gcs_port"])]
        if is_cloud or head.get("host"):
            # cloud workers join over the network: bind beyond loopback
            args += ["--gcs-host", head.get("host", "0.0.0.0")]
        if head.get("num_cpus") is not None:
            args += ["--num-cpus", str(head["num_cpus"])]
        if head.get("resources"):
            args += ["--resources", json.dumps(head["resources"])]
        if head.get("snapshot_path"):
            args += ["--snapshot-path", head["snapshot_path"]]
        # `python -m ray_tpu_torch` must resolve regardless of the invoking
        # cwd:
        # export the package's parent onto PYTHONPATH (source checkouts;
        # harmless for installed packages)
        import ray_tpu_torch as _pkg

        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        # head output goes to a LOG FILE, not a pipe: the daemon must
        # outlive a non-blocking `up` (a dead pipe reader would kill it on
        # its next write), and file polling gives a real startup timeout
        os.makedirs(_STATE_ROOT, exist_ok=True)
        log_path = os.path.join(_STATE_ROOT,
                                f"{self.config.cluster_name}-head.log")
        log_f = open(log_path, "w")
        try:
            self._head_proc = subprocess.Popen(
                args, stdout=log_f, stderr=subprocess.STDOUT, env=env)
        finally:
            log_f.close()  # the child holds its own descriptor
        deadline = time.monotonic() + 60
        address = None
        while time.monotonic() < deadline and address is None:
            if self._head_proc.poll() is not None:
                break  # head died during startup
            try:
                with open(log_path) as f:
                    for line in f:
                        if "GCS address:" in line:
                            address = line.rsplit("GCS address:", 1)[1].strip()
                            break
            except FileNotFoundError:
                pass
            if address is None:
                time.sleep(0.1)
        if address is None:
            self._head_proc.terminate()  # never leak a half-started head
            try:
                self._head_proc.wait(timeout=10)
            except Exception:
                self._head_proc.kill()
            raise RuntimeError(
                f"head node failed to report a GCS address (see {log_path})")
        host, port = address.rsplit(":", 1)
        if is_cloud and host in ("0.0.0.0", "127.0.0.1"):
            # advertise a routable address to worker startup scripts
            host = head.get("advertise_ip") or self._primary_ip()
        return f"{host}:{port}"

    def _make_provider(self, gcs_address: str):
        import re

        from ray_tpu_torch.autoscaler.node_provider import (
            FakeNodeProvider, GceGpuNodeProvider)

        p = self.config.provider
        kind = p.get("type", "fake")
        if kind == "fake":
            return FakeNodeProvider(gcs_address)
        if kind == "gce":
            # the cluster's own label value: another cluster's VMs in the
            # same project are not this one's capacity
            label = re.sub(r"[^a-z0-9_-]", "-",
                           self.config.cluster_name.lower())[:63]
            extra = {k: p[k] for k in ("accelerator_types", "machine_types",
                                       "source_image") if k in p}
            return GceGpuNodeProvider(
                project=p["project"], zone=p["zone"],
                gcs_address=gcs_address,
                name_prefix=p.get("name_prefix",
                                  f"ray-tpu-torch-{self.config.cluster_name}"),
                cluster_label=p.get("cluster_label", label),
                request_fn=p.get("request_fn"), **extra)
        raise ValueError(f"unknown provider type {kind!r}")

    # ----------------------------------------------------------------- up
    def up(self, wait_timeout_s: float = 120.0) -> Dict[str, Any]:
        gcs_address = self._start_head()
        self.provider = self._make_provider(gcs_address)
        w = self.config.workers
        count = int(w.get("count", 0))
        node_type = w.get("node_type", "worker")
        resources = dict(w.get("resources") or {"CPU": 1})
        node_ids = [self.provider.create_node(
            node_type, resources, dict(w.get("labels") or {}))
            for _ in range(count)]
        self._wait_for_nodes(gcs_address, count + 1, wait_timeout_s)
        self.state = {
            "cluster_name": self.config.cluster_name,
            "gcs_address": gcs_address,
            "head_pid": self._head_proc.pid if self._head_proc else None,
            "provider": {k: v for k, v in self.config.provider.items()
                         if k != "request_fn"},
            "worker_node_ids": node_ids,
        }
        os.makedirs(_STATE_ROOT, exist_ok=True)
        with open(_state_path(self.config.cluster_name), "w") as f:
            json.dump(self.state, f)
        return self.state

    def _wait_for_nodes(self, gcs_address: str, n: int,
                        timeout_s: float) -> None:
        """Block until the GCS reports n alive nodes (the bootstrap
        equivalent of the reference's `ray up` waiting on SSH setup)."""
        from ray_tpu_torch.core import rpc

        if self.config.provider.get("type") == "gce":
            return  # cloud workers join minutes later via startup scripts
        cli = rpc.connect_with_retry(gcs_address, timeout=30)
        try:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                nodes = cli.call("get_all_nodes", {}, timeout=10)
                if sum(1 for x in nodes if x.get("alive")) >= n:
                    return
                time.sleep(0.2)
            raise TimeoutError(
                f"cluster did not reach {n} alive nodes in {timeout_s}s")
        finally:
            cli.close()

    # --------------------------------------------------------------- down
    def down(self) -> None:
        name = self.config.cluster_name
        state = self.state or (load_state(name) if os.path.exists(
            _state_path(name)) else {})
        if self.provider is not None:
            for nid in state.get("worker_node_ids", []):
                try:
                    self.provider.terminate_node(nid)
                except Exception:
                    logger.warning("terminate of %s failed", nid)
        pid = state.get("head_pid")
        if self._head_proc is not None:
            self._head_proc.terminate()
            try:
                self._head_proc.wait(timeout=10)
            except Exception:
                self._head_proc.kill()
        elif pid:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        try:
            os.unlink(_state_path(name))
        except FileNotFoundError:
            pass

    # --------------------------------------------------------- exec/attach
    @staticmethod
    def exec_command(name: str, cmd: List[str],
                     capture: bool = False) -> subprocess.CompletedProcess:
        """Run a command against the cluster (RAY_TPU_TORCH_ADDRESS injected,
        the reference's `ray exec`). The head is local by design, so this is a
        local subprocess — no SSH round trip."""
        state = load_state(name)
        env = dict(os.environ, RAY_TPU_TORCH_ADDRESS=state["gcs_address"])
        return subprocess.run(cmd, env=env, capture_output=capture,
                              text=True)

    @staticmethod
    def submit(name: str, script: str,
               args: Optional[List[str]] = None) -> int:
        """`python -m ray_tpu_torch submit cluster.yaml script.py` — run a
        driver script against the cluster."""
        out = ClusterLauncher.exec_command(
            name, [sys.executable, script, *(args or [])])
        return out.returncode

    @staticmethod
    def attach_command(name: str) -> List[str]:
        """The shell command `attach` runs: an interactive shell with the
        cluster address exported (reference `ray attach`)."""
        state = load_state(name)
        shell = os.environ.get("SHELL", "/bin/bash")
        return ["env", f"RAY_TPU_TORCH_ADDRESS={state['gcs_address']}",
                shell]


# ------------------------------------------------------------------- CLI


def cli_up(path: str, block: bool) -> int:
    cfg = ClusterConfig.from_yaml(path)
    launcher = ClusterLauncher(cfg)
    state = launcher.up()
    print(f"cluster '{cfg.cluster_name}' up: {state['gcs_address']} "
          f"({len(state['worker_node_ids'])} workers)")
    print(f"Connect with: ray_tpu_torch.init("
          f"address=\"{state['gcs_address']}\")")
    if block or cfg.provider.get("type") == "fake":
        # fake workers live in THIS process: stay resident like `ray start`,
        # and record the holder pid so `python -m ray_tpu_torch down` from
        # another terminal can signal the process that actually owns the
        # in-process raylets
        state["holder_pid"] = os.getpid()
        with open(_state_path(cfg.cluster_name), "w") as f:
            json.dump(state, f)
        print("holding cluster (Ctrl-C to tear down)")
        stop = {"flag": False}
        signal.signal(signal.SIGINT, lambda *a: stop.update(flag=True))
        signal.signal(signal.SIGTERM, lambda *a: stop.update(flag=True))
        while not stop["flag"]:
            time.sleep(0.5)
        launcher.down()
    return 0


def cli_down(path: str) -> int:
    cfg = ClusterConfig.from_yaml(path)
    try:
        state = load_state(cfg.cluster_name)
    except FileNotFoundError:
        print(f"no state for cluster '{cfg.cluster_name}'")
        return 1
    holder = state.get("holder_pid")
    if holder and holder != os.getpid():
        # a resident `up` owns the (fake) workers: signal IT to tear down
        try:
            os.kill(holder, signal.SIGTERM)
            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and os.path.exists(_state_path(cfg.cluster_name))):
                time.sleep(0.2)
            print(f"cluster '{cfg.cluster_name}' down (via holder)")
            return 0
        except ProcessLookupError:
            pass  # holder already gone: fall through to direct teardown
    launcher = ClusterLauncher(cfg)
    launcher.provider = launcher._make_provider(state["gcs_address"])
    launcher.down()
    print(f"cluster '{cfg.cluster_name}' down")
    return 0


def cli_exec(path: str, cmd: List[str]) -> int:
    cfg = ClusterConfig.from_yaml(path)
    return ClusterLauncher.exec_command(cfg.cluster_name, cmd).returncode


def cli_submit(path: str, script: str, args: List[str]) -> int:
    cfg = ClusterConfig.from_yaml(path)
    return ClusterLauncher.submit(cfg.cluster_name, script, args)


def cli_attach(path: str) -> int:
    cfg = ClusterConfig.from_yaml(path)
    cmd = ClusterLauncher.attach_command(cfg.cluster_name)
    return subprocess.call(cmd)
