"""Node providers: the pluggable cloud interface.

Mirrors the reference's `NodeProvider` plugin surface
(`python/ray/autoscaler/node_provider.py:13`; aws/gcp/... subclasses) with
three implementations:

  - `FakeNodeProvider`: launches real in-process raylets (the reference's
    `FakeMultiNodeProvider`, `fake_multi_node/node_provider.py:237`), so
    the autoscaler's end-to-end behavior (and the node and partition
    storms of `core/burst.py`) is testable on one machine;
  - `GceGpuNodeProvider`: elastic GPU hosts through Compute Engine's
    `instances` REST API (v1): a machine type with `guestAccelerators`
    (an A3 machine with `nvidia-h100-80gb` x n by default), metadata-
    server auth and an injectable transport (unit-tested against a fake
    cloud; no SDK dependency);
  - `KubernetesGpuNodeProvider`: worker Pods asking for `nvidia.com/gpu`.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional


def _is_not_found(e: Exception) -> bool:
    """True for an HTTP 404 from any transport shape (urllib's HTTPError
    carries `.code`; injected test transports may use `.status`)."""
    return getattr(e, "code", None) == 404 or getattr(e, "status", None) == 404


class NodeProvider:
    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Backs node launches with in-process raylets joined to a real GCS."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._nodes: Dict[str, Any] = {}
        # partition chaos: ids whose terminate_node must NOT actually kill
        # the raylet — it leaves the provider listing (the cloud API
        # accepted the delete) while the process lives on (the API can't
        # reach the partitioned host). The zombie is what incarnation
        # fencing exists for; the harness releases it at heal time.
        self._hold_termination: set = set()
        self._zombies: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        from ray_tpu_torch.core.raylet import Raylet

        raylet = Raylet(gcs_address=self.gcs_address,
                        resources=dict(resources), labels=dict(labels))
        # the raylet registers with the GCS inside start(), so the GCS
        # view leads the provider listing by a beat: a node is listed here
        # only once fully booted (observers picking kill victims off
        # non_terminated_nodes() must never get a mid-boot raylet)
        try:
            raylet.start()
        except Exception:
            # a boot that failed after registering must not linger as a
            # heartbeating ghost the provider denies owning
            try:
                raylet.stop()
            except Exception:
                pass
            raise
        pid = f"fake-{node_type}-{uuid.uuid4().hex[:8]}"
        with self._lock:
            self._nodes[pid] = raylet
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        """Idempotent: terminating an already-gone id (double reap after a
        node self-died) is a no-op, and a crashed raylet's teardown errors
        are swallowed — the node is dead either way."""
        with self._lock:
            raylet = self._nodes.pop(provider_node_id, None)
            if raylet is not None \
                    and provider_node_id in self._hold_termination:
                # partitioned host: the delete "succeeds" at the API but
                # can't reach the process — a zombie raylet survives
                self._zombies[provider_node_id] = raylet
                return
        if raylet is not None:
            try:
                raylet.stop()
            except Exception:
                pass  # already crashed (kill_node); nothing left to stop

    def hold_termination(self, provider_node_id: str) -> None:
        """Arm the partition-zombie behavior for one node (see
        _hold_termination)."""
        with self._lock:
            self._hold_termination.add(provider_node_id)

    def release_zombie(self, provider_node_id: str):
        """Heal-side cleanup: stop holding the zombie's termination.
        Returns the still-running raylet (the harness keeps it alive to
        prove fencing, then stops it) or None."""
        with self._lock:
            self._hold_termination.discard(provider_node_id)
            return self._zombies.pop(provider_node_id, None)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def raylet_for(self, provider_node_id: str):
        return self._nodes.get(provider_node_id)

    def kill_node(self, provider_node_id: str, vanish: bool = False) -> None:
        """Chaos: whole-node SIGKILL — the raylet, its workers and its fork
        templates die together, with NO drain notify. With `vanish=False`
        the corpse stays listed (a crashed VM the cloud API still shows —
        the autoscaler must terminate-and-replace it); with `vanish=True`
        it also leaves the provider view (a preempted slice)."""
        with self._lock:
            raylet = (self._nodes.pop(provider_node_id, None) if vanish
                      else self._nodes.get(provider_node_id))
        if raylet is not None:
            raylet.crash()


# the labels every node of a port's cluster carries (GCE labels and
# Kubernetes label keys: lowercase letters, digits and hyphens)
CLUSTER_LABEL = "ray-tpu-torch-cluster"
TYPE_LABEL = "ray-tpu-torch-type"


def _start_command(gcs_address: str, gpus: int) -> str:
    """The command that joins a GPU host to the cluster's head."""
    return (f"python -m ray_tpu_torch start --address={gcs_address} "
            f"--num-gpus {gpus}")


class GceGpuNodeProvider(NodeProvider):
    """Elastic GPU hosts through the Compute Engine REST API (reference
    cloud providers: `python/ray/autoscaler/_private/gcp/`).

    Speaks `compute.googleapis.com/compute/v1` directly over HTTPS with a
    bearer token from the GCE metadata server (the standard in-cluster
    auth path — no SDK dependency). Each created node is one VM: a machine
    type (`a3-highgpu-{n}g` for n GPUs unless `machine_types` names one)
    with `guestAccelerators` of `accelerator_type` x n and
    `onHostMaintenance: TERMINATE` (a GPU VM cannot live-migrate); its
    startup script joins the host to the cluster (`python -m ray_tpu_torch
    start --address=... --num-gpus n`) — the role the reference's SSH
    command_runner plays.

    The HTTP transport is injectable (`request_fn`) so the control logic is
    unit-testable without cloud egress.
    """

    _API = "https://compute.googleapis.com/compute/v1"
    _METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/"
                           "v1/instance/service-accounts/default/token")
    # instance states with no live raylet behind them (a preempted spot VM
    # goes to TERMINATED)
    _DEAD = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED", "TERMINATED")

    def __init__(self, project: str, zone: str, gcs_address: str, *,
                 accelerator_types: Optional[Dict[str, str]] = None,
                 machine_types: Optional[Dict[str, str]] = None,
                 source_image: str = (
                     "projects/deeplearning-platform-release/global/images/"
                     "family/common-cu124-debian-11-py310"),
                 name_prefix: str = "ray-tpu-torch",
                 cluster_label: str = "1",
                 request_fn=None):
        self.project = project
        self.zone = zone
        self.gcs_address = gcs_address
        # node_type -> accelerator type (default "nvidia-h100-80gb") and
        # node_type -> machine type (default a3-highgpu-{n}g)
        self.accelerator_types = dict(accelerator_types or {})
        self.machine_types = dict(machine_types or {})
        self.source_image = source_image
        self.name_prefix = name_prefix
        self.cluster_label = cluster_label
        self._request = request_fn or self._http_request
        self._token: Optional[str] = None
        self._token_expiry = 0.0
        self._lock = threading.Lock()  # guards the token cache

    # ------------------------------------------------------------ transport
    def _http_request(self, method: str, url: str,
                      body: Optional[dict] = None,
                      headers: Optional[Dict[str, str]] = None) -> dict:
        import json
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=dict(headers or {}))
        if data is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def _auth_headers(self) -> Dict[str, str]:
        import time

        with self._lock:
            # refresh 60s before expiry: a stale bearer token would 401
            # every call forever and freeze scaling
            if self._token is None or time.time() >= self._token_expiry - 60:
                tok = self._request(
                    "GET", self._METADATA_TOKEN_URL, None,
                    {"Metadata-Flavor": "Google"})
                self._token = tok["access_token"]
                self._token_expiry = time.time() + float(
                    tok.get("expires_in", 300))
            return {"Authorization": f"Bearer {self._token}"}

    def _parent(self) -> str:
        return f"projects/{self.project}/zones/{self.zone}"

    # ------------------------------------------------------------- provider
    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        gpus = max(int(resources.get("GPU", 8)), 1)
        accel = self.accelerator_types.get(node_type, "nvidia-h100-80gb")
        machine = self.machine_types.get(node_type, f"a3-highgpu-{gpus}g")
        # RFC-1035: instance names must be lowercase letters/digits/
        # hyphens (underscored node types like "gpu_8" would 400)
        import re

        safe_type = re.sub(r"[^a-z0-9-]", "-", node_type.lower()).strip("-")
        node_id = (f"{self.name_prefix}-{safe_type or 'node'}-"
                   f"{uuid.uuid4().hex[:8]}")
        startup = ("pip install ray_tpu_torch 2>/dev/null; "
                   + _start_command(self.gcs_address, gpus))
        zone = f"zones/{self.zone}"
        body = {
            "name": node_id,
            "machineType": f"{zone}/machineTypes/{machine}",
            "guestAccelerators": [{
                "acceleratorType": f"{zone}/acceleratorTypes/{accel}",
                "acceleratorCount": gpus,
            }],
            "scheduling": {"onHostMaintenance": "TERMINATE",
                           "automaticRestart": False},
            "disks": [{
                "boot": True, "autoDelete": True,
                "initializeParams": {"sourceImage": self.source_image},
            }],
            "networkInterfaces": [{"network": "global/networks/default"}],
            "labels": {**{k: str(v) for k, v in labels.items()},
                       CLUSTER_LABEL: self.cluster_label,
                       TYPE_LABEL: safe_type or "node"},
            "metadata": {"items": [
                {"key": "startup-script", "value": startup},
                {"key": "install-nvidia-driver", "value": "True"},
            ]},
        }
        self._request(
            "POST", f"{self._API}/{self._parent()}/instances",
            body, self._auth_headers())
        return node_id

    def terminate_node(self, provider_node_id: str) -> None:
        try:
            self._request(
                "DELETE",
                f"{self._API}/{self._parent()}/instances/{provider_node_id}",
                None, self._auth_headers())
        except Exception as e:
            if _is_not_found(e):
                # idempotent termination: the VM already self-died (or a
                # previous reap won the race) — a 404 double reap is a
                # no-op, not a crash in the autoscaler's reconcile loop
                return
            raise

    def non_terminated_nodes(self) -> List[str]:
        out: List[str] = []
        page: Optional[str] = ""
        while page is not None:
            url = f"{self._API}/{self._parent()}/instances"
            if page:
                url += f"?pageToken={page}"
            resp = self._request("GET", url, None, self._auth_headers())
            for inst in resp.get("items", []):
                labels = inst.get("labels", {})
                # preempted or stopped VMs have no live raylet: reporting
                # them as capacity would stop the autoscaler from healing
                if (labels.get(CLUSTER_LABEL) == self.cluster_label
                        and inst.get("status", "") not in self._DEAD):
                    out.append(inst["name"].rsplit("/", 1)[-1])
            page = resp.get("nextPageToken") or None
        return out


class KubernetesGpuNodeProvider(NodeProvider):
    """The kuberay analog of the reference's provider
    (`python/ray/autoscaler/_private/kuberay/`): elastic worker capacity as
    Kubernetes Pods with `nvidia.com/gpu` resource requests.

    Where kuberay drives a CRD reconciled by an operator, this provider
    creates worker Pods directly against the Kubernetes API — operator-free
    by design (the control loop is the port's own autoscaler; an external
    reconciler would fight it). In-cluster auth: bearer token + CA from the
    mounted service account. The HTTP transport is injectable (`request_fn`)
    so the control logic unit-tests without a cluster.
    """

    _SA = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, namespace: str, gcs_address: str, *,
                 image: str = "pytorch/pytorch:latest",
                 gpu_resource: str = "nvidia.com/gpu",
                 node_selector: Optional[Dict[str, str]] = None,
                 name_prefix: str = "ray-tpu-torch-worker",
                 api_server: str = "https://kubernetes.default.svc",
                 request_fn=None):
        self.namespace = namespace
        self.gcs_address = gcs_address
        self.image = image
        self.gpu_resource = gpu_resource
        self.node_selector = dict(node_selector or {})
        self.name_prefix = name_prefix
        self.api_server = api_server
        self._request = request_fn or self._http_request

    # ------------------------------------------------------------ transport
    def _token(self) -> str:
        with open(f"{self._SA}/token") as f:
            return f.read().strip()

    def _http_request(self, method: str, url: str,
                      body: Optional[dict] = None,
                      headers: Optional[Dict[str, str]] = None) -> dict:
        import json
        import ssl
        import urllib.request

        ctx = ssl.create_default_context(cafile=f"{self._SA}/ca.crt")
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=dict(headers or {}))
        req.add_header("Authorization", f"Bearer {self._token()}")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=60, context=ctx) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def _pods_url(self, suffix: str = "") -> str:
        return (f"{self.api_server}/api/v1/namespaces/{self.namespace}"
                f"/pods{suffix}")

    # ------------------------------------------------------------- provider
    def pod_manifest(self, node_type: str, resources: Dict[str, float],
                     labels: Dict[str, str]) -> dict:
        """Pure manifest assembly (unit-tested without a cluster, the
        container-runtime-env pattern)."""
        gpus = int(resources.get("GPU", 1))
        name = f"{self.name_prefix}-{uuid.uuid4().hex[:8]}"
        cmd = _start_command(self.gcs_address, gpus)
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "labels": {**{k: str(v) for k, v in labels.items()},
                           CLUSTER_LABEL: "1",
                           TYPE_LABEL: node_type},
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": [{
                    "name": "worker",
                    "image": self.image,
                    "command": ["/bin/sh", "-c", cmd],
                    "resources": {
                        "limits": {self.gpu_resource: str(gpus)},
                        "requests": {self.gpu_resource: str(gpus)},
                    },
                }],
            },
        }
        if self.node_selector:
            manifest["spec"]["nodeSelector"] = dict(self.node_selector)
        return manifest

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        manifest = self.pod_manifest(node_type, resources, labels)
        self._request("POST", self._pods_url(), manifest)
        return manifest["metadata"]["name"]

    def terminate_node(self, provider_node_id: str) -> None:
        try:
            self._request("DELETE", self._pods_url(f"/{provider_node_id}"))
        except Exception as e:
            if _is_not_found(e):
                return  # pod already deleted: double reap is a no-op
            raise

    def non_terminated_nodes(self) -> List[str]:
        resp = self._request(
            "GET", self._pods_url(f"?labelSelector={CLUSTER_LABEL}%3D1"))
        out: List[str] = []
        for item in resp.get("items", []):
            phase = item.get("status", {}).get("phase", "")
            if phase in ("Pending", "Running"):
                out.append(item["metadata"]["name"])
        return out
