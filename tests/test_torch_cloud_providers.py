"""The port's cloud providers and cluster launcher against ray_tpu's.

- `GceGpuNodeProvider` (Compute Engine `instances`, v1) and
  `KubernetesGpuNodeProvider` (`nvidia.com/gpu` Pods) through the cases of
  tests/test_gce_provider.py, on a stubbed transport: nothing egresses.
- The autoscaler's reap-and-replace loop through the Kubernetes provider
  (tests/test_node_failure.py's case) on the port's runtime.
- The launcher's cases of tests/test_cluster_launcher.py: YAML parsing,
  fake up/submit/down, the GCE request shapes, attach's exported address.
- Shared logic held against the reference: both packages' autoscalers,
  each over its own package's cloud provider and a fake of that cloud, see
  the same seeded demands, failures and preemptions tick by tick ("TPU"
  mapped to "GPU") and must create and terminate the same nodes in the
  same order.
"""

import io
import json
import os
import random
import time
import urllib.error

import numpy as np
import pytest

import ray_tpu.autoscaler.autoscaler as ref_auto
import ray_tpu.autoscaler.node_provider as ref_np
import ray_tpu.util.backoff as ref_backoff
import ray_tpu_torch.autoscaler.autoscaler as port_auto
import ray_tpu_torch.util.backoff as port_backoff
from ray_tpu_torch.autoscaler import launcher as launcher_mod
from ray_tpu_torch.autoscaler import node_provider as port_np
from ray_tpu_torch.autoscaler.launcher import ClusterConfig, ClusterLauncher
from ray_tpu_torch.autoscaler.node_provider import (GceGpuNodeProvider,
                                                    KubernetesGpuNodeProvider)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPUTE = "https://compute.googleapis.com/compute/v1"


class _FakeCompute:
    """Minimal Compute Engine `instances` double recording requests."""

    def __init__(self):
        self.instances = {}
        self.calls = []

    def request(self, method, url, body=None, headers=None):
        self.calls.append((method, url, body))
        if "metadata.google.internal" in url:
            assert headers == {"Metadata-Flavor": "Google"}
            return {"access_token": "tok", "expires_in": 3600}
        assert headers.get("Authorization") == "Bearer tok"
        assert url.startswith(COMPUTE + "/projects/")
        if method == "POST":
            assert url.endswith("/instances")
            self.instances[body["name"]] = {
                "name": body["name"], "status": "RUNNING",
                "labels": body["labels"]}
            return {"kind": "compute#operation", "name": "op1"}
        if method == "DELETE":
            name = url.rsplit("/", 1)[-1]
            self.instances[name]["status"] = "STOPPING"
            return {"kind": "compute#operation", "name": "op2"}
        if method == "GET":
            return {"items": list(self.instances.values())}
        raise AssertionError(f"unexpected {method} {url}")


def _gce(cloud, **kw):
    return GceGpuNodeProvider("proj", kw.pop("zone", "us-central1-a"),
                              "10.0.0.1:6379", request_fn=cloud.request,
                              **kw)


def test_gce_gpu_provider_lifecycle():
    cloud = _FakeCompute()
    p = _gce(cloud)
    nid = p.create_node("h100_8", {"GPU": 8}, {"team": "ml"})
    # node type sanitized to RFC-1035 (no underscores)
    assert nid.startswith("ray-tpu-torch-h100-8-")
    method, url, body = cloud.calls[-1]
    assert method == "POST"
    assert url == (f"{COMPUTE}/projects/proj/zones/us-central1-a/"
                   f"instances")
    assert body["name"] == nid
    assert body["machineType"] == \
        "zones/us-central1-a/machineTypes/a3-highgpu-8g"
    assert body["guestAccelerators"] == [{
        "acceleratorType":
            "zones/us-central1-a/acceleratorTypes/nvidia-h100-80gb",
        "acceleratorCount": 8}]
    assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    items = {i["key"]: i["value"] for i in body["metadata"]["items"]}
    assert ("python -m ray_tpu_torch start --address=10.0.0.1:6379 "
            "--num-gpus 8") in items["startup-script"]
    assert body["labels"]["ray-tpu-torch-cluster"] == "1"
    assert body["labels"]["team"] == "ml"
    assert not any(k.startswith("ray-tpu-") and "torch" not in k
                   for k in body["labels"])

    assert p.non_terminated_nodes() == [nid]
    p.terminate_node(nid)
    assert cloud.calls[-1][:2] == (
        "DELETE", f"{COMPUTE}/projects/proj/zones/us-central1-a/"
                  f"instances/{nid}")
    assert p.non_terminated_nodes() == []


def test_gce_gpu_provider_accelerator_mapping():
    cloud = _FakeCompute()
    p = _gce(cloud, zone="z",
             accelerator_types={"big": "nvidia-h100-mega-80gb"},
             machine_types={"big": "a3-megagpu-8g"})
    p.create_node("big", {"GPU": 8}, {})
    body = cloud.calls[-1][2]
    assert body["machineType"] == "zones/z/machineTypes/a3-megagpu-8g"
    assert body["guestAccelerators"][0]["acceleratorType"] == \
        "zones/z/acceleratorTypes/nvidia-h100-mega-80gb"
    # without a mapping, the A3 machine of the node's GPU count
    p.create_node("small", {"GPU": 2, "CPU": 24}, {})
    body = cloud.calls[-1][2]
    assert body["machineType"] == "zones/z/machineTypes/a3-highgpu-2g"
    assert body["guestAccelerators"][0]["acceleratorCount"] == 2


@pytest.mark.parametrize("status", ["TERMINATED", "STOPPED", "STOPPING",
                                    "SUSPENDED"])
def test_gce_gpu_provider_excludes_preempted_nodes(status):
    cloud = _FakeCompute()
    p = _gce(cloud, zone="z")
    nid = p.create_node("a", {"GPU": 1}, {})
    keep = p.create_node("a", {"GPU": 1}, {})
    cloud.instances[nid]["status"] = status  # a spot VM preempted
    assert p.non_terminated_nodes() == [keep]


def test_gce_gpu_provider_refreshes_expired_token():
    cloud = _FakeCompute()
    p = _gce(cloud, zone="z")
    p.non_terminated_nodes()
    first_token_calls = sum(1 for c in cloud.calls if "metadata" in c[1])
    p._token_expiry = time.time() - 1  # simulate expiry
    p.non_terminated_nodes()
    assert sum(1 for c in cloud.calls if "metadata" in c[1]) == \
        first_token_calls + 1


def test_gce_gpu_provider_ignores_foreign_nodes():
    cloud = _FakeCompute()
    cloud.instances["other"] = {"name": "other", "status": "RUNNING",
                                "labels": {}}
    # a reference cluster's TPU-style label and another port cluster's
    cloud.instances["ref"] = {"name": "ref", "status": "RUNNING",
                              "labels": {"ray-tpu-cluster": "1"}}
    cloud.instances["b"] = {"name": "b", "status": "RUNNING",
                            "labels": {"ray-tpu-torch-cluster": "b"}}
    p = _gce(cloud, zone="z", cluster_label="a")
    assert p.non_terminated_nodes() == []
    mine = p.create_node("g", {"GPU": 1}, {})
    assert p.non_terminated_nodes() == [mine]


def test_gce_gpu_provider_pages_through_the_listing():
    pages = {"": {"items": [{"name": "x1", "status": "RUNNING",
                             "labels": {"ray-tpu-torch-cluster": "1"}}],
                  "nextPageToken": "p2"},
             "p2": {"items": [{"name": "x2", "status": "PROVISIONING",
                               "labels": {"ray-tpu-torch-cluster": "1"}}]}}

    def request(method, url, body=None, headers=None):
        if "metadata" in url:
            return {"access_token": "tok", "expires_in": 3600}
        return pages[url.split("pageToken=")[1] if "pageToken" in url
                     else ""]

    p = GceGpuNodeProvider("proj", "z", "gcs:1", request_fn=request)
    assert p.non_terminated_nodes() == ["x1", "x2"]


def _http_error(url, code):
    return urllib.error.HTTPError(url, code, "err", {}, io.BytesIO(b""))


def test_gce_terminate_404_is_noop():
    """A DELETE of an already-gone VM (double reap after it self-died or
    was preempted away) returns 404: the provider swallows it; any other
    error still raises."""
    cloud = _FakeCompute()
    p = _gce(cloud, zone="z")
    nid = p.create_node("h100_8", {"GPU": 8}, {})
    real_request = cloud.request

    def request_with(code):
        def request(method, url, body=None, headers=None):
            if method == "DELETE":
                raise _http_error(url, code)
            return real_request(method, url, body, headers)
        return request

    p._request = request_with(404)
    p.terminate_node(nid)  # no raise: the node is gone either way
    p.terminate_node("never-existed")
    p._request = request_with(500)
    with pytest.raises(urllib.error.HTTPError):
        p.terminate_node(nid)


def test_gce_default_transport_is_the_one_http_request(monkeypatch):
    """With no `request_fn`, every call goes through `_http_request`."""
    cloud = _FakeCompute()
    monkeypatch.setattr(
        GceGpuNodeProvider, "_http_request",
        lambda self, method, url, body=None, headers=None:
        cloud.request(method, url, body, headers))
    p = GceGpuNodeProvider("proj", "z", "gcs:1")
    nid = p.create_node("g", {"GPU": 4}, {})
    assert p.non_terminated_nodes() == [nid]
    assert [c[0] for c in cloud.calls] == ["GET", "POST", "GET"]


# ---------------------------------------------------------------- kubernetes


class _FakeKube:
    """Pod API double recording requests."""

    def __init__(self):
        self.pods = {}
        self.calls = []

    def request(self, method, url, body=None, headers=None):
        self.calls.append((method, url, body))
        if method == "POST":
            name = body["metadata"]["name"]
            self.pods[name] = {
                "metadata": body["metadata"],
                "status": {"phase": "Pending"},
            }
            return dict(body)
        if method == "DELETE":
            name = url.rsplit("/", 1)[-1]
            self.pods[name]["status"]["phase"] = "Terminating"
            return {}
        assert "labelSelector=ray-tpu-torch-cluster%3D1" in url
        return {"items": list(self.pods.values())}


def _kube_provider(fake):
    return KubernetesGpuNodeProvider(
        "ml", "10.0.0.1:6379", image="rtt:latest",
        node_selector={"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
        request_fn=fake.request)


def test_kube_provider_lifecycle():
    fake = _FakeKube()
    p = _kube_provider(fake)
    node = p.create_node("gpu_8", {"GPU": 8}, {"team": "ml"})
    assert node.startswith("ray-tpu-torch-worker-")
    assert p.non_terminated_nodes() == [node]
    # Running pods still count; terminated ones drop out
    fake.pods[node]["status"]["phase"] = "Running"
    assert p.non_terminated_nodes() == [node]
    p.terminate_node(node)
    assert p.non_terminated_nodes() == []
    methods = [m for m, _, _ in fake.calls]
    assert methods.count("POST") == 1 and methods.count("DELETE") == 1


def test_kube_provider_pod_manifest():
    """Manifest assembly: GPU requests/limits, join command, selector,
    cluster labels."""
    p = _kube_provider(_FakeKube())
    m = p.pod_manifest("gpu_8", {"GPU": 8}, {"env": "prod"})
    c = m["spec"]["containers"][0]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "8"}
    assert c["resources"]["requests"] == {"nvidia.com/gpu": "8"}
    assert c["command"][2] == ("python -m ray_tpu_torch start "
                               "--address=10.0.0.1:6379 --num-gpus 8")
    assert m["spec"]["nodeSelector"][
        "cloud.google.com/gke-accelerator"] == "nvidia-h100-80gb"
    assert m["metadata"]["labels"]["ray-tpu-torch-cluster"] == "1"
    assert m["metadata"]["labels"]["ray-tpu-torch-type"] == "gpu_8"
    assert m["metadata"]["labels"]["env"] == "prod"
    assert m["spec"]["restartPolicy"] == "Never"


def test_kube_provider_with_autoscaler():
    """Scale up and down through the kube provider as through the GCE and
    fake providers (provider-agnostic control loop)."""
    fake = _FakeKube()
    p = _kube_provider(fake)
    ids = [p.create_node("gpu_8", {"GPU": 8}, {}) for _ in range(3)]
    assert sorted(p.non_terminated_nodes()) == sorted(ids)
    for nid in ids[1:]:
        p.terminate_node(nid)
    assert p.non_terminated_nodes() == [ids[0]]


def test_kube_terminate_404_is_noop():
    fake = _FakeKube()
    p = _kube_provider(fake)
    nid = p.create_node("gpu_8", {"GPU": 8}, {})

    def request_404(method, url, body=None, headers=None):
        raise _http_error(url, 404)

    p._request = request_404
    p.terminate_node(nid)  # pod already deleted: no raise


class _FakeKubeApi:
    """Stateful fake of the Kubernetes pods API: POST creates a Running
    pod, GET lists by label selector, DELETE removes (404 on unknown). Pods
    can be killed behind the provider's back (preemption) so the
    autoscaler's vanished-node reconcile runs end to end."""

    class _NotFound(Exception):
        status = 404

    def __init__(self, fail_creates: int = 0, label="ray-tpu-torch-cluster"):
        self.pods: dict = {}
        self.create_calls = 0
        self.delete_calls = 0
        self.fail_creates = fail_creates
        self.label = label

    def __call__(self, method, url, body=None, headers=None):
        if method == "POST":
            self.create_calls += 1
            if self.create_calls <= self.fail_creates:
                raise RuntimeError("apiserver 500 (injected)")
            name = body["metadata"]["name"]
            self.pods[name] = dict(body, status={"phase": "Running"})
            return {}
        if method == "GET":
            assert f"labelSelector={self.label}%3D1" in url
            return {"items": [p for p in self.pods.values()
                              if p["metadata"]["labels"]
                              .get(self.label) == "1"]}
        if method == "DELETE":
            self.delete_calls += 1
            name = url.rsplit("/", 1)[-1]
            if name not in self.pods:
                raise self._NotFound("pod not found")
            del self.pods[name]
            return {}
        raise AssertionError(f"unexpected {method} {url}")

    def preempt(self, name: str) -> None:
        """The node vanishes out from under the provider (spot reclaim)."""
        del self.pods[name]


@pytest.fixture
def fast_health():
    from ray_tpu_torch.core.config import get_config

    cfg = get_config()
    saved = (cfg.health_check_period_ms, cfg.health_check_timeout_ms)
    cfg.health_check_period_ms = 200
    cfg.health_check_timeout_ms = 1500
    yield cfg
    cfg.health_check_period_ms, cfg.health_check_timeout_ms = saved


def test_kubernetes_provider_reap_and_replace_loop(fast_health):
    """The autoscaler's reap-and-replace loop through
    KubernetesGpuNodeProvider over its fake transport: minimums converge
    through an injected create failure, a preempted pod is seen as vanished
    and relaunched, the update thread survives, and the 404 double reap
    stays a no-op."""
    from ray_tpu_torch.autoscaler import NodeType, StandardAutoscaler
    from ray_tpu_torch.core.cluster import Cluster

    cluster = Cluster()  # a real (empty) control plane for the demand polls
    cluster.add_node(num_cpus=1, resources={"head": 1})
    cluster.connect()
    api = _FakeKubeApi(fail_creates=1)
    provider = KubernetesGpuNodeProvider(
        "testns", cluster.gcs_address, request_fn=api)
    autoscaler = StandardAutoscaler(
        cluster.gcs_address, provider,
        [NodeType("gpu_pod", {"GPU": 4.0}, min_workers=2, max_workers=4)],
        update_interval_s=0.1, idle_timeout_s=10_000.0)
    try:
        autoscaler.start()
        deadline = time.monotonic() + 15
        while len(provider.non_terminated_nodes()) < 2:
            assert time.monotonic() < deadline, \
                f"pod fleet never formed: {autoscaler.stats()}"
            time.sleep(0.05)
        assert autoscaler.stats()["launch_failures"] >= 1

        victim = provider.non_terminated_nodes()[0]
        auto0 = autoscaler.stats()
        api.preempt(victim)
        deadline = time.monotonic() + 15
        while True:
            stats = autoscaler.stats()
            if (stats["relaunches"] > auto0["relaunches"]
                    and len(provider.non_terminated_nodes()) >= 2):
                break
            assert time.monotonic() < deadline, \
                f"preempted pod never replaced: {stats}"
            time.sleep(0.05)
        assert stats["deaths_by_reason"].get("vanished", 0) >= 1
        assert autoscaler._thread.is_alive()
        provider.terminate_node(victim)
        provider.terminate_node("never-existed")
        pod = next(iter(api.pods.values()))
        assert pod["metadata"]["labels"]["ray-tpu-torch-type"] == "gpu_pod"
        limits = pod["spec"]["containers"][0]["resources"]["limits"]
        assert limits == {"nvidia.com/gpu": "4"}
    finally:
        try:
            autoscaler.stop()
        finally:
            cluster.shutdown()


# --------------------------------------------- the same calls as the reference


class _FakeTpuApi:
    """The reference's cloud (Cloud TPU v2 nodes) in the same shape as
    `_FakeCompute`: insertion-ordered, preemptible."""

    def __init__(self):
        self.nodes = {}

    def __call__(self, method, url, body=None, headers=None):
        if "metadata.google.internal" in url:
            return {"access_token": "tok", "expires_in": 3600}
        if method == "POST":
            nid = url.split("nodeId=")[1]
            self.nodes[nid] = {"name": f"x/nodes/{nid}", "state": "READY",
                               "labels": body["labels"]}
            return {}
        if method == "DELETE":
            nid = url.rsplit("/", 1)[-1]
            if nid not in self.nodes:
                raise _http_error(url, 404)
            del self.nodes[nid]
            return {}
        return {"nodes": list(self.nodes.values())}

    def names(self):
        return list(self.nodes)

    def preempt(self, name):
        self.nodes[name]["state"] = "PREEMPTED"


class _FakeComputeApi(_FakeTpuApi):
    def __call__(self, method, url, body=None, headers=None):
        if "metadata.google.internal" in url:
            return {"access_token": "tok", "expires_in": 3600}
        if method == "POST":
            self.nodes[body["name"]] = {"name": body["name"],
                                        "status": "RUNNING",
                                        "labels": body["labels"]}
            return {}
        if method == "DELETE":
            nid = url.rsplit("/", 1)[-1]
            if nid not in self.nodes:
                raise _http_error(url, 404)
            del self.nodes[nid]
            return {}
        return {"items": list(self.nodes.values())}

    def preempt(self, name):
        self.nodes[name]["status"] = "TERMINATED"


class _KubeApi(_FakeKubeApi):
    def names(self):
        return list(self.pods)


class _RefKubeApi(_KubeApi):
    def __init__(self):
        super().__init__(label="ray-tpu-cluster")


class _PortKubeApi(_KubeApi):
    def __init__(self):
        super().__init__(label="ray-tpu-torch-cluster")


class _Recording:
    """A provider wrapper recording each create's (type, resources) and
    each terminate's creation index, and failing creates on a script."""

    def __init__(self, inner, fail_next):
        self.inner, self.fail_next = inner, fail_next
        self.created, self.terminated, self.index = [], [], {}

    def create_node(self, node_type, resources, labels):
        if self.fail_next():
            raise RuntimeError("cloud API 500 (scripted)")
        pid = self.inner.create_node(node_type, resources, labels)
        self.index[pid] = len(self.index)
        self.created.append((node_type, dict(resources)))
        return pid

    def terminate_node(self, pid):
        self.terminated.append(self.index.get(pid, pid))
        self.inner.terminate_node(pid)

    def non_terminated_nodes(self):
        return self.inner.non_terminated_nodes()


class _StubGcs:
    def __init__(self):
        self.demands = []

    def call(self, method, payload=None, timeout=None):
        if method == "get_pending_demands":
            return self.demands
        if method == "get_cluster_view":
            return {}
        return True

    def notify(self, method, payload=None):
        pass

    def close(self):
        pass


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _cloud_providers(pkg, kind, api):
    if kind == "gce":
        if pkg == "ref":
            return ref_np.GceTpuNodeProvider("proj", "z", "gcs:1",
                                             request_fn=api)
        return port_np.GceGpuNodeProvider("proj", "z", "gcs:1",
                                          request_fn=api)
    if pkg == "ref":
        return ref_np.KubernetesTpuNodeProvider("ns", "gcs:1",
                                                request_fn=api)
    return port_np.KubernetesGpuNodeProvider("ns", "gcs:1", request_fn=api)


def _cloud_scenario(pkg, kind, seed, monkeypatch):
    auto_mod, backoff_mod = {"ref": (ref_auto, ref_backoff),
                             "port": (port_auto, port_backoff)}[pkg]
    acc = "TPU" if pkg == "ref" else "GPU"
    rng = np.random.default_rng(seed)
    clock, gcs = _Clock(), _StubGcs()
    monkeypatch.setattr(auto_mod.rpc, "ReconnectingClient",
                        lambda *a, **k: gcs)
    monkeypatch.setattr(auto_mod, "time", clock)
    monkeypatch.setattr(backoff_mod, "random", random.Random(seed))
    api = {("ref", "gce"): _FakeTpuApi, ("port", "gce"): _FakeComputeApi,
           ("ref", "kube"): _RefKubeApi,
           ("port", "kube"): _PortKubeApi}[pkg, kind]()
    fails = []
    provider = _Recording(_cloud_providers(pkg, kind, api),
                          lambda: fails.pop(0) if fails else False)
    types = [auto_mod.NodeType("small", {"CPU": 8.0, acc: 1.0}, 1, 3),
             auto_mod.NodeType("big", {"CPU": 32.0, acc: 8.0}, 0, 2)]
    scaler = auto_mod.StandardAutoscaler(
        "stub:0", provider, types, update_interval_s=1.0,
        idle_timeout_s=30.0, launch_failure_threshold=3)
    trace = []
    for _ in range(25):
        fails[:] = [bool(x) for x in rng.random(4) < 0.3]
        live = api.names()
        if live and rng.random() < 0.25:
            api.preempt(live[int(rng.integers(0, len(live)))])
        gcs.demands = [{"CPU": float(rng.choice([1, 4, 16])),
                        acc: float(rng.choice([1, 4, 8]))}
                       for _ in range(int(rng.integers(0, 4)))]
        n_created, n_term = len(provider.created), len(provider.terminated)
        scaler.update()
        trace.append({
            "created": [(t, {("TPU" if k == acc else k): v
                             for k, v in r.items()})
                        for t, r in provider.created[n_created:]],
            "terminated": provider.terminated[n_term:],
            "stats": scaler.stats(),
        })
        clock.now += float(rng.choice([0.5, 2.0, 40.0]))
    return trace


@pytest.mark.parametrize("kind", ["gce", "kube"])
@pytest.mark.parametrize("seed", range(3))
def test_autoscaler_makes_the_reference_calls_through_the_cloud(
        kind, seed, monkeypatch):
    ref = _cloud_scenario("ref", kind, seed, monkeypatch)
    port = _cloud_scenario("port", kind, seed, monkeypatch)
    for i, (r, p) in enumerate(zip(ref, port, strict=True)):
        assert p == r, f"{kind} seed {seed} tick {i}: {p} != {r}"
    assert ref[-1]["stats"]["launches"] > 0


# ------------------------------------------------------------------ launcher


@pytest.fixture
def state_root(tmp_path, monkeypatch):
    root = str(tmp_path / "clusters")
    monkeypatch.setattr(launcher_mod, "_STATE_ROOT", root)
    return root


def test_cluster_yaml_parsing(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(
        "cluster_name: demo\n"
        "provider:\n  type: fake\n"
        "head:\n  num_cpus: 2\n  resources: {GPU: 1}\n"
        "workers:\n  count: 2\n  resources: {GPU: 8, CPU: 1}\n")
    cfg = ClusterConfig.from_yaml(str(p))
    assert cfg.cluster_name == "demo"
    assert cfg.provider["type"] == "fake"
    assert cfg.head["resources"] == {"GPU": 1}
    assert cfg.workers["count"] == 2
    with pytest.raises(ValueError):
        q = tmp_path / "bad.yaml"
        q.write_text("provider: {type: fake}\n")
        ClusterConfig.from_yaml(str(q))


def test_state_root_moves_with_its_variable():
    import subprocess
    import sys

    code = ("from ray_tpu_torch.autoscaler import launcher; "
            "print(launcher._STATE_ROOT)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RAY_TPU_TORCH_CLUSTERS_DIR")}
    env["PYTHONPATH"] = REPO
    roots = []
    for extra in ({}, {"RAY_TPU_TORCH_CLUSTERS_DIR": "/x/y"}):
        out = subprocess.run([sys.executable, "-c", code], env={**env,
                             **extra}, capture_output=True, text=True,
                             timeout=60, check=True)
        roots.append(out.stdout.strip())
    assert roots == [os.path.expanduser("~/.ray_tpu_torch/clusters"), "/x/y"]


def test_fake_cluster_up_submit_down(tmp_path, state_root):
    """One command chain — up (a head with a GPU and two fake workers),
    submit a driver script that uses the whole cluster, down."""
    cfg = ClusterConfig(
        cluster_name="e2e",
        provider={"type": "fake"},
        head={"num_cpus": 2, "resources": {"GPU": 1}},
        workers={"count": 2, "resources": {"CPU": 1}})
    launcher = ClusterLauncher(cfg)
    try:
        state = launcher.up(wait_timeout_s=90)
        assert state["gcs_address"]
        assert len(state["worker_node_ids"]) == 2
        assert os.path.exists(os.path.join(state_root, "e2e.json"))

        script = tmp_path / "driver.py"
        script.write_text(
            f"import os, sys\nsys.path.insert(0, {REPO!r})\n"
            "import ray_tpu_torch\n"
            "assert os.environ['RAY_TPU_TORCH_ADDRESS']\n"
            "ray_tpu_torch.init()\n"  # the address variable joins it
            "assert len([n for n in ray_tpu_torch.nodes() if n['alive']]) "
            "== 3, ray_tpu_torch.nodes()\n"
            "assert ray_tpu_torch.cluster_resources()['GPU'] == 1\n"
            "@ray_tpu_torch.remote\n"
            "def f(x):\n    return x * 2\n"
            "assert ray_tpu_torch.get([f.remote(i) for i in range(8)]) == "
            "[i * 2 for i in range(8)]\n"
            "print('DRIVER OK')\n")
        assert ClusterLauncher.submit("e2e", str(script)) == 0
    finally:
        launcher.down()
    assert not os.path.exists(os.path.join(state_root, "e2e.json"))
    pid = state["head_pid"]
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        pytest.fail("head process survived down()")


def test_gce_cluster_up_request_shapes(state_root):
    """GCE flow: up() creates one GPU VM per worker through the REST API
    with a startup script that joins the head; down() deletes them. The
    transport is injected — request shapes are asserted, nothing
    egresses."""
    calls = []

    def fake_request(method, url, body, headers):
        if "metadata.google.internal" in url:
            return {"access_token": "tok", "expires_in": 3600}
        calls.append((method, url, body))
        return {"name": "operation-1"}

    cfg = ClusterConfig(
        cluster_name="gce-test",
        provider={"type": "gce", "project": "proj", "zone": "us-central1-a",
                  "request_fn": fake_request},
        head={"num_cpus": 1, "gcs_port": 0, "advertise_ip": "10.1.2.3"},
        workers={"count": 2, "node_type": "h100-8",
                 "resources": {"GPU": 8, "CPU": 200}})
    launcher = ClusterLauncher(cfg)
    try:
        state = launcher.up()
        assert state["gcs_address"].startswith("10.1.2.3:")
        creates = [c for c in calls if c[0] == "POST"]
        assert len(creates) == 2
        for method, url, body in creates:
            assert url == (f"{COMPUTE}/projects/proj/zones/us-central1-a/"
                           f"instances")
            assert body["name"].startswith("ray-tpu-torch-gce-test-h100-8-")
            assert body["machineType"].endswith("/a3-highgpu-8g")
            assert body["guestAccelerators"][0]["acceleratorCount"] == 8
            assert body["labels"]["ray-tpu-torch-cluster"] == "gce-test"
            startup = {i["key"]: i["value"]
                       for i in body["metadata"]["items"]}["startup-script"]
            assert (f"python -m ray_tpu_torch start "
                    f"--address={state['gcs_address']} --num-gpus 8"
                    ) in startup
        with open(os.path.join(state_root, "gce-test.json")) as f:
            persisted = json.load(f)
        assert "request_fn" not in persisted["provider"]
    finally:
        launcher.down()
    deletes = [c for c in calls if c[0] == "DELETE"]
    assert len(deletes) == 2


def test_attach_command_exports_address(state_root):
    os.makedirs(state_root, exist_ok=True)
    with open(os.path.join(state_root, "att.json"), "w") as f:
        json.dump({"cluster_name": "att", "gcs_address": "1.2.3.4:6380"}, f)
    cmd = ClusterLauncher.attach_command("att")
    assert "RAY_TPU_TORCH_ADDRESS=1.2.3.4:6380" in cmd
    assert not [c for c in cmd if c.startswith("RAY_TPU_ADDRESS=")]
    out = ClusterLauncher.exec_command(
        "att", ["sh", "-c", "echo $RAY_TPU_TORCH_ADDRESS"], capture=True)
    assert out.stdout.strip() == "1.2.3.4:6380"
