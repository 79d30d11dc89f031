"""The port's runtime lives beside the reference's without touching it: both
alive in one process, neither sees the other's address variable, segments,
session directories or native libraries; the port's workers import neither
jax nor ray_tpu; a large torch CPU tensor got from the store is a view on
its segment; and the fork template hands CUDA-free, reseeded torch to every
forked worker."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core import serialization
from torch_runtime import mapping_of, one_runtime


@pytest.fixture(scope="module")
def both():
    """ray_tpu's node, then the port's with ray_tpu's address exported as
    ray_tpu's drivers read it: a port driver must not join that cluster."""
    with pytest.MonkeyPatch.context() as mp, \
            one_runtime(ray_tpu, num_cpus=2, resources={"TPU": 1}) as ref:
        mp.setenv("RAY_TPU_ADDRESS", ref["gcs_address"])
        with one_runtime(ray_tpu_torch, num_cpus=2,
                         resources={"GPU": 1}) as port:
            yield ref["gcs_address"], port


def test_port_driver_ignores_the_reference_address(both):
    ref_address, info = both
    assert info["gcs_address"] != ref_address
    assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0
    assert ray_tpu.cluster_resources().get("TPU") == 1.0
    assert "GPU" not in ray_tpu.cluster_resources()


def test_port_worker_imports_neither_jax_nor_ray_tpu(both):
    @ray_tpu_torch.remote
    def roots():
        import sys

        return sorted({m.split(".")[0] for m in sys.modules})

    @ray_tpu.remote
    def ref_roots():
        import sys

        return sorted({m.split(".")[0] for m in sys.modules})

    got = set(ray_tpu_torch.get(roots.remote()))
    assert "ray_tpu_torch" in got
    assert not got & {"jax", "jaxlib", "ray_tpu"}, got & {"jax", "ray_tpu"}
    assert "ray_tpu_torch" not in set(ray_tpu.get(ref_roots.remote()))


def test_segments_and_session_dirs_are_apart(both):
    from ray_tpu.core import api as ref_api
    from ray_tpu.core.config import get_config as ref_config
    from ray_tpu_torch.core import api as port_api
    from ray_tpu_torch.core.config import get_config as port_config

    big = np.arange(1 << 20, dtype=np.float64)  # 8 MiB: a shm segment
    ref_obj, port_obj = ray_tpu.put(big), ray_tpu_torch.put(big)
    assert np.array_equal(ray_tpu.get(ref_obj), ray_tpu_torch.get(port_obj))
    ref_store = ref_api._node.raylet.store
    port_store = port_api._node.raylet.store
    assert port_store._prefix.startswith("rtt-")
    assert ref_store._prefix.startswith("rtpu-")
    name, _ = port_store.lookup(port_obj.id)
    assert name.startswith("rtt-")
    assert os.path.exists(os.path.join("/dev/shm", name))
    assert ref_store.lookup(ref_obj.id)[0].startswith("rtpu-")
    assert not port_store.contains(ref_obj.id)
    assert not ref_store.contains(port_obj.id)
    ref_root, port_root = (ref_config().session_dir_root,
                           port_config().session_dir_root)
    assert os.path.basename(port_root) == "ray_tpu_torch"
    assert os.path.commonpath([ref_root, port_root]) != port_root
    assert port_store.spill_dir.startswith(port_root)
    assert not port_store.spill_dir.startswith(ref_root + os.sep)


def test_config_reads_only_the_port_namespace(monkeypatch):
    from ray_tpu_torch.core.config import Config

    monkeypatch.setenv("RAY_TPU_GPUS_PER_HOST", "3")
    assert Config().gpus_per_host == 8
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS_PER_HOST", "3")
    assert Config().gpus_per_host == 3


def test_large_cpu_tensor_from_the_store_is_a_view_on_its_segment(both):
    t = torch.arange(4 << 20, dtype=torch.float32)  # 16 MiB
    ref = ray_tpu_torch.put(t)
    got = ray_tpu_torch.get(ref)
    assert torch.equal(got, t)
    backing = mapping_of(got.data_ptr())
    assert backing is not None and backing.startswith("/dev/shm/rtt-"), \
        backing

    @ray_tpu_torch.remote
    def where(x):
        import torch as _torch  # noqa: F401 - x arrived as a tensor

        with open("/proc/self/maps") as f:
            for line in f:
                parts = line.split()
                lo, hi = (int(v, 16) for v in parts[0].split("-"))
                if lo <= x.data_ptr() < hi:
                    return parts[5] if len(parts) > 5 else None, \
                        float(x[-1])

    backing, last = ray_tpu_torch.get(where.remote(ref))
    assert backing.startswith("/dev/shm/rtt-") and last == float(t[-1])


@pytest.mark.parametrize("where", ["driver", "task"])
@pytest.mark.parametrize("numel", [64, 4 << 20], ids=["inline", "16MiB"])
def test_an_in_place_write_leaves_the_stored_tensor(both, where, numel):
    """Torch has no read-only flag: a tensor got from the store takes
    in-place ops (a 16 MiB one on a copy-on-write view of its segment, an
    inline one on its own copy), and the stored object keeps its bytes."""
    t = torch.arange(numel, dtype=torch.float32)
    ref = ray_tpu_torch.put(t)

    def write(x):
        import torch as _torch

        x.add_(1)
        _torch.nn.functional.relu(x.sub_(2), inplace=True)
        with open("/proc/self/maps") as f:
            for line in f:
                parts = line.split()
                lo, hi = (int(v, 16) for v in parts[0].split("-"))
                if lo <= x.data_ptr() < hi:
                    backing = parts[5] if len(parts) > 5 else ""
        return float(x[0]), float(x[-1]), backing

    if where == "driver":
        first, last, backing = write(ray_tpu_torch.get(ref))
    else:
        first, last, backing = ray_tpu_torch.get(
            ray_tpu_torch.remote(write).remote(ref))
    assert (first, last) == (0.0, float(numel - 2))
    assert backing.startswith("/dev/shm/rtt-") == (numel == 4 << 20), backing

    @ray_tpu_torch.remote
    def unchanged(x):
        import torch as _torch

        return _torch.equal(x, _torch.arange(x.numel(), dtype=x.dtype))

    assert torch.equal(ray_tpu_torch.get(ref), t)
    assert ray_tpu_torch.get(unchanged.remote(ref))


def test_a_numpy_array_got_from_the_store_stays_read_only(both):
    big = np.arange(1 << 21, dtype=np.float64)  # 16 MiB: a shm segment
    got = ray_tpu_torch.get(ray_tpu_torch.put(big))
    assert not got.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        got[0] = 1.0


def test_a_cuda_tensor_got_without_cuda_raises(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    class FakeCudaTensor:
        """Pickles as a staged CUDA tensor would (see _reduce_tensor)."""

        def __reduce__(self):
            raw = np.arange(4, dtype=np.float32).view(np.uint8)
            return (serialization._rebuild_tensor,
                    (pickle.PickleBuffer(raw), "float32", (4,), False, True))

    with pytest.raises(serialization.CudaUnavailableError, match="CUDA"):
        serialization.loads(serialization.dumps(FakeCudaTensor()))

    @ray_tpu_torch.remote
    def make():
        return FakeCudaTensor()

    with pytest.raises(Exception, match="without CUDA"):
        ray_tpu_torch.get(make.remote())


def test_forked_workers_get_torch_without_cuda_and_reseeded(both):
    @ray_tpu_torch.remote
    class Probe:
        def state(self):
            import os
            import sys

            preloaded = "torch" in sys.modules  # before this call imports it
            import torch as _torch

            return {"forked": os.environ.get("RAY_TPU_TORCH_WORKER_FORKED"),
                    "preloaded": preloaded,
                    "cuda_initialized": _torch.cuda.is_initialized(),
                    "seed": _torch.initial_seed()}

    probes = [Probe.remote() for _ in range(2)]
    states = ray_tpu_torch.get([p.state.remote() for p in probes])
    for s in states:
        assert s["forked"] == "1" and s["preloaded"]
        assert not s["cuda_initialized"]
    assert states[0]["seed"] != states[1]["seed"]
    for p in probes:
        ray_tpu_torch.kill(p)


def test_import_is_light():
    """`import ray_tpu_torch` binds the runtime's API lazily: neither the
    runtime nor torch is loaded until an attribute is used."""
    import subprocess

    code = ("import sys, ray_tpu_torch\n"
            "print('torch' in sys.modules, "
            "'ray_tpu_torch.core.api' in sys.modules)\n"
            "ray_tpu_torch.get_gpu_ids\n"
            "print('ray_tpu_torch.core.api' in sys.modules, "
            "'torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=60)
    assert out.stdout.split() == ["False", "False", "True", "False"], \
        out.stdout + out.stderr


def test_serve_knobs_read_only_their_own_namespace(monkeypatch):
    """`RAY_TPU_SERVE_*` sets ray_tpu's Serve knobs and
    `RAY_TPU_TORCH_SERVE_*` the port's; neither reaches the other."""
    from ray_tpu.serve import config as ref_cfg
    from ray_tpu_torch.serve import config as port_cfg

    monkeypatch.setenv("RAY_TPU_SERVE_REQUEST_TIMEOUT_S", "7")
    monkeypatch.setenv("RAY_TPU_SERVE_MAX_QUEUE_PER_REPLICA", "3")
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_REQUEST_TIMEOUT_S", "11")
    ref_cfg.reset_serve_config()
    port_cfg.reset_serve_config()
    try:
        ref, port = ref_cfg.get_serve_config(), port_cfg.get_serve_config()
        assert (ref.request_timeout_s, ref.max_queue_per_replica) == (7.0, 3)
        assert port.request_timeout_s == 11.0
        assert port.max_queue_per_replica == \
            port_cfg.ServeConfig.max_queue_per_replica
        port_cfg.set_serve_config(drain_deadline_s=1.5)
        assert ref.drain_deadline_s == ref_cfg.ServeConfig.drain_deadline_s
    finally:
        ref_cfg.reset_serve_config()
        port_cfg.reset_serve_config()


def test_serve_metrics_stay_in_their_own_registry(both):
    """A deployment served on one runtime counts its requests under that
    runtime's metric names and registry only."""
    from ray_tpu import serve as ref_serve
    from ray_tpu.util import metrics as ref_metrics
    from ray_tpu_torch import serve as port_serve
    from ray_tpu_torch.util import metrics as port_metrics

    @port_serve.deployment
    def iso_port(x):
        return x

    @ref_serve.deployment
    def iso_ref(x):
        return x

    try:
        h = port_serve.run(iso_port.bind())
        assert ray_tpu_torch.get([h.remote(i) for i in range(2)],
                                 timeout=60) == [0, 1]
        h = ref_serve.run(iso_ref.bind())
        assert ray_tpu.get([h.remote(i) for i in range(3)],
                           timeout=60) == [0, 1, 2]
        port_snap, ref_snap = port_metrics.snapshot(), ref_metrics.snapshot()
        port_served = port_snap["ray_tpu_torch_serve_requests_total"]
        ref_served = ref_snap["ray_tpu_serve_requests_total"]
        assert [v for k, v in port_served["values"].items()
                if "iso_port" in str(k)] == [2]
        assert [v for k, v in ref_served["values"].items()
                if "iso_ref" in str(k)] == [3]
        assert "iso_ref" not in str(port_snap)
        assert "iso_port" not in str(ref_snap)
        assert not [k for k in port_snap if k.startswith("ray_tpu_serve_")]
        assert not [k for k in ref_snap if k.startswith("ray_tpu_torch_")]
    finally:
        port_serve.shutdown()
        ref_serve.shutdown()
