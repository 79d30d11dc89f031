"""Collectives over the port's runtime: `util.collective` between two actors
gives the reference's all-reduce and all-gather, and
`parallel.distributed.initialize_group` rendezvouses two actors through the
runtime's KV store (gloo on the CPU), as ray_tpu's does for jax.distributed.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_runtime import one_runtime, rerun_if_killed


def _collective_program(rt, collective, backend: str):
    group = f"parity-{backend}"

    @rt.remote
    class Member:
        def __init__(self, rank):
            self.rank = rank

        def join(self):
            collective.init_collective_group(2, self.rank, backend=backend,
                                             group_name=group)
            return True

        def run(self):
            x = np.arange(6, dtype=np.float32) * (self.rank + 1)
            out = {"sum": collective.allreduce(x, group),
                   "max": collective.allreduce(x, group, op="max"),
                   "gather": collective.allgather(x[:2], group),
                   "bcast": collective.broadcast(x, 1, group),
                   "scatter": collective.reducescatter(x, group)}
            collective.barrier(group)
            return {k: np.asarray(v).tolist() for k, v in out.items()}

        def leave(self):
            collective.destroy_collective_group(group)
            return True

    members = [Member.remote(r) for r in range(2)]
    rt.get(members[0].join.remote())  # rank 0 names the rendezvous actor
    rt.get(members[1].join.remote())
    out = rt.get([m.run.remote() for m in members])
    rt.get([m.leave.remote() for m in members])
    for m in members:
        rt.kill(m)
    return out


@pytest.fixture
def port_runtime():
    with one_runtime(ray_tpu_torch, num_cpus=4):
        yield


@pytest.fixture(scope="module")
def reference_results():
    """The reference's results, for both of its backend names."""
    from ray_tpu.util import collective

    with one_runtime(ray_tpu, num_cpus=4):
        return {b: rerun_if_killed(_collective_program, ray_tpu, collective,
                                   b) for b in ("host", "xla")}


@pytest.mark.parametrize("backend,ref_backend", [("host", "host"),
                                                 ("nccl", "xla")])
def test_collective_gives_the_reference_results(reference_results,
                                                port_runtime, backend,
                                                ref_backend):
    from ray_tpu_torch.util import collective

    got = rerun_if_killed(_collective_program, ray_tpu_torch, collective,
                          backend)
    assert got == reference_results[ref_backend]
    assert got[0]["sum"] == (np.arange(6) * 3.0).tolist()
    assert got[1]["gather"] == [[0.0, 1.0], [0.0, 2.0]]


def test_initialize_group_rendezvous_through_the_kv(port_runtime):
    @ray_tpu_torch.remote
    class Rank:
        def __init__(self, rank):
            self.rank = rank

        def run(self):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch.core.worker import current_worker
            from ray_tpu_torch.parallel import distributed

            distributed.initialize_group(self.rank, 2, device="cpu",
                                         group_name="kvgroup", timeout=60)
            key = current_worker().gcs.call("kv_get", {
                "namespace": "_torch_distributed",
                "key": b"coordinator:kvgroup"}).decode()
            x = torch.tensor([float(self.rank + 1)])
            dist.all_reduce(x)
            backend = dist.get_backend()
            dist.barrier()
            distributed.shutdown_group("kvgroup")
            return {"sum": float(x), "backend": backend, "key": key,
                    "in_group": dist.is_initialized()}

    ranks = [Rank.remote(r) for r in range(2)]
    out = ray_tpu_torch.get([r.run.remote() for r in ranks], timeout=120)
    assert [o["sum"] for o in out] == [3.0, 3.0]
    assert {o["backend"] for o in out} == {"gloo"}
    host, port = out[0]["key"].rsplit(":", 1)
    assert out[1]["key"] == out[0]["key"] and int(port) > 0
    assert not any(o["in_group"] for o in out)
    w = ray_tpu_torch.core.api._global_worker()
    assert w.gcs.call("kv_get", {"namespace": "_torch_distributed",
                                 "key": b"coordinator:kvgroup"}) is None
    for r in ranks:
        ray_tpu_torch.kill(r)
