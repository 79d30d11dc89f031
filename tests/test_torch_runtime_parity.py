"""The port's runtime against the reference's: the same driver programs run
on ray_tpu and on ray_tpu_torch, both alive in this process, and give equal
results and exceptions of the same types.

Each program takes the runtime module and its accelerator spelling (ray_tpu's
"TPU" resource, `num_tpus` and `get_tpu_ids`; the port's "GPU", `num_gpus`
and `get_gpu_ids`). Remote functions and classes are defined inside the
programs, so cloudpickle ships them by value to workers that cannot import
this test module.
"""

import hashlib
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from torch_runtime import both_runtimes as _both
from torch_runtime import KILLED, rerun_if_killed, rerun_if_pkilled

ACCEL = {
    "ref": {"rt": ray_tpu, "key": "TPU", "opt": "num_tpus",
            "ids": ray_tpu.get_tpu_ids, "label": "tpu_slice"},
    "port": {"rt": ray_tpu_torch, "key": "GPU", "opt": "num_gpus",
             "ids": ray_tpu_torch.get_gpu_ids, "label": "nvlink_domain"},
}

TORCH_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.float8_e4m3fn, torch.float8_e5m2, torch.complex64,
                torch.complex128, torch.int8, torch.int16, torch.int32,
                torch.int64, torch.uint8, torch.uint16, torch.uint32,
                torch.uint64, torch.bool)


def _digest(v):
    """dtype, shape and raw bytes of an array or tensor, as one string."""
    if isinstance(v, torch.Tensor):
        raw = v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        return f"{v.dtype}{list(v.shape)}:{hashlib.sha256(raw).hexdigest()}"
    a = np.ascontiguousarray(v)
    return f"{a.dtype}{list(a.shape)}:{hashlib.sha256(a.tobytes()).hexdigest()}"


def _values():
    """Inline (< 100 KiB) and store-sized (> 1 MiB) numpy arrays, and a
    small and a large torch CPU tensor of every dtype, from one seed."""
    rng = np.random.default_rng(7)
    out = {
        "np_f32_small": rng.standard_normal(100).astype(np.float32),
        "np_i64_large": rng.integers(-2**62, 2**62, 300_000),
        "np_f16_large": rng.standard_normal(700_000).astype(np.float16),
        "np_bool": rng.random(1000) < 0.5,
    }
    for dt in TORCH_DTYPES:
        n = torch.empty(0, dtype=dt).element_size()
        for size, rows in (("small", 8), ("large", 40_000)):
            raw = torch.from_numpy(rng.integers(0, 256, (rows, 32 * n),
                                                dtype=np.uint8))
            t = raw.view(torch.uint8) % 2 == 1 if dt == torch.bool \
                else raw.view(dt)
            out[f"torch_{str(dt).split('.')[1]}_{size}"] = t
    out["torch_strided"] = torch.arange(64, dtype=torch.float32).view(
        8, 8).t()
    return out


# ---------------------------------------------------------------- programs


def prog_tasks(a):
    rt = a["rt"]

    @rt.remote
    def add(x, y):
        return x + y

    @rt.remote
    def nest(n):
        return rt.get(add.remote(n, 1)) * 2

    @rt.remote
    def deref(lst):
        return rt.get(lst[0]) + 100

    @rt.remote(num_returns=3)
    def three(x):
        return x, x * 2, x * 3

    @rt.remote(num_returns="dynamic")
    def squares(n):
        for i in range(n):
            yield i * i

    chain = add.remote(add.remote(1, 2), add.remote(3, 4))
    refs = three.remote(5)
    return {"chain": rt.get(chain), "nest": rt.get(nest.remote(3)),
            "ref_in_list": rt.get(deref.remote([add.remote(1, 1)])),
            "three": rt.get(list(refs)),
            "dynamic": [rt.get(r) for r in squares.remote(5)]}


def prog_wait(a):
    rt = a["rt"]

    @rt.remote
    def sleepy(t, v):
        time.sleep(t)
        return v

    fast, slow = sleepy.remote(0, "fast"), sleepy.remote(3, "slow")
    rt.get(fast)
    ready, rest = rt.wait([fast, slow], num_returns=2, timeout=0.5)
    none_ready, _ = rt.wait([slow], num_returns=1, timeout=0)
    try:
        rt.get(slow, timeout=0.2)
        timed_out = None
    except KILLED:
        raise
    except Exception as e:  # noqa: BLE001 - the type is the result
        timed_out = [type(e).__name__, isinstance(e, TimeoutError)]
    both, _ = rt.wait([fast, slow], num_returns=2, timeout=30)
    return {"ready": [rt.get(r) for r in ready], "n_rest": len(rest),
            "none_ready": len(none_ready), "timeout": timed_out,
            "both": sorted(rt.get(r) for r in both)}


def prog_errors(a):
    rt = a["rt"]

    class Custom(Exception):
        pass

    @rt.remote
    def boom():
        raise ValueError("bad value 7")

    @rt.remote
    def custom():
        raise Custom("custom 8")

    @rt.remote
    def outer():
        return rt.get(boom.remote())

    out = {}
    for name, fn in (("boom", boom), ("custom", custom), ("outer", outer)):
        try:
            rt.get(fn.remote())
            out[name] = None
        except KILLED:
            raise
        except Exception as e:  # noqa: BLE001
            chain, cur = [], e
            while cur is not None:
                chain.append(type(cur).__name__)
                cur = getattr(cur, "cause", None)
            out[name] = {"chain": chain, "task_error": isinstance(
                e, rt.TaskError), "text": "bad value 7" in str(e)
                or "custom 8" in str(e)}
    return out


def prog_actors(a):
    rt = a["rt"]

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def ping(self):
            self.calls += 1
            return self.calls

        def die(self):
            import os

            os._exit(1)

    c = Counter.remote(10)
    out = {"ordered": rt.get([c.add.remote(i) for i in range(20)])}
    named = Counter.options(name="parity-counter").remote(0)
    rt.get(named.add.remote(1))
    out["named"] = rt.get(rt.get_actor("parity-counter").add.remote(5))
    rt.kill(named)
    try:
        rt.get(named.add.remote(1), timeout=30)
        out["after_kill"] = None
    except Exception as e:  # noqa: BLE001
        out["after_kill"] = type(e).__name__
    try:
        rt.get_actor("parity-counter")
        out["lookup_after_kill"] = None
    except Exception as e:  # noqa: BLE001
        out["lookup_after_kill"] = type(e).__name__
    p = Phoenix.remote()
    out["before_restart"] = [rt.get(p.ping.remote()) for _ in range(3)]
    try:
        rt.get(p.die.remote(), timeout=30)
    except Exception:  # noqa: BLE001 - the death itself is not compared
        pass
    deadline, after = time.monotonic() + 60, None
    while time.monotonic() < deadline:
        try:
            after = rt.get(p.ping.remote(), timeout=10)
            break
        except Exception:  # noqa: BLE001 - the restart is in flight
            time.sleep(0.2)
    out["after_restart"] = after  # the new incarnation starts from zero
    for h in (c, p):
        rt.kill(h)
    return out


def prog_objects(a):
    """Each value through put/get and through a task, as its digest, or
    the name of the exception its round trip raised."""
    rt = a["rt"]

    @rt.remote
    def echo(x):
        return x

    out = {}
    for k, v in _values().items():
        for path, trip in (("put", lambda: rt.get(rt.put(v))),
                           ("task", lambda: rt.get(echo.remote(v)))):
            try:
                out[f"{path}/{k}"] = _digest(trip())
            except KILLED:
                raise
            except Exception as e:  # noqa: BLE001 - the type is the result
                out[f"{path}/{k}"] = type(e).__name__
    return out


def _wait_free(rt, key, amount, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.available_resources().get(key, 0.0) >= amount:
            return
        time.sleep(0.05)
    raise AssertionError(f"{key} not released")


def prog_grants(a):
    """Concurrent integer and fractional demands on a node with two chips
    (TPU) or two cards (GPU): the index sets each holder is granted."""
    rt, key, opt, get_ids = a["rt"], a["key"], a["opt"], a["ids"]

    @rt.remote
    class Holder:
        def ids(self):
            return get_ids()

    @rt.remote
    def hold(t):
        got = get_ids()
        time.sleep(t)
        return got

    out = {}
    for name, amount, count in (("whole", 1, 2), ("half", 0.5, 4)):
        holders = [Holder.options(**{opt: amount}).remote()
                   for _ in range(count)]
        ids = rt.get([h.ids.remote() for h in holders])
        out[f"actors_{name}"] = sorted(ids)
        for h in holders:
            rt.kill(h)
        _wait_free(rt, key, 2.0)
    for name, amount, count in (("whole", 1, 2), ("pair", 2, 1),
                                ("half", 0.5, 4)):
        ids = rt.get([hold.options(**{opt: amount}).remote(1.0)
                      for _ in range(count)])
        out[f"tasks_{name}"] = sorted(ids)
        _wait_free(rt, key, 2.0)
    out["none"] = rt.get(hold.remote(0))
    return out


PROGRAMS = {"tasks": prog_tasks, "wait": prog_wait, "errors": prog_errors,
            "actors": prog_actors, "grants": prog_grants}

# torch's own pickling, which ray_tpu's serializer falls back to, cannot
# load these (its storage path has no dtype for them); the port's tensor
# reducer carries every dtype
TORCH_PICKLE_FAILS = {"float8_e4m3fn", "float8_e5m2", "uint16", "uint32",
                      "uint64"}


@pytest.fixture(scope="class")
def both_runtimes():
    """One node of each runtime, alive together: 4 CPUs and two
    accelerators (ray_tpu's TPU chips, the port's GPUs)."""
    with _both(num_cpus=4, accelerators=2):
        yield


@pytest.mark.usefixtures("both_runtimes")
class TestSameProgramsSameResults:
    # rerun_if_pkilled, not rerun_if_killed: an outside pkill can change
    # these results without an error (a holder that answered and then died
    # frees its card for the next one, which then gets the same index)
    @pytest.mark.parametrize("program", list(PROGRAMS))
    def test_program(self, program):
        ref = rerun_if_pkilled(PROGRAMS[program], ACCEL["ref"])
        port = rerun_if_pkilled(PROGRAMS[program], ACCEL["port"])
        assert port == ref

    def test_grants_are_disjoint(self):
        g = rerun_if_pkilled(prog_grants, ACCEL["port"])
        assert g["actors_whole"] == [[0], [1]]
        assert g["tasks_whole"] == [[0], [1]]
        assert g["tasks_pair"] == [[0, 1]]
        # fractional demands share one card, best fit: two to a card
        assert g["actors_half"] == [[0], [0], [1], [1]]
        assert g["tasks_half"] == [[0], [0], [1], [1]]
        assert g["none"] == []

    def test_objects_round_trip_bit_for_bit(self):
        """Inline and store-sized numpy arrays and torch CPU tensors of
        every dtype: the port returns every one bit for bit, and ray_tpu
        the same bits wherever torch's own pickling can carry the dtype."""
        want = {k: _digest(v) for k, v in _values().items()}
        ref = rerun_if_killed(prog_objects, ACCEL["ref"])
        port = rerun_if_killed(prog_objects, ACCEL["port"])
        for key, got in port.items():
            name = key.split("/", 1)[1]
            assert got == want[name], key
            dtype = name[len("torch_"):].rsplit("_", 1)[0]
            if ref[key] != got:  # an exception's name, not other bits
                assert dtype in TORCH_PICKLE_FAILS and ":" not in ref[key], \
                    (key, ref[key])
        assert sum(k.startswith("put/torch_") for k in port) == \
            2 * len(TORCH_DTYPES) + 1

    def test_programs_ran_on_both(self):
        """The runtimes are two: each cluster sees its own node only."""
        assert ray_tpu.cluster_resources().get("TPU") == 2.0
        assert "GPU" not in ray_tpu.cluster_resources()
        assert ray_tpu_torch.cluster_resources().get("GPU") == 2.0
        assert "TPU" not in ray_tpu_torch.cluster_resources()
        assert not hasattr(ray_tpu_torch, "get_tpu_ids")


# ------------------------------------------------------- placement groups

STRATEGIES = ("STRICT_PACK", "PACK", "SPREAD", "STRICT_SPREAD")


def _cluster(a):
    """Three nodes of one runtime: two share an NVLink domain (a TPU slice
    for ray_tpu), the third is alone in another."""
    if a["rt"] is ray_tpu:
        from ray_tpu.core.cluster import Cluster
    else:
        from ray_tpu_torch.core.cluster import Cluster
    cluster = Cluster()
    nodes = [cluster.add_node(num_cpus=2, resources={a["key"]: 2},
                              labels={a["label"]: dom})
             for dom in ("d0", "d0", "d1")]
    cluster.connect()
    return cluster, [n.node_id.binary() for n in nodes]


def prog_placement(a):
    rt = a["rt"]
    if rt is ray_tpu:
        from ray_tpu.core.placement_group import (
            tpu_slice_placement_group as helper)
        from ray_tpu.util import placement_group, remove_placement_group
        helper_kw = {"chips_per_host": 2}
    else:
        from ray_tpu_torch.core.placement_group import (
            nvlink_domain_placement_group as helper)
        from ray_tpu_torch.util import placement_group, remove_placement_group
        helper_kw = {"gpus_per_host": 2}

    @rt.remote
    def where():
        nid = rt.get_runtime_context().node_id
        return nid if isinstance(nid, bytes) else nid.binary()

    cluster, node_ids = _cluster(a)
    index = {nid: i for i, nid in enumerate(node_ids)}
    out = {}
    try:
        for strategy in STRATEGIES:
            # a removed group's bundles return to their nodes later: each
            # group is placed on a cluster with nothing reserved, as the
            # strategies' choices depend on what each node has free
            _wait_free(rt, "CPU", 6.0)
            _wait_free(rt, a["key"], 6.0)
            pg = placement_group([{"CPU": 1, a["key"]: 1}] * 2,
                                 strategy=strategy)
            assert pg.ready(timeout=30), strategy
            placed = [index[n] for n in pg.bundle_node_ids()]
            # SPREAD breaks ties between equally loaded nodes by their
            # random ids: how many nodes the bundles span is what the
            # strategy decides
            out[strategy] = (len(set(placed)) if strategy.endswith("SPREAD")
                             else placed)
            if strategy == "STRICT_PACK":  # both bundles on the head node
                out["ran_in_bundle_0"] = index[rt.get(where.options(
                    placement_group=pg,
                    placement_group_bundle_index=0).remote(), timeout=60)]
            remove_placement_group(pg)
        _wait_free(rt, "CPU", 6.0)
        _wait_free(rt, a["key"], 6.0)
        pg = helper(2, **helper_kw)
        assert pg.ready(timeout=30)
        out["domain_helper"] = [index[n] for n in pg.bundle_node_ids()]
        remove_placement_group(pg)
        too_big = placement_group([{"CPU": 1, a["key"]: 2}] * 4,
                                  strategy="STRICT_SPREAD")
        out["infeasible_ready"] = too_big.ready(timeout=1)
    finally:
        rt.shutdown()
        cluster.shutdown()
    return out


def test_placement_groups_place_alike():
    ref = rerun_if_killed(prog_placement, ACCEL["ref"])
    port = rerun_if_killed(prog_placement, ACCEL["port"])
    assert port == ref
    # the helper packs one domain's two hosts, as ray_tpu packs a slice
    assert port["domain_helper"] == [0, 1]
    assert port["STRICT_PACK"] == [0, 0] and port["ran_in_bundle_0"] == 0
    assert port["SPREAD"] == port["STRICT_SPREAD"] == 2
    assert port["infeasible_ready"] is False
