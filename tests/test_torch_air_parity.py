"""The port's AIR layer against ray_tpu's, on the same inputs.

Checkpoints: the port flattens pytrees as jax does (dicts by sorted key,
lists, tuples, namedtuples, None), so a dict -> directory -> dict round trip
gives the reference's structure and values; torch tensors of any dtype
(bf16 included) round-trip bit for bit through a directory, a pickle and
the runtime's store. `ScalingConfig` does the reference's arithmetic with
its TPU fields mapped to GPU ones; the session API reports what the
reference's does; `parallel.initialize_from_session` joins a group from the
session. The integrations keep their imports lazy and name the port.
"""

import collections
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tpu.air import checkpoint as ref_ckpt
from ray_tpu.air import config as ref_config
from ray_tpu.air import session as ref_session
from ray_tpu_torch.air import checkpoint as port_ckpt
from ray_tpu_torch.air import config as port_config
from ray_tpu_torch.air import session as port_session
from torch_runtime import one_runtime

REPO = Path(__file__).resolve().parents[1]
Point = collections.namedtuple("Point", "x y")


def _trees():
    rng = np.random.default_rng(0)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "flat": {"w": a(3, 4), "b": a(4), "a": a(2)},
        "nested": {"z": {"k": a(2, 2), "j": [a(3), a(1)]}, "m": (a(2), a(5))},
        "none": {"p": None, "q": a(3), "r": [None, a(2)]},
        "namedtuple": {"pt": Point(a(2), a(3)), "n": np.arange(4)},
        "scalars": {"s": np.float32(2.5), "i": np.int64(7), "v": a(1)},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_tree_flatten_matches_jax(name):
    tree = _trees()[name]
    leaves, treedef = port_ckpt.tree_flatten(tree)
    want, jdef = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert g is w
    back = port_ckpt.tree_unflatten(treedef, leaves)
    jback = jax.tree_util.tree_unflatten(jdef, want)
    assert jax.tree_util.tree_structure(back) == jdef
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jback)):
        assert g is w


@pytest.mark.parametrize("name", list(_trees()))
def test_checkpoint_directory_round_trip_matches_reference(name, tmp_path):
    tree = _trees()[name]
    ref = ref_ckpt.Checkpoint.from_dict(tree).to_directory(
        str(tmp_path / "ref"))
    port = port_ckpt.Checkpoint.from_dict(tree).to_directory(
        str(tmp_path / "port"))
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    want = ref_ckpt.Checkpoint.from_directory(ref).to_dict()
    got = port_ckpt.Checkpoint.from_directory(port).to_dict()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


def test_non_array_checkpoint_pickles_whole_like_the_reference(tmp_path):
    data = {"step": 3, "name": "x", "arr": np.arange(3)}
    for mod, d in ((ref_ckpt, "ref"), (port_ckpt, "port")):
        path = mod.Checkpoint.from_dict(data).to_directory(str(tmp_path / d))
        assert os.listdir(path) == ["checkpoint.pkl"]
        got = mod.Checkpoint.from_directory(path).to_dict()
        assert got["step"] == 3 and got["name"] == "x"
        np.testing.assert_array_equal(got["arr"], data["arr"])


def _tensor_tree():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "f32": torch.randn(3, 4, generator=g),
            "layers": [torch.randn(2, generator=g).to(torch.bfloat16),
                       torch.arange(4, dtype=torch.int32)],
            "np": np.arange(6, dtype=np.float32).reshape(2, 3)}


def _assert_same_bits(got, want):
    for k in ("bf16", "f32"):
        assert got[k].dtype == want[k].dtype and got[k].device.type == "cpu"
        assert torch.equal(got[k].view(torch.int16 if k == "bf16"
                                       else torch.int32),
                           want[k].view(torch.int16 if k == "bf16"
                                        else torch.int32))
    for g, w in zip(got["layers"], want["layers"]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_array_equal(got["np"], want["np"])


def test_tensor_checkpoint_round_trips_through_a_directory(tmp_path):
    want = _tensor_tree()
    path = port_ckpt.Checkpoint.from_dict(want).to_directory(str(tmp_path))
    assert sorted(os.listdir(path)) == ["arrays.npz", "checkpoint.pkl",
                                        "tensors.pt"]
    got = port_ckpt.Checkpoint.from_directory(path).to_dict()
    _assert_same_bits(got, want)
    # a directory-backed checkpoint copies to another directory whole
    other = port_ckpt.Checkpoint.from_directory(path).to_directory(
        str(tmp_path / "copy"))
    _assert_same_bits(port_ckpt.Checkpoint.from_directory(other).to_dict(),
                      want)


def test_tensor_checkpoint_round_trips_through_pickle_and_the_store():
    import ray_tpu_torch

    want = _tensor_tree()
    ck = port_ckpt.Checkpoint.from_dict(want)
    assert ck.to_dict() is ck._data  # the process that built it: as given
    _assert_same_bits(pickle.loads(pickle.dumps(ck)).to_dict(), want)
    with one_runtime(ray_tpu_torch, num_cpus=2):
        got = ray_tpu_torch.get(ray_tpu_torch.put(ck)).to_dict()
    _assert_same_bits(got, want)


def test_to_host_keeps_structure():
    """What a pickled checkpoint carries: every container type and order
    kept, CPU tensors as they are."""
    t = torch.ones(2)
    tree = collections.OrderedDict(
        b=[t, (t, None)], a=Point(t, 3), c={"z": 1, "y": t})
    out = port_ckpt._to_host(tree)
    assert type(out) is collections.OrderedDict and list(out) == ["b", "a",
                                                                 "c"]
    assert type(out["a"]) is Point and out["a"].y == 3
    assert isinstance(out["b"][1], tuple) and out["b"][1][1] is None
    assert list(out["c"]) == ["z", "y"] and out["c"]["y"] is t


def test_temp_checkpoint_directory_is_the_ports():
    path = port_ckpt.Checkpoint.from_dict({"x": np.zeros(1)}).to_directory()
    try:
        assert os.path.basename(path).startswith("rtt-ckpt-")
    finally:
        import shutil

        shutil.rmtree(path)


# ----------------------------------------------------------- ScalingConfig


@pytest.mark.parametrize("kw", [
    {}, {"num_workers": 4}, {"use_accel": True},
    {"use_accel": True, "per_worker": 2, "num_workers": 8},
    {"use_accel": True, "placement_strategy": "SPREAD"},
    {"use_accel": True, "resources_per_worker": {"CPU": 2.0}},
    {"placement_strategy": "STRICT_SPREAD"},
    {"use_accel": True, "per_worker": 1, "elastic": True,
     "topology": "8xH100"},
])
def test_scaling_config_matches_reference_with_tpu_as_gpu(kw):
    kw = dict(kw)
    use, per = kw.pop("use_accel", False), kw.pop("per_worker", None)
    ref_kw = dict(kw, use_tpu=use)
    port_kw = dict(kw, use_gpu=use)
    if per is not None:
        ref_kw["chips_per_worker"] = port_kw["gpus_per_worker"] = per
    elif use:  # each package's own default: 4 chips a host, 1 card a worker
        assert port_config.ScalingConfig(use_gpu=True).gpus_per_worker == 1
        ref_kw["chips_per_worker"] = 1
    ref = ref_config.ScalingConfig(**ref_kw)
    port = port_config.ScalingConfig(**port_kw)
    want = {("GPU" if k == "TPU" else k): v
            for k, v in ref.worker_resources().items()}
    assert port.worker_resources() == want
    assert port.strategy() == ref.strategy()
    assert (port.num_workers, port.elastic) == (ref.num_workers, ref.elastic)


def test_run_configs_match_reference():
    for name in ("RunConfig", "FailureConfig", "CheckpointConfig"):
        ref, port = getattr(ref_config, name)(), getattr(port_config, name)()
        assert type(ref).__dataclass_fields__.keys() == \
            type(port).__dataclass_fields__.keys()
        assert repr(port).split("(", 1)[1] == repr(ref).split("(", 1)[1]


# --------------------------------------------------------------- session


def _drive_session(mod, ckpt_mod):
    reported = []
    ck = ckpt_mod.Checkpoint.from_dict({"w": np.ones(2)})
    s = mod._Session(rank=1, world_size=4,
                     report_fn=lambda m, c: reported.append((m, c)),
                     checkpoint=ck, dataset_shards={"train": "shard"},
                     trial_info={"name": "t1"})
    mod._set_session(s)
    try:
        mod.report({"loss": 1.5})
        mod.report({"loss": 1.0}, checkpoint=ck)
        out = (mod.get_world_rank(), mod.get_world_size(),
               mod.get_dataset_shard(), mod.get_dataset_shard("x"),
               mod.get_trial_name(), mod.get_checkpoint() is ck)
    finally:
        mod._set_session(None)
    with pytest.raises(RuntimeError, match="no active session"):
        mod.get_world_rank()
    return out, [(m, c is ck) for m, c in reported]


def test_session_api_matches_reference():
    assert _drive_session(port_session, port_ckpt) == _drive_session(
        ref_session, ref_ckpt)


def test_session_report_carries_the_ports_checkpoint_save_seconds(tmp_path):
    from ray_tpu_torch.train import checkpointing

    checkpointing.save_sharded({"w": torch.ones(4)}, str(tmp_path / "c"))
    reported = []
    port_session._set_session(port_session._Session(
        0, 1, lambda m, c: reported.append(m), None, None))
    try:
        port_session.report({"loss": 1.0})
        port_session.report({"loss": 0.5})
    finally:
        port_session._set_session(None)
    assert reported[0]["checkpoint_save_seconds"] > 0
    assert "checkpoint_save_seconds" not in reported[1]


def test_initialize_from_session_joins_a_group_of_one():
    """Inside a session of rank 0 and world 1 on the CPU: a gloo group of
    one; outside a session, the reference's RuntimeError."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import distributed, initialize_from_session

    with pytest.raises(RuntimeError, match="no active session"):
        initialize_from_session(group_name="air-session", device="cpu")
    port_session._set_session(port_session._Session(
        0, 1, lambda m, c: None, None, None))
    try:
        initialize_from_session(group_name="air-session", device="cpu")
        assert dist.is_initialized()
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        assert dist.get_backend() == "gloo"
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        initialize_from_session(group_name="air-session", device="cpu")
    finally:
        port_session._set_session(None)
        distributed.shutdown_group("air-session")
    assert not dist.is_initialized()


def test_result_matches_reference():
    from ray_tpu.air.result import Result as RefResult
    from ray_tpu_torch.air.result import Result

    assert Result.__dataclass_fields__.keys() == \
        RefResult.__dataclass_fields__.keys()
    r = Result(metrics={"config": {"a": 1}, "x": 2})
    assert r.config == {"a": 1} and r.metrics_history == []


def test_integrations_are_lazy_and_name_the_port():
    """Importing the integrations (and the libraries) loads no tracker
    and no pyarrow or pandas; the default W&B project and MLflow
    experiment are the port's."""
    code = ("import sys\n"
            "import ray_tpu_torch.air.integrations as i\n"
            "import ray_tpu_torch.tune, ray_tpu_torch.data, "
            "ray_tpu_torch.workflow\n"
            "print(i.WandbLoggerCallback()._project, "
            "i.MLflowLoggerCallback()._experiment_name, "
            "sorted(m for m in sys.modules if m.split('.')[0] in "
            "('wandb', 'mlflow', 'pyarrow', 'pandas', 'pymongo', 'jax', "
            "'ray_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ray_tpu_torch", "ray_tpu_torch", "[]"]
