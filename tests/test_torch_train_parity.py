"""The port's Train trainers against ray_tpu's, on the same inputs.

Each scenario of the reference's own tests of its trainers
(test_train_trainer, test_gbdt) runs through both packages, one runtime of each alive
side by side in this process: the reference's assertions hold on each, and
what the trainers and predictors return (each fit's metrics, history,
checkpoint and whether it failed; each prediction) is recorded and
compared between the two. A scenario whose body calls jax gets a twin on
the port. Then the slice as a whole: `tiny` trained 3 steps through each
package's `DataParallelTrainer` from one initial state (carried across by
`bridge.train_state_from_jax`), its batches read from a `Datastream` shard.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, normalize, recording, reference_tests, run
from torch_runtime import rerun_if_killed

FILES = ("test_train_trainer.py", "test_gbdt.py")
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
# scenarios whose body calls jax: twins below
TWINNED = {"test_jax_distributed_worker_group"}
# the reference's slow scenario stays slow here; its model's init is
# unseeded and its history holds wall-clock rates, so only the reference's
# own assertions hold it, on each package
SLOW = UNCOMPARED = {"test_transformers_trainer_ddp"}


def _fit_summary(result):
    """A Result as comparable values: metrics, history, the checkpoint's
    dict (a dict checkpoint) and whether the fit failed."""
    ckpt = result.checkpoint
    data = None
    if ckpt is not None and ckpt._data is not None:
        data = {k: v for k, v in ckpt.to_dict().items()
                if k not in ("estimator", "gbdt_model", "state_dict")}
    return {"metrics": result.metrics, "history": result.metrics_history,
            "checkpoint": data, "failed": result.error is not None}


def _sklearn_summary(result):
    return {"metrics": result.metrics, "failed": result.error is not None}


def _targets(pkg):
    import importlib

    name = PKGS[pkg].__name__
    tr = importlib.import_module(f"{name}.train.trainer")
    gb = importlib.import_module(f"{name}.train.gbdt")
    sk = importlib.import_module(f"{name}.train.sklearn")
    return [(tr.DataParallelTrainer, "fit", _fit_summary),
            (gb.GBDTTrainer, "fit", _fit_summary),
            (gb.GBDTPredictor, "predict"),
            (sk.SklearnTrainer, "fit", _sklearn_summary),
            (sk.SklearnPredictor, "predict")]


@pytest.fixture(scope="module")
def both():
    """One runtime of each package for the module. The reference's trainer
    loses each removed group's charged CPUs (ROADMAP C.8: every fit keeps
    its workers' CPUs), so its runtime gets room for every scenario's
    workers; the port's, repaired, runs them all in the reference
    fixture's 4."""
    ray_tpu.init(num_cpus=64, resources={"TPU": 8})
    try:
        ray_tpu_torch.init(num_cpus=4, resources={"GPU": 8})
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
    finally:
        ray_tpu.shutdown()


CASES = [pytest.param(f, name, marks=[pytest.mark.slow] if name in SLOW
                      else [], id=f"{f[5:-3]}::{name}")
         for f in FILES for name in reference_tests(f)
         if name not in TWINNED]


@pytest.mark.parametrize("filename,name", CASES)
def test_reference_scenario_matches(both, filename, name, tmp_path, request):
    got = {}
    for pkg in PKGS:
        ns = load(filename, pkg)

        def scenario():
            with recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        got[pkg] = [repr(c).replace(str(tmp_path / pkg), "<tmp>")
                    for c in rerun_if_killed(scenario)]
    if name not in UNCOMPARED:
        assert got["port"] == got["ref"]


def test_to_port_names_the_ports_trainers():
    from torch_libs import to_port

    src = ("JaxTrainer JaxPredictor ScalingConfig(use_tpu=True, "
           "chips_per_worker=4) rt.get_tpu_ids() ray_tpu.train")
    assert to_port(src) == (
        "MeshTrainer TorchPredictor ScalingConfig(use_gpu=True, "
        "gpus_per_worker=4) rt.get_gpu_ids() ray_tpu_torch.train")


# ------------------------------------------------ a twin and the GPU contract


def _gloo_world_loop_factory():
    """The loop of the process-group twin, defined here so the runtime
    ships it by value (its workers cannot import this module)."""
    import os  # noqa: F401

    def _loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.air import session
        from ray_tpu_torch.parallel import (initialize_from_session,
                                            shutdown_group)

        initialize_from_session(group_name="t1", device="cpu")
        try:
            x = torch.ones(1)
            dist.all_reduce(x)
            session.report({"total": float(x), "world": dist.get_world_size(),
                            "rank": session.get_world_rank()})
        finally:
            shutdown_group("t1")

    return _loop


def test_process_group_worker_group_twin(both):
    """Twin of test_jax_distributed_worker_group: two CPU workers form one
    gloo world through the KV rendezvous (`initialize_from_session`), and an
    all-reduce of ones gives the world size."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    def program():
        return DataParallelTrainer(
            _gloo_world_loop_factory(),
            scaling_config=ScalingConfig(
                num_workers=2, resources_per_worker={"CPU": 1})).fit()

    result = rerun_if_killed(program)
    assert result.error is None, result.error
    assert result.metrics == {"total": 2.0, "world": 2, "rank": 0}


def test_use_gpu_worker_without_a_card_fails(both):
    """A `use_gpu` worker on a node whose declared GPUs are not cards of
    this host fails its attempt; it never trains on the CPU."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    if torch.cuda.is_available():
        pytest.skip("this host has a card")

    def loop():
        session.report({"ran": 1})

    result = rerun_if_killed(DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1,
                                           use_gpu=True)).fit)
    assert result.error is not None
    assert "use_gpu worker has no card" in str(result.error)
    assert result.metrics_history == []


def _report_loop_factory():
    import os  # noqa: F401

    def _loop():
        import torch

        from ray_tpu_torch.air import Checkpoint, session

        session.report({"loss": torch.tensor(1.5), "vec": torch.arange(3.0),
                        "step_time_s": 0.25},
                       checkpoint=Checkpoint.from_dict(
                           {"w": torch.arange(4, dtype=torch.bfloat16)}))

    return _loop


def test_reports_leave_the_worker_as_numbers_and_feed_the_ports_gauges(both):
    """A one-element tensor in a report reaches the driver as a Python
    number (and so its gauge), a larger one as a CPU tensor; the gauges
    are the port's `ray_tpu_torch_train_*` series."""
    import torch

    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer
    from ray_tpu_torch.util.metrics import export_prometheus

    result = rerun_if_killed(DataParallelTrainer(
        _report_loop_factory(),
        scaling_config=ScalingConfig(num_workers=1)).fit)
    assert result.error is None, result.error
    m = result.metrics
    assert type(m["loss"]) is float and m["loss"] == 1.5
    assert m["vec"].device.type == "cpu" and m["vec"].tolist() == [0, 1, 2]
    w = result.checkpoint.to_dict()["w"]
    assert w.dtype == torch.bfloat16 and w.tolist() == [0, 1, 2, 3]
    text = export_prometheus()
    assert "ray_tpu_torch_train_loss 1.5" in text
    assert "ray_tpu_torch_train_step_seconds 0.25" in text
    assert "\nray_tpu_train_loss" not in text


def test_shrink_halves_the_gpu_grant():
    """The elastic ladder reads the port's GPU fields: workers first, then
    `resources_per_worker["GPU"]`, then `gpus_per_worker`."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    t = DataParallelTrainer(lambda: None, scaling_config=ScalingConfig(
        num_workers=2, resources_per_worker={"GPU": 4}, elastic=True))
    seen = []
    while True:
        sc = t.scaling_config
        seen.append((sc.num_workers, sc.worker_resources()))
        if not t._shrink():
            break
    assert seen == [(2, {"GPU": 4}), (1, {"GPU": 4}), (1, {"GPU": 2.0}),
                    (1, {"GPU": 1.0})]
    t = DataParallelTrainer(lambda: None, scaling_config=ScalingConfig(
        use_gpu=True, gpus_per_worker=2, elastic=True))
    assert t.scaling_config.worker_resources() == {"GPU": 2.0}
    assert t.scaling_config.strategy() == "STRICT_PACK"
    assert t._shrink() and t.scaling_config.worker_resources() == {"GPU": 1.0}
    assert not t._shrink()


# --------------------------------------------- the slice as a whole


SEQ, BATCH, STEPS = 32, 2, 3


def _jax_loop_factory():
    """The JAX package's worker loop, defined here so the runtime ships it
    by value."""
    import os  # noqa: F401

    def _jax_loop(config):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from ray_tpu.air import session
        from ray_tpu.models import ModelConfig
        from ray_tpu.parallel import MeshConfig, make_mesh
        from ray_tpu.train import make_train_step
        from ray_tpu.train.step import default_optimizer

        mesh = make_mesh(MeshConfig(dp=1), jax.devices()[:1])
        step_fn, init_fn, _ = make_train_step(
            ModelConfig.tiny(), mesh, default_optimizer(1e-3, warmup_steps=1),
            donate=False)
        state = init_fn(jax.random.PRNGKey(0))
        shard = session.get_dataset_shard("train")
        for i, b in zip(range(STEPS), shard.iter_batches(batch_size=BATCH)):
            tokens = jnp.asarray(np.asarray(b["tokens"]))
            state, m = step_fn(state, {"inputs": tokens[:, :-1],
                                       "targets": tokens[:, 1:]})
            session.report({"step": i + 1, "loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])})

    return _jax_loop


def _port_loop_factory():
    """The port's worker loop: the same, from the JAX initial state."""
    import os  # noqa: F401

    def _port_loop(config):
        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import ModelConfig
        from ray_tpu_torch.train import default_optimizer, make_train_step

        step_fn, _ = make_train_step(ModelConfig.tiny(), default_optimizer(
            1e-3, warmup_steps=1), device="cpu")
        state = config["init"]
        shard = session.get_dataset_shard("train")
        for i, b in zip(range(STEPS), shard.iter_torch_batches(
                batch_size=BATCH, device="cpu")):
            tokens = b["tokens"].long()
            state, m = step_fn(state, {"inputs": tokens[:, :-1],
                                       "targets": tokens[:, 1:]})
            session.report({"step": i + 1, "loss": m["loss"],
                            "grad_norm": m["grad_norm"]})

    return _port_loop


def test_trainer_trains_tiny_like_the_jax_package(both):
    """ROADMAP C.3's bounds: losses within 1e-5, grad norms within 1e-4,
    each package's DataParallelTrainer reading the same token windows from
    its own Datastream (a streaming_split shard)."""
    import jax

    from ray_tpu import data as ref_data
    from ray_tpu.air import ScalingConfig as RefScaling
    from ray_tpu.models import ModelConfig as JConfig
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu.train import DataParallelTrainer as RefTrainer
    from ray_tpu.train import make_train_step
    from ray_tpu.train.step import default_optimizer
    from ray_tpu_torch import data
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.bridge import train_state_from_jax
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.train import DataParallelTrainer

    tokens = np.random.default_rng(13).integers(
        0, JConfig.tiny().vocab_size, (STEPS * BATCH, SEQ + 1),
        dtype=np.int32)
    _, init_fn, _ = make_train_step(
        JConfig.tiny(), make_mesh(MeshConfig(dp=1), jax.devices()[:1]),
        default_optimizer(1e-3, warmup_steps=1), donate=False)
    init = train_state_from_jax(jax.device_get(init_fn(jax.random.PRNGKey(0))),
                                ModelConfig.tiny(), device="cpu")

    def ref():
        return RefTrainer(
            _jax_loop_factory(), scaling_config=RefScaling(num_workers=1),
            datasets={"train": ref_data.from_numpy({"tokens": tokens})}).fit()

    def port():
        return DataParallelTrainer(
            _port_loop_factory(), train_loop_config={"init": init},
            scaling_config=ScalingConfig(num_workers=1),
            datasets={"train": data.from_numpy({"tokens": tokens})}).fit()

    want, got = rerun_if_killed(ref), rerun_if_killed(port)
    assert want.error is None, want.error
    assert got.error is None, got.error
    w, g = want.metrics_history, got.metrics_history
    assert [m["step"] for m in g] == [m["step"] for m in w] == [1, 2, 3]
    assert all(type(m["loss"]) is float for m in g)
    assert w[-1]["loss"] < w[0]["loss"]
    np.testing.assert_allclose([m["loss"] for m in g],
                               [m["loss"] for m in w], rtol=1e-5)
    np.testing.assert_allclose([m["grad_norm"] for m in g],
                               [m["grad_norm"] for m in w], rtol=1e-4)
