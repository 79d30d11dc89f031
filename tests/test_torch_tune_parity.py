"""The port's Tune against ray_tpu's, on the same inputs.

Each scenario of the reference's test_tune runs through both packages, one
runtime of each alive side by side in this process: the reference's
assertions hold on each, and what its calls return (each sweep's results
and best configs, every searcher suggestion, PBT's explored configs, the
schedulers' decisions) is recorded and compared between the two, where the
scenario fixes it (ASHA's stops and PBT's exploits are compared on fixed
streams in tests/test_torch_tune_search_parity.py, with the loggers and
searchers). The port's GPU contract: trials on fractional grants, a trial
with no grant never touching CUDA, tensor metrics leaving a trial as
numbers. Then the slice as a whole: a sweep training `tiny`
from the native loader, one trial failing once and restarting from its
checkpoint, on the JAX package and on the port (from the same initial
state, carried across by `bridge.train_state_from_jax`).
"""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, normalize, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_killed

FILES = ("test_tune.py",)
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
# scenarios whose recorded values depend on timing: trials running at once
# report in arrival order (ASHA's and PBT's decisions, PB2's GP). The reference's own assertions still hold on
# both packages; ASHA's and PBT's decisions are compared on streams that
# fix the order in tests/test_torch_tune_search_parity.py.
UNCOMPARED = {"test_asha_stops_bad_trials", "test_pbt_exploits_checkpoints",
              "test_pb2_gp_explore_prefers_good_region"}


def _grid(grid):
    """A ResultGrid as its trials' configs, metrics and errors, sorted."""
    rows = [(normalize(r.config), normalize({k: v for k, v in
                                             r.metrics.items()
                                             if k != "config"}),
             r.error is not None) for r in grid]
    return sorted(rows, key=repr)


def _targets(pkg):
    import importlib

    name = PKGS[pkg].__name__
    tuner = importlib.import_module(f"{name}.tune.tuner")
    se = importlib.import_module(f"{name}.tune.searchers")
    sc = importlib.import_module(f"{name}.tune.schedulers")
    return [(tuner.Tuner, "fit", _grid),
            (se.RandomSearcher, "suggest"), (se.ConcurrencyLimiter, "suggest"),
            (se._HistorySearcher, "suggest"),
            (sc.PopulationBasedTraining, "_explore"), (sc.PB2, "_explore"),
            (sc.ASHAScheduler, "on_trial_result"),
            (sc.MedianStoppingRule, "on_trial_result"),
            (sc.HyperBandScheduler, "on_trial_result"),
            (sc.PopulationBasedTraining, "on_trial_result")]


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=2):
        yield


# test_tune's two slowest scenarios run in tests/test_torch_tune_search_parity.py,
# which keeps each file's run short
ELSEWHERE = {"test_tuner_experiment_resume_after_driver_kill",
             "test_timeout_stopper_stops_experiment"}
CASES = [(f, name) for f in FILES for name in reference_tests(f)
         if name not in ELSEWHERE]


@pytest.mark.parametrize("filename,name", CASES,
                         ids=[f"{f[5:-3]}::{n}" for f, n in CASES])
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


# ------------------------------------------------ the port's GPU contract


def _grant_probe_factory():
    """`grant_probe`, defined here so the runtime ships it by value (its
    workers cannot import this module)."""
    import os  # noqa: F401

    def _grant_probe(config):
        """A trial's view of its grant: what it reported and whether its
        process ever probed CUDA."""
        import sys

        import ray_tpu_torch
        from ray_tpu_torch import tune

        torch = sys.modules.get("torch")
        worker = sys.modules["ray_tpu_torch.core.worker"]
        tune.report({
            "gpu_ids": list(ray_tpu_torch.get_gpu_ids()),
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "cuda_probed": worker._cuda_cards is not None,
            "loss": __import__("torch").tensor(config["x"] * 0.5),
            "vec": __import__("torch").arange(3.0),
        })

    return _grant_probe


@pytest.mark.parametrize("resources,probed", [
    ({"GPU": 0.5}, True), (None, False)])
def test_trial_grants_and_host_metrics(both, resources, probed):
    """`resources_per_trial={"GPU": 0.5}` runs two trials at once on card
    0; a trial granted no GPU never touches CUDA (its process never even
    asks torch for a card). Tensor metrics leave a trial as Python numbers
    (one element) or CPU tensors."""
    import torch

    from ray_tpu_torch import tune

    def program():
        return tune.Tuner(
            _grant_probe_factory(), param_space={"x": tune.grid_search([1.0, 2.0])},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=2,
                                        resources_per_trial=resources)).fit()

    grid = rerun_if_killed(program)
    assert not grid.errors
    for r in grid:
        m = r.metrics
        assert m["gpu_ids"] == ([0] if resources else [])
        assert m["cuda_initialized"] is False
        assert m["cuda_probed"] is probed
        assert type(m["loss"]) is float and m["loss"] == r.config["x"] * 0.5
        assert isinstance(m["vec"], torch.Tensor) and m["vec"].device.type \
            == "cpu"
    assert grid.get_best_result().config == {"x": 1.0}


def test_trials_running_gauge_is_the_ports():
    from ray_tpu_torch.tune import tuner
    from ray_tpu_torch.util.metrics import export_prometheus

    tuner._trials_running_gauge().set(3.0)
    text = export_prometheus()
    assert "ray_tpu_torch_tune_trials_running 3.0" in text
    assert "\nray_tpu_tune_trials_running" not in text


# --------------------------------------------- the slice as a whole


SEQ, BATCH, STEPS = 32, 2, 3


def _jax_trainable_factory():
    """`jax_trainable`, defined here so the runtime ships it by value (its
    workers cannot import this module)."""
    import os  # noqa: F401

    def _jax_trainable(config, *, path, marks):
        """The JAX package's trial: `tiny` through make_train_step, batches
        from its native loader; the "restart" trial saves after step 1 and
        fails at step 2 on its first attempt."""
        import os

        import jax
        import jax.numpy as jnp
        import numpy as np

        from ray_tpu import tune
        from ray_tpu.air.checkpoint import Checkpoint
        from ray_tpu.data.token_loader import TokenLoader
        from ray_tpu.models import ModelConfig
        from ray_tpu.parallel import MeshConfig, make_mesh
        from ray_tpu.train import make_train_step
        from ray_tpu.train.step import default_optimizer

        mesh = make_mesh(MeshConfig(dp=1), jax.devices()[:1])
        step_fn, init_fn, _ = make_train_step(
            ModelConfig.tiny(), mesh, default_optimizer(1e-3, warmup_steps=1),
            donate=False)
        state = init_fn(jax.random.PRNGKey(0))
        loader = TokenLoader(path, batch=BATCH, seq_len=SEQ, n_threads=1,
                             seed=7, mode="sequential")
        ckpt, start = tune.get_checkpoint(), 0
        if ckpt is not None:
            saved = ckpt.to_dict()
            state = jax.tree_util.tree_map(jnp.asarray, saved["state"])
            start = saved["step"]
            for _ in range(start):
                loader.next()
        mark = os.path.join(marks, f"ref-{config['run']}")
        for i in range(start, STEPS):
            if config["run"] == "restart" and i == 1 and not os.path.exists(mark):
                open(mark, "w").close()
                raise RuntimeError("the planned failure")
            tokens = loader.next()
            state, m = step_fn(state, {"inputs": jnp.asarray(tokens[:, :-1]),
                                       "targets": jnp.asarray(tokens[:, 1:])})
            host = jax.device_get(state)
            out = {"step": i + 1, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            if i + 1 == STEPS:
                out["params"] = host.params
            tune.report(out, checkpoint=Checkpoint.from_dict(
                {"state": host, "step": i + 1}))

    return _jax_trainable


def _port_trainable_factory():
    """`port_trainable`, defined here so the runtime ships it by value (its
    workers cannot import this module)."""
    import os  # noqa: F401

    def _port_trainable(config, init=None, *, path, marks):
        """The port's trial: the same, from the JAX initial state."""
        import os

        import torch

        from ray_tpu_torch import tune
        from ray_tpu_torch.air import Checkpoint
        from ray_tpu_torch.bridge import params_to_numpy
        from ray_tpu_torch.data.token_loader import TokenLoader, native
        from ray_tpu_torch.models import ModelConfig
        from ray_tpu_torch.train import default_optimizer, make_train_step

        step_fn, _ = make_train_step(ModelConfig.tiny(), default_optimizer(
            1e-3, warmup_steps=1), device="cpu")
        state = init
        loader = TokenLoader(path, batch=BATCH, seq_len=SEQ, n_threads=1,
                             seed=7, mode="sequential")
        assert native()
        ckpt, start = tune.get_checkpoint(), 0
        if ckpt is not None:
            saved = ckpt.to_dict()
            state, start = saved["state"], saved["step"]
            for _ in range(start):
                loader.next()
        mark = os.path.join(marks, f"port-{config['run']}")
        for i in range(start, STEPS):
            if config["run"] == "restart" and i == 1 and not os.path.exists(mark):
                open(mark, "w").close()
                raise RuntimeError("the planned failure")
            tokens = torch.from_numpy(loader.next())
            state, m = step_fn(state, {"inputs": tokens[:, :-1],
                                       "targets": tokens[:, 1:]})
            out = {"step": i + 1, "loss": m["loss"], "grad_norm": m["grad_norm"]}
            if i + 1 == STEPS:
                out["params"] = params_to_numpy(state.params)
            tune.report(out, checkpoint=Checkpoint.from_dict(
                {"state": state, "step": i + 1}))

    return _port_trainable


def _sweep(pkg, trainable, tmp_path):
    import importlib

    tune = importlib.import_module(f"{PKGS[pkg].__name__}.tune")
    air = importlib.import_module(f"{PKGS[pkg].__name__}.air")
    grid = tune.Tuner(
        trainable,
        param_space={"run": tune.grid_search(["straight", "restart"])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=air.RunConfig(
            name=f"sweep-{pkg}", storage_path=str(tmp_path),
            failure_config=air.FailureConfig(max_failures=1))).fit()
    assert not grid.errors, grid.errors
    out = {}
    for r in grid:
        hist = sorted((m for m in r.metrics_history if "step" in m),
                      key=lambda m: m["step"])
        assert [m["step"] for m in hist] == list(range(1, STEPS + 1))
        out[r.config["run"]] = {
            "loss": [m["loss"] for m in hist],
            "grad_norm": [m["grad_norm"] for m in hist],
            "params": hist[-1]["params"]}
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def test_sweep_trains_tiny_like_the_jax_package(both, tmp_path):
    """ROADMAP C.3's bounds: losses within 1e-5, final params within 1e-4;
    in each package the restarted trial equals the straight one exactly."""
    import functools

    import jax

    from ray_tpu.models import ModelConfig as JConfig
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu.train import make_train_step
    from ray_tpu.train.step import default_optimizer
    from ray_tpu_torch import tune
    from ray_tpu_torch.bridge import train_state_from_jax
    from ray_tpu_torch.models import ModelConfig

    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(11).integers(
        0, JConfig.tiny().vocab_size, 8 * BATCH * (SEQ + 1),
        dtype=np.int32).tofile(path)
    marks = tmp_path / "marks"
    marks.mkdir()
    kw = dict(path=path, marks=str(marks))
    _, init_fn, _ = make_train_step(
        JConfig.tiny(), make_mesh(MeshConfig(dp=1), jax.devices()[:1]),
        default_optimizer(1e-3, warmup_steps=1), donate=False)
    init = train_state_from_jax(jax.device_get(init_fn(jax.random.PRNGKey(0))),
                                ModelConfig.tiny(), device="cpu")
    ref = rerun_if_killed(_sweep, "ref", functools.partial(
        _jax_trainable_factory(), **kw), tmp_path)
    port = rerun_if_killed(_sweep, "port", tune.with_parameters(
        functools.partial(_port_trainable_factory(), **kw), init=init), tmp_path)
    for out in (ref, port):
        s, r = out["straight"], out["restart"]
        assert r["loss"] == s["loss"] and r["grad_norm"] == s["grad_norm"]
        for k, v in _leaves(s["params"]).items():
            np.testing.assert_array_equal(_leaves(r["params"])[k], v)
    want, got = ref["straight"], port["straight"]
    assert want["loss"][-1] < want["loss"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    w, g = _leaves(want["params"]), _leaves(got["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
