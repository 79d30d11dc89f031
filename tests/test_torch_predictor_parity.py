"""The port's predictors against ray_tpu's, on the same inputs.

Each scenario of the reference's test_predictor_util runs through both
packages, one runtime of each alive side by side in this process, and what
its predictors and trainers return is recorded and compared; the two whose
body reaches jax (`JaxPredictor`) get twins on `TorchPredictor` on the
CPU. Then the slice as a whole: `TorchPredictor` against `JaxPredictor`,
each applying its own package's `forward` to the same `tiny` params, and a
`BatchPredictor` of each over the same 4 blocks, row for row.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, normalize, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_killed, rerun_if_pkilled

FILE = "test_predictor_util.py"
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
TWINNED = {"test_jax_predictor_from_checkpoint",
           "test_batch_predictor_over_datastream"}


def _rows(ds):
    return ds.take_all()


def _targets(pkg):
    import importlib

    name = PKGS[pkg].__name__
    pr = importlib.import_module(f"{name}.train.predictor")
    sk = importlib.import_module(f"{name}.train.sklearn")
    return [(pr.BatchPredictor, "predict", _rows),
            (sk.SklearnTrainer, "fit",
             lambda r: {"metrics": r.metrics, "failed": r.error is not None}),
            (sk.SklearnPredictor, "predict")]


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=8):
        yield


CASES = [name for name in reference_tests(FILE) if name not in TWINNED]


@pytest.mark.parametrize("name", CASES)
def test_reference_scenario_matches(both, name, tmp_path, request):
    got = {}
    for pkg in PKGS:
        ns = load(FILE, pkg)

        def scenario():
            with recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        # rerun_if_pkilled, not rerun_if_killed: SklearnTrainer.fit (and
        # the other trainers) catch a lost worker into Result.error, so an
        # outside pkill surfaces as the scenario's own assertion failing
        got[pkg] = [repr(c) for c in rerun_if_pkilled(scenario)]
    assert got["port"] == got["ref"]


# ------------------------------------------------ twins of jax scenarios


def _matmul_apply(params, batch):
    return batch["x"] @ params["w"]


def test_predictor_from_checkpoint_twin():
    """Twin of test_jax_predictor_from_checkpoint: the same `x @ w` through
    TorchPredictor on the CPU gives JaxPredictor's predictions."""
    from ray_tpu.air.checkpoint import Checkpoint as RefCheckpoint
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.train import TorchPredictor

    w = {"w": np.array([[2.0], [3.0]], np.float32)}
    x = {"x": np.array([[1.0, 1.0], [2.0, 0.0]], np.float32)}
    want = JaxPredictor.from_checkpoint(
        RefCheckpoint.from_dict({"params": w}),
        apply_fn=_matmul_apply).predict(x)
    pred = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": w}), apply_fn=_matmul_apply,
        device="cpu")
    got = pred.predict(x)
    assert normalize(got) == normalize(want)
    np.testing.assert_allclose(got["predictions"][:, 0], [5.0, 4.0])


def _matmul_factory():
    """`x @ w`, defined here so the runtime ships it by value (its workers
    cannot import this module)."""
    import os  # noqa: F401

    def _apply(params, batch):
        return batch["x"] @ params["w"]

    return _apply


def _batch_predict(pkg, predictor, kw):
    import importlib

    rt = PKGS[pkg].__name__
    data = importlib.import_module(f"{rt}.data")
    ckpt_mod = importlib.import_module(f"{rt}.air.checkpoint")
    train = importlib.import_module(f"{rt}.train")
    ckpt = ckpt_mod.Checkpoint.from_dict(
        {"params": {"w": np.array([[1.0], [1.0]], np.float32)}})
    ds = data.from_items([{"x": np.array([float(i), float(i)], np.float32)}
                          for i in range(8)]).repartition(4)
    bp = train.BatchPredictor.from_checkpoint(
        ckpt, getattr(train, predictor), apply_fn=_matmul_factory(), **kw)
    return bp.predict(ds, num_actors=2).take_all()


def test_batch_predictor_over_datastream_twin(both):
    """Twin of test_batch_predictor_over_datastream: TorchPredictor actors
    on the CPU give JaxPredictor's rows, block for block."""
    want = rerun_if_killed(_batch_predict, "ref", "JaxPredictor", {})
    got = rerun_if_killed(_batch_predict, "port", "TorchPredictor",
                          {"device": "cpu"})
    assert sorted(float(r["predictions"][0]) for r in got) == \
        [2.0 * i for i in range(8)]
    assert normalize(got) == normalize(want)


def test_bf16_predictions_come_back_as_float32():
    import torch

    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.train import TorchPredictor

    pred = TorchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": {
            "w": torch.tensor([[1.5], [0.5]], dtype=torch.bfloat16)}}),
        apply_fn=lambda p, b: {"y": b["x"].to(torch.bfloat16) @ p["w"],
                               "n": b["x"].shape[0]},
        device="cpu")
    out = pred.predict({"x": np.array([[2.0, 4.0]], np.float32)})
    assert out["y"].dtype == np.float32 and out["y"].tolist() == [[5.0]]
    assert int(out["n"]) == 1


def test_predictor_defaults_to_the_card():
    import torch

    from ray_tpu_torch.train import TorchPredictor

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchPredictor({"w": np.ones(2, np.float32)}, _matmul_apply)


# --------------------------------------------- the slice as a whole


SEQ, ROWS = 16, 8


def _jax_apply_factory():
    import os  # noqa: F401

    def _apply(params, batch):
        import jax
        import jax.numpy as jnp

        from ray_tpu.models import ModelConfig
        from ray_tpu.models.transformer import forward

        tokens = jnp.asarray(batch["tokens"])
        logits = forward(params, tokens[:, :-1], ModelConfig.tiny())
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                   tokens[:, 1:, None], axis=-1)[..., 0]
        return {"nll": nll.mean(axis=1), "last": logits[:, -1]}

    return _apply


def _port_apply_factory():
    import os  # noqa: F401

    def _apply(params, batch):
        import torch

        from ray_tpu_torch.models import ModelConfig
        from ray_tpu_torch.models.transformer import forward

        tokens = batch["tokens"].long()
        logits = forward(params, tokens[:, :-1], ModelConfig.tiny())
        nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                            tokens[:, 1:, None])[..., 0]
        return {"nll": nll.mean(dim=1), "last": logits[:, -1]}

    return _apply


@pytest.fixture(scope="module")
def tiny_params():
    import jax

    from ray_tpu.models import ModelConfig as JConfig
    from ray_tpu.models.transformer import init_params

    params = jax.device_get(init_params(jax.random.PRNGKey(3),
                                        JConfig.tiny()))
    tokens = np.random.default_rng(4).integers(
        0, JConfig.tiny().vocab_size, (ROWS, SEQ + 1), dtype=np.int32)
    return params, tokens


def _port_checkpoint(params):
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig

    return Checkpoint.from_dict({"params": params_from_jax(
        params, ModelConfig.tiny(), device="cpu")})


def test_torch_predictor_matches_jax_predictor_on_tiny(tiny_params):
    """Each package's predictor applying its own `forward`: per-row mean
    NLL and last-position logits within 1e-5."""
    from ray_tpu.air.checkpoint import Checkpoint as RefCheckpoint
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.train import TorchPredictor

    params, tokens = tiny_params
    want = JaxPredictor.from_checkpoint(
        RefCheckpoint.from_dict({"params": params}),
        apply_fn=_jax_apply_factory()).predict({"tokens": tokens})
    got = TorchPredictor.from_checkpoint(
        _port_checkpoint(params), apply_fn=_port_apply_factory(),
        device="cpu").predict({"tokens": tokens})
    assert sorted(got) == sorted(want) == ["last", "nll"]
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_batch_predictor_scores_blocks_like_the_jax_package(both, tiny_params):
    """A BatchPredictor of each package over the same 4 blocks: the same
    rows in the same order, each within 1e-5."""
    import importlib

    params, tokens = tiny_params

    def scores(pkg):
        rt = PKGS[pkg].__name__
        data = importlib.import_module(f"{rt}.data")
        train = importlib.import_module(f"{rt}.train")
        ds = data.from_numpy({"tokens": tokens}).repartition(4)
        if pkg == "ref":
            ckpt = importlib.import_module(f"{rt}.air.checkpoint") \
                .Checkpoint.from_dict({"params": params})
            bp = train.BatchPredictor.from_checkpoint(
                ckpt, train.JaxPredictor, apply_fn=_jax_apply_factory())
        else:
            bp = train.BatchPredictor.from_checkpoint(
                _port_checkpoint(params), train.TorchPredictor,
                apply_fn=_port_apply_factory(), device="cpu")
        assert ds.num_blocks() == 4
        return bp.predict(ds, num_actors=2).take_all()

    want = rerun_if_killed(scores, "ref")
    got = rerun_if_killed(scores, "port")
    assert len(got) == len(want) == ROWS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=1e-5, atol=1e-5)
