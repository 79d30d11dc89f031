"""train/checkpointing: the port's step-addressed checkpoints on
torch.distributed.checkpoint, on the CPU. A saved and restored `tiny`
TrainState is bit for bit the one saved, under both optimizers; a resumed
run is bit for bit the straight one; the step-directory contract is the
JAX package's (tests/test_checkpointing.py); and a JAX checkpoint carried
through the bridge into a port checkpoint comes back out equal to the JAX
state."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.train import load_checkpoint as jload_checkpoint
from ray_tpu.train import save_checkpoint as jsave_checkpoint
from ray_tpu.train.step import TrainState as JTrainState
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.bridge import train_state_from_jax, train_state_to_numpy
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import tree_leaves
from ray_tpu_torch.ops.kernels.adamw import FusedAdamWState
from ray_tpu_torch.train import (AdamWState, abstract_like,
                                 default_optimizer, fused_adamw_optimizer,
                                 gc_checkpoints, latest_checkpoint,
                                 load_checkpoint, make_train_step,
                                 restore_sharded, save_checkpoint,
                                 save_sharded)
from ray_tpu_torch.train import checkpointing

OPTIMIZERS = {
    "default": lambda: default_optimizer(1e-3, warmup_steps=1),
    "fused": lambda: fused_adamw_optimizer(1e-3, warmup_steps=1),
}


def _cfg(dtype=torch.float32):
    return dataclasses.replace(ModelConfig.tiny(), dtype=dtype)


def _train(cfg, opt, steps, state=None, step_fn=None):
    step_fn = step_fn or make_train_step(cfg, OPTIMIZERS[opt](), "cpu")[0]
    if state is None:
        state = make_train_step(cfg, OPTIMIZERS[opt](), "cpu")[1](0)
    batch = make_batch(cfg, 2, 32, 1, "cpu")
    losses = []
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def _tensors(state):
    return {"params": state.params, "mu": state.opt_state.mu,
            "nu": state.opt_state.nu}


def _assert_same(got, want):
    assert got.step == want.step
    assert got.opt_state.count == want.opt_state.count
    assert type(got.opt_state) is type(want.opt_state)
    for a, b in zip(tree_leaves(_tensors(got)), tree_leaves(_tensors(want)),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_state_round_trip_is_bitwise(tmp_path, opt, dtype):
    cfg = _cfg(dtype)
    state, _ = _train(cfg, opt, 2)
    assert state.step == 2 and state.opt_state.count == 2
    want_opt = AdamWState if opt == "default" else FusedAdamWState
    assert type(state.opt_state) is want_opt
    nu = state.opt_state.nu["embed"].dtype
    assert nu == (dtype if opt == "default" else torch.float32)

    path = save_checkpoint(state, str(tmp_path), step=2, meta={"opt": opt})
    target = abstract_like(state)
    assert target.step == 2 and type(target.opt_state) is want_opt
    live = {t.data_ptr() for t in tree_leaves(_tensors(state))}
    assert not live & {t.data_ptr() for t in tree_leaves(_tensors(target))}
    target.step, target.opt_state.count = 0, 0
    restored, meta = load_checkpoint(path, target)
    assert meta == {"step": 2, "opt": opt}
    _assert_same(restored, state)
    # the restore filled the target's own tensors, never the live state's
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(_tensors(restored)), tree_leaves(_tensors(target))))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_resumed_run_equals_the_straight_run(tmp_path, opt):
    """4 steps straight through against 2 steps, a checkpoint, a restore
    into an abstract_like state, and 2 more: losses and the final state
    bit for bit."""
    cfg = _cfg()
    step_fn, init_fn = make_train_step(cfg, OPTIMIZERS[opt](), "cpu")
    straight, straight_losses = _train(cfg, opt, 4, init_fn(0), step_fn)

    state, losses = _train(cfg, opt, 2, init_fn(0), step_fn)
    save_checkpoint(state, str(tmp_path), step=2)
    target = abstract_like(state)
    del state
    resumed, meta = load_checkpoint(latest_checkpoint(str(tmp_path)), target)
    assert meta["step"] == 2 and resumed.step == 2
    resumed, more = _train(cfg, opt, 2, resumed, step_fn)
    assert losses + more == straight_losses
    _assert_same(resumed, straight)


def test_step_checkpoints_latest_and_retention(tmp_path):
    """latest_checkpoint resolves only COMPLETE saves, torn staging dirs and
    bare step dirs are invisible, and gc keeps the newest K (the JAX
    package's test on the port)."""
    root = str(tmp_path / "run")
    assert latest_checkpoint(root) is None  # empty / missing root
    state = {"w": torch.arange(8, dtype=torch.float32)}
    for step in (2, 4, 6):
        save_checkpoint(state, root, step, meta={"epoch": step * 10})
    # a torn save: staging dir left behind by a crash mid-write
    os.makedirs(os.path.join(root, ".tmp-step_8-123"))
    # an incomplete final dir (no meta.json commit marker)
    os.makedirs(os.path.join(root, "step_9", "state"))

    latest = latest_checkpoint(root)
    assert latest is not None and latest.endswith("step_6")
    restored, meta = load_checkpoint(latest, abstract_like(state))
    assert torch.equal(restored["w"], state["w"])
    assert meta["step"] == 6 and meta["epoch"] == 60

    deleted = gc_checkpoints(root, keep=2)
    kept = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert kept == ["step_4", "step_6", "step_9"]
    assert any(p.endswith("step_2") for p in deleted)
    assert not any(d.startswith(".tmp-") for d in os.listdir(root))
    assert latest_checkpoint(root).endswith("step_6")
    with open(os.path.join(root, "step_6", "meta.json")) as f:
        assert json.load(f)["epoch"] == 60
    assert gc_checkpoints(root, keep=0)
    assert latest_checkpoint(root) is None


def test_a_failed_save_commits_nothing(tmp_path, monkeypatch):
    """A save that dies mid-write leaves no step directory and no staging
    directory; the previous checkpoint stays the latest."""
    root = str(tmp_path)
    state = {"w": torch.ones(4)}
    save_checkpoint(state, root, 1)

    def torn(state, path):
        os.makedirs(path)
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing, "save_sharded", torn)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(state, root, 2)
    assert sorted(os.listdir(root)) == ["step_1"]
    assert latest_checkpoint(root).endswith("step_1")


def test_a_resave_replaces_the_step(tmp_path):
    root = str(tmp_path)
    save_checkpoint({"w": torch.zeros(3)}, root, 5, meta={"v": 1})
    save_checkpoint({"w": torch.ones(3)}, root, 5, meta={"v": 2})
    state, meta = load_checkpoint(latest_checkpoint(root),
                                  {"w": torch.empty(3)})
    assert meta["v"] == 2 and torch.equal(state["w"], torch.ones(3))


def test_save_sharded_records_its_time(tmp_path):
    checkpointing.pop_last_save_seconds()
    path = save_sharded({"a": torch.ones(2), "n": 3}, str(tmp_path / "s"))
    seconds = checkpointing.pop_last_save_seconds()
    assert seconds is not None and seconds >= 0
    assert checkpointing.pop_last_save_seconds() is None
    out = restore_sharded(path, {"a": torch.zeros(2), "n": 0})
    assert out["n"] == 3 and torch.equal(out["a"], torch.ones(2))


def test_other_shardings_are_not_ported():
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        abstract_like({"w": torch.ones(2)}, shardings={"w": None})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_carried_through_a_port_checkpoint(tmp_path, dtype):
    """JAX save_checkpoint/load_checkpoint -> bridge.train_state_from_jax
    -> the port's save_checkpoint/load_checkpoint -> train_state_to_numpy:
    params, mu, nu (nu in the parameter dtype, as optax keeps it), count and
    step equal to the JAX state's, bit for bit."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=getattr(jnp, dtype))
    cfg = _cfg(getattr(torch, dtype))
    params = jinit(jax.random.PRNGKey(2), jcfg)
    tx = jdefault_optimizer(1e-3, warmup_steps=1)
    opt = tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(3):  # moments and count away from their init
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        _, opt = tx.update(grads, opt, params)
    jstate = JTrainState(params=params, opt_state=opt, step=jnp.int32(3))
    jpath = jsave_checkpoint(jstate, str(tmp_path / "jax"), step=3)
    jrestored, jmeta = jload_checkpoint(jpath, jstate)
    assert jmeta["step"] == 3

    state = train_state_from_jax(jrestored, cfg, device="cpu")
    path = save_checkpoint(state, str(tmp_path / "port"), step=3)
    restored, meta = load_checkpoint(path, abstract_like(state))
    assert meta["step"] == 3
    back = train_state_to_numpy(restored)
    assert back["step"] == 3 and back["count"] == 3
    adam = opt[1][0]
    for key, tree in (("params", params), ("mu", adam.mu), ("nu", adam.nu)):
        src = dict(_leaves(jax.tree_util.tree_map(np.asarray, tree)))
        got = dict(_leaves(back[key]))
        assert src.keys() == got.keys()
        for name, a in src.items():
            assert got[name].dtype == a.dtype, (key, name)
            np.testing.assert_array_equal(_bits(got[name]), _bits(a),
                                          err_msg=f"{key} {name}")
