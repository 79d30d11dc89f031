"""The port's Learner stack (ray_tpu_torch/rllib/learner.py, optim.py)
against ray_tpu's, on the CPU.

- The optimizer transforms (`optim.adam`, `optim.adamw`, `optim.rmsprop`,
  `delayed` under `optim.multi_transform`) against optax on the same gradients, step by
  step: updates and states within 1e-7, params within 1e-7 + 1e-7·|p|.
- Twins of tests/test_learner_group.py's mesh cases (the reference runs dp
  8 on 8 virtual devices): every learner on a dp 2 mesh of two gloo ranks
  (dp 4 on four ranks is slow) against the same learner without a mesh and
  against ray_tpu's learner: losses within 1e-5 relative, params within
  the reference's bounds (rtol 1e-4, atol 1e-5), DQN's gathered `td` in
  row order. A mesh LearnerGroup with no mesh starts a world of 1 and
  equals the local learner bit for bit.
- `DQNLearner` (double and SimpleQ): 5 updates with a target sync at step
  3 against ray_tpu's, the target a copy that no update moves.
- `delayed` freezing its inner state (the twin of
  test_delayed_transform_freezes_inner_state, whose body calls optax).
- A learner asked for the card without one raises.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu_torch.rllib import optim
from torch_ranks import dqn_batch, ppo_batch, traj_batch

LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-5)   # tests/test_learner_group.py:39-43


def _grads(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w0": (4, 8), "b0": (8,), "w1": (8, 2), "b1": (2,)}


def _as_torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _close(got, want, rtol=0.0):
    for k, g in got.items():   # optax's masked state also holds MaskedNodes
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["adam", "rmsprop", "delayed_multi",
                                  "adamw"])
def test_optimizer_transforms_match_optax(name):
    import optax

    from ray_tpu.rllib.learner import delayed as jdelayed
    from ray_tpu_torch.rllib.learner import delayed

    labels = {"w0": "a", "b0": "a", "w1": "c", "b1": "c"}
    if name == "adam":
        ref, port = optax.adam(3e-3), optim.adam(3e-3)
    elif name == "adamw":   # the Decision Transformer's (dt.py:190)
        ref, port = (optax.adamw(1e-3, weight_decay=1e-4),
                     optim.adamw(1e-3, weight_decay=1e-4))
    elif name == "rmsprop":   # IMPALA's (impala.py:123)
        ref = optax.rmsprop(1e-3, decay=0.99, eps=0.1)
        port = optim.rmsprop(1e-3, decay=0.99, eps=0.1)
    else:   # TD3's shape: a delayed adam beside a plain one
        ref = optax.multi_transform(
            {"a": jdelayed(optax.adam(1e-3), 2), "c": optax.adam(2e-3)},
            labels)
        port = optim.multi_transform(
            {"a": delayed(optim.adam(1e-3), 2), "c": optim.adam(2e-3)},
            labels)
    params = _grads(0, SHAPES)
    r_state, p_state = ref.init(params), port.init(_as_torch(params))
    r_params, p_params = dict(params), _as_torch(params)
    for step in range(5):
        g = _grads(step + 1, SHAPES)
        r_up, r_state = ref.update(g, r_state, r_params)
        p_up, p_state = port.update(_as_torch(g), p_state, p_params)
        _close(p_up, r_up)
        r_params = optax.apply_updates(r_params, r_up)
        p_params = optim.apply_updates(p_params, p_up)
        _close(p_params, r_params, rtol=1e-7)   # 1 ulp of p + u at |p| ~ 1
    if name == "delayed_multi":   # the frozen inner state is the same
        (r_inner, r_count), (p_inner, p_count) = (
            r_state.inner_states["a"].inner_state, p_state.inner_states["a"])
        assert int(r_count) == p_count == 5
        _close(p_inner.mu, r_inner[0].mu)   # optax.adam: (adam, scale) states


def test_delayed_transform_freezes_inner_state_twin():
    """test_delayed_transform_freezes_inner_state with the port's
    transforms (optax.sgd(0.1) is a scale by -0.1)."""
    from ray_tpu_torch.rllib.learner import delayed

    sgd = optim.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (
            optim.tree_map(lambda x: -0.1 * x, g), s))
    tx = delayed(sgd, 2)
    params = {"w": torch.ones(3)}
    state = tx.init(params)
    g = {"w": torch.ones(3)}
    ups = []
    for _ in range(3):
        up, state = tx.update(g, state, params)
        ups.append(up["w"])
    assert torch.allclose(ups[0], torch.full((3,), -0.1))
    assert torch.equal(ups[1], torch.zeros(3))
    assert torch.allclose(ups[2], torch.full((3,), -0.1))


# ------------------------------------------------------------ mesh twins


def _reference_learners():
    """What rl_mesh's plain learners return, from ray_tpu's learners."""
    from ray_tpu.rllib.appo import APPOLearner
    from ray_tpu.rllib.dqn import DQNLearner
    from ray_tpu.rllib.impala import ImpalaLearner
    from ray_tpu.rllib.ppo import PPOLearner

    out, params = {}, {}
    ppo = PPOLearner(4, 2, lr=1e-3, seed=7)
    out["ppo"] = float(ppo.update(ppo_batch(64))["total_loss"])
    params["ppo"] = ppo.get_weights()
    dqn = DQNLearner(4, 2, lr=1e-3, gamma=0.99)
    loss1, td = dqn.update_batch(dqn_batch())
    dqn.sync_target()
    loss2, _ = dqn.update_batch(dqn_batch())
    out["dqn"], out["dqn_td"] = [loss1, loss2], td
    params["dqn"] = dqn.get_weights()
    for cls in (ImpalaLearner, APPOLearner):
        args = (4, 2, 1e-3, 0.99) + ((0.2,) if cls is APPOLearner
                                     else ()) + (0.5, 0.01)
        vt = cls(*args, seed=5)
        out[cls.__name__] = vt.update_batch(traj_batch())["total_loss"]
        params[cls.__name__] = vt.get_weights()
    return out, params


@pytest.mark.parametrize("world", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_mesh_learners_match_one_device_and_the_reference(tmp_path, world):
    got = torch_ranks.run_ranks("rl_mesh", world, tmp_path)
    arrays = dict(np.load(tmp_path / "out.npz"))
    want, want_params = _reference_learners()
    for name, ref_name in (("ppo", "ppo"), ("ImpalaLearner", "ImpalaLearner"),
                           ("APPOLearner", "APPOLearner"), ("dqn", "dqn")):
        plain, mesh = got[f"{name}_plain"], got[f"{name}_mesh"]
        np.testing.assert_allclose(mesh, plain, **LOSS)
        np.testing.assert_allclose(plain, want[ref_name], **LOSS)
        for k, w in want_params[ref_name].items():
            p = arrays[f"{name}_plain/{k}"]
            np.testing.assert_allclose(arrays[f"{name}_mesh/{k}"], p,
                                       **PARAMS, err_msg=f"{name} {k}")
            np.testing.assert_allclose(p, w, **PARAMS, err_msg=f"{name} {k}")
    # the per-sample td, gathered over dp in row order
    assert arrays["dqn_mesh_td"].shape == (32,)
    np.testing.assert_allclose(arrays["dqn_mesh_td"], arrays["dqn_plain_td"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(arrays["dqn_plain_td"], want["dqn_td"],
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(got["group"]) and got["group_roundtrip"]


def test_mesh_group_without_a_mesh_is_the_local_learner_bit_for_bit():
    """backend="mesh" with no mesh: a world of 1 through initialize_group
    (left again at the end), the same bits as the learner alone."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import shutdown_group
    from ray_tpu_torch.rllib.learner import LearnerGroup
    from ray_tpu_torch.rllib.ppo import PPOLearner

    assert not dist.is_initialized()
    kw = {"obs_dim": 4, "num_actions": 2, "lr": 1e-3, "seed": 7,
          "device": "cpu"}
    local = PPOLearner(**kw)
    try:
        group = LearnerGroup(PPOLearner, kw, backend="mesh")
        assert dist.get_world_size() == 1 and group.mesh.size() == 1
        for seed in range(3):
            a = {k: float(v) for k, v in
                 local.update(ppo_batch(64, seed=seed)).items()}
            assert group.update(ppo_batch(64, seed=seed)) == a
        w, g = local.get_weights(), group.get_weights()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    finally:
        shutdown_group()


# ---------------------------------------------------------------- DQN


@pytest.mark.parametrize("double_q", [True, False], ids=["double", "simple"])
def test_dqn_target_is_a_copy_synced_at_step_3(double_q):
    from ray_tpu.rllib.dqn import DQNLearner as RefDQN
    from ray_tpu_torch.rllib.dqn import DQNLearner

    ref = RefDQN(4, 2, lr=1e-3, gamma=0.99, seed=1, double_q=double_q)
    port = DQNLearner(4, 2, lr=1e-3, gamma=0.99, seed=1, double_q=double_q,
                      device="cpu")
    target0 = {k: v.clone() for k, v in port.extra.items()}
    for step in range(1, 6):
        batch = dqn_batch()
        r_loss, r_td = ref.update_batch(dict(batch))
        p_loss, p_td = port.update_batch(dict(batch))
        np.testing.assert_allclose(p_loss, r_loss, **LOSS)
        np.testing.assert_allclose(p_td, r_td, rtol=1e-5, atol=1e-6)
        if step < 3:   # no update moves the target
            for k, v in port.extra.items():
                assert torch.equal(v, target0[k]), k
        if step == 3:
            ref.sync_target()
            port.sync_target()
            synced = {k: v.clone() for k, v in port.extra.items()}
            for k, v in port.extra.items():
                assert torch.equal(v, port.params[k])
                assert v.data_ptr() != port.params[k].data_ptr()
        if step > 3:
            for k, v in port.extra.items():
                assert torch.equal(v, synced[k]), k
    r_w, p_w = ref.get_weights(), port.get_weights()
    for k in r_w:
        np.testing.assert_allclose(p_w[k], r_w[k], **PARAMS, err_msg=k)
    for k, v in ref.target_params.items():
        np.testing.assert_allclose(port.target_params[k].numpy(),
                                   np.asarray(v), **PARAMS, err_msg=k)


def test_learner_asked_for_the_card_without_one_raises():
    from ray_tpu_torch.rllib.learner import LearnerGroup
    from ray_tpu_torch.rllib.ppo import PPOLearner

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        PPOLearner(4, 2, lr=1e-3)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        LearnerGroup(PPOLearner, {"obs_dim": 4, "num_actions": 2,
                                  "lr": 1e-3}, backend="mesh")
