"""The port's rllib families (ES, ARS, bandits, SAC, DDPG/TD3, Ape-X,
DD-PPO, the offline learners, the Decision Transformer, QMIX, MADDPG,
R2D2) against ray_tpu's, on the CPU.

Each scenario of the reference's tests for these modules
(test_rllib_algos but the next slice's four, test_rllib's ES case,
test_rllib_census's Ape-X DDPG case, test_r2d2, test_offline_data) runs
through both packages, one runtime of each alive side by side in this
process, the port's learners and configs asked for the CPU
(`torch_libs.to_port`). What its calls return is recorded and compared:

- host-only scenarios (environments, datasets, ES, ARS, the bandits,
  policy-mapped rollouts, parquet round trips): every recorded value
  equal, `train()` included;
- learner scenarios: the datasets they collect equal; the first
  `train()` equal in its host entries (episode rewards, step and sample
  counts, epsilon) and within 1e-5 relative in the learner's losses; the
  later ones have the same keys, and the port's own assertions hold;
- SAC and TD3 draw their noise from the learner's torch generator, which
  cannot reproduce a JAX key stream: their first `train()` is compared in
  its host entries only. Ape-X takes its samples as they finish: only its
  keys are compared.

Then twins, in tier-1: SAC's and TD3's losses given the reference's own
standard normals against the JAX losses (loss within 1e-5 relative,
gradients within 1e-4 of each leaf's largest magnitude); DDPG's and SAC's
learners on a dp 2 mesh of gloo ranks (dp 4 slow) against one device and
against the reference (rtol 1e-4, atol 1e-5; 3 updates crossing TD3's
delay of 2); QMIX, the Decision Transformer, MADDPG and R2D2, 3 updates
each from the reference's initial params on one fixed batch against the
JAX updates (loss 1e-5 relative, params 1e-4); every new algorithm's
initial weights bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_ranks
from torch_libs import load, normalize, recording, reference_tests, run
from torch_ranks import (CONTINUOUS_UPDATES, DDPG_KW, SAC_KW, _flat,
                         continuous_batch)
from torch_runtime import both_runtimes, rerun_if_pkilled

PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}

# kinds: HOST (every recorded value equal), ALGO (first train's host
# entries equal, its losses within 1e-5), NOISY (first train's host
# entries equal), ASYNC (keys only)
HOST, ALGO, NOISY, ASYNC = "host", "algo", "noisy", "async"
NEXT_SLICE = {"test_slateq_beats_random_slates",
              "test_interest_evolution_env_mechanics",
              "test_maml_meta_learns_adaptation",
              "test_dreamer_world_model_and_imagination_policy"}
SCENARIOS = {
    "test_rllib_algos.py": {
        "test_pendulum_dynamics": HOST,
        "test_a2c_trains_on_cartpole": ALGO,
        "test_appo_trains_on_cartpole": ASYNC,
        "test_sac_trains_on_pendulum": NOISY,
        "test_td3_trains_on_pendulum": NOISY,
        "test_ddpg_save_restore": ALGO,
        "test_collect_episodes_columnar": HOST,
        "test_bc_clones_expert": ALGO,
        "test_marwil_beta_weights_improve_on_mixed_data": ALGO,
        "test_cql_penalty_decreases_ood_q": ALGO,
        "test_crr_weighted_regression_prefers_good_actions": ALGO,
        "test_linucb_sublinear_regret": HOST,
        "test_lints_learns_and_checkpoints": HOST,
        "test_ars_improves_on_cartpole": HOST,
        "test_ars_save_restore": HOST,
        "test_apex_dqn_trains_on_cartpole": ASYNC,
        "test_two_step_env_payoffs": HOST,
        "test_qmix_learns_two_step_coordination": ALGO,
        "test_policy_mapping_rollout": HOST,
        "test_ddppo_decentralized_sync": ALGO,
        "test_decision_transformer_return_conditioning": ALGO,
        "test_maddpg_learns_cooperative_spread": ALGO,
    },
    "test_rllib.py": {
        "test_es_improves_on_cartpole": HOST,
    },
    "test_rllib_census.py": {
        "test_apex_ddpg_trains_on_pendulum": ASYNC,
    },
    "test_r2d2.py": {
        "test_memory_corridor_env": HOST,
        "test_r2d2_learns_memory_task": ALGO,
        "test_r2d2_sequence_storage_shapes": HOST,
    },
    "test_offline_data.py": {
        "test_experience_parquet_roundtrip": HOST,
        "test_rollout_parquet_bc_roundtrip": ALGO,
        "test_cql_trains_from_file_backed_dataset": ALGO,
        "test_offline_data_accepts_datastream": HOST,
        "test_parquet_tensor_columns": HOST,
    },
}
# the reference marks these slow (many training iterations)
SLOW = {"test_qmix_learns_two_step_coordination",
        "test_decision_transformer_return_conditioning",
        "test_maddpg_learns_cooperative_spread",
        "test_r2d2_learns_memory_task"}
# train() entries fixed by the rollouts and datasets alone
HOST_KEYS = {"episode_reward_mean", "num_env_steps_sampled", "buffer_size",
             "epsilon", "training_iteration", "num_samples_trained",
             "num_sequences", "num_updates"}


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{PKGS[pkg].__name__}.rllib{name}")


def _paths(out):
    """write_experiences' paths name the package's directory: their
    count."""
    return len(out)


def _targets(pkg, kind):
    """Host calls (every kind: their values equal), then the algorithms'
    train/evaluate (and, for HOST scenarios, the envs' steps)."""
    rllib, alg = _mod(pkg, ""), _mod(pkg, ".algorithm")
    out = [(rllib, "collect_episodes"), (rllib, "policy_mapping_rollout"),
           (rllib, "read_experiences"), (rllib, "write_experiences", _paths),
           (alg.Algorithm, "train")]
    if kind == HOST:
        env, ma = _mod(pkg, ".env"), _mod(pkg, ".multi_agent")
        r2d2, bandit = _mod(pkg, ".r2d2"), _mod(pkg, ".bandit")
        out += [(env.PendulumEnv, "reset"), (env.PendulumEnv, "step"),
                (ma.TwoStepCooperativeEnv, "reset"),
                (ma.TwoStepCooperativeEnv, "step"),
                (r2d2.MemoryCorridorEnv, "reset"),
                (r2d2.MemoryCorridorEnv, "step"),
                (r2d2.R2D2, "_collect_episode"),
                (bandit.LinearBanditEnv, "observation"),
                (bandit.LinearBanditEnv, "reward")]
    else:
        out.append((alg.Algorithm, "evaluate"))
    return out


# host calls compared exactly in every kind
EXACT = {"rllib.collect_episodes", "rllib.policy_mapping_rollout",
         "rllib.read_experiences", "rllib.write_experiences"}


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-5, abs_tol=1e-7)
    return a == b


def _keys(v):
    return sorted(v) if isinstance(v, dict) else type(v).__name__


def _compare(kind, ref, port):
    assert [label for label, _ in port] == [label for label, _ in ref]
    if kind == HOST:
        assert port == ref
        return
    first_train = True
    for (label, r), (_, p) in zip(ref, port):
        if label in EXACT:
            assert p == r, label
        elif label == "Algorithm.train" and first_train and kind != ASYNC:
            first_train = False
            assert _keys(p) == _keys(r)
            for k in r:
                if k in HOST_KEYS:
                    assert p[k] == r[k], (k, p[k], r[k])
                elif kind == ALGO:
                    assert _close(p[k], r[k]), (k, p[k], r[k])
        else:
            assert _keys(p) == _keys(r), label


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=8):
        yield


def _cases():
    for filename, names in SCENARIOS.items():
        found = set(reference_tests(filename))
        for name, kind in names.items():
            assert name in found, (filename, name)
            marks = [pytest.mark.slow] if name in SLOW else []
            yield pytest.param(filename, name, kind, marks=marks,
                               id=f"{filename[:-3]}::{name}")


def test_every_reference_scenario_of_the_slice_is_here():
    """test_rllib_algos' scenarios are all here but the next slice's."""
    assert (set(reference_tests("test_rllib_algos.py")) - NEXT_SLICE
            == set(SCENARIOS["test_rllib_algos.py"]))
    assert set(reference_tests("test_r2d2.py")) == set(
        SCENARIOS["test_r2d2.py"])
    assert set(reference_tests("test_offline_data.py")) == set(
        SCENARIOS["test_offline_data.py"])


@pytest.mark.parametrize("filename,name,kind", list(_cases()))
def test_reference_scenario_matches(both, filename, name, kind, tmp_path,
                                    request):
    got = {}
    for pkg in PKGS:
        ns = load(filename, pkg)

        def scenario():
            with recording(pkg, _targets(pkg, kind)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        got[pkg] = rerun_if_pkilled(scenario)
    _compare(kind, got["ref"], got["port"])


# ------------------------------------------------------------ loss twins


def _grad_close(got, want, what):
    """Each leaf within 1e-4 of the leaf's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, (what, err, scale)


def _loss_twin(ref, port, batch, noise, key):
    """The reference learner's loss and gradients at its params under
    `key`, and the port's given the same standard normals (`noise`, batch
    keys): loss and scalar aux within 1e-5 relative, gradients within 1e-4
    of each leaf's largest magnitude."""
    import jax

    (r_loss, r_aux), r_grads = jax.value_and_grad(ref.loss, has_aux=True)(
        ref.params, {k: jax.numpy.asarray(v) for k, v in batch.items()},
        ref.extra, key)
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.rllib.learner import _to_tensors

    leaves = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                            port.params)
    p_loss, p_aux = port.loss(leaves, _to_tensors({**batch, **noise}, "cpu"),
                              port.extra, None)
    flat = dict(optim.tree_items(leaves))
    grads = dict(zip(flat, torch.autograd.grad(p_loss, list(flat.values()))))
    np.testing.assert_allclose(float(p_loss.detach()), float(r_loss),
                               rtol=1e-5)
    for k, v in r_aux.items():
        if np.ndim(v) == 0:
            np.testing.assert_allclose(float(p_aux[k].detach()), float(v),
                                       rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    for path, want in _flat(jax.device_get(r_grads)).items():
        _grad_close(grads[path].numpy(), np.asarray(want), path)


def _shift_targets(port, ref, seed):
    """The same perturbed target nets in both learners, so the backups
    read targets that differ from the online nets."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shifted = {k: {n: np.asarray(v) + 0.05 * rng.standard_normal(
                   np.shape(v)).astype(np.float32)
                   for n, v in ref.extra[k].items()} for k in ref.extra}
    ref.extra = {k: {n: jnp.asarray(v) for n, v in t.items()}
                 for k, t in shifted.items()}
    port.extra = {k: {n: torch.from_numpy(v.copy()) for n, v in t.items()}
                  for k, t in shifted.items()}


def test_sac_loss_given_the_same_noise_matches_the_jax_loss():
    """SAC's loss draws two standard normals (next actions under k1, the
    actor's sample under k2 of `jax.random.split(rng)`); given them, the
    port's loss is the reference's."""
    import jax

    from ray_tpu.rllib.sac import SACLearner as Ref
    from ray_tpu_torch.rllib.sac import SACLearner

    ref = Ref(3, 1, 1.0, **SAC_KW)
    port = SACLearner(3, 1, 1.0, **SAC_KW, device="cpu")
    _shift_targets(port, ref, 5)
    batch = continuous_batch(0)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    noise = {"next_eps": np.asarray(jax.random.normal(k1, (32, 1))),
             "eps": np.asarray(jax.random.normal(k2, (32, 1)))}
    _loss_twin(ref, port, batch, noise, key)


def test_td3_loss_given_the_same_noise_matches_the_jax_loss():
    """TD3's target smoothing draws one standard normal of the next
    actions' shape from the update's key; given it, the port's loss is
    the reference's."""
    import jax

    from ray_tpu.rllib.ddpg import DDPGLearner as Ref
    from ray_tpu_torch.rllib.ddpg import DDPGLearner

    kw = {**DDPG_KW, "smooth_target_policy": True, "target_noise": 0.2,
          "target_noise_clip": 0.5}
    ref = Ref(3, 1, 1.0, **kw)
    port = DDPGLearner(3, 1, 1.0, **kw, device="cpu")
    _shift_targets(port, ref, 6)
    key = jax.random.PRNGKey(12)
    noise = {"target_eps": np.asarray(jax.random.normal(key, (32, 1)))}
    _loss_twin(ref, port, continuous_batch(1), noise, key)


# ------------------------------------------------------------ mesh twins

PARAMS = dict(rtol=1e-4, atol=1e-5)   # tests/test_learner_group.py:172-225


def _reference_continuous():
    """The reference's DDPG and SAC learners through 3 updates, and the
    standard normals SAC's loss drew in each (the learner's key split once
    an update, then into k1, k2)."""
    import jax

    from ray_tpu.rllib.ddpg import DDPGLearner
    from ray_tpu.rllib.sac import SACLearner

    ddpg = DDPGLearner(3, 1, 1.0, **DDPG_KW)
    sac = SACLearner(3, 1, 1.0, **SAC_KW)
    noise, key = {}, sac._rng_key
    stats = {"ddpg": [], "sac": []}
    for u in range(CONTINUOUS_UPDATES):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        noise[f"next_eps{u}"] = np.asarray(jax.random.normal(k1, (32, 1)))
        noise[f"eps{u}"] = np.asarray(jax.random.normal(k2, (32, 1)))
        stats["ddpg"].append(ddpg.update_batch(continuous_batch(1)))
        stats["sac"].append(sac.update_batch(continuous_batch(0)))
    params = {"ddpg": {**_flat(jax.device_get(ddpg.params)),
                       **{f"target/{k}": v for k, v in
                          _flat(jax.device_get(ddpg.extra)).items()}},
              "sac": {**_flat(jax.device_get(sac.params)),
                      **{f"target/{k}": v for k, v in
                         _flat(jax.device_get(sac.extra)).items()}}}
    return noise, stats, params


def _close_stats(got, want):
    """Each update's stats within the reference's mesh bounds (SAC's
    actor loss is a difference of O(1) terms near 0)."""
    assert len(got) == len(want) == CONTINUOUS_UPDATES
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **PARAMS, err_msg=k)


@pytest.mark.parametrize("world", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_continuous_mesh_learners_match_one_device_and_the_reference(
        tmp_path, world):
    """DDPG (twin critics, delayed actor) and SAC (given the reference's
    noise) on a dp mesh of gloo ranks against the same learner on one
    device and against ray_tpu's; TD3's smoothing and SAC drawing their
    own noise against one device (each rank draws the whole batch's
    noise and keeps its rows)."""
    noise, want, want_params = _reference_continuous()
    np.savez(tmp_path / "noise.npz", **noise)
    got = torch_ranks.run_ranks("rl_mesh_continuous", world, tmp_path)
    arrays = dict(np.load(tmp_path / "out.npz"))
    for tag in ("ddpg", "td3", "sac", "sac_own"):
        _close_stats(got[f"{tag}_mesh"], got[f"{tag}_plain"])
        names = [k[len(f"{tag}_plain/"):] for k in arrays
                 if k.startswith(f"{tag}_plain/")]
        assert names
        for k in names:
            np.testing.assert_allclose(arrays[f"{tag}_mesh/{k}"],
                                       arrays[f"{tag}_plain/{k}"],
                                       **PARAMS, err_msg=f"{tag} {k}")
    for tag in ("ddpg", "sac"):
        _close_stats([{k: v for k, v in s.items() if k in w}
                      for s, w in zip(got[f"{tag}_plain"], want[tag])],
                     want[tag])
        assert set(want_params[tag]) == {
            k[len(f"{tag}_plain/"):] for k in arrays
            if k.startswith(f"{tag}_plain/")}
        for k, w in want_params[tag].items():
            np.testing.assert_allclose(arrays[f"{tag}_plain/{k}"],
                                       np.asarray(w), **PARAMS,
                                       err_msg=f"{tag} {k}")
    # the polyak targets trail the online nets
    assert not np.array_equal(arrays["ddpg_plain/target/q1/w0"],
                              arrays["ddpg_plain/q1/w0"])


# ------------------------------------------------- algorithms' own updates

UPDATE = dict(rtol=1e-5)
# the repo's params bound (PARAMS): Adam turns rounding noise in a null
# direction's gradient (the keys' bias under softmax) into ~1e-6 a step
PARAMS_3 = PARAMS


def _assert_trees(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   **PARAMS_3, err_msg=f"{what} {k}")


def test_qmix_updates_match_the_jax_updates():
    """3 of QMIX's updates (hypernetwork mixing, target net) on one batch
    from the reference's initial params."""
    import jax

    from ray_tpu.rllib.multi_agent import QMixConfig as RefConfig
    from ray_tpu_torch.rllib.learner import clone_tree
    from ray_tpu_torch.rllib.multi_agent import QMixConfig

    ref, port = RefConfig().build(), QMixConfig().training(
        device="cpu").build()
    assert normalize(port.get_weights()) == normalize(
        jax.device_get(ref.params))
    rng = np.random.default_rng(0)
    B, A, S = 32, 2, 3
    obs = np.zeros((B, A, S + A), np.float32)
    obs[..., :S] = np.eye(S, dtype=np.float32)[rng.integers(0, S, (B, 1))]
    obs[:, np.arange(A), S + np.arange(A)] = 1.0
    nxt = obs.copy()
    nxt[..., :S] = np.eye(S, dtype=np.float32)[rng.integers(0, S, (B, 1))]
    batch = {"obs": obs, "actions": rng.integers(0, 2, (B, A)).astype(
                 np.int32),
             "state": obs[:, 0, :S].copy(),
             "reward": rng.normal(size=B).astype(np.float32),
             "next_obs": nxt, "next_state": nxt[:, 0, :S].copy(),
             "done": (rng.random(B) < 0.5).astype(np.float32)}
    # targets apart from the online net: one update before the sync
    for step in range(3):
        r_params, ref.opt_state, r_loss = ref._update(
            ref.params, ref.opt_state, ref.target,
            {k: jax.numpy.asarray(v) for k, v in batch.items()})
        ref.params = r_params
        p_loss = port._update(batch)
        np.testing.assert_allclose(p_loss, float(r_loss), **UPDATE)
        if step == 0:
            ref.target = jax.device_get(ref.params)
            port.target = clone_tree(port.params)
    _assert_trees(port.get_weights(), jax.device_get(ref.params), "qmix")


def _dt_dataset():
    from ray_tpu.rllib.env import CartPoleEnv
    from ray_tpu.rllib.offline import collect_episodes

    return collect_episodes(lambda s: CartPoleEnv(s),
                            lambda obs, rng: int(rng.integers(2)), 6, seed=0)


def test_dt_updates_match_the_jax_updates():
    """3 AdamW steps of the Decision Transformer (2 layers, 2 heads,
    context 20 at width 64) on one sampled batch; the samplers' numpy
    draws are the reference's (the same batch from each)."""
    import jax

    from ray_tpu.rllib.dt import DTConfig as RefConfig
    from ray_tpu_torch.rllib.dt import DTConfig

    data = _dt_dataset()
    ref = RefConfig().offline_data(data).training(batch_size=16).build()
    port = DTConfig().offline_data(data).training(batch_size=16,
                                                  device="cpu").build()
    assert normalize(port.get_weights()) == normalize(ref.get_weights())
    batch = ref._sample_batch()
    assert normalize(port._sample_batch()) == normalize(batch)
    for _ in range(3):
        ref.params, ref.opt_state, r_loss = ref._update(
            ref.params, ref.opt_state, batch)
        np.testing.assert_allclose(port._update(batch), float(r_loss),
                                   **UPDATE)
    _assert_trees(port.get_weights(), ref.get_weights(), "dt")
    logits = port._forward(batch["rtg"], batch["obs"], batch["actions_in"],
                           batch["timesteps"], batch["mask"])
    want = ref._forward(ref.params, batch["rtg"], batch["obs"],
                        batch["actions_in"], batch["timesteps"],
                        batch["mask"])
    np.testing.assert_allclose(logits, np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_maddpg_updates_match_the_jax_updates():
    """3 of MADDPG's updates (each agent's centralized critic, then its
    actor, then both polyak targets) from one filled replay buffer."""
    from ray_tpu.rllib.maddpg import MADDPGConfig as RefConfig
    from ray_tpu_torch.rllib.maddpg import MADDPGConfig

    ref = RefConfig().training(batch_size=64).build()
    port = MADDPGConfig().training(batch_size=64, device="cpu").build()
    assert normalize(port.get_weights()) == normalize(ref.get_weights())
    rng = np.random.default_rng(1)
    fill = {"obs": rng.normal(size=(128, 2, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (128, 2, 1)).astype(np.float32),
            "rewards": rng.normal(size=(128, 2)).astype(np.float32),
            "next_obs": rng.normal(size=(128, 2, 3)).astype(np.float32),
            "dones": (rng.random(128) < 0.1).astype(np.float32)}
    ref.buffer.add_batch(fill)
    port.buffer.add_batch(fill)
    for _ in range(3):
        want, got = ref._update_once(), port._update_once()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **UPDATE, err_msg=k)
    import jax

    _assert_trees(port.get_weights(), jax.device_get(ref.get_weights()),
                  "maddpg")
    for i in range(2):
        _assert_trees(port.t_actors[i], jax.device_get(ref.t_actors[i]),
                      f"target actor {i}")
        _assert_trees(port.t_critics[i], jax.device_get(ref.t_critics[i]),
                      f"target critic {i}")


def test_r2d2_updates_match_the_jax_updates():
    """3 of R2D2's sequence updates (burn-in of 2 without gradients, the
    double-DQN backup through the target unroll), the target synced after
    the first."""
    import jax

    from ray_tpu.rllib.r2d2 import R2D2Learner as Ref
    from ray_tpu.rllib.rl_module import RecurrentQModule as RefModule
    from ray_tpu_torch.rllib.r2d2 import R2D2Learner
    from ray_tpu_torch.rllib.rl_module import RecurrentQModule

    ref = Ref(RefModule(3, 2, 32), 2e-3, 0.997, 2, seed=1)
    port = R2D2Learner(RecurrentQModule(3, 2, 32), 2e-3, 0.997, 2, seed=1,
                       device="cpu")
    assert normalize(port.get_weights()) == normalize(ref.get_weights())
    rng = np.random.default_rng(2)
    B, T = 16, 8
    obs = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T + 1))]
    batch = {"obs": obs[:, :T], "next_obs": obs[:, 1:],
             "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
             "rewards": rng.normal(size=(B, T)).astype(np.float32),
             "dones": (rng.random((B, T)) < 0.1).astype(np.float32),
             "mask": (rng.random((B, T)) < 0.9).astype(np.float32)}
    for step in range(3):
        r_loss = float(jax.device_get(ref.update(batch))["total_loss"])
        p_loss = float(port.update(batch)["total_loss"])
        np.testing.assert_allclose(p_loss, r_loss, **UPDATE)
        if step == 0:
            ref.sync_target()
            port.sync_target()
            assert port.extra["wq"].data_ptr() != port.params[
                "wq"].data_ptr()
    _assert_trees(port.get_weights(), ref.get_weights(), "r2d2")


# ------------------------------------------------------- initial weights


def test_initial_weights_are_the_reference_bit_for_bit():
    import jax

    from ray_tpu.rllib import ddpg as rddpg, offline as roff, sac as rsac
    from ray_tpu.rllib.ddppo import init_policy_params as rinit
    from ray_tpu_torch.rllib import ddpg, offline, sac
    from ray_tpu_torch.rllib.ddppo import init_policy_params

    pairs = [
        (sac.SACLearner(3, 1, 2.0, **SAC_KW, device="cpu"),
         rsac.SACLearner(3, 1, 2.0, **SAC_KW)),
        (ddpg.DDPGLearner(3, 1, 2.0, **DDPG_KW, device="cpu"),
         rddpg.DDPGLearner(3, 1, 2.0, **DDPG_KW)),
        (offline.MARWILLearner(4, 2, 1e-3, 1.0, 1.0, seed=3, device="cpu"),
         roff.MARWILLearner(4, 2, 1e-3, 1.0, 1.0, seed=3)),
        (offline.CQLLearner(4, 2, 1e-3, 0.99, 1.0, seed=3, device="cpu"),
         roff.CQLLearner(4, 2, 1e-3, 0.99, 1.0, seed=3)),
        (offline.CRRLearner(4, 2, 1e-3, 0.99, 1.0, "exp", seed=3,
                            device="cpu"),
         roff.CRRLearner(4, 2, 1e-3, 0.99, 1.0, "exp", seed=3)),
    ]
    for port, ref in pairs:
        assert normalize(port.get_weights()) == normalize(
            jax.device_get(ref.get_weights())), type(port).__name__
        assert normalize(_flat(port.extra or {})) == normalize(
            _flat(jax.device_get(ref.extra or {}))), type(port).__name__
    assert normalize(init_policy_params(5, 4, 2)) == normalize(
        rinit(5, 4, 2))
    # QMIX, DT, MADDPG and R2D2: in their update twins above


def test_rllib_cli_reaches_the_new_algorithms(both, capsys):
    """`rllib train --algo NAME` finds every algorithm of the reference's
    registry but the next slice's, and trains TD3 and DD-PPO an iteration
    (their learners on `--device cpu`)."""
    import importlib

    def cli(pkg, *argv):
        main = importlib.import_module(f"{PKGS[pkg].__name__}.__main__").main
        extra = ["--device", "cpu"] if pkg == "port" else []
        rc = main(["rllib", "train", *argv, *extra])
        return rc, capsys.readouterr().out

    names = {}
    for pkg in PKGS:
        rc, out = cli(pkg, "--algo", "nope")
        assert rc == 1
        names[pkg] = set(out.split("available:")[1].split())
    assert names["port"] == names["ref"] - {"alphazero", "slateq", "maml",
                                            "dreamer", "fleet"}
    for algo in ("td3", "ddppo"):
        rc, out = rerun_if_pkilled(cli, "port", "--algo", algo,
                                   "--stop-iters", "1", "--num-workers", "1")
        assert rc == 0 and "iter 1: reward=" in out, (algo, out)
