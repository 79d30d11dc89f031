"""The port's rllib against ray_tpu's, on the CPU.

Each scenario of the reference's rllib tests (test_rllib, test_rl_module,
test_rllib_census, test_learner_group's actor cases, and
test_cli_observability's `rllib train`/`evaluate`) for the algorithms the
port has runs through both packages, one runtime of each alive side by
side in this process, its learners, configs and CLI asked for the CPU
(`torch_libs.to_port`). What its calls return is recorded and compared:

- host-only scenarios (environments, replay buffers, connectors, the
  numpy distributions): every recorded value equal;
- algorithm scenarios: the first `train()` of each algorithm, whose
  rollout is host-only, equal in its host entries (episode rewards, step
  counts, buffer size, epsilon) and within 1e-5 relative in the learner's
  losses; the later ones (a flipped sample can part two trajectories)
  have the same keys, and the port's own assertions hold. IMPALA and A3C
  take their samples as they finish, so only their keys are compared;
- learner groups: each update's stats within 1e-5 relative.

Then twins of the scenarios whose bodies call jax (v-trace, the squashed
Gaussian's log-prob against the SAC sampler, the recurrent module's
unroll, SimpleQ against double DQN), and the slice as a whole: PPO's
`training_step` twice, run in this process from the algorithm's own
seeds in both packages (trajectories equal, stats within 1e-5).
"""

import math

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from torch_libs import load, normalize, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_pkilled

PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}

# (file, scenario) -> kind; the families' scenarios (ES, Ape-X DDPG) run
# in test_torch_rllib_families_parity.py, the twinned ones below here
HOST, ALGO, ASYNC, GROUP = "host", "algo", "async", "group"
SCENARIOS = {
    "test_rllib.py": {
        "test_cartpole_dynamics": HOST,
        "test_vector_env_auto_reset": HOST,
        "test_gae_simple_case": HOST,
        "test_policy_apply_shapes": HOST,
        "test_ppo_learns_cartpole": ALGO,
        "test_ppo_save_restore": ALGO,
        "test_replay_buffer_ring_and_sampling": HOST,
        "test_prioritized_buffer_weights_and_update": HOST,
        "test_dqn_trains_on_cartpole": ALGO,
        "test_impala_trains_on_cartpole": ASYNC,
        "test_ppo_periodic_evaluation": ALGO,
        "test_dqn_manual_evaluate": ALGO,
    },
    "test_rl_module.py": {
        "test_categorical_sample_logp_entropy": HOST,
        "test_squashed_gaussian_bounds_mode_logp": HOST,
        "test_deterministic_dist": HOST,
        "test_epsilon_greedy_override_and_anneal": HOST,
        "test_random_actions_connector_bounds": HOST,
        "test_recurrent_q_module_state_carries_memory": HOST,
        "test_continuous_workers_act_through_pipelines": HOST,
    },
    "test_rllib_census.py": {
        "test_pg_trains_on_cartpole": ALGO,
        "test_pg_learns_cartpole": ALGO,
        "test_a3c_applies_async_gradients": ASYNC,
        "test_random_agent_baseline": ALGO,
    },
    "test_learner_group.py": {
        "test_learner_group_actor_backend": GROUP,
        "test_ppo_algorithm_with_actor_learner_group": ALGO,
    },
    "test_cli_observability.py": {
        "test_rllib_cli_train_and_evaluate": ALGO,
    },
}
# the reference marks these slow (many training iterations)
SLOW = {"test_ppo_learns_cartpole", "test_pg_learns_cartpole"}
# train() entries fixed by the rollouts alone
HOST_KEYS = {"episode_reward_mean", "num_env_steps_sampled", "buffer_size",
             "epsilon", "num_grads_applied", "training_iteration"}


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{PKGS[pkg].__name__}.rllib.{name}")


def _targets(pkg, kind):
    if kind == HOST:
        env, buf = _mod(pkg, "env"), _mod(pkg, "replay_buffers")
        con, mod = _mod(pkg, "connectors"), _mod(pkg, "rl_module")
        pairs = [(env.CartPoleEnv, "reset"), (env.CartPoleEnv, "step"),
                 (env.VectorEnv, "reset"), (env.VectorEnv, "step"),
                 (buf.ReplayBuffer, "sample"),
                 (buf.PrioritizedReplayBuffer, "sample"),
                 (con.EpsilonGreedy, "__call__"),
                 (con.RandomActions, "__call__"),
                 (con.SampleAction, "__call__"),
                 (con.GaussianNoise, "__call__"),
                 (mod.Categorical, "sample"), (mod.Categorical, "logp"),
                 (mod.Categorical, "entropy"),
                 (mod.SquashedGaussian, "sample"),
                 (mod.SquashedGaussian, "logp")]
        return [(c, m, _no_objects) for c, m in pairs if m in c.__dict__]
    alg, learner = _mod(pkg, "algorithm"), _mod(pkg, "learner")
    return [(alg.Algorithm, "train"), (alg.Algorithm, "evaluate"),
            (learner.LearnerGroup, "update")]


def _no_objects(out):
    """A connector's data dict without its module, params and generator."""
    if isinstance(out, dict):
        return {k: v for k, v in out.items()
                if k not in ("module", "params", "rng")}
    return out


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
        if label == "LearnerGroup.update":
            assert _keys(p) == _keys(r)
            for k in r:
                assert _close(p[k], r[k]), (label, k, p[k], r[k])
        elif label == "Algorithm.train" and first_train and kind != ASYNC:
            first_train = False
            assert _keys(p) == _keys(r)
            for k in r:
                if k in HOST_KEYS:
                    assert p[k] == r[k], (k, p[k], r[k])
                else:
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


@pytest.mark.parametrize("filename,name,kind", list(_cases()))
def test_reference_scenario_matches(both, filename, name, kind, tmp_path,
                                    request):
    got = {}
    for pkg in PKGS:
        ns = load(filename, pkg)
        extra = {"capsys": request.getfixturevalue("capsys")}

        def scenario():
            with recording(pkg, _targets(pkg, kind)) as calls:
                run(ns, name, pkg, tmp_path, request, extra=extra)
            return calls

        got[pkg] = rerun_if_pkilled(scenario)
    _compare(kind, got["ref"], got["port"])


def test_every_ported_config_runs_its_learner_on_the_cpu_when_asked():
    """Every algorithm config of the port has a `device` (the card by
    default) that to_port's `.training(device=)`/`.learners(device=)`
    reach; RandomAgent, ES and ARS have no learner."""
    from ray_tpu_torch import rllib
    from torch_libs import RL_CONFIGS

    no_learner = {"RandomAgentConfig", "ESConfig", "ARSConfig"}
    configs = {n for n in dir(rllib) if n.endswith("Config")}
    assert configs == set(RL_CONFIGS) | {"PPOConfig"} | no_learner
    for n in RL_CONFIGS:
        cfg = getattr(rllib, n)()
        assert cfg.device == "cuda", n
        assert cfg.training(device="cpu").device == "cpu"
    assert rllib.PPOConfig().learners(device="cpu").device == "cpu"
    for n in no_learner:
        assert not hasattr(getattr(rllib, n)(), "device"), n


# ------------------------------------------------ twins of jax scenarios


def test_vtrace_matches_the_reference_and_gae_on_policy():
    """Twin of test_vtrace_reduces_to_gae_like_targets_on_policy: the
    port's loop from T-1 down to 0 against the reference's reversed scan,
    on-policy and off it."""
    import jax.numpy as jnp

    from ray_tpu.rllib.impala import vtrace_targets as jvtrace
    from ray_tpu_torch.rllib.impala import vtrace_targets

    T, N = 5, 3
    rng = np.random.default_rng(0)
    rewards, values, behave, target = (
        rng.normal(size=(T, N)).astype(np.float32) for _ in range(4))
    last_value = rng.normal(size=(N,)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    for tlogp in (behave, target):
        want = jvtrace(*(jnp.asarray(a) for a in (
            behave, tlogp, rewards, values, last_value, dones)), gamma=0.9)
        got = vtrace_targets(*(torch.from_numpy(a) for a in (
            behave, tlogp, rewards, values, last_value, dones)), gamma=0.9)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    vs, _ = vtrace_targets(*(torch.from_numpy(a) for a in (
        behave, behave, rewards, values, last_value,
        np.zeros_like(dones))), gamma=0.9)
    expect = np.zeros((T, N), np.float32)
    acc, next_v = np.zeros(N, np.float32), last_value
    for t in reversed(range(T)):
        acc = rewards[t] + 0.9 * next_v - values[t] + 0.9 * acc
        expect[t] = acc + values[t]
        next_v = values[t]
    np.testing.assert_allclose(vs.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_squashed_gaussian_logp_matches_the_jax_sampler_twin():
    """Twin of test_squashed_gaussian_logp_matches_jax_sampler: the port's
    host-side logp of the reference SAC sampler's draw is the reference's
    host-side logp, and within 1e-3 of the sampler's own."""
    import jax

    from ray_tpu.rllib.rl_module import SquashedGaussianModule as Ref
    from ray_tpu.rllib.sac import sample_action
    from ray_tpu_torch.rllib.rl_module import SquashedGaussianModule

    module = SquashedGaussianModule(3, 2, max_action=1.0, hidden=(8,))
    ref = Ref(3, 2, max_action=1.0, hidden=(8,))
    params = module.init_params(0)
    assert normalize(params) == normalize(ref.init_params(0))
    obs = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    a, logp_jax = sample_action(params, obs, jax.random.PRNGKey(0), 2, 1.0)
    logp = module.action_dist(module.forward_inference(params, obs)).logp(
        np.asarray(a))
    want = ref.action_dist(ref.forward_inference(params, obs)).logp(
        np.asarray(a))
    np.testing.assert_array_equal(logp, want)
    assert np.allclose(logp, np.asarray(logp_jax), atol=1e-3)


def test_recurrent_q_module_step_matches_unroll_twin():
    """Twin of test_recurrent_q_module_step_matches_unroll: the numpy
    acting path, the port's torch unroll (a loop over time) and the
    reference's `lax.scan` unroll compute the same values."""
    import jax.numpy as jnp

    from ray_tpu.rllib.rl_module import RecurrentQModule as Ref
    from ray_tpu_torch.rllib.rl_module import RecurrentQModule

    module, ref = RecurrentQModule(3, 2, hidden=8), Ref(3, 2, hidden=8)
    params = module.init_params(0)
    obs_seq = np.random.default_rng(3).standard_normal(
        (2, 5, 3)).astype(np.float32)
    q_t, h_t = module.unroll({k: torch.from_numpy(v) for k, v in
                              params.items()},
                             torch.from_numpy(obs_seq), torch.zeros((2, 8)))
    q_j, h_j = ref.unroll({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(obs_seq), jnp.zeros((2, 8)))
    state, qs = module.get_initial_state(2), []
    for t in range(5):
        out = module.forward_inference(params, obs_seq[:, t], state=state)
        want = ref.forward_inference(params, obs_seq[:, t], state=state)
        assert normalize(out) == normalize(want)
        qs.append(out["action_dist_inputs"])
        state = out["state_out"]
    assert np.allclose(np.stack(qs, 1), q_t.numpy(), atol=1e-5)
    assert np.allclose(state, h_t.numpy(), atol=1e-5)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-6)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6)
    fwd = module.forward_train({k: torch.from_numpy(v) for k, v in
                                params.items()},
                               {"obs": torch.from_numpy(obs_seq)})
    assert torch.equal(fwd["action_dist_inputs"], q_t)


def test_simple_q_trains_and_differs_from_double_twin(both):
    """Twin of test_simple_q_trains_and_differs_from_double: SimpleQ
    trains through the port, and its plain max backup differs from double
    DQN's where the online and target nets disagree, each loss within 1e-5
    of the reference's."""
    from ray_tpu.rllib.dqn import DQNLearner as Ref
    from ray_tpu_torch.rllib import SimpleQConfig
    from ray_tpu_torch.rllib.dqn import DQNLearner

    def train():
        algo = (SimpleQConfig().training(device="cpu")
                .rollouts(num_rollout_workers=1).build())
        try:
            return [algo.train() for _ in range(4)][-1]
        finally:
            algo.stop()

    assert rerun_if_pkilled(train)["num_env_steps_sampled"] > 0
    losses = {}
    for double_q in (False, True):
        port = DQNLearner(2, 2, lr=1e-3, gamma=0.9, seed=0,
                          double_q=double_q, device="cpu")
        ref = Ref(2, 2, lr=1e-3, gamma=0.9, seed=0, double_q=double_q)
        rng = np.random.default_rng(0)
        shifted = {k: v + rng.standard_normal(v.shape).astype(np.float32)
                   * 0.5 for k, v in port.get_weights().items()}
        port.extra = {k: torch.from_numpy(v) for k, v in shifted.items()}
        import jax.numpy as jnp

        ref.extra = {k: jnp.asarray(v) for k, v in shifted.items()}
        batch = {
            "obs": rng.standard_normal((32, 2)).astype(np.float32),
            "actions": rng.integers(0, 2, 32).astype(np.int32),
            "rewards": rng.standard_normal(32).astype(np.float32),
            "next_obs": rng.standard_normal((32, 2)).astype(np.float32),
            "dones": np.zeros(32, np.float32),
        }
        losses[double_q], _ = port.update_batch(dict(batch))
        want, _ = ref.update_batch(dict(batch))
        assert math.isclose(losses[double_q], want, rel_tol=1e-5)
    assert losses[False] != losses[True]


# --------------------------------------------- the slice as a whole


def _direct_ppo(pkg, iters=2):
    """PPO's training_step, `iters` times, in this process: the workers
    the algorithm makes (RolloutWorkerImpl, the same seeds) and its
    learner, on the CPU for the port. Returns each iteration's rollouts
    and stats, and the final weights."""
    ppo = _mod(pkg, "ppo")
    cfg = ppo.PPOConfig()
    kw = dict(obs_dim=cfg.obs_dim, num_actions=cfg.num_actions, lr=cfg.lr,
              clip=cfg.clip_param, vf_coeff=cfg.vf_coeff,
              entropy_coeff=cfg.entropy_coeff, seed=cfg.seed)
    if pkg == "port":
        kw["device"] = "cpu"
    learner = ppo.PPOLearner(**kw)
    workers = [ppo.RolloutWorkerImpl(
        cfg.env_maker, cfg.num_envs_per_worker, cfg.seed + 1000 * (i + 1),
        cfg.obs_dim, cfg.num_actions) for i in range(cfg.num_rollout_workers)]
    rng = np.random.default_rng(cfg.seed)
    out = []
    for _ in range(iters):
        w = learner.get_weights()
        for wk in workers:
            wk.set_weights(w)
        samples = [wk.sample(cfg.rollout_fragment_length) for wk in workers]
        flats = []
        for batch in samples:
            adv, ret = ppo.compute_gae(batch, cfg.gamma, cfg.lambda_)
            T, N = batch["actions"].shape
            flats.append({"obs": batch["obs"].reshape(T * N, -1),
                          "actions": batch["actions"].reshape(-1),
                          "logp": batch["logp"].reshape(-1),
                          "advantages": adv.reshape(-1),
                          "returns": ret.reshape(-1)})
        flat = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
        a = flat["advantages"]
        flat["advantages"] = (a - a.mean()) / (a.std() + 1e-8)
        stats = learner.update_minibatches(flat, cfg.num_sgd_iter,
                                           cfg.sgd_minibatch_size, rng)
        out.append((samples, stats))
    return out, learner.get_weights()


def test_ppo_training_steps_match_the_reference():
    """Two of PPO's iterations at its defaults (CartPole, 2 workers x 4
    envs x 128 steps, 4 epochs of 256 rows): the first rollout (the
    initial weights, equal bit for bit) equal in every array; the second's
    trajectory (observations, actions, rewards, episodes) equal and its
    log-probs and values, from weights equal to float precision, within
    1e-5; each iteration's stats within 1e-5 relative, the weights within
    the reference's bounds."""
    ref, ref_w = _direct_ppo("ref")
    port, port_w = _direct_ppo("port")
    for it, ((r_samples, r_stats), (p_samples, p_stats)) in enumerate(
            zip(ref, port)):
        if it == 0:   # the initial weights: every array bit for bit
            assert normalize(p_samples) == normalize(r_samples)
        for r, p in zip(r_samples, p_samples):
            for k in ("obs", "actions", "rewards", "dones",
                      "episode_returns"):
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            for k in ("logp", "values", "last_value"):  # updated weights
                np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        assert sorted(p_stats) == sorted(r_stats)
        for k in r_stats:
            assert math.isclose(p_stats[k], r_stats[k], rel_tol=1e-5), k
    for k in ref_w:
        np.testing.assert_allclose(port_w[k], ref_w[k], rtol=1e-4, atol=1e-5)


def test_initial_weights_are_the_reference_bit_for_bit():
    from ray_tpu.rllib.dqn import DQNLearner as RefDQN
    from ray_tpu.rllib.ppo import PPOLearner as RefPPO
    from ray_tpu_torch.rllib.dqn import DQNLearner
    from ray_tpu_torch.rllib.ppo import PPOLearner

    for port, ref in ((PPOLearner(4, 2, 1e-3, seed=3, device="cpu"),
                       RefPPO(4, 2, 1e-3, seed=3)),
                      (DQNLearner(4, 2, 1e-3, 0.99, seed=3, device="cpu"),
                       RefDQN(4, 2, 1e-3, 0.99, seed=3))):
        assert normalize(port.get_weights()) == normalize(ref.get_weights())

