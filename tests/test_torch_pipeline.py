"""Pipeline parallelism (parallel/pipeline.py: GPipe over pp, composed with
dp, fsdp and tp) on the CPU under gloo, `ModelConfig.tiny` in float32.

- Several ranks, each its own process (tests/torch_ranks.py, no jax),
  from the JAX params through the bridge, with a loss mask that keeps 32,
  20, 5 and 0 tokens of the four rows (so each microbatch and each data
  rank its own count):
  - against the port's dense `loss_fn` (tests/test_pipeline.py's cases):
    the pipeline's step-1 loss within 2e-5 relative, its step-1 gradients
    within 1e-4, `pp_forward`'s logits within 1e-4 of the dense forward's;
    3 steps run and the step counter reads 3;
  - against the JAX package's `make_pp_train_step` on `make_virtual_mesh`
    at the same mesh, 3 steps of `default_optimizer`: losses and grad
    norms within 1e-5 relative, every param within 1e-4 plus 1e-4 of its
    size (tests/test_torch_sharded_step.py's bounds).
  pp 2 on 2 ranks here; pp 2 x tp 2, dp 2 x pp 2, pp 2 x fsdp 2 and pp 4
  on 4 ranks are slow. A state saved at fsdp 2 restores onto pp 2 bit for
  bit, and the next pipeline step's loss is the unsharded step's.
- World 1: the pipeline at pp 1 and n_micro 1 is the sharded step bit for
  bit (losses, grad norms, every param after 3 steps) under both
  optimizers; at n_micro 2 and 4 the losses and grad norms within 1e-6
  relative (the microbatches' sums in another order), every param within
  the bounds above.
- An sp 2 mesh raises ValueError, MoE NotImplementedError, a global batch
  that n_micro does not divide ValueError. n_micro may divide the global
  batch and not a rank's rows: dp 2 x pp 2 with n_micro 4 (slow).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_virtual_mesh as jmake_virtual_mesh
from ray_tpu.parallel.pipeline import make_pp_train_step as jmake_pp_train_step
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.bridge import params_from_jax
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import forward, loss_fn, tree_leaves
from ray_tpu_torch.parallel import (MeshConfig, initialize_group, make_mesh,
                                    shutdown_group)
from ray_tpu_torch.parallel.fsdp import tree_paths
from ray_tpu_torch.parallel.pipeline import make_pp_train_step, micro_rows
from ray_tpu_torch.train import (default_optimizer, fused_adamw_optimizer,
                                 make_train_step, to_local)

BATCH, SEQ = 4, 32
OPTIMIZERS = {"default": default_optimizer,
              "fused": fused_adamw_optimizer}


def _tokens():
    return np.random.default_rng(7).integers(
        0, 512, (BATCH, SEQ + 1)).astype(np.int64)


def _mask():
    m = np.ones((BATCH, SEQ), np.float32)
    m[1, 20:] = m[2, 5:] = m[3] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _jax_pp(n, dp, pp, fsdp, tp, n_layers, n_micro):
    """JAX's pipeline step on an n-device virtual mesh: the initial params
    and, after each of 3 masked steps, (loss, grad_norm, params)."""
    mesh = jmake_virtual_mesh(n, JMeshConfig(dp=dp, pp=pp, fsdp=fsdp, tp=tp))
    cfg = dataclasses.replace(JConfig.tiny(), n_layers=n_layers)
    step_fn, init_fn, _ = jmake_pp_train_step(
        cfg, mesh, jdefault_optimizer(1e-3, warmup_steps=1), n_micro=n_micro,
        donate=False)
    # the step's own body: its jit's batch sharding names no loss mask
    step = jax.jit(step_fn.__wrapped__)
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    tokens = _tokens()
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:]),
             "loss_mask": jnp.asarray(_mask())}
    out = []
    for _ in range(3):
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    jax.device_get(state.params)))
    return init, out


def _check_pipeline(tmp_path, dp=1, pp=2, fsdp=1, tp=1, n_layers=2,
                    n_micro=2):
    world = dp * pp * fsdp * tp
    init, want = _jax_pp(world, dp, pp, fsdp, tp, n_layers, n_micro)
    np.savez(tmp_path / "in.npz", tokens=_tokens(), mask=_mask(),
             n_layers=n_layers,
             **{"p/" + k: np.asarray(v) for k, v in tree_paths(init)})
    got = torch_ranks.run_ranks("pp", world, tmp_path, dp, pp, fsdp, tp,
                                n_micro)
    out = dict(np.load(tmp_path / "out.npz"))
    assert got["count"] == got["step"] == 3
    assert got["local_rows"] == BATCH // (dp * fsdp)

    # the port's dense loss, gradients and logits on the same params
    cfg = dataclasses.replace(ModelConfig.tiny(), n_layers=n_layers)
    params = params_from_jax(init, cfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    tokens = torch.from_numpy(_tokens())
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
             "loss_mask": torch.from_numpy(_mask())}
    dense, _ = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(dense, leaves)
    np.testing.assert_allclose(got["losses"][0], float(dense.detach()),
                               rtol=2e-5)
    for (path, _), g in zip(tree_paths(params), grads, strict=True):
        err = np.abs(out["g/" + path] - g.numpy()).max()
        assert err < 1e-4, (path, err)
    with torch.no_grad():
        rows = got["local_rows"]
        logits = forward(params, batch["inputs"][:rows], cfg)
    pp_logits = np.load(tmp_path / "logits.npz")["logits"]
    n_local = len(micro_rows(rows, n_micro, 0, dp * fsdp))
    assert pp_logits.shape == (n_local, rows // n_local, SEQ, 512)
    np.testing.assert_allclose(pp_logits.reshape(logits.shape),
                               logits.numpy(), rtol=1e-4, atol=1e-4)

    for i, (loss, gnorm, _) in enumerate(want):
        np.testing.assert_allclose(got["losses"][i], loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"][i], gnorm, rtol=1e-5)
    for path, w in tree_paths(want[-1][2]):
        np.testing.assert_allclose(out["p/" + path], np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    assert want[-1][0] < want[0][0]


def test_pp2_on_two_ranks_matches_dense_and_jax(tmp_path):
    _check_pipeline(tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("dp,pp,fsdp,tp,n_layers,n_micro", [
    (1, 2, 1, 2, 2, 2),
    (2, 2, 1, 1, 2, 2),
    (1, 2, 2, 1, 4, 2),
    (1, 4, 1, 1, 4, 4),
    (2, 2, 1, 1, 2, 4),  # n_micro the global batch: 2 microbatches a rank
])
def test_four_ranks_match_dense_and_jax(tmp_path, dp, pp, fsdp, tp,
                                        n_layers, n_micro):
    _check_pipeline(tmp_path, dp, pp, fsdp, tp, n_layers, n_micro)


def test_checkpoint_at_fsdp2_restores_onto_pp2(tmp_path):
    got = torch_ranks.run_ranks("ckpt_pp", 2, tmp_path)
    assert got["equal"] == got["leaves"] and len(got["leaves"]) == 36
    assert got["on_target_mesh"]
    assert (got["step"], got["count"]) == (1, 1)
    one, pp = got["next_loss"]
    np.testing.assert_allclose(pp, one, rtol=1e-5)


# ---------------------------------------------------------------- world 1


@pytest.fixture
def world_one():
    initialize_group(0, 1, device="cpu")
    try:
        yield make_mesh(MeshConfig(), device="cpu")
    finally:
        shutdown_group()


def _run(cfg, optimizer, mesh, n_micro=None):
    """3 steps on the masked batch: the sharded step, or (n_micro given)
    the pipeline."""
    if n_micro is None:
        step_fn, init_fn = make_train_step(cfg, optimizer, "cpu", mesh=mesh)
    else:
        step_fn, init_fn, _ = make_pp_train_step(cfg, mesh, optimizer,
                                                 n_micro, "cpu")
    state = init_fn(0)
    batch = make_batch(cfg, BATCH, SEQ, 1, "cpu")
    batch["loss_mask"] = torch.from_numpy(_mask())
    metrics = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    return metrics, [t.clone() for t in tree_leaves(to_local(state.params))]


@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_world_one_is_the_sharded_step(world_one, opt, n_micro):
    cfg = ModelConfig.tiny()
    make = functools.partial(OPTIMIZERS[opt], 1e-3, warmup_steps=1)
    want, want_params = _run(cfg, make(), world_one)
    got, got_params = _run(cfg, make(), world_one, n_micro)
    if n_micro == 1:
        assert got == want
        assert all(torch.equal(a, b) for a, b in zip(got_params, want_params,
                                                     strict=True))
    else:
        assert [m[2] for m in got] == [0, 1, 2]
        for (la, na, _), (lb, nb, _) in zip(got, want):
            assert abs(la - lb) <= 1e-6 * abs(lb)
            assert abs(na - nb) <= 1e-6 * abs(nb)
        for a, b in zip(got_params, want_params, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4)


def test_rows_that_n_micro_does_not_divide_raise(world_one):
    cfg = ModelConfig.tiny()
    step_fn, init_fn, _ = make_pp_train_step(cfg, world_one, n_micro=3,
                                             device="cpu")
    with pytest.raises(ValueError, match="4 rows is not divisible by "
                                         "n_micro 3"):
        step_fn(init_fn(0), make_batch(cfg, BATCH, SEQ, 1, "cpu"))


def test_microbatches_follow_the_global_batch():
    """`micro_rows`: n_micro dividing a rank's rows cuts them; else the
    rank runs its parts of the global microbatches (dp 2 x pp 2 with 4
    rows and n_micro 4: 2 of 1 row each); unequal counts raise."""
    assert micro_rows(4, 2) == [slice(0, 2), slice(2, 4)]
    assert micro_rows(2, 4, 1, 2) == [slice(0, 1), slice(1, 2)]
    assert micro_rows(3, 6, 2, 4) == [slice(0, 2), slice(2, 3)]
    assert micro_rows(1, 2, 3, 4) == [slice(0, 1)]
    with pytest.raises(ValueError, match="12 rows is not divisible by "
                                         "n_micro 5"):
        micro_rows(3, 5, 0, 4)
    with pytest.raises(ValueError, match="each must run as many"):
        micro_rows(6, 4, 0, 2 * 5)


class _Mesh:
    """What make_pp_train_step reads of a mesh before any collective."""
    mesh_dim_names = ("dp", "pp", "fsdp", "tp", "sp")
    device_type = "cpu"

    def __init__(self, **sizes):
        self.shape = tuple(sizes.get(n, 1) for n in self.mesh_dim_names)


def test_sp_and_moe_raise():
    with pytest.raises(ValueError, match="requires sp == 1"):
        make_pp_train_step(ModelConfig.tiny(), _Mesh(dp=2, pp=2, sp=2),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        make_pp_train_step(ModelConfig.tiny_moe(), _Mesh(pp=2), device="cpu")
