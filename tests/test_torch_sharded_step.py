"""The sharded training step (train/step.py with `mesh=`, parallel/fsdp.py)
on the CPU under gloo, `ModelConfig.tiny` in float32.

- World 1: the sharded step is the unsharded step bit for bit (losses,
  grad norms, every param after 3 steps) under both optimizers, on the
  plain, fused-block and remat + chunked-loss paths; a saved gathered
  weight is gathered again in the backward, never kept whole.
- Several ranks, each its own process (tests/torch_ranks.py, no jax):
  against the JAX package's `make_train_step` on `make_virtual_mesh` at the
  same mesh, from the JAX params through the bridge, 3 steps of
  `default_optimizer`: losses and grad norms within 1e-5 relative, every
  param within 1e-4 plus 1e-4 of its size (tests/test_torch_train_step.py's
  bounds: Adam's first steps move a parameter whose gradient nearly
  cancels by up to the learning rate, 1e-3, on another summation order),
  with a loss mask that keeps a different count of tokens on each
  rank. fsdp 2 on 2 ranks here, and pp 2 on 2 ranks, which runs
  replicated over pp as the reference's step does (every pp rank holds the
  same bits); dp 2 x fsdp 2 and fsdp 4 on 4 ranks, and the checkpoint
  saved at dp 2 x fsdp 2 and restored onto fsdp 4 and onto one process,
  are slow.
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
from ray_tpu.train import make_train_step as jmake_train_step
from ray_tpu.train import step as jstep
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.bridge import params_to_numpy
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import tree_leaves
from ray_tpu_torch.parallel import (MeshConfig, initialize_group, make_mesh,
                                    shutdown_group)
from ray_tpu_torch.parallel import fsdp as fsdp_mod
from ray_tpu_torch.parallel.fsdp import tree_paths
from ray_tpu_torch.train import (abstract_like, default_optimizer,
                                 fused_adamw_optimizer, load_checkpoint,
                                 make_train_step, to_local)
from ray_tpu_torch.train.step import _check_mesh

BATCH, SEQ = 4, 32
OPTIMIZERS = {"default": default_optimizer,
              "fused": fused_adamw_optimizer}
VARIANTS = {"plain": {}, "fused_blocks": dict(fused_ffn=True, fused_attn=True),
            "remat_chunked": dict(remat="full", loss_chunk=8)}


@pytest.fixture
def world_one():
    initialize_group(0, 1, device="cpu")
    try:
        yield make_mesh(MeshConfig(), device="cpu")
    finally:
        shutdown_group()


def _run(cfg, optimizer, mesh, steps=3):
    step_fn, init_fn = make_train_step(cfg, optimizer, "cpu", mesh=mesh)
    state = init_fn(0)
    batch = make_batch(cfg, 2, SEQ, 1, "cpu")
    metrics = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        m["step"]))
    return metrics, [t.clone() for t in tree_leaves(to_local(state.params))]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_world_one_is_the_unsharded_step_bit_for_bit(world_one, opt,
                                                     variant):
    cfg = dataclasses.replace(ModelConfig.tiny(), **VARIANTS[variant])
    make = functools.partial(OPTIMIZERS[opt], 1e-3, warmup_steps=1)
    want, want_params = _run(cfg, make(), None)
    got, got_params = _run(cfg, make(), world_one)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_params, want_params,
                                                 strict=True))


def test_saved_weights_are_gathered_again_in_the_backward(world_one,
                                                          monkeypatch):
    """Every leaf split over fsdp is gathered once a layer forward; each
    weight a product saves for the backward is packed as its shard and
    gathered again there (all but the embedding, whose lookup saves only
    the token ids)."""
    cfg = ModelConfig.tiny()
    calls = []
    real = fsdp_mod._gather

    def counting(shard, dim, group, n):
        calls.append(torch.is_grad_enabled())
        return real(shard, dim, group, n)

    monkeypatch.setattr(fsdp_mod, "_gather", counting)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(), "cpu",
                                       mesh=world_one)
    step_fn(init_fn(0), make_batch(cfg, 2, SEQ, 1, "cpu"))
    per_layer = 7  # wq, wk, wv, wo, w_gate, w_up, w_down (norms whole)
    gathers = 2 + per_layer * cfg.n_layers  # + embed, lm_head
    assert len(calls) == gathers + gathers - 1


def test_unported_meshes_raise():
    """MoE over an fsdp that does not divide the experts raises naming the
    expert leaves; pp runs (replicated over pp here, split by
    parallel/pipeline.py), MoE on any other shard of (dp, fsdp, tp, sp)
    runs (tests/test_torch_expert_parallel.py), and so do tp and sp
    (tests/test_torch_tensor_parallel.py,
    tests/test_torch_seq_parallel.py)."""
    class Mesh:
        mesh_dim_names = ("dp", "pp", "fsdp", "tp", "sp")
        device_type = "cpu"

        def __init__(self, shape):
            self.shape = shape

    cpu = torch.device("cpu")
    _check_mesh(ModelConfig.tiny(), Mesh((1, 2, 1, 1, 1)), cpu)
    for shape in ((2, 1, 1, 1, 1), (1, 1, 2, 1, 1), (1, 1, 1, 2, 1),
                  (1, 1, 4, 1, 1), (2, 1, 2, 2, 1)):
        _check_mesh(ModelConfig.tiny_moe(), Mesh(shape), cpu)
    with pytest.raises(ValueError, match="fsdp=3 does not divide "
                                         "n_experts=4: the expert leaves "
                                         "layers/w_gate"):
        _check_mesh(ModelConfig.tiny_moe(), Mesh((1, 1, 3, 1, 1)), cpu)
    _check_mesh(ModelConfig.tiny_moe(), Mesh((1, 1, 1, 1, 1)), cpu)
    _check_mesh(ModelConfig.tiny(), Mesh((1, 1, 1, 2, 1)), cpu)
    _check_mesh(dataclasses.replace(ModelConfig.tiny(), seq_parallel="ring"),
                Mesh((1, 1, 1, 1, 2)), cpu)


# ---------------------------------------------------------------- vs JAX


def _tokens():
    return np.random.default_rng(5).integers(
        0, 512, (BATCH, SEQ + 1)).astype(np.int32)


def _mask():
    """Rows keep 32, 20, 5 and 0 tokens: every rank its own count."""
    m = np.ones((BATCH, SEQ), np.float32)
    m[1, 20:] = m[2, 5:] = m[3] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _jax_steps(n, dp, fsdp, masked, tp=1, sp=1, scheme="", pp=1, kv=0):
    """The JAX step on an n-device virtual mesh (`tiny`, `seq_parallel`
    `scheme`, `kv` KV heads if not 0): the initial params and, after each
    of 3 steps, (loss, grad_norm, params)."""
    mesh = jmake_virtual_mesh(n, JMeshConfig(dp=dp, fsdp=fsdp, tp=tp,
                                             sp=sp, pp=pp))
    real = jstep.batch_sharding

    def with_mask(m):  # the loss mask laid out as the rows it masks
        sh = real(m)
        return {**sh, "loss_mask": sh["inputs"]}

    jstep.batch_sharding = with_mask if masked else real
    try:
        cfg = dataclasses.replace(JConfig.tiny(), seq_parallel=scheme)
        if kv:
            cfg = dataclasses.replace(cfg, n_kv_heads=kv)
        step_fn, init_fn, _ = jmake_train_step(
            cfg, mesh,
            jdefault_optimizer(1e-3, warmup_steps=1), donate=False)
    finally:
        jstep.batch_sharding = real
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    tokens = _tokens()
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:])}
    if masked:
        batch["loss_mask"] = jnp.asarray(_mask())
    out = []
    for _ in range(3):
        state, metrics = step_fn(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    jax.device_get(state.params)))
    return init, out


def _check_against_jax(tmp_path, world, dp, fsdp, masked, tp=1, sp=1,
                       scheme="", fused=False, pp=1, kv=0):
    """The port's sharded step on `world` gloo ranks against the JAX step
    at the same mesh (the JAX side unfused: its fused blocks compute the
    same function, tests/test_torch_fused_blocks.py); `kv` KV heads in
    both if not 0."""
    init, want = _jax_steps(world, dp, fsdp, masked, tp, sp, scheme, pp, kv)
    np.savez(tmp_path / "in.npz", tokens=_tokens().astype(np.int64),
             mask=_mask(),
             **{"p/" + k: np.asarray(v) for k, v in tree_paths(init)})
    got = torch_ranks.run_ranks("steps", world, tmp_path, dp, fsdp,
                                int(masked), tp, sp, scheme or "-",
                                int(fused), 0, pp, kv)
    assert got["rows_as_dtensor"] and got["pp_replicas_equal"]
    assert (got["local_rows"], got["local_seq"]) == (BATCH // (dp * fsdp),
                                                     SEQ // sp)
    assert got["count"] == got["step"] == 3
    params = dict(np.load(tmp_path / "out.npz"))
    for i, (loss, gnorm, _) in enumerate(want):
        np.testing.assert_allclose(got["losses"][i], loss, rtol=1e-5)
        np.testing.assert_allclose(got["norms"][i], gnorm, rtol=1e-5)
    for path, w in tree_paths(want[-1][2]):
        np.testing.assert_allclose(params["p/" + path], np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    assert want[-1][0] < want[0][0]


def test_fsdp2_on_two_ranks_matches_jax(tmp_path):
    _check_against_jax(tmp_path, 2, 1, 2, masked=True)


def test_pp2_on_two_ranks_runs_replicated_and_matches_jax(tmp_path):
    _check_against_jax(tmp_path, 2, 1, 1, masked=True, pp=2)


@pytest.mark.slow
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dp,fsdp", [(2, 2), (1, 4)])
def test_four_ranks_match_jax(tmp_path, dp, fsdp, masked):
    _check_against_jax(tmp_path, 4, dp, fsdp, masked)


@pytest.mark.slow
def test_checkpoint_reshards_onto_another_mesh_and_one_process(tmp_path):
    """Saved by 4 ranks at dp 2 x fsdp 2; restored onto fsdp 4 every leaf
    bit for bit, on the target mesh, and the next step's loss the same on
    both meshes; restored here, in one process with no process group, into
    an unsharded state, every leaf bit for bit too."""
    got = torch_ranks.run_ranks("ckpt", 4, tmp_path)
    assert got["equal"] == got["leaves"] and len(got["leaves"]) == 36
    assert got["on_target_mesh"]
    assert (got["step"], got["count"], got["meta"]) == (
        1, 1, {"step": 1, "mesh": "dp2xfsdp2"})
    a, b = got["next_loss"]
    assert abs(a - b) <= 1e-6 * abs(a)

    cfg = ModelConfig.tiny()
    template = make_train_step(cfg, default_optimizer(), "cpu")[1](0)
    state, meta = load_checkpoint(str(tmp_path / "ckpt" / "step_1"),
                                  abstract_like(template))
    assert (state.step, state.opt_state.count) == (1, 1)
    whole = dict(np.load(tmp_path / "out.npz"))
    trees = {"params": state.params, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu}
    for path, t in tree_paths(params_to_numpy(trees)):
        assert np.array_equal(t, whole[path]), path


@pytest.mark.slow
def test_multichip_runner_rehearses_on_four_cpu_ranks(tmp_path):
    """`python -m ray_tpu_torch.multichip --cpu`: every phase of the 4-card
    runner (parity, full depth, reshard, collectives) on gloo ranks at
    tiny widths, its checks passing."""
    from ray_tpu_torch import multichip

    out = multichip.main(["--cpu", "--chips", "4", "--json",
                          str(tmp_path / "mc.json"), "--ckpt-root",
                          str(tmp_path / "ckpt")])
    assert set(multichip.PHASES) <= set(out)
    assert out["reshard"]["bit_identical_leaves"] == out["reshard"]["leaves"]
