"""Sequence parallelism (ops/ring_attention.py, ops/ulysses.py, sp in the
model and the sharded step) on the CPU under gloo, in float32, against the
JAX package on `make_virtual_mesh`.

- The ring and Ulysses ops at sp 2 (each rank its own process,
  tests/torch_ranks.py): outputs and dq, dk, dv within 1e-5 of
  `ring_attention_sharded` / `ulysses_attention_sharded`, causal and not,
  GQA included (the cases of tests/test_ops.py:63-150).
- The step at sp 2 under ring and under Ulysses, on 2 ranks, against
  `make_train_step` at the same mesh, 3 steps with a loss mask that keeps
  a different count on each rank: losses and grad norms within 1e-5
  relative, params within 1e-4 + 1e-4·|p|. tp 2 x sp 2 on 4 ranks is slow.
- World 1 through the new code: Ulysses on a one-rank sp group is the
  unsharded step bit for bit; ring (an einsum merge where the plain step
  runs the flash pair's plain version) within the step bounds above.
- The raises that stay: a {"tokens"} batch under sp, sp without a scheme,
  a local head count sp does not divide.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu.ops.ring_attention import ring_attention_sharded
from ray_tpu.ops.ulysses import ulysses_attention_sharded
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_virtual_mesh as jmake_virtual_mesh
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
from ray_tpu_torch.parallel import (MeshConfig, initialize_group, make_mesh,
                                    shutdown_group)
from ray_tpu_torch.parallel.tensor import Parallel
from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                 to_local)
from ray_tpu_torch.train.step import _check_mesh
from test_torch_sharded_step import _check_against_jax

TOL = dict(rtol=1e-5, atol=1e-5)
# name: (scheme, causal, query heads, KV heads)
OP_CASES = {"ring_causal": ("ring", True, 4, 4),
            "ring_full": ("ring", False, 4, 4),
            "ring_gqa": ("ring", True, 4, 2),
            "ulysses_causal": ("ulysses", True, 4, 4),
            "ulysses_full": ("ulysses", False, 4, 4),
            "ulysses_gqa": ("ulysses", True, 4, 2),
            "ulysses_gqa_one_kv": ("ulysses", True, 4, 1)}
B, S, D = 2, 32, 16


def _op_inputs(case):
    _, _, hq, hkv = OP_CASES[case]
    rng = np.random.default_rng(sorted(OP_CASES).index(case))
    q = rng.standard_normal((B, hq, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, hkv, S, D)).astype(np.float32)
            for _ in range(2))
    dy = rng.standard_normal((B, hq, S, D)).astype(np.float32)
    return q, k, v, dy


def _jax_op(case):
    """(out, dq, dk, dv) of the JAX op at sp 2, K/V repeated first for the
    ring (as the model does)."""
    scheme, causal, hq, hkv = OP_CASES[case]
    mesh = jmake_virtual_mesh(2, JMeshConfig(dp=1, fsdp=1, tp=1, sp=2))
    q, k, v, dy = _op_inputs(case)

    def fn(q, k, v):
        if scheme == "ring":
            k, v = (jnp.repeat(t, hq // hkv, axis=1) for t in (k, v))
            return ring_attention_sharded(mesh, q, k, v, causal=causal)
        return ulysses_attention_sharded(mesh, q, k, v, causal=causal)

    @jax.jit
    def run(q, k, v, dy):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, *vjp(dy)

    return [np.asarray(t) for t in run(*(jnp.asarray(t)
                                         for t in (q, k, v, dy)))]


@pytest.fixture(scope="module")
def port_ops(tmp_path_factory):
    """Every case through the port's ops on 2 gloo ranks (one launch)."""
    path = tmp_path_factory.mktemp("sp_ops")
    arrays = {}
    for case in OP_CASES:
        q, k, v, dy = _op_inputs(case)
        arrays.update({f"{case}/q": q, f"{case}/k": k, f"{case}/v": v,
                       f"{case}/dy": dy,
                       f"{case}/causal": np.array(OP_CASES[case][1])})
    np.savez(path / "in.npz", **arrays)
    got = torch_ranks.run_ranks("sp_ops", 2, path)
    assert got["cases"] == sorted(OP_CASES)
    return dict(np.load(path / "out.npz"))


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_ring_and_ulysses_ops_match_jax(port_ops, case):
    want = _jax_op(case)
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(port_ops[f"{case}/{name}"], w,
                                   err_msg=f"{case} {name}", **TOL)


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sp2_step_on_two_ranks_matches_jax(tmp_path, scheme):
    _check_against_jax(tmp_path, 2, 1, 1, True, sp=2, scheme=scheme)


@pytest.mark.slow
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_tp2_sp2_step_on_four_ranks_matches_jax(tmp_path, scheme):
    _check_against_jax(tmp_path, 4, 1, 1, True, tp=2, sp=2, scheme=scheme)


# ---------------------------------------------------------------- world 1


@pytest.fixture
def world_one():
    initialize_group(0, 1, device="cpu")
    try:
        yield make_mesh(MeshConfig(), device="cpu")
    finally:
        shutdown_group()


def _run(cfg, mesh, steps=3):
    step_fn, init_fn = make_train_step(
        cfg, default_optimizer(1e-3, warmup_steps=1), "cpu", mesh=mesh)
    state = init_fn(0)
    batch = make_batch(cfg, 2, 32, 1, "cpu")
    metrics = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, [t.clone() for t in tree_leaves(to_local(state.params))]


@functools.lru_cache(maxsize=None)
def _unsharded(remat):
    return _run(dataclasses.replace(ModelConfig.tiny(), remat=remat), None)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_world_one_ulysses_is_the_unsharded_step_bit_for_bit(world_one,
                                                             remat):
    want, want_params = _unsharded(remat)
    got, got_params = _run(dataclasses.replace(
        ModelConfig.tiny(), remat=remat, seq_parallel="ulysses"), world_one)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_params, want_params,
                                                 strict=True))


@pytest.mark.parametrize("flag", [dict(seq_parallel="ring"),
                                  dict(use_ring_attention=True)])
def test_world_one_ring_matches_the_unsharded_step(world_one, flag):
    want, want_params = _unsharded("none")
    got, got_params = _run(dataclasses.replace(ModelConfig.tiny(), **flag),
                           world_one)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(got_params, want_params, strict=True):  # the step bounds
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------- raises


class _Mesh:
    mesh_dim_names = ("dp", "pp", "fsdp", "tp", "sp")
    device_type = "cpu"

    def __init__(self, shape):
        self.shape = shape


def test_tokens_batches_raise_under_sp():
    cfg = dataclasses.replace(ModelConfig.tiny(), seq_parallel="ulysses")
    tokens = make_batch(cfg, 2, 16, 1, "cpu")["inputs"]
    with pytest.raises(ValueError, match="pre-shifted"):
        loss_fn({}, {"tokens": tokens}, cfg,
                Parallel(sp_group=object(), sp=2))


def test_sp_without_a_scheme_raises():
    with pytest.raises(ValueError, match="sp=2 needs seq_parallel"):
        _check_mesh(ModelConfig.tiny(), _Mesh((1, 1, 1, 1, 2)),
                    torch.device("cpu"))


def test_ulysses_raises_where_sp_does_not_divide_the_local_heads():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.ops.ulysses import ulysses_attention

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        q = torch.zeros(1, 3, 8, 4)
        k = torch.zeros(1, 1, 8, 4)
        with pytest.raises(ValueError, match="local Q head count 3 not "
                                             "divisible by sp=2"):
            ulysses_attention(q, k, k, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
