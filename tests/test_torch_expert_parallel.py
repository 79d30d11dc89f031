"""Expert parallelism (ops/moe.py over a mesh, parallel/expert.py, the
expert leaves of parallel/fsdp.py) on the CPU under gloo, `tiny_moe` in
float32 (4 experts, top-2), against the JAX package, whose GSPMD keeps
`moe_ffn`'s meaning on any mesh: the router sees the global batch.

- The sharded step at fsdp 2 and at tp 2 on 2 ranks (each its own
  process, tests/torch_ranks.py) against JAX's `make_train_step` on
  `make_virtual_mesh` at the same mesh, from the JAX params, 3 steps of
  `default_optimizer` with a loss mask that keeps another count on each
  rank: losses, grad norms and `moe_aux` within 1e-5 relative, params
  within 1e-4 + 1e-4·|p| (the tp tests' bounds). dp 2 x fsdp 2, fsdp 2
  x tp 2, tp 2 x sp 2 under Ulysses, dp 2 x fsdp 2 x tp 2 (the reference's own
  layout, tests/test_moe_inference.py) and a MoE checkpoint saved at fsdp
  4 and restored onto fsdp 2 x tp 2 and back are slow.
- Each rank's block of the expert leaves and the router, at fsdp 2, fsdp
  2 x tp 2 and dp 2 x fsdp 2 (one process, `fake_pg`): JAX's `shard_shape`
  and the values JAX puts on that device; and the raise that names the
  expert leaves where fsdp does not divide the experts.
- World 1: the sharded step is the unsharded MoE step bit for bit, under
  both optimizers, without remat and under "dots" (whose backward reruns
  the collectives), and no expert leaf is ever gathered.
- Two unit tests with no JAX step, on 2 ranks: the global token order
  (`local_gating` at sp 2 and at fsdp 2 gives each rank exactly the
  unsharded gating's rows of dispatch and combine, and its aux); and the
  router's gradient under tp 2 (one MoE layer at tp 2 against the same
  layer at tp 1: output, aux and every gradient, the input's included,
  which would count the replicated router branch twice if the router read
  `copy_to_tp`'s output).
- The routing witness of `multichip`'s (h) (`_Routes`, `_route_diff`):
  what it records, what forcing a record gives, what the diff counts.
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
from ray_tpu.models import loss_fn as jloss_fn
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_virtual_mesh as jmake_virtual_mesh
from ray_tpu.train import make_train_step as jmake_train_step
from ray_tpu.train import step as jstep
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import (_layer, init_params,
                                              param_logical_axes,
                                              tree_leaves)
from ray_tpu_torch.ops.layers import rotary_embedding
from ray_tpu_torch.ops.moe import top2_gating
from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshConfig,
                                    initialize_group, logical_sharding,
                                    make_mesh, shutdown_group)
from ray_tpu_torch.parallel import fsdp as fsdp_mod
from ray_tpu_torch.parallel.fsdp import tree_paths
from ray_tpu_torch.parallel.tensor import SINGLE
from ray_tpu_torch.train import (default_optimizer, fused_adamw_optimizer,
                                 make_train_step, to_local)
from ray_tpu_torch.train.step import _check_mesh
from test_torch_sharded_step import BATCH, SEQ, _mask, _tokens
from test_torch_tensor_parallel import fake_world  # noqa: F401 (fixture)

RTOL = 1e-5
EXPERT_LEAVES = ("layers/w_gate", "layers/w_up", "layers/w_down")


# ---------------------------------------------------------------- vs JAX


@functools.lru_cache(maxsize=None)
def _jax_moe_steps(n, dp, fsdp, tp=1, sp=1, scheme=""):
    """The JAX step on `tiny_moe` on an n-device virtual mesh, with the
    loss mask: the initial params and, for each of 3 steps, (loss,
    grad_norm, moe_aux at the params the step starts from, params)."""
    cfg = dataclasses.replace(JConfig.tiny_moe(), seq_parallel=scheme)
    mesh = jmake_virtual_mesh(n, JMeshConfig(dp=dp, fsdp=fsdp, tp=tp,
                                             sp=sp))
    real = jstep.batch_sharding

    def with_mask(m):  # the loss mask laid out as the rows it masks
        sh = real(m)
        return {**sh, "loss_mask": sh["inputs"]}

    jstep.batch_sharding = with_mask
    try:
        step_fn, init_fn, _ = jmake_train_step(
            cfg, mesh, jdefault_optimizer(1e-3, warmup_steps=1),
            donate=False)
    finally:
        jstep.batch_sharding = real
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    tokens = _tokens()
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:]),
             "loss_mask": jnp.asarray(_mask())}
    aux_fn = jax.jit(lambda p, b: jloss_fn(p, b, cfg, mesh)[1]["moe_aux"])
    out = []
    for _ in range(3):
        aux = float(aux_fn(state.params, batch))
        state, metrics = step_fn(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    aux, jax.device_get(state.params)))
    return init, out


def _check_moe_against_jax(tmp_path, world, dp, fsdp, tp=1, sp=1,
                           scheme=""):
    init, want = _jax_moe_steps(world, dp, fsdp, tp, sp, scheme)
    np.savez(tmp_path / "in.npz", tokens=_tokens().astype(np.int64),
             mask=_mask(),
             **{"p/" + k: np.asarray(v) for k, v in tree_paths(init)})
    got = torch_ranks.run_ranks("steps", world, tmp_path, dp, fsdp, 1, tp,
                                sp, scheme or "-", 0, 1, timeout=240.0)
    assert got["rows_as_dtensor"]
    assert (got["local_rows"], got["local_seq"]) == (BATCH // (dp * fsdp),
                                                     SEQ // sp)
    params = dict(np.load(tmp_path / "out.npz"))
    for i, (loss, gnorm, aux, _) in enumerate(want):
        np.testing.assert_allclose(got["losses"][i], loss, rtol=RTOL)
        np.testing.assert_allclose(got["norms"][i], gnorm, rtol=RTOL)
        np.testing.assert_allclose(got["moe_aux"][i], aux, rtol=RTOL)
    for path, w in tree_paths(want[-1][3]):
        np.testing.assert_allclose(params["p/" + path], np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    assert want[-1][0] < want[0][0]


def test_fsdp2_moe_step_on_two_ranks_matches_jax(tmp_path):
    """Two experts a rank: the router gathers both ranks' tokens, the
    dispatch is reduce-scattered to the experts' ranks."""
    _check_moe_against_jax(tmp_path, 2, 1, 2)


def test_tp2_moe_step_on_two_ranks_matches_jax(tmp_path):
    """Every expert on both ranks, d_ff split over tp."""
    _check_moe_against_jax(tmp_path, 2, 1, 1, tp=2)


@pytest.mark.slow
@pytest.mark.parametrize("layout", [
    dict(dp=2, fsdp=2), dict(fsdp=2, tp=2),
    dict(tp=2, sp=2, scheme="ulysses")],
    ids=lambda kw: "x".join(f"{k}{v}" for k, v in kw.items()))
def test_four_rank_moe_steps_match_jax(tmp_path, layout):
    kw = {"dp": 1, "fsdp": 1, **layout}
    _check_moe_against_jax(tmp_path, 4, kw.pop("dp"), kw.pop("fsdp"), **kw)


@pytest.mark.slow
def test_dp2_fsdp2_tp2_moe_step_matches_jax(tmp_path):
    """The reference's own sharded MoE layout (tests/test_moe_inference.py
    trains `tiny_moe` on dp 2 x fsdp 2 x tp 2), on 8 ranks."""
    _check_moe_against_jax(tmp_path, 8, 2, 2, tp=2)


@pytest.mark.slow
def test_moe_checkpoint_reshards_between_fsdp4_and_fsdp2_tp2(tmp_path):
    """A `tiny_moe` state saved at fsdp 4 (one expert a rank) restored onto
    fsdp 2 x tp 2 and back, every leaf bit for bit on the target mesh, and
    the next step's loss the same on each (DCP reshards the expert
    leaves; train/checkpointing.py has no code of its own for them)."""
    got = torch_ranks.run_ranks("reshard_tp", 4, tmp_path, 1,
                                timeout=240.0)
    for way in ("fsdp4->fsdp2xtp2", "fsdp2xtp2->fsdp4"):
        assert got[way]["equal"] == got[way]["leaves"] == 39, way
        assert got[way]["on_target_mesh"], way
    losses = got["next_loss"]
    for name in ("fsdp2xtp2", "back"):
        assert abs(losses[name] - losses["fsdp4"]) <= 1e-5 * losses["fsdp4"]


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("mesh_kw", [dict(fsdp=2), dict(fsdp=2, tp=2),
                                     dict(dp=2, fsdp=2)],
                         ids=lambda kw: "x".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_expert_leaf_blocks_match_jax_shards(fake_world, mesh_kw):
    """`spec_placements` and `NamedSharding.block` give each rank JAX's
    `shard_shape` and the values JAX puts on its device for the expert
    leaves ("expert" over fsdp, embed then unsplit) and the router (embed
    over fsdp)."""
    from jax.sharding import NamedSharding as JNamedSharding

    n = int(np.prod(list(mesh_kw.values())))
    cfg = ModelConfig.tiny_moe()
    rng = np.random.default_rng(2)
    paths = (*EXPERT_LEAVES, "layers/router")
    full = {p: rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for p, t in tree_paths(init_params(cfg, device="meta"))
            if p in paths}
    axes = dict(tree_paths(param_logical_axes(cfg)))
    jmesh = jmake_virtual_mesh(n, JMeshConfig(**mesh_kw))
    want = {}
    for path, arr in full.items():
        spec = DEFAULT_RULES.spec(axes[path])
        assert spec[1] == "fsdp", (path, spec)
        sh = JNamedSharding(jmesh, jax.sharding.PartitionSpec(*spec))
        for shard in jax.device_put(arr, sh).addressable_shards:
            coord = np.argwhere(jmesh.devices == shard.device)[0]
            rank = int(np.ravel_multi_index(coord, jmesh.devices.shape))
            assert shard.data.shape == sh.shard_shape(arr.shape)
            want[path, rank] = np.asarray(shard.data)
    for rank in range(n):
        fake_world(rank, n)
        mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
        shardings = dict(tree_paths(logical_sharding(
            mesh, param_logical_axes(cfg))))
        for path, arr in full.items():
            got = shardings[path].local(torch.from_numpy(arr)).numpy()
            np.testing.assert_array_equal(got, want[path, rank],
                                          err_msg=f"{path} rank {rank}")


class _Mesh:
    mesh_dim_names = ("dp", "pp", "fsdp", "tp", "sp")
    device_type = "cpu"

    def __init__(self, shape):
        self.shape = shape


def test_fsdp_that_does_not_divide_the_experts_raises_naming_the_leaves():
    cpu = torch.device("cpu")
    for fsdp in (3, 8):
        with pytest.raises(ValueError, match=f"fsdp={fsdp} does not divide "
                                             f"n_experts=4.*layers/w_gate"):
            _check_mesh(ModelConfig.tiny_moe(), _Mesh((1, 1, fsdp, 1, 1)),
                        cpu)
    _check_mesh(ModelConfig.tiny_moe(), _Mesh((1, 1, 4, 1, 1)), cpu)
    cfg = dataclasses.replace(ModelConfig.tiny_moe(), d_ff=255)
    with pytest.raises(ValueError, match="tp=2 does not divide d_ff=255"):
        _check_mesh(cfg, _Mesh((1, 1, 1, 2, 1)), cpu)


# ---------------------------------------------------------------- world 1


@pytest.fixture
def world_one():
    initialize_group(0, 1, device="cpu")
    try:
        yield make_mesh(MeshConfig(), device="cpu")
    finally:
        shutdown_group()


def _run(cfg, optimizer, mesh):
    step_fn, init_fn = make_train_step(cfg, optimizer, "cpu", mesh=mesh)
    state = init_fn(0)
    batch = make_batch(cfg, 2, SEQ, 1, "cpu")
    metrics = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["moe_aux"])))
    return metrics, [t.clone() for t in tree_leaves(to_local(state.params))]


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("opt", ["default", "fused"])
def test_world_one_moe_is_the_unsharded_step_bit_for_bit(world_one, opt,
                                                         remat):
    cfg = dataclasses.replace(ModelConfig.tiny_moe(), remat=remat)
    make = functools.partial({"default": default_optimizer,
                              "fused": fused_adamw_optimizer}[opt], 1e-3,
                             warmup_steps=1)
    want, want_params = _run(cfg, make(), None)
    got, got_params = _run(cfg, make(), world_one)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_params, want_params,
                                                 strict=True))


def test_expert_leaves_are_never_gathered(world_one, monkeypatch):
    """The FSDP of a MoE state marks w_gate, w_up and w_down (by their
    "expert" axis) and gathers only the others: per layer wq, wk, wv, wo
    and the router, forward and again in the backward."""
    cfg = ModelConfig.tiny_moe()
    calls = []
    real = fsdp_mod._gather

    def counting(shard, dim, group, n):
        calls.append(tuple(shard.shape))
        return real(shard, dim, group, n)

    monkeypatch.setattr(fsdp_mod, "_gather", counting)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(), "cpu",
                                       mesh=world_one)
    step_fn(init_fn(0), make_batch(cfg, 2, SEQ, 1, "cpu"))
    gathers = 2 + 5 * cfg.n_layers  # + embed, lm_head
    assert len(calls) == gathers + gathers - 1
    expert = (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert expert not in calls and expert[::-1] not in calls
    fsdp = fsdp_mod.FSDP(world_one, logical_sharding(
        world_one, param_logical_axes(cfg)), param_logical_axes(cfg))
    assert fsdp.experts == set(EXPERT_LEAVES)


# ---------------------------------------------------------------- units

UNIT_B, UNIT_S, UNIT_E, UNIT_CAPACITY = 4, 16, 4, 12


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """Both unit tests' ranks, run once: 2 gloo processes."""
    path = tmp_path_factory.mktemp("moe_units")
    rng = np.random.default_rng(7)
    cfg = ModelConfig.tiny_moe()
    params = init_params(cfg, seed=3, device="cpu")
    layer = {f"p/{k}": v[0].numpy() for k, v in params["layers"].items()}
    np.savez(path / "in.npz",
             logits=rng.standard_normal((UNIT_B, UNIT_S, UNIT_E)).astype(
                 np.float32),
             capacity=np.array(UNIT_CAPACITY),
             x=rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32),
             dy=rng.standard_normal((2, SEQ, cfg.d_model)).astype(
                 np.float32), **layer)
    torch_ranks.run_ranks("moe_units", 2, path)
    return path


@pytest.mark.parametrize("mesh", ["sp2", "fsdp2"])
def test_global_token_order_gives_the_unsharded_gating_rows(units, mesh):
    """Each rank's dispatch and combine rows are the unsharded gating's at
    its tokens' places in the global batch (b·S + s), bit for bit; under
    sp 2 a rank's tokens are not a contiguous run of that order, and the
    queue positions (a running count over it) would differ if the gather
    concatenated the ranks' blocks."""
    data = dict(np.load(units / "in.npz"))
    logits = torch.from_numpy(data["logits"])
    dispatch, combine, aux = top2_gating(logits.reshape(-1, UNIT_E),
                                         UNIT_CAPACITY)
    shape = (UNIT_B, UNIT_S, UNIT_E, UNIT_CAPACITY)
    dispatch, combine = dispatch.reshape(shape), combine.reshape(shape)
    seen = 0
    for rank in range(2):
        got = dict(np.load(units / f"{mesh}_{rank}.npz"))
        b0, b, s0, s = got["block"]
        for name, want in (("dispatch", dispatch), ("combine", combine)):
            np.testing.assert_array_equal(
                got[name], want[b0:b0 + b, s0:s0 + s].reshape(
                    b * s, UNIT_E, UNIT_CAPACITY).numpy(), err_msg=name)
        assert got["aux"] == aux.numpy()
        seen += int(got["dispatch"].sum())
    assert seen == int(dispatch.sum()) > 0


def test_router_gradient_under_tp2_equals_tp1(units):
    """One MoE layer (`_layer`, tiny_moe) at tp 2 against the same layer
    unsplit: output and aux within 1e-5, every gradient within 1e-5 (the
    router's and the input's included)."""
    data = dict(np.load(units / "in.npz"))
    cfg = ModelConfig.tiny_moe()
    leaves = {k[2:]: torch.from_numpy(v).requires_grad_(True)
              for k, v in data.items() if k.startswith("p/")}
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    cos, sin = rotary_embedding(torch.arange(x.shape[1]), cfg.head_dim,
                                cfg.rope_theta)
    out, aux = _layer(cfg, SINGLE, x, leaves, cos[None], sin[None])
    loss = (out * torch.from_numpy(data["dy"])).sum() + aux
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [x] + [leaves[n] for n in names])
    got = dict(np.load(units / "out.npz"))
    tol = dict(rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got["out"], out.detach().numpy(), **tol)
    np.testing.assert_allclose(got["aux"], aux.detach().numpy(), **tol)
    for name, g in zip(["x"] + names, grads):
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(got["d/" + name] / scale,
                                   g.numpy() / scale, err_msg=name, **tol)


def test_routes_record_and_force_the_routing():
    """multichip's routing witness (`_Routes`, `_route_diff`): it records
    the gating's two experts and kept bits of each token; forcing that
    record onto other logits gives the recorded dispatch (the queue
    depends only on the choices); the diff counts the tokens whose choices
    differ; and the gating is restored on exit."""
    from ray_tpu_torch.multichip import _route_diff, _Routes
    from ray_tpu_torch.ops import moe

    rng = np.random.default_rng(0)
    real = moe._route, moe._choose
    logits, other = (torch.from_numpy(rng.standard_normal((32, 4)).astype(
        np.float32)) for _ in range(2))
    want = top2_gating(logits, 10)
    runs = {}
    for name, lg, forced in (("own", logits, None), ("other", other, None),
                             ("forced", other, "own")):
        with _Routes(1, forced=runs[forced] if forced else None) as rec:
            rec.step()
            runs[name + "_out"] = top2_gating(lg, 10)
        runs[name] = rec.steps[0]
    assert (moe._route, moe._choose) == real
    own, top = runs["own"][0], logits.topk(2, dim=-1).indices
    assert torch.equal(own["first"], top[:, 0])
    assert torch.equal(own["second"], top[:, 1])
    assert int(own["kept"].sum()) == int(want[0].sum()) < 64  # some dropped
    assert torch.equal(runs["forced_out"][0], want[0])
    assert _route_diff(runs["own"], runs["forced"]) == [[0, 0, 0]]
    flips = int((other.argmax(-1) != logits.argmax(-1)).sum())
    diff = _route_diff(runs["own"], runs["other"])
    assert diff[0][0] == flips > 0 and diff[0][2] > 0
