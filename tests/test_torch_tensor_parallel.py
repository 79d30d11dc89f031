"""Tensor parallelism (parallel/tensor.py, tp in the fused blocks, the model
and the sharded step) on the CPU under gloo, in float32, against the JAX
package on `make_virtual_mesh`.

- The step at tp 2 on 2 ranks (each its own process, tests/torch_ranks.py),
  plain and through the fused blocks, against `make_train_step` at the
  same mesh, 3 steps with a loss mask that keeps a different count on each
  rank: losses and grad norms within 1e-5 relative, params within
  1e-4 + 1e-4·|p|. fsdp 2 x tp 2 on 4 ranks, and a checkpoint saved at
  fsdp 4, restored onto fsdp 2 x tp 2 and back, are slow.
- The fused blocks at tp 2 against the JAX fused blocks jitted on the same
  mesh, their weights split by the rules: outputs within 1e-5, gradients
  within 1e-4 (tests/test_torch_fused_blocks.py's bounds).
- `vocab_embed` and `vocab_nll` (dense, and chunked) at tp 2 with a loss
  mask against `_embed_lookup`, `token_nll` and `chunked_token_nll`: the
  rows exactly, losses and gradients within 1e-5.
- Each leaf's local block on each rank, for dp x fsdp x tp x sp meshes of
  up to 8 ranks (one process, `fake_pg`), against JAX's `shard_shape` and
  the values JAX puts on that device; and the 8B plan's fsdp 16 x tp 4
  layout on 64 fake ranks with meta tensors: every leaf's local shape,
  more than 8.0e9 parameters, `_budget`'s `local_bytes` (the counterpart
  of test_eightb_sharding_lowers_on_virtual_v5e64).
- A one-rank tp group through the fused blocks is bit-identical to none.
- Fewer KV heads than tp ranks (ROADMAP A.7.5: wk/wv split over tp on
  their columns, gathered at use, each rank projecting with the one KV
  head its query heads read): `tiny` with 1 KV head at tp 2, plain and
  fused, against `make_train_step` on a 2-device mesh in the bounds
  above; `tiny` (2 KV heads) at tp 4 on four ranks is slow.
- The raises that stay: tp not dividing the query heads, and KV heads
  that tp neither divides nor gathers (3 KV heads at tp 4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu.models import transformer as jtf
from ray_tpu.ops.layers import rotary_embedding
from ray_tpu.ops.pallas import fused_attn as jattn
from ray_tpu.ops.pallas import fused_ffn as jffn
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_virtual_mesh as jmake_virtual_mesh
from ray_tpu_torch.models import ModelConfig, planning
from ray_tpu_torch.models.transformer import init_params, param_logical_axes
from ray_tpu_torch.ops.kernels.fused_attn import attn_block
from ray_tpu_torch.ops.kernels.fused_ffn import ffn_block
from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshConfig,
                                    initialize_group, logical_sharding,
                                    make_mesh, shutdown_group)
from ray_tpu_torch.parallel.fsdp import tree_paths
from ray_tpu_torch.train import default_optimizer
from ray_tpu_torch.train.step import _check_mesh
from test_torch_sharded_step import _check_against_jax

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["plain",
                                                       "fused_blocks"])
def test_tp2_step_on_two_ranks_matches_jax(tmp_path, fused):
    _check_against_jax(tmp_path, 2, 1, 1, True, tp=2, fused=fused)


@pytest.mark.parametrize("fused", [False, True], ids=["plain",
                                                       "fused_blocks"])
def test_tp2_with_one_kv_head_on_two_ranks_matches_jax(tmp_path, fused):
    _check_against_jax(tmp_path, 2, 1, 1, True, tp=2, fused=fused, kv=1)


@pytest.mark.slow
def test_tp4_with_two_kv_heads_on_four_ranks_matches_jax(tmp_path):
    _check_against_jax(tmp_path, 4, 1, 1, True, tp=4)


@pytest.mark.slow
def test_fsdp2_tp2_step_on_four_ranks_matches_jax(tmp_path):
    _check_against_jax(tmp_path, 4, 1, 2, True, tp=2)


@pytest.mark.slow
def test_checkpoint_reshards_between_fsdp4_and_fsdp2_tp2(tmp_path):
    """Saved at fsdp 4 and restored onto fsdp 2 x tp 2, then saved there
    and restored onto fsdp 4: every leaf bit for bit on the target mesh,
    and the next step's loss the same on each (DCP reshards; no code of
    its own)."""
    got = torch_ranks.run_ranks("reshard_tp", 4, tmp_path)
    for way in ("fsdp4->fsdp2xtp2", "fsdp2xtp2->fsdp4"):
        assert got[way]["equal"] == got[way]["leaves"] == 36, way
        assert got[way]["on_target_mesh"], way
    losses = got["next_loss"]
    for name in ("fsdp2xtp2", "back"):
        assert abs(losses[name] - losses["fsdp4"]) <= 1e-6 * losses["fsdp4"]


# ---------------------------------------------------------------- blocks

B, S, D, H, KV, DFF = 2, 32, 128, 4, 2, 256   # tiny's widths


def _block_inputs():
    rng = np.random.default_rng(0)
    hd = D // H

    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(
            np.float32)

    cos, sin = rotary_embedding(jnp.arange(S), hd)
    attn = {"x": rng.standard_normal((B, S, D)).astype(np.float32),
            "nw": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            "wq": w(D, H * hd), "wk": w(D, KV * hd), "wv": w(D, KV * hd),
            "wo": w(H * hd, D), "cos": np.array(cos)[None],
            "sin": np.array(sin)[None],
            "dy": rng.standard_normal((B, S, D)).astype(np.float32)}
    ffn = {"x": rng.standard_normal((B, S, D)).astype(np.float32),
           "nw": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
           "wg": w(D, DFF), "wu": w(D, DFF), "wd": w(DFF, D),
           "dy": rng.standard_normal((B, S, D)).astype(np.float32)}
    return {"attn": attn, "ffn": ffn}


NAMES = {"attn": ("x", "nw", "wq", "wk", "wv", "wo", "cos", "sin"),
         "ffn": ("x", "nw", "wg", "wu", "wd")}
# the tp spec of each input: columns of the projections, rows of wo/w_down
SPECS = {"attn": (None, None, (None, "tp"), (None, "tp"), (None, "tp"),
                  ("tp", None), None, None),
         "ffn": (None, None, (None, "tp"), (None, "tp"), ("tp", None))}


@functools.lru_cache(maxsize=None)
def _jax_block(block):
    """(output, grads) of the JAX fused block jitted on a tp 2 mesh, its
    inputs placed by the rules."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmake_virtual_mesh(2, JMeshConfig(dp=1, fsdp=1, tp=2, sp=1))
    data = _block_inputs()[block]
    args = [jax.device_put(jnp.asarray(data[n]), NamedSharding(
        mesh, P(*spec) if spec else P())) for n, spec in zip(NAMES[block],
                                                             SPECS[block])]
    fn = (functools.partial(jattn.attn_block, n_heads=H, n_kv_heads=KV)
          if block == "attn" else jffn.ffn_block)

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(data["dy"]))

    y, grads = run(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def port_blocks(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_blocks")
    arrays = {f"{b}/{k}": v for b, d in _block_inputs().items()
              for k, v in d.items()}
    arrays["attn/heads"] = np.array([H, KV])
    np.savez(path / "in.npz", **arrays)
    torch_ranks.run_ranks("tp_blocks", 2, path)
    return dict(np.load(path / "out.npz"))


@pytest.mark.parametrize("block", ["attn", "ffn"])
def test_fused_blocks_at_tp2_match_jax(port_blocks, block):
    y, grads = _jax_block(block)
    np.testing.assert_allclose(port_blocks[f"{block}/y"], y, **OUT_TOL)
    for name, g in zip(NAMES[block], grads):
        np.testing.assert_allclose(port_blocks[f"{block}/d{name}"], g,
                                   err_msg=f"{block} d{name}", **GRAD_TOL)


def test_one_rank_tp_group_is_the_unsplit_block_bit_for_bit():
    import torch.distributed as dist

    data = _block_inputs()
    initialize_group(0, 1, device="cpu")
    try:
        for block, fn, kw in (("attn", attn_block, dict(n_heads=H,
                                                        n_kv_heads=KV)),
                              ("ffn", ffn_block, {})):
            runs = []
            for group in (None, dist.group.WORLD):
                leaves = [torch.from_numpy(data[block][n]).requires_grad_(
                    True) for n in NAMES[block]]
                y = fn(*leaves, **kw, tp_group=group)
                runs.append((y, torch.autograd.grad(
                    y, leaves, torch.from_numpy(data[block]["dy"]))))
            (y0, g0), (y1, g1) = runs
            assert torch.equal(y0, y1), block
            assert all(torch.equal(a, b) for a, b in zip(g0, g1)), block
    finally:
        shutdown_group()


# ---------------------------------------------------------------- vocab

V, CHUNK = 512, 8


def _vocab_inputs():
    rng = np.random.default_rng(3)
    mask = np.ones((B, S), np.float32)
    mask[0, 20:] = mask[1, :7] = 0.0
    return {"emb": rng.standard_normal((V, D)).astype(np.float32),
            "tokens": rng.integers(0, V, (B, S)),
            "rows_dy": rng.standard_normal((B, S, D)).astype(np.float32),
            "x": rng.standard_normal((B, S, D)).astype(np.float32),
            "head": (rng.standard_normal((D, V)) * 0.1).astype(np.float32),
            "targets": rng.integers(0, V, (B, S)), "mask": mask}


@functools.lru_cache(maxsize=None)
def _jax_vocab():
    d = {k: jnp.asarray(v) for k, v in _vocab_inputs().items()}
    rows, vjp = jax.vjp(lambda e: jtf._embed_lookup(e, d["tokens"],
                                                    jnp.float32), d["emb"])
    out = {"rows": rows, "d_emb": vjp(d["rows_dy"])[0]}
    losses = {
        "dense": lambda x, h: jtf.token_nll(
            (x @ h).astype(jnp.float32), d["targets"], d["mask"]),
        "chunked": lambda x, h: jtf.chunked_token_nll(
            x, h, d["targets"], d["mask"], CHUNK)}
    for name, fn in losses.items():
        loss, (dx, dh) = jax.value_and_grad(fn, argnums=(0, 1))(d["x"],
                                                                d["head"])
        out.update({f"{name}/loss": loss, f"{name}/dx": dx,
                    f"{name}/dhead": dh})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab")
    np.savez(path / "in.npz", **_vocab_inputs())
    torch_ranks.run_ranks("vocab", 2, path, CHUNK)
    return dict(np.load(path / "out.npz"))


@pytest.mark.parametrize("part", ["embed", "dense", "chunked"])
def test_vocab_split_matches_jax(port_vocab, part):
    want = _jax_vocab()
    if part == "embed":
        np.testing.assert_array_equal(port_vocab["rows"], want["rows"])
        np.testing.assert_allclose(port_vocab["d_emb"], want["d_emb"],
                                   **OUT_TOL)
        return
    for name in ("loss", "dx", "dhead"):
        np.testing.assert_allclose(port_vocab[f"{part}/{name}"],
                                   want[f"{part}/{name}"],
                                   err_msg=f"{part} {name}", **OUT_TOL)


# ---------------------------------------------------------------- blocks


@pytest.fixture
def fake_world():
    """init(rank, world): this process as one rank of a fake process group
    (no peers, no communication), torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_kw", [
    dict(fsdp=2, tp=2), dict(dp=2, tp=2, sp=2), dict(fsdp=2, tp=2, sp=2),
    dict(tp=4, sp=2), dict(dp=2, fsdp=2, tp=2)],
    ids=lambda kw: "x".join(f"{k}{v}" for k, v in kw.items()))
def test_leaf_blocks_match_jax_shards(fake_world, mesh_kw):
    """Each rank's block of every `tiny` leaf: JAX's `shard_shape`, and
    the values JAX puts on the device at the rank's coordinate."""
    from jax.sharding import NamedSharding as JNamedSharding

    n = int(np.prod(list(mesh_kw.values())))
    cfg = ModelConfig.tiny()
    rng = np.random.default_rng(1)
    full = {p: rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for p, t in tree_paths(init_params(cfg, device="meta"))}
    axes = dict(tree_paths(param_logical_axes(cfg)))
    jmesh = jmake_virtual_mesh(n, JMeshConfig(**mesh_kw))
    want = {}  # (path, rank) -> JAX's shard on that device
    for path, arr in full.items():
        spec = DEFAULT_RULES.spec(axes[path])
        sh = JNamedSharding(jmesh, jax.sharding.PartitionSpec(*spec))
        placed = jax.device_put(arr, sh)
        for shard in placed.addressable_shards:
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


def test_eightb_plan_layout_on_64_fake_ranks(fake_world):
    """fsdp 16 x tp 4, llama3_8b: every rank's local leaf shapes (fsdp
    splits embed, tp heads/mlp/vocab), > 8.0e9 parameters, and the plan's
    `local_bytes` equal to a rank's blocks of params and moments."""
    from ray_tpu_torch.models.planning import _tree_bytes

    cfg = dataclasses.replace(ModelConfig.llama3_8b(), max_seq_len=4096,
                              remat="dots")
    optimizer = default_optimizer()
    meta = init_params(cfg, device="meta")
    n_params = sum(t.numel() for _, t in tree_paths(meta))
    assert n_params > 8.0e9
    budget = planning._budget(cfg, optimizer, 64, 16, 4, 4096, 4096)
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    want = {"embed": (V // 4, d // 16), "lm_head": (d // 16, V // 4),
            "final_norm": (d,), "layers/attn_norm": (L, d),
            "layers/mlp_norm": (L, d),
            "layers/wq": (L, d // 16, qd // 4),
            "layers/wk": (L, d // 16, kvd // 4),
            "layers/wv": (L, d // 16, kvd // 4),
            "layers/wo": (L, qd // 4, d // 16),
            "layers/w_gate": (L, d // 16, dff // 4),
            "layers/w_up": (L, d // 16, dff // 4),
            "layers/w_down": (L, dff // 4, d // 16)}
    for rank in range(64):
        fake_world(rank, 64)
        mesh = make_mesh(MeshConfig(fsdp=16, tp=4), device="cpu")
        shardings = logical_sharding(mesh, param_logical_axes(cfg))
        local = {}
        for path, t in tree_paths(meta):
            node = shardings
            for key in path.split("/"):
                node = node[key]
            local_t = node.local(t)
            assert tuple(local_t.shape) == want[path], (path, rank)
            node_tree = local
            *parents, leaf = path.split("/")
            for key in parents:
                node_tree = node_tree.setdefault(key, {})
            node_tree[leaf] = local_t
        opt = optimizer.init(local)
        assert {"params": _tree_bytes(local),
                "optimizer": _tree_bytes(opt.mu) + _tree_bytes(opt.nu),
                "grads": _tree_bytes(local)} == budget["local_bytes"]


# ---------------------------------------------------------------- raises


class _Mesh:
    mesh_dim_names = ("dp", "pp", "fsdp", "tp", "sp")
    device_type = "cpu"

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("tp,dim,kv", [(3, "n_heads", 2),
                                       (4, "n_kv_heads", 3)])
def test_tp_that_does_not_split_the_heads_raises(tp, dim, kv):
    """Query heads tp does not divide, and KV heads tp neither divides nor
    gathers (3 at tp 4: 3 does not divide 4); `tiny`'s 2 KV heads at tp 4
    run (test_tp4_with_two_kv_heads_on_four_ranks_matches_jax)."""
    cfg = dataclasses.replace(ModelConfig.tiny(), n_kv_heads=kv)
    with pytest.raises(ValueError, match=f"tp={tp} does not divide {dim}="):
        _check_mesh(cfg, _Mesh((1, 1, 1, tp, 1)), torch.device("cpu"))
    _check_mesh(ModelConfig.tiny(), _Mesh((1, 1, 1, 4, 1)),
                torch.device("cpu"))
