"""parallel/mesh: the port's MeshConfig and AxisRules against the JAX
package's, on the CPU. `resolve` gives the same meshes and the same errors;
`AxisRules.spec` gives JAX's PartitionSpec for every leaf of
`param_logical_axes` (tiny, tiny_moe, llama3_8b); and on each mesh
(dp 2 x fsdp 2, fsdp 4, dp 8) the block every device holds under the port's
placements is the block JAX gives that device, rows over ("dp", "fsdp")
dp-major included."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models.transformer import param_logical_axes as jaxes
from ray_tpu.parallel import DEFAULT_RULES as JRULES
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_virtual_mesh as jmake_virtual_mesh
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import init_params, param_logical_axes
from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshConfig,
                                    initialize_group, make_mesh,
                                    make_virtual_mesh, shutdown_group)
from ray_tpu_torch.parallel.fsdp import tree_paths
from ray_tpu_torch.parallel.mesh import (AXIS_NAMES, NamedSharding, P,
                                         spec_placements)

MESHES = [dict(dp=2, fsdp=2), dict(fsdp=4), dict(dp=8)]


def _devices(mesh_kw):
    return 8 if mesh_kw.get("dp") == 8 else 4


@pytest.mark.parametrize("kw,n", [
    ({}, 8), (dict(fsdp=2), 8), (dict(dp=2, fsdp=2), 4), (dict(fsdp=4), 4),
    (dict(dp=8), 8), (dict(fsdp=3), 8), (dict(dp=2, fsdp=2), 8),
    (dict(tp=2, sp=2, pp=2), 8), (dict(dp=3, fsdp=2), 4)])
def test_resolve_matches_jax(kw, n):
    def run(cls):
        try:
            return cls(**kw).resolve(n).shape
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(MeshConfig) == run(JMeshConfig)


class _Mesh:
    """The mesh attributes a NamedSharding reads, at one coordinate."""
    mesh_dim_names = AXIS_NAMES

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return list(self.coord)


def _blocks_match(jmesh, spec, shape):
    """For every device of the JAX mesh, the port's block under `spec` is
    the slice JAX gives that device."""
    want = jax.sharding.NamedSharding(jmesh, spec).devices_indices_map(shape)
    for dev, index in want.items():
        coord = tuple(int(c) for c in np.argwhere(jmesh.devices == dev)[0])
        got = NamedSharding(_Mesh(jmesh.devices.shape, coord),
                            P(*spec)).block(shape)
        for (start, length), sl, n in zip(got, index, shape):
            assert (start, start + length) == (sl.start or 0,
                                               n if sl.stop is None
                                               else sl.stop), (dev, spec)


@pytest.mark.parametrize("mesh_kw", MESHES)
@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "llama3_8b"])
def test_param_specs_and_blocks_match_jax(preset, mesh_kw):
    cfg, jcfg = getattr(ModelConfig, preset)(), getattr(JConfig, preset)()
    jmesh = jmake_virtual_mesh(_devices(mesh_kw), JMeshConfig(**mesh_kw))
    shapes = dict(tree_paths(init_params(cfg, device="meta")))
    ours, theirs = dict(tree_paths(param_logical_axes(cfg))), dict(
        tree_paths(jaxes(jcfg)))
    assert ours == theirs
    mesh = _Mesh(jmesh.devices.shape, (0,) * 5)
    for path, axes in ours.items():
        spec = DEFAULT_RULES.spec(axes)
        assert tuple(spec) == tuple(JRULES.spec(axes)), path
        # placements: Shard(d) on each mesh axis the spec names for dim d
        placements = spec_placements(mesh, spec)
        for i, name in enumerate(AXIS_NAMES):
            dims = [d for d, part in enumerate(spec)
                    if name in (part if isinstance(part, tuple) else (part,))]
            assert getattr(placements[i], "dim", None) == (
                dims[0] if dims else None), (path, name)
        _blocks_match(jmesh, JRULES.spec(axes), tuple(shapes[path].shape))


@pytest.mark.parametrize("mesh_kw", MESHES)
def test_batch_rows_split_dp_major_as_jax(mesh_kw):
    jmesh = jmake_virtual_mesh(_devices(mesh_kw), JMeshConfig(**mesh_kw))
    spec = JRULES.spec(("batch", "seq"))
    assert tuple(spec) == tuple(DEFAULT_RULES.spec(("batch", "seq"))) == (
        ("dp", "fsdp"), "sp")
    _blocks_match(jmesh, spec, (16, 64))


def test_spec_must_name_a_dims_axes_in_mesh_order():
    mesh = _Mesh((2, 1, 2, 1, 1), (0,) * 5)
    with pytest.raises(ValueError, match="minor axis first"):
        spec_placements(mesh, P(("fsdp", "dp")))
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, P("fsdp")).block((3,))


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_group"):
        make_mesh(MeshConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="launch 4 CPU processes"):
        make_virtual_mesh(4, MeshConfig(fsdp=4))


def test_world_one_mesh_over_gloo():
    initialize_group(0, 1, device="cpu")
    try:
        initialize_group(0, 1, device="cpu")  # idempotent for one group
        with pytest.raises(RuntimeError, match="already in"):
            initialize_group(0, 1, device="cpu", group_name="other")
        mesh = make_virtual_mesh(1, MeshConfig(fsdp=1))
        assert mesh.mesh_dim_names == AXIS_NAMES
        assert tuple(mesh.shape) == (1, 1, 1, 1, 1)
        s = NamedSharding(mesh, DEFAULT_RULES.spec(("embed", "vocab")))
        full = torch.arange(12.0).reshape(3, 4)
        dt = s.distribute(full)
        assert dt.shape == full.shape and torch.equal(dt.full_tensor(), full)
    finally:
        shutdown_group()
