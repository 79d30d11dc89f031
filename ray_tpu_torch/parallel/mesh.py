"""Device meshes and logical-axis shardings (twin of
ray_tpu/parallel/mesh.py), on `torch.distributed`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the process group, one rank a card (or a CPU process under gloo), with the
reference's axes in the reference's order:

    dp    — data parallel, outermost (across hosts)
    pp    — pipeline stages
    fsdp  — sharded data parallel (ZeRO-3)
    tp    — tensor parallel
    sp    — sequence parallel

Parameters carry *logical* axis names (`param_logical_axes`) which
`AxisRules` maps to mesh axes, as in the reference. `AxisRules.spec`
returns the reference's PartitionSpec (here a tuple subclass of the same
entries); `AxisRules.placements` turns it into DTensor placements, one a
mesh dim: a tensor dim split over several mesh axes gets `Shard(d)` on
each, and DTensor splits it in mesh-dim order, dp before fsdp, which is
the order JAX splits `("dp", "fsdp")` in (dp-major). A `NamedSharding`
pairs a mesh with a spec: it cuts a full tensor to this rank's block
(`local`) and wraps a block as a DTensor (`from_local`), the form in which
a sharded state is stored and checkpointed.

No mesh axis may split a dim it does not divide: the collectives move
equal blocks. Each axis's process group (`mesh.get_group("tp")`, "sp",
...) and this rank's place on it (`mesh.get_local_rank("tp")`) are the
DeviceMesh's own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.ops.kernels._util import require_cuda


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallelism axis. -1 on `dp` means 'fill'.

    `pp` (pipeline parallel) is manual-mode in the reference: the sharded
    train step runs replicated over it, and `parallel/pipeline.py` splits
    the layer stack over it.
    """

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.pp * self.fsdp * self.tp * self.sp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by pp*fsdp*tp*sp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.pp}x{self.fsdp}x{self.tp}x{self.sp} "
                f"!= {n_devices} devices")
        return MeshConfig(dp=dp, fsdp=self.fsdp, tp=self.tp, sp=self.sp,
                          pp=self.pp)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.tp, self.sp)


# pp sits between dp and fsdp: stage boundaries cross lower-bandwidth links
# than tp/sp, which stay innermost (neighbouring ranks).
AXIS_NAMES = ("dp", "pp", "fsdp", "tp", "sp")


def _world_ranks() -> list:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call ray_tpu_torch.parallel.initialize_group "
            "before building a mesh")
    return list(range(dist.get_world_size()))


def _device_mesh(device_type: str, ranks: Sequence[int], shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=AXIS_NAMES)


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None, *,
              device="cuda"):
    """A DeviceMesh with (dp, pp, fsdp, tp, sp) axes over `ranks` (the
    process group's ranks by default), one rank a card on "cuda" or a gloo
    process on "cpu". Every rank of the group must call it (each axis's
    sub-groups are created collectively).

    Axis order puts the innermost (fastest-varying) axes, tp and sp, on
    neighbouring ranks and dp outermost, as the reference does."""
    dev = require_cuda(device)
    ranks = list(ranks if ranks is not None else _world_ranks())
    cfg = config.resolve(len(ranks))
    return _device_mesh(dev.type, ranks, cfg.shape)


def make_hybrid_mesh(config: MeshConfig, *, dcn_dp: int = 1,
                     ranks: Optional[Sequence[int]] = None, device="cuda"):
    """Multi-host mesh: `dcn_dp` data-parallel replicas across hosts,
    `config` parallelism within each host.

    Ranks are numbered host by host (torchrun's order), so the plain
    reshape — the reference's own fallback where devices carry no slice
    topology — puts only the outermost dp axis across hosts: tp, sp and
    fsdp collectives stay on a host's NVLink."""
    dev = require_cuda(device)
    ranks = list(ranks if ranks is not None else _world_ranks())
    if dcn_dp <= 1:
        return make_mesh(config, ranks, device=dev)
    if len(ranks) % dcn_dp != 0:
        raise ValueError(f"{len(ranks)} devices not divisible by dcn_dp={dcn_dp}")
    per_slice = config.resolve(len(ranks) // dcn_dp)
    return _device_mesh(dev.type, ranks,
                        (dcn_dp * per_slice.dp,) + per_slice.shape[1:])


def make_virtual_mesh(n_devices: int, config: Optional[MeshConfig] = None):
    """A mesh of CPU ranks for tests: the first `n_devices` ranks of the
    current gloo process group."""
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world < n_devices:
        raise RuntimeError(
            f"need {n_devices} ranks, have {world}; launch {n_devices} CPU "
            f"processes (e.g. torchrun --nproc-per-node {n_devices}), each "
            f"calling ray_tpu_torch.parallel.initialize_group(rank, "
            f"{n_devices}, device='cpu')")
    cfg = (config or MeshConfig()).resolve(n_devices)
    return make_mesh(cfg, range(n_devices), device="cpu")


# --------------------------------------------------------------------------
# Partition specs and their DTensor placements


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec's form: one entry a tensor dim, each None
    (replicated), a mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_placements(mesh, spec: Sequence[Any]) -> tuple:
    """DTensor placements, one a mesh dim, of a PartitionSpec: `Shard(d)`
    on every mesh axis that splits tensor dim d, `Replicate()` elsewhere.
    DTensor splits a dim over several mesh dims in mesh-dim order, so a
    spec entry must name its axes in that order (("dp", "fsdp"), not
    ("fsdp", "dp"))."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = tuple(part) if isinstance(part, (tuple, list)) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"{spec}: tensor dim {dim} splits over {axes} minor axis "
                f"first; DTensor splits a dim over mesh dims in mesh order "
                f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec (jax.sharding.NamedSharding's pair)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)

    def block(self, shape: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        """(start, length) along each dim of this rank's block of a tensor
        of `shape`: each sharding mesh dim, in mesh order, cuts the block so
        far into equal pieces and keeps the rank's coordinate's."""
        from torch.distributed.tensor import Shard

        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        block = [[0, n] for n in shape]
        for i, pl in enumerate(self.placements):
            if not isinstance(pl, Shard):
                continue
            n = self.mesh.size(i)
            start, length = block[pl.dim]
            if length % n:
                raise ValueError(
                    f"mesh axis {self.mesh.mesh_dim_names[i]} of size {n} "
                    f"does not divide dim {pl.dim} ({length}) of a tensor "
                    f"of shape {tuple(shape)}")
            length //= n
            block[pl.dim] = [start + coord[i] * length, length]
        return tuple((s, n) for s, n in block)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor, in its own contiguous
        memory (the full tensor can be freed)."""
        out = full
        for dim, (start, length) in enumerate(self.block(full.shape)):
            out = out.narrow(dim, start, length)
        return out.clone(memory_format=torch.contiguous_format)

    def from_local(self, local: torch.Tensor):
        """A DTensor whose block on this rank is `local` (no copy, no
        communication); its global shape is the block's times the mesh
        axes that split it (the blocks are equal)."""
        from torch.distributed.tensor import DTensor, Shard

        shape = list(local.shape)
        for i, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                shape[pl.dim] *= self.mesh.size(i)
        shape = torch.Size(shape)
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    def distribute(self, full: torch.Tensor):
        """The full tensor (held whole by every rank) as a DTensor of this
        sharding: its block copied out, no communication."""
        return self.from_local(self.local(full))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# --------------------------------------------------------------------------
# Logical axis rules


class AxisRules:
    """Maps logical axis names -> mesh axis (or None = replicated)."""

    def __init__(self, rules: Dict[str, Any]):
        self.rules = dict(rules)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        parts = []
        used = set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            if m is None:
                parts.append(None)
            else:
                # a logical axis may map to a tuple of mesh axes
                key = tuple(m) if isinstance(m, (tuple, list)) else (m,)
                free = tuple(a for a in key if a not in used)
                used.update(free)
                parts.append(free if len(free) != 1 else free[0])
                if not free:
                    parts[-1] = None
        return P(*parts)

    def sharding(self, mesh, logical_axes: Sequence[Optional[str]]
                 ) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes))

    def placements(self, mesh, logical_axes: Sequence[Optional[str]]
                   ) -> tuple:
        """The DTensor placements of `spec(logical_axes)` on `mesh`."""
        return spec_placements(mesh, self.spec(logical_axes))


# Default rules for transformer LMs: FSDP shards the embed dim of weights,
# TP shards heads/mlp, batch shards over (dp, fsdp) [fsdp acts as extra DP
# for activations, ZeRO-style], sequence shards over sp.
DEFAULT_RULES = AxisRules({
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "expert": "fsdp",
})


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def logical_sharding(mesh, axes_tree: Any, rules: AxisRules = DEFAULT_RULES):
    """Map a tree (nested dicts) of logical-axis tuples to the same tree of
    NamedShardings."""
    if _is_axes(axes_tree):
        return rules.sharding(mesh, axes_tree)
    return {k: logical_sharding(mesh, v, rules) for k, v in axes_tree.items()}


def shard_pytree(tree: Any, shardings: Any):
    """A tree (nested dicts) of full tensors, held whole by every rank, as
    the same tree of DTensors with the given shardings: each rank keeps its
    own block (the counterpart of the reference's host -> sharded
    `device_put`); values that are not tensors pass through."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return shardings.distribute(tree)
    return tree
