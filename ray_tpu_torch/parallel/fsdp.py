"""The collectives of the sharded training step, written out: what XLA
emits for the reference's dp x fsdp x tp x sp step from its sharding
annotations (ray_tpu/train/step.py:1-10). tp's own collectives sit inside
the blocks (`parallel/tensor.py`); this module holds those around them.

The state is stored as DTensors (the rules' placements, so a checkpoint
can reshard), and the step computes on their local blocks:

- **fsdp (ZeRO-3).** Each leaf sharded over fsdp is gathered whole just
  before it is used, one layer at a time (`FSDP.gather`, an autograd
  Function: `all_gather_into_tensor` over the fsdp group forward, a
  summing `reduce_scatter_tensor` of its gradient backward), along the
  leaf's fsdp dim only (found from its spec): a leaf also split over tp
  keeps its tp block, so every kernel runs unchanged on this rank's
  per-layer weights (whole, or its tp block) and its own rows.
  A leaf split along a dim other than its first (`wo`, `w_down` per layer,
  `embed`) is gathered into `[fsdp, ...]` and moved into place, and its
  gradient moved back before the reduce-scatter, so the layout a
  checkpoint and the bridge see stays the reference's.
- **Re-gather in the backward.** The fused blocks save their weights for
  the backward; saved whole, the forward would hold every layer's gathered
  weights (16 GB at 8B). Under `FSDP.saved_tensor_hooks` a saved gathered
  weight (or a view of one) is packed as its shard and gathered again when
  the backward unpacks it: the plan's "all-gather params forward and
  backward" (models/planning.py). Inside a checkpointed region (remat
  modes, the chunked loss) torch's own hooks take over, and the region
  keeps what it keeps.
- **Expert leaves.** A leaf split over fsdp along its "expert" dim (the
  MoE `w_gate`, `w_up` and `w_down`, found from their logical axes) is
  never gathered: each fsdp rank runs its own experts on every token's
  slots (`parallel/expert.py` moves the tokens to them), so `gather`
  returns the shard as it is and the backward hooks have nothing to
  re-gather. Its gradient is this rank's experts' whole gradient over the
  fsdp group's tokens already (the dispatch's reduce-scatter summed them),
  so `reduce_grads` does not sum it over fsdp; it is summed over sp and
  dp like every gradient, and `global_norm` sums its squares over fsdp
  like any leaf split there. The router is an ordinary leaf, gathered
  on its embed dim.
- **Replicated leaves** (the norms: "embed_nosplit" is in no rule) are
  used as they are; their gradients are summed over fsdp after the
  backward, not over tp (`copy_to_tp`'s backward already gave every tp
  rank the same whole gradient). **sp, then dp**: every gradient is then
  summed over sp (its ranks saw other positions of the same rows) and
  over dp.
- **pp.** Under the pipeline's rules (`parallel/pipeline.py`: the layer
  stack split over pp, each stage its contiguous layers) a leaf not split
  over pp (`embed`, `lm_head`, `final_norm`) is used by the first or the
  last stage only, so its gradient is also summed over pp; a layer leaf's
  never is. Where no leaf is split over pp (the sharded step on a mesh
  with pp > 1, which runs replicated over pp as the reference's does) no
  collective crosses pp.
- **Global values.** Each rank's loss is scaled by its share of the
  global token count (`data_sum`: over fsdp, sp and dp; tp and pp ranks
  hold the same tokens), so the summed gradients are the gradient of the
  global mean and the summed loss is the global loss; the gradient norm
  sums each leaf's squares over fsdp, then over tp, then (pipelined) over
  pp, a leaf not split over an axis counted once. Every rank gets the
  same loss and norm.

All collectives run on torch's current stream, so they stay ordered with
the kernels (which launch there too); a collective on the card goes
through NCCL or fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch


def _dist():
    import torch.distributed as dist

    return dist


def _fsdp_dim(spec: Sequence[Any]) -> Optional[int]:
    """The tensor dim a PartitionSpec splits over fsdp, or None."""
    for dim, part in enumerate(spec):
        axes = part if isinstance(part, tuple) else (part,)
        if "fsdp" in axes:
            return dim
    return None


def _gather(shard: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The full tensor from the fsdp shards, split along `dim`: gathered
    along dim 0 (the collective's own layout), then, for another dim, the
    `n` blocks moved into place (a copy)."""
    out = torch.empty((n * shard.shape[0], *shard.shape[1:]),
                      dtype=shard.dtype, device=shard.device)
    _dist().all_gather_into_tensor(out, shard.contiguous(), group=group)
    if dim == 0:
        return out
    return out.unflatten(0, (n, shard.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def _reduce_scatter(grad: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    """This rank's block of the sum over fsdp of the full gradient (its
    blocks moved to dim 0 first when split along another dim)."""
    if dim:
        grad = grad.unflatten(dim, (n, grad.shape[dim] // n)).movedim(
            dim, 0).flatten(0, 1)
    grad = grad.contiguous()
    out = torch.empty((grad.shape[0] // n, *grad.shape[1:]),
                      dtype=grad.dtype, device=grad.device)
    _dist().reduce_scatter_tensor(out, grad, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather(shard, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group, ctx.n), None, \
            None, None


@dataclasses.dataclass
class _Regather:
    """A saved gathered weight, packed: its shard and how to rebuild it."""
    source: tuple      # (shard, dim, group, n)
    size: torch.Size
    stride: tuple
    offset: int


def _pack(t: torch.Tensor) -> Any:
    root = t if t._base is None else t._base
    source = getattr(root, "_fsdp_source", None)
    if source is None:
        return t
    return _Regather(source, t.size(), t.stride(), t.storage_offset())


def _unpack(x: Any) -> torch.Tensor:
    if not isinstance(x, _Regather):
        return x
    with torch.no_grad():
        full = _gather(*x.source)
    return full.as_strided(x.size, x.stride, x.offset)


class FSDP:
    """The collectives of one mesh for a parameter tree of `shardings`
    (nested dicts of NamedSharding, `param_logical_axes`' structure), whose
    `logical_axes` (`param_logical_axes` itself) mark the expert leaves:
    those split over fsdp along an "expert" dim, kept local (module
    docstring). Needs no leaf split over dp or sp."""

    def __init__(self, mesh, shardings: Dict[str, Any],
                 logical_axes: Dict[str, Any]):
        self.mesh = mesh
        self.fsdp_group = mesh.get_group("fsdp")
        self.dp_group = mesh.get_group("dp")
        self.n_fsdp = mesh.size(mesh.mesh_dim_names.index("fsdp"))
        self.fsdp_rank = mesh.get_local_rank("fsdp")
        self.tp_group, self.sp_group = mesh.get_group("tp"), \
            mesh.get_group("sp")
        self.n_tp = mesh.size(mesh.mesh_dim_names.index("tp"))
        self.n_sp = mesh.size(mesh.mesh_dim_names.index("sp"))
        self.tp_rank = mesh.get_local_rank("tp")
        self.pp_group = mesh.get_group("pp")
        self.pp_rank = mesh.get_local_rank("pp")
        # the fsdp dim of each leaf by its path ("embed", "layers/wq"); a
        # stacked leaf's is that of one layer's slice (the gather runs a
        # layer at a time); and whether the leaf is split over tp
        self.dims: Dict[str, Optional[int]] = {}
        self.tp_split: Dict[str, bool] = {}
        self.pp_split: Dict[str, bool] = {}
        self._whole = None  # global_norm's mask of leaves not split
        self._not_tp = None  # the same for tp
        self._not_pp = None  # and for pp
        names = dict(tree_paths(logical_axes))
        self.experts = set()  # the expert leaves' paths
        for path, sh in tree_paths(shardings):
            axes = {a for part in sh.spec if part is not None
                    for a in (part if isinstance(part, tuple) else (part,))}
            for axis in ("dp", "sp"):
                if axis in axes:
                    raise NotImplementedError(
                        f"{path} is split over {axis}: parameters split "
                        f"over {axis} are not ported")
            self.tp_split[path] = "tp" in axes
            self.pp_split[path] = "pp" in axes
            dim = _fsdp_dim(sh.spec)
            if dim is not None and names[path][dim] == "expert":
                self.experts.add(path)
            if dim is not None and path.startswith("layers/"):
                if dim == 0:
                    raise ValueError(f"{path}: the stacked layers dim "
                                     f"cannot be split over fsdp")
                dim -= 1
            self.dims[path] = dim
        # the layer stack split over more than one stage: the pipeline
        self.pipelined = (mesh.size(mesh.mesh_dim_names.index("pp")) > 1
                          and any(self.pp_split.values()))

    def gather(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The full weight of `path` from this rank's shard `t` (one layer's
        slice for a stacked leaf); a leaf not split over fsdp, or an expert
        leaf, as it is."""
        dim = self.dims[path]
        if dim is None or path in self.experts:
            return t
        full = _Gather.apply(t, dim, self.fsdp_group, self.n_fsdp)
        root = full if full._base is None else full._base
        root._fsdp_source = (t.detach(), dim, self.fsdp_group, self.n_fsdp)
        return full

    @contextlib.contextmanager
    def saved_tensor_hooks(self):
        """Inside: a gathered weight saved for the backward is kept as its
        shard and gathered again when the backward reads it."""
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`x` summed over the ranks that hold other tokens (fsdp, sp, then
        dp; not tp, whose ranks hold the same ones), in place."""
        dist = _dist()
        dist.all_reduce(x, group=self.fsdp_group)
        if self.n_sp > 1:
            dist.all_reduce(x, group=self.sp_group)
        dist.all_reduce(x, group=self.dp_group)
        return x

    def reduce_grads(self, paths: Sequence[str],
                     grads: Sequence[torch.Tensor]) -> None:
        """After the backward, in place: the gradients of leaves not split
        over fsdp summed over fsdp (each rank saw its own rows; a split
        leaf's reduce-scatter, or an expert leaf's dispatch, summed the
        others), then every gradient summed over sp (other positions) and
        over dp; pipelined, those of leaves not split over pp summed over
        pp (only the stage that uses one holds its gradient)."""
        dist = _dist()
        for path, g in zip(paths, grads, strict=True):
            if self.dims[path] is None:
                dist.all_reduce(g, group=self.fsdp_group)
            if self.pipelined and not self.pp_split[path]:
                dist.all_reduce(g, group=self.pp_group)
        if self.n_sp > 1:
            for g in grads:
                dist.all_reduce(g, group=self.sp_group)
        for g in grads:
            dist.all_reduce(g, group=self.dp_group)

    def global_norm(self, paths: Sequence[str],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of the global gradient, in float32:
        each leaf's squares summed over its fsdp shards, then its tp
        blocks, then (pipelined) its pp blocks, a leaf not split over an
        axis counted once; the same value on every rank."""
        sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                          .square() for g in grads])
        if self.fsdp_rank != 0:
            if self._whole is None:  # one copy to the device, then kept
                self._whole = torch.tensor(
                    [self.dims[p] is None for p in paths], device=sq.device)
            sq = sq.masked_fill(self._whole, 0.0)
        _dist().all_reduce(sq, group=self.fsdp_group)
        if self.n_tp > 1:
            if self.tp_rank != 0:
                if self._not_tp is None:
                    self._not_tp = torch.tensor(
                        [not self.tp_split[p] for p in paths],
                        device=sq.device)
                sq = sq.masked_fill(self._not_tp, 0.0)
            _dist().all_reduce(sq, group=self.tp_group)
        if self.pipelined:
            if self.pp_rank != 0:
                if self._not_pp is None:
                    self._not_pp = torch.tensor(
                        [not self.pp_split[p] for p in paths],
                        device=sq.device)
                sq = sq.masked_fill(self._not_pp, 0.0)
            _dist().all_reduce(sq, group=self.pp_group)
        return sq.sum().sqrt()


def tree_paths(tree: Dict[str, Any], prefix: str = ""):
    """(path, leaf) of a tree of nested dicts in sorted-key order (the
    order of `tree_leaves`), paths joined by "/"."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
