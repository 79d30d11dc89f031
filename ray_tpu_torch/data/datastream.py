"""Datastream: distributed datasets of object-store blocks.

Equivalent capability surface to the reference's Data library
(`python/ray/data/datastream.py:171`, blocks `python/ray/data/block.py:259`,
streaming executor `_internal/execution/streaming_executor.py:45`,
streaming split `_internal/iterator/stream_split_iterator.py:41`):

  - a dataset is a list of *blocks* living in the object store as ObjectRefs;
  - transforms are lazy: a logical op list, fused into one task per block at
    execution (the map-fusion optimization the reference's logical optimizer
    performs);
  - execution happens as parallel tasks over blocks; `iter_batches` streams
    block results without materializing the whole dataset on the driver;
  - `streaming_split(n)` hands per-worker iterators coordinated by a block-
    assignment actor (the reference's coordinator-actor design, SURVEY §H).

Blocks are columnar dicts of numpy arrays (the layout that feeds `torch`
tensors directly: `iter_torch_batches` puts them on the caller's current
card by default) or plain row lists for generic Python data.
"""

from __future__ import annotations

import builtins
import functools
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef

Block = Union[List[Any], Dict[str, np.ndarray]]


def _block_len(block: Block) -> int:
    if isinstance(block, dict):
        return len(next(iter(block.values()))) if block else 0
    return len(block)


def _block_rows(block: Block) -> List[Any]:
    if isinstance(block, dict):
        keys = list(block)
        return [{k: block[k][i] for k in keys}
                for i in builtins.range(_block_len(block))]
    return list(block)


def _rows_to_block(rows: List[Any]) -> Block:
    if rows and isinstance(rows[0], dict) and all(
            isinstance(v, (int, float, str, np.number, np.str_, np.ndarray))
            for v in rows[0].values()):
        keys = list(rows[0])
        try:
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
        except Exception:
            return rows
    return rows


def _concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if _block_len(b) > 0]
    if not blocks:
        return []
    if all(isinstance(b, dict) for b in blocks):
        keys = list(blocks[0])
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    rows: List[Any] = []
    for b in blocks:
        rows.extend(_block_rows(b))
    return rows


def _slice_block(block: Block, start: int, end: int) -> Block:
    if isinstance(block, dict):
        return {k: v[start:end] for k, v in block.items()}
    return block[start:end]


# ------------------------------------------------------------------ ops


def _apply_ops_timed(block: Block, ops: List[tuple]):
    """_apply_ops + per-op wall time, for Datastream.stats()
    (reference Dataset.stats() per-operator execution summary)."""
    import time

    timings = []
    for idx, op in enumerate(ops):
        t0 = time.perf_counter()
        block = _apply_ops(block, [op])
        # Keyed by (position, kind): a chain with two map ops gets distinct
        # per-operator lines instead of one merged bucket.
        timings.append((idx, op[0], time.perf_counter() - t0))
    return block, timings


def _apply_ops(block: Block, ops: List[tuple]) -> Block:
    """Run the fused op chain on one block (executes inside a task)."""
    for op in ops:
        kind = op[0]
        if kind == "map_batches":
            fn = op[1]
            if isinstance(block, list):
                block = fn(_rows_to_block(block))
            else:
                block = fn(block)
        elif kind == "map":
            fn = op[1]
            block = _rows_to_block([fn(r) for r in _block_rows(block)])
        elif kind == "flat_map":
            fn = op[1]
            out: List[Any] = []
            for r in _block_rows(block):
                out.extend(fn(r))
            block = _rows_to_block(out)
        elif kind == "filter":
            fn = op[1]
            block = _rows_to_block([r for r in _block_rows(block) if fn(r)])
        elif kind == "filter_expr":
            pred = op[1]
            if isinstance(block, dict):
                mask = pred.mask(block)
                block = {k: np.asarray(v)[mask] for k, v in block.items()}
            else:
                block = _rows_to_block(
                    [r for r in _block_rows(block) if pred(r)])
        elif kind == "limit":
            block = _slice_block(block, 0, op[1])
    return block


@ray_tpu_torch.remote
def _exec_block(block_or_ref, ops: List[tuple]) -> Block:
    return _apply_ops(block_or_ref, ops)


@ray_tpu_torch.remote
def _count_rows_after_ops(block_or_ref, ops: List[tuple]) -> int:
    """Row count of a block after the op chain (ops=[] = raw block length —
    the zip()/count() shared counting helper; only ints ship to the driver).
    """
    return _block_len(_apply_ops(block_or_ref, ops))


def _apply_batched(fn, batch_size: int, block: Block) -> Block:
    """Slice a block into <=batch_size row batches, apply fn, re-concat."""
    if isinstance(block, list):
        block = _rows_to_block(block)
    n = _block_len(block)
    if n <= batch_size:
        return fn(block)
    outs = [fn(_slice_block(block, i, min(i + batch_size, n)))
            for i in builtins.range(0, n, batch_size)]
    return _concat_blocks(outs)


class _SourceSpec:
    """Lazy, pushdown-capable read (reference `python/ray/data/datasource/
    parquet_datasource.py:179,214`): the reader tasks are NOT submitted at
    read_*() time — they launch when blocks are first needed, with the
    plan's leading select/predicate ops folded into the reader call, so
    column pruning and row-group filtering happen at the FILE layer.

    Pushed ops stay in the op chain (selects and predicate filters are
    idempotent), so no plan surgery is needed for correctness."""

    def __init__(self, kind: str, paths: List[str], loader,
                 supports_columns: bool = False,
                 supports_filters: bool = False,
                 columns: Optional[List[str]] = None,
                 filters: Optional[list] = None):
        self.kind = kind
        self.paths = list(paths)
        self.loader = loader
        self.supports_columns = supports_columns
        self.supports_filters = supports_filters
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None
        # branched pipelines (two streams derived from one read) share one
        # scan per distinct pushdown instead of re-reading every file
        self._submitted: Dict[Any, List[ObjectRef]] = {}

    def pushdown(self, ops: List[tuple]):
        """(columns, filters, pushed_labels) for the optimized chain: the
        leading run of select-only projections and predicate filters folds
        into the reader; the scan stops at the first op that could change
        names or rows in a way the reader can't express."""
        from ray_tpu_torch.data.plan import optimize

        optimized, _ = optimize(list(ops))
        columns = self.columns
        filters = list(self.filters or [])
        # columns of filters pushed FROM THE CHAIN: the chain re-applies
        # them (idempotently), so the read must keep those columns even
        # when a later select drops them
        chain_filter_cols: List[str] = []
        pushed: List[str] = []
        for op in optimized:
            if op[0] == "project" and self.supports_columns:
                spec = op[1]
                steps = spec.get("steps") or [spec]
                first = steps[0]
                if "select" not in first:
                    break  # drop/rename head: column set not derivable
                if columns is None:
                    sel = list(first["select"])
                    columns = sel + [c for c in chain_filter_cols
                                     if c not in sel]
                    pushed.append(f"columns={sel}")
                if not all("select" in s for s in steps):
                    break  # renames ahead: later predicate names unsafe
            elif op[0] == "filter_expr" and self.supports_filters:
                pred = op[1]
                if columns is not None and pred.column not in columns:
                    # predicate on a column the pushed select dropped: the
                    # executor path must raise (as it always did), not the
                    # reader silently filter on an unread column
                    break
                filters.append(pred.as_tuple())
                chain_filter_cols.append(pred.column)
                pushed.append(f"filter[{pred!r}]")
            else:
                break
        return columns, (filters or None), pushed

    def submit(self, ops: List[tuple]) -> List[ObjectRef]:
        columns, filters, _ = self.pushdown(ops)
        key = (tuple(columns) if columns else None,
               tuple(filters) if filters else None)
        if key not in self._submitted:
            self._submitted[key] = [self.loader.remote(p, columns, filters)
                                    for p in self.paths]
        return self._submitted[key]

    def describe(self, ops: List[tuple]) -> str:
        columns, filters, pushed = self.pushdown(ops)
        extra = f", pushdown: {' '.join(pushed)}" if pushed else ""
        return (f"Source[{self.kind}, {len(self.paths)} files{extra}]")


class Datastream:
    """A lazy, distributed dataset. (alias: Dataset)"""

    def __init__(self, block_refs: Optional[List[ObjectRef]],
                 ops: Optional[List[tuple]] = None,
                 source: Optional[_SourceSpec] = None):
        self._refs: Optional[List[ObjectRef]] = (
            list(block_refs) if block_refs is not None else None)
        self._source = source
        if self._refs is None and source is None:
            raise ValueError("Datastream needs block refs or a source")
        # LOGICAL operator chain (data/plan.py); execution sites lower it
        # through the optimizer passes via _physical_ops
        self._ops: List[tuple] = list(ops or [])

    @property
    def _block_refs(self) -> List[ObjectRef]:
        """Materialize the source on first use (reader tasks launch with
        this stream's pushed-down columns/filters)."""
        if self._refs is None:
            self._refs = self._source.submit(self._ops)
        return self._refs

    @_block_refs.setter
    def _block_refs(self, refs: List[ObjectRef]) -> None:
        self._refs = list(refs)

    def _derive(self, extra_ops: List[tuple]) -> "Datastream":
        """Lazy transform: keep the unsubmitted source flowing so later
        ops can still push into the readers."""
        if self._refs is None:
            return Datastream(None, self._ops + extra_ops,
                              source=self._source)
        return Datastream(self._refs, self._ops + extra_ops)


    @property
    def _physical_ops(self) -> List[tuple]:
        """Optimizer passes + lowering over the logical chain (reference
        _internal/logical optimizer -> physical plan)."""
        from ray_tpu_torch.data.plan import lower, optimize

        ops, _ = optimize(self._ops)
        return lower(ops)

    def explain(self) -> str:
        """Printable logical plan, applied rules, optimized plan, and
        physical op list (reference Dataset.explain). For lazy sources the
        header shows the reader-level pushdown (columns/filters) without
        submitting any read."""
        from ray_tpu_torch.data.plan import explain_ops

        source_desc = (self._source.describe(self._ops)
                       if self._refs is None else None)
        text = explain_ops(self.num_blocks(), self._ops,
                           source_desc=source_desc)
        print(text)
        return text

    # ---------------------------------------------------------- transforms
    def map(self, fn: Callable[[Any], Any]) -> "Datastream":
        return self._derive([("map", fn)])

    def map_batches(self, fn, *,
                    batch_format: str = "numpy",
                    batch_size: Optional[int] = None,
                    compute: Optional["ActorPoolStrategy"] = None,
                    fn_constructor_args: tuple = ()) -> "Datastream":
        """Per-batch transform. Without `batch_size` each block is one
        batch; with it, blocks are re-sliced so `fn` sees at most
        `batch_size` rows per call. `fn` may be a callable (task compute,
        lazy) or a class (stateful UDF) with `compute=ActorPoolStrategy(...)`
        — then a pool of actors is created, each constructing the class once
        and streaming batches through `__call__` (reference
        actor_pool_map_operator.py)."""
        if compute is not None or isinstance(fn, type):
            if not isinstance(fn, type):
                raise ValueError(
                    "compute=ActorPoolStrategy requires a class UDF")
            compute = compute or ActorPoolStrategy()
            return self._map_batches_actors(
                fn, compute, fn_constructor_args, batch_size)
        if batch_size is not None:
            fn = functools.partial(_apply_batched, fn, batch_size)
        return self._derive([("map_batches", fn)])

    def _map_batches_actors(self, fn_cls: type,
                            compute: "ActorPoolStrategy",
                            ctor_args: tuple,
                            batch_size: Optional[int] = None) -> "Datastream":
        """Eagerly runs this stage (with all pending lazy ops) through a
        pool of stateful actors; returns a new lazy Datastream over the
        result blocks."""
        # min_size is the pre-warm floor (expensive ctors), max_size the cap
        n_actors = max(1, min(compute.max_size,
                              max(compute.min_size, len(self._block_refs))))

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self, ops, args):
                self._ops = ops
                self._udf = fn_cls(*args)

            def apply(self, block) -> Block:
                block = _apply_ops(block, self._ops)
                if isinstance(block, list):
                    block = _rows_to_block(block)
                if batch_size is not None:
                    return _apply_batched(self._udf, batch_size, block)
                return self._udf(block)

        actors = [_MapWorker.options(**compute.actor_options).remote(
            self._physical_ops, ctor_args) for _ in builtins.range(n_actors)]
        refs = [actors[i % n_actors].apply.remote(r)
                for i, r in enumerate(self._block_refs)]
        # block until all results are in the store (the driver owns them and
        # they outlive the pool), but never pull them through the driver
        ray_tpu_torch.wait(refs, num_returns=len(refs))
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        return Datastream(refs)

    def flat_map(self, fn: Callable[[Any], Iterable[Any]]) -> "Datastream":
        return self._derive([("flat_map", fn)])

    def filter(self, fn) -> "Datastream":
        """Row filter. A `col("x") > 5` predicate expression runs as a
        vectorized mask AND pushes into parquet readers (row-group pruning
        by statistics); a plain callable filters row-wise in the executor
        (opaque to pushdown, like the reference's non-expression UDFs)."""
        from ray_tpu_torch.data.expressions import ColumnPredicate

        if isinstance(fn, ColumnPredicate):
            return self._derive([("filter_expr", fn)])
        return self._derive([("filter", fn)])

    # stats-aware partitioning: target rows per output block when the
    # caller doesn't pick a count (reference streaming executor's
    # resource-budgeted partitioning)
    TARGET_ROWS_PER_BLOCK = 8192

    def _auto_num_blocks(self) -> int:
        """Estimate output partitions from a one-block row-count sample:
        total_rows ~= rows(first block) * num_blocks, sized to
        TARGET_ROWS_PER_BLOCK."""
        if not self._block_refs:
            return 1
        sample = ray_tpu_torch.get(_count_rows_after_ops.remote(
            self._block_refs[0], self._physical_ops))
        est_total = sample * len(self._block_refs)
        return builtins.max(
            1, builtins.min(4 * len(self._block_refs),
                            -(-est_total // self.TARGET_ROWS_PER_BLOCK)))

    def repartition(self, num_blocks: Optional[int] = None) -> "Datastream":
        """Task-based all-to-all repartition (round-robin rows);
        num_blocks=None sizes partitions from sampled row stats."""
        from ray_tpu_torch.data.shuffle import shuffle_refs

        return Datastream(shuffle_refs(
            self._block_refs, self._physical_ops, mode="random",
            num_partitions=num_blocks or self._auto_num_blocks(), seed=0))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Datastream":
        """Distributed two-stage shuffle; the driver never sees the rows
        (cf. reference `_internal/push_based_shuffle.py`). num_blocks=None
        keeps the input partitioning (or pass a count; see repartition for
        the stats-aware sizing)."""
        from ray_tpu_torch.data.shuffle import shuffle_refs

        return Datastream(shuffle_refs(
            self._block_refs, self._physical_ops, mode="random", seed=seed,
            num_partitions=num_blocks))

    def sort(self, key: Union[str, Callable[[Any], Any]],
             descending: bool = False) -> "Datastream":
        """Distributed range-partition sort (sample boundaries → partition
        map tasks → per-range merge tasks; cf. reference sort exchange)."""
        from ray_tpu_torch.data.shuffle import shuffle_refs

        out = Datastream(shuffle_refs(
            self._block_refs, self._physical_ops, mode="sort", key=key))
        if descending:
            refs = out._block_refs[::-1]
            rev = ray_tpu_torch.remote(_reverse_block)
            return Datastream([rev.remote(r) for r in refs])
        return out

    def groupby(self, key: Union[str, Callable[[Any], Any]]) -> "GroupedData":
        """Hash-partition rows so each key's rows co-locate, then aggregate
        per partition (cf. reference `grouped_data.py`)."""
        from ray_tpu_torch.data.shuffle import shuffle_refs

        refs = shuffle_refs(self._block_refs, self._physical_ops, mode="hash", key=key)
        return GroupedData(refs, key)

    def union(self, other: "Datastream") -> "Datastream":
        a, b = self.materialize(), other.materialize()
        return Datastream(a._block_refs + b._block_refs)

    def zip(self, other: "Datastream") -> "Datastream":
        """Column-wise zip. Runs as one task per left block that pulls only
        the overlapping right-side blocks — rows never land on the driver."""
        a_refs = self._executed_refs()
        b_refs = other._executed_refs()
        a_sizes = ray_tpu_torch.get([_count_rows_after_ops.remote(r, []) for r in a_refs])
        b_sizes = ray_tpu_torch.get([_count_rows_after_ops.remote(r, []) for r in b_refs])
        if sum(a_sizes) != sum(b_sizes):
            raise ValueError(
                f"zip requires equal lengths: {sum(a_sizes)} vs {sum(b_sizes)}")
        b_starts = np.cumsum([0] + b_sizes[:-1]).tolist()
        merge = ray_tpu_torch.remote(_zip_merge)
        out_refs, start = [], 0
        for aref, asz in zip(a_refs, a_sizes):
            end = start + asz
            picks, ranges = [], []
            for bref, bsz, bstart in zip(b_refs, b_sizes, b_starts):
                bend = bstart + bsz
                if bend <= start or bstart >= end:
                    continue
                picks.append(bref)
                ranges.append((max(start, bstart) - bstart,
                               min(end, bend) - bstart))
            out_refs.append(merge.remote(aref, ranges, *picks))
            start = end
        return Datastream(out_refs)

    def limit(self, n: int) -> "Datastream":
        """First n rows. Executes blocks incrementally and stops as soon as
        n rows are covered — pending ops never run on the untouched tail,
        and the LimitPushdown pass hops the limit over row-preserving ops
        so their UDFs touch at most n rows of each block."""
        from ray_tpu_torch.data.plan import lower, optimize

        optimized, _ = optimize(self._ops + [("limit", n)])
        out_refs, seen = [], 0
        for ref in self._block_refs:
            if seen >= n:
                break
            # per-block remaining budget: rewrite every limit op's n
            ops = lower([("limit", n - seen) if op[0] == "limit" else op
                         for op in optimized])
            out = _exec_block.remote(ref, ops)
            out_refs.append(out)
            seen += _block_len(ray_tpu_torch.get(out))
        return Datastream(out_refs)

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]) -> "Datastream":
        def add(block: Block) -> Block:
            if not isinstance(block, dict):
                rows = _block_rows(block)
                block = _rows_to_block(rows)
                if not isinstance(block, dict):
                    raise TypeError("add_column requires columnar blocks")
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out

        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Datastream":
        return self._derive([("project", {"drop": list(cols)})])

    def select_columns(self, cols: List[str]) -> "Datastream":
        return self._derive([("project", {"select": list(cols)})])

    def rename_columns(self, mapping: Dict[str, str]) -> "Datastream":
        return self._derive([("project", {"rename": dict(mapping)})])

    # ----------------------------------------------------------- execution
    def materialize(self) -> "Datastream":
        if not self._ops:
            return self
        refs = [_exec_block.remote(r, self._physical_ops) for r in self._block_refs]
        return Datastream(refs)

    def _executed_refs(self) -> List[ObjectRef]:
        return self.materialize()._block_refs

    def _stream_refs(self, max_inflight: Optional[int] = None,
                     memory_budget: Optional[int] = None) -> Iterator[ObjectRef]:
        """Backpressured streaming execution (reference
        `_internal/execution/streaming_executor.py:45`): yield executed block
        refs in order while keeping at most `max_inflight` block tasks
        submitted-but-unconsumed AND at most `memory_budget` bytes of
        PRODUCED-but-unconsumed results (the per-operator memory quota of
        the reference's streaming executor): an operator whose outputs
        balloon stops getting new submissions until the consumer drains,
        regardless of the count window."""
        if not self._ops:
            yield from self._block_refs
            return
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        if max_inflight is None:
            max_inflight = cfg.data_max_inflight_blocks
        if memory_budget is None:
            memory_budget = cfg.data_op_memory_budget_bytes
        from ray_tpu_torch.core.api import _global_worker

        w = _global_worker()

        def produced_bytes(refs) -> int:
            total = 0
            for r in refs:
                sz = w.object_size(r)  # None while the task still runs
                if sz:
                    total += sz
            return total

        inflight: deque = deque()
        ops = self._physical_ops
        for r in self._block_refs:
            while len(inflight) >= max_inflight or (
                    inflight and produced_bytes(inflight) >= memory_budget):
                yield inflight.popleft()
            inflight.append(_exec_block.remote(r, ops))
        while inflight:
            yield inflight.popleft()

    # ----------------------------------------------------------- consumers
    def count(self) -> int:
        # CountProjection pass (reference _internal/logical optimizer):
        # trailing row-preserving ops (map / project) are dropped — a
        # map-only chain counts SOURCE blocks without running any UDF —
        # and counting ships per-block row COUNTS, never block data.
        from ray_tpu_torch.data.plan import lower, ops_for_count, optimize

        ops, _ = ops_for_count(optimize(self._ops)[0])
        ops = lower(ops)
        return sum(ray_tpu_torch.get(
            [_count_rows_after_ops.remote(r, ops) for r in self._block_refs]))

    def _column_reduce(self, col: str, block_fn, combine):
        task = ray_tpu_torch.remote(
            lambda b, ops: block_fn(_apply_ops(b, ops), col))
        parts = [p for p in ray_tpu_torch.get(
            [task.remote(r, self._physical_ops) for r in self._block_refs])
            if p is not None]
        if not parts:
            raise ValueError(f"no rows with column {col!r}")
        return combine(parts)

    def sum(self, col: str):
        return self._column_reduce(col, _block_col_sum, lambda ps: sum(ps))

    def min(self, col: str):
        return self._column_reduce(col, _block_col_min, lambda ps: builtins.min(ps))

    def max(self, col: str):
        return self._column_reduce(col, _block_col_max, lambda ps: builtins.max(ps))

    def mean(self, col: str):
        pairs = self._column_reduce(
            col, _block_col_sum_count, lambda ps: ps)
        total = sum(p[0] for p in pairs)
        cnt = sum(p[1] for p in pairs)
        return total / builtins.max(cnt, 1)

    def std(self, col: str, ddof: int = 1):
        vals = np.concatenate([np.atleast_1d(v) for v in self._column_values(col)])
        return float(np.std(vals, ddof=ddof))

    def unique(self, col: str) -> List[Any]:
        vals = np.concatenate([np.atleast_1d(v) for v in self._column_values(col)])
        return sorted(np.unique(vals).tolist())

    def _column_values(self, col: str) -> List[np.ndarray]:
        task = ray_tpu_torch.remote(lambda b, ops: _block_col(_apply_ops(b, ops), col))
        return [v for v in ray_tpu_torch.get(
            [task.remote(r, self._physical_ops) for r in self._block_refs]) if v is not None]

    # ------------------------------------------------------------- writers
    def _write(self, path_prefix: str, ext: str, write_block) -> List[str]:
        import os

        os.makedirs(path_prefix, exist_ok=True)
        task = ray_tpu_torch.remote(
            lambda b, ops, p: write_block(_apply_ops(b, ops), p))
        paths = [os.path.join(path_prefix, f"part-{i:05d}.{ext}")
                 for i in builtins.range(len(self._block_refs))]
        ray_tpu_torch.get([task.remote(r, self._physical_ops, p)
                     for r, p in zip(self._block_refs, paths)])
        return paths

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json", _write_block_json)

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv", _write_block_csv)

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet", _write_block_parquet)

    def write_tfrecords(self, path: str) -> List[str]:
        return self._write(path, "tfrecords", _write_block_tfrecords)

    def train_test_split(self, test_size: Union[int, float], *,
                         shuffle: bool = False, seed: Optional[int] = None):
        """(train, test) split (reference Datastream.train_test_split)."""
        ds = self.random_shuffle(seed=seed) if shuffle else self
        n = ds.count()
        n_test = int(n * test_size) if isinstance(test_size, float) else test_size
        return ds.split_at_indices([n - n_test])

    def to_pandas(self):
        """Materialize into one DataFrame (reference Datastream.to_pandas)."""
        import pandas as pd

        rows = self.take_all()
        if not rows:
            return pd.DataFrame()
        if isinstance(rows[0], dict):
            return pd.DataFrame(rows)
        return pd.DataFrame({"value": rows})

    def to_arrow(self):
        """Materialize into one pyarrow Table."""
        import pyarrow as pa

        return pa.Table.from_pandas(self.to_pandas(), preserve_index=False)

    def split_at_indices(self, indices: List[int]) -> List["Datastream"]:
        """Split into len(indices)+1 streams at global row offsets. Each
        piece keeps the source's block parallelism so downstream
        streaming_split/map fan-out isn't collapsed to one block."""
        rows = self.take_all()
        out = []
        prev = 0
        par = max(1, self.num_blocks())
        for idx in list(indices) + [len(rows)]:
            out.append(from_items(rows[prev:idx], parallelism=par))
            prev = idx
        return out

    def split_proportionately(self, proportions: List[float]
                              ) -> List["Datastream"]:
        """Split by fractions; a final stream carries the remainder
        (reference Dataset.split_proportionately). [0.7, 0.2] -> three
        streams of ~70%/20%/10%."""
        if not proportions or any(p <= 0 for p in proportions):
            raise ValueError("proportions must be positive")
        if sum(proportions) >= 1.0:
            raise ValueError("proportions must sum to < 1 "
                             "(the remainder forms the last split)")
        n = self.count()
        indices, acc = [], 0.0
        for p in proportions:
            acc += p
            # round, not truncate: float accumulation (0.7+0.2=0.8999…)
            # must not shave a row off a split boundary
            indices.append(round(n * acc))
        return self.split_at_indices(indices)

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Datastream":
        """Bernoulli row sample at `fraction` (reference
        Dataset.random_sample): each block filters locally with a
        per-block rng — no shuffle, no driver materialization."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        import random as _random

        base = seed if seed is not None else _random.randrange(2**31)

        def sample(block, _base=base, _frac=fraction):
            rows = _block_rows(block)
            # per-block rng derived from (seed, block content checksum):
            # distinct blocks sample independently, and a retried/lineage-
            # re-executed block reproduces its original sample
            csum = len(rows)
            if isinstance(block, dict) and block:
                first = np.ascontiguousarray(next(iter(block.values())))
                if first.size and first.dtype != object:
                    csum = int(first.view(np.uint8).sum())
                elif first.size:  # object columns: hash a stable prefix
                    csum = hash(repr(first.ravel()[0])) & 0x7FFFFFFF
            rng = np.random.default_rng((_base, csum))
            keep = rng.random(len(rows)) < _frac
            return _rows_to_block([r for r, k in zip(rows, keep) if k])

        return self.map_batches(sample)

    def randomize_block_order(self, *, seed: Optional[int] = None
                              ) -> "Datastream":
        """Shuffle the BLOCK order only — O(1) metadata, no data moves
        (reference Dataset.randomize_block_order; the cheap shuffle used
        between epochs when a full row shuffle is too expensive)."""
        import copy
        import random as _random

        if self._refs is None:
            # lazy source: block order IS file order — shuffle the paths and
            # stay lazy (pushdown, input_files, footer schema all survive)
            source = copy.copy(self._source)
            source.paths = list(source.paths)
            _random.Random(seed).shuffle(source.paths)
            source._submitted = {}
            return Datastream(None, self._ops, source=source)
        refs = list(self._refs)
        _random.Random(seed).shuffle(refs)
        return Datastream(refs, self._ops)

    def take_batch(self, batch_size: int = 20) -> Block:
        """First up-to-batch_size rows as one columnar batch (reference
        Dataset.take_batch)."""
        return _rows_to_block(self.take(batch_size))

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def size_bytes(self) -> int:
        """Total materialized block bytes (reference Dataset.size_bytes)."""
        total = 0
        for ref in self._stream_refs():
            b = ray_tpu_torch.get(ref)
            if isinstance(b, dict):
                total += sum(np.asarray(v).nbytes for v in b.values())
            else:
                import sys as _sys

                total += sum(_sys.getsizeof(r) for r in b)
        return total

    def input_files(self) -> List[str]:
        """Source files feeding this stream, [] for in-memory sources
        (reference Dataset.input_files)."""
        return list(self._source.paths) if self._source is not None else []

    def to_numpy_refs(self) -> List["ObjectRef"]:
        """Object refs of the executed blocks (dict-of-numpy form),
        without pulling them to the driver (reference
        Dataset.to_numpy_refs)."""
        return list(self._stream_refs())

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for ref in self._stream_refs():
            out.extend(_block_rows(ray_tpu_torch.get(ref)))
            if len(out) >= limit:
                break
        return out[:limit]

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for ref in self._stream_refs():
            out.extend(_block_rows(ray_tpu_torch.get(ref)))
        return out

    def schema(self) -> Optional[Dict[str, Any]]:
        """Column name -> dtype. For an unsubmitted parquet source whose op
        chain can't invent columns, this reads only the file FOOTER
        (reference ParquetDatasource metadata-only schema) — no data task
        runs. Otherwise the first non-empty block is peeked."""
        if (self._refs is None and self._source.kind == "parquet"
                and all(op[0] in ("project", "filter_expr", "limit", "filter")
                        for op in self._ops)):
            import pyarrow as pa
            import pyarrow.parquet as pq

            arrow_schema = pq.read_schema(self._source.paths[0])
            # reader-level column pruning (source columns= plus pushed-down
            # selects/filter columns) applies to TOP-LEVEL file columns
            read_cols, _, _ = self._source.pushdown(self._ops)
            top = [n for n in arrow_schema.names
                   if read_cols is None or n in read_cols]

            def leaves(name, typ):
                """Mirror _table_to_block: structs flatten to dotted keys;
                leaf dtypes match what the numpy block will hold."""
                if pa.types.is_struct(typ):
                    for field in typ:
                        yield from leaves(f"{name}.{field.name}", field.type)
                    return
                if pa.types.is_dictionary(typ):
                    typ = typ.value_type
                while pa.types.is_fixed_size_list(typ):
                    typ = typ.value_type
                if (pa.types.is_list(typ) or pa.types.is_large_list(typ)
                        or pa.types.is_string(typ)
                        or pa.types.is_large_string(typ)
                        or pa.types.is_binary(typ)):
                    yield name, np.dtype(object)
                    return
                try:
                    yield name, np.dtype(typ.to_pandas_dtype())
                except (NotImplementedError, TypeError):
                    yield name, np.dtype(object)

            names, types = [], {}
            for n in top:
                for leaf, dt in leaves(n, arrow_schema.field(n).type):
                    names.append(leaf)
                    types[leaf] = dt
            # replay the op chain's projections over the flattened names
            for op in self._ops:
                if op[0] != "project":
                    continue
                st = op[1]
                if "select" in st:
                    names = [n for n in names if n in st["select"]]
                elif "drop" in st:
                    names = [n for n in names if n not in st["drop"]]
                elif "rename" in st:
                    names = [st["rename"].get(n, n) for n in names]
                    types = {st["rename"].get(n, n): t
                             for n, t in types.items()}
            return {n: types[n] for n in names}
        for ref in self._stream_refs():
            b = ray_tpu_torch.get(ref)
            if _block_len(b):
                if isinstance(b, dict):
                    return {k: v.dtype for k, v in b.items()}
                r = _block_rows(b)[0]
                return {k: type(v) for k, v in r.items()} if isinstance(r, dict) else {
                    "value": type(r)}
        return None

    def num_blocks(self) -> int:
        if self._refs is None:
            return len(self._source.paths)  # known without reading
        return len(self._refs)

    def iter_rows(self) -> Iterator[Any]:
        for ref in self._stream_refs():
            yield from _block_rows(ray_tpu_torch.get(ref))

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Block]:
        """Stream batches; a bounded window of block tasks executes ahead of
        consumption (backpressure — consumption drives submission)."""
        carry: Optional[Block] = None
        for ref in self._stream_refs():
            block = ray_tpu_torch.get(ref)
            if carry is not None:
                block = _concat_blocks([carry, block])
                carry = None
            n = _block_len(block)
            i = 0
            while n - i >= batch_size:
                yield _slice_block(block, i, i + batch_size)
                i += batch_size
            if i < n:
                carry = _slice_block(block, i, n)
        if carry is not None and not drop_last:
            yield carry

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device: str = "cuda",
                           drop_last: bool = False) -> Iterator[Dict[str, Any]]:
        """Batches as dicts of torch tensors (reference
        `Datastream.iter_torch_batches`). Non-numeric columns pass through
        unchanged; `dtypes` maps column -> torch dtype. `device` defaults
        to the card: "cuda" is the calling thread's current card (a granted
        worker's grant); pass "cpu" for host tensors. Without a card the
        default raises rather than falling back to the CPU."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield _to_torch_batch(batch, dtypes, device)

    def stats(self) -> str:
        """Execute the pending op chain with per-operator timing and return
        a summary (reference `Dataset.stats()`): per op kind — total wall
        time across blocks, min/max per block, rows out."""
        timed = ray_tpu_torch.remote(_apply_ops_timed)
        outs = ray_tpu_torch.get([timed.remote(r, self._physical_ops)
                            for r in self._block_refs])
        per_op: Dict[int, List[float]] = {}
        total_rows = 0
        for block, timings in outs:
            total_rows += _block_len(block)
            for idx, _kind, seconds in timings:
                per_op.setdefault(idx, []).append(seconds)
        lines = [f"Datastream stats: {len(self._block_refs)} blocks, "
                 f"{total_rows} rows out"]
        for i, op in enumerate(self._physical_ops):
            kind = op[0]
            times = per_op.get(i, [])
            if not times:
                continue
            lines.append(
                f"  op {i} {kind}: total {sum(times)*1e3:.1f}ms, "
                f"min {min(times)*1e3:.2f}ms, max {max(times)*1e3:.2f}ms, "
                f"avg {np.mean(times)*1e3:.2f}ms over {len(times)} blocks")
        if not self._ops:
            lines.append("  (no pending ops — fully materialized)")
        return "\n".join(lines)

    def split(self, n: int, *, equal: bool = False) -> List["Datastream"]:
        refs = self._executed_refs()
        if equal:
            blocks = ray_tpu_torch.get(refs)
            whole = _concat_blocks(blocks)
            total = _block_len(whole)
            per = total // n
            return [Datastream([ray_tpu_torch.put(_slice_block(whole, i * per, (i + 1) * per))])
                    for i in builtins.range(n)]
        out: List[List[ObjectRef]] = [[] for _ in builtins.range(n)]
        for i, r in enumerate(refs):
            out[i % n].append(r)
        return [Datastream(r) for r in out]

    def streaming_split(self, n: int, *, equal: bool = True) -> List["DataIterator"]:
        """Per-consumer iterators fed by a coordinator actor (SURVEY §H).
        Block tasks execute lazily inside the coordinator as consumers pull
        (one block of prefetch per consumer) — the full pipeline output is
        never resident at once."""
        coord = _SplitCoordinator.options(num_cpus=0).remote(
            list(self._block_refs), n, list(self._physical_ops))
        return [DataIterator(coord, i) for i in builtins.range(n)]

    def __repr__(self):
        # num_blocks(), NOT _block_refs: printing a lazy stream (a REPL
        # echo!) must never launch the distributed read
        return (f"Datastream(num_blocks={self.num_blocks()}, "
                f"pending_ops={len(self._ops)})")


Dataset = Datastream  # the reference renamed Dataset->Datastream in this era


class ActorPoolStrategy:
    """Actor compute for stateful map_batches UDFs (reference
    python/ray/data/_internal/compute.py ActorPoolStrategy). `actor_options`
    pass through to `.options()` — e.g. {"num_gpus": 1} pins each pool
    member to a card."""

    def __init__(self, min_size: int = 1, max_size: int = 4,
                 actor_options: Optional[Dict[str, Any]] = None):
        self.min_size = min_size
        self.max_size = max(min_size, max_size)
        self.actor_options = dict(actor_options or {})


def _to_torch_batch(batch: Block, dtypes, device: str) -> Dict[str, Any]:
    import torch

    from ray_tpu_torch.ops.kernels._util import require_cuda

    device = require_cuda(device)  # "cuda" without a card raises
    if isinstance(batch, list):
        batch = _rows_to_block(batch)
        if isinstance(batch, list):  # non-dict rows: single "data" column
            batch = {"data": np.asarray(batch)}
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind in "biuf":
            t = torch.as_tensor(arr)
            if dtypes and k in dtypes:
                t = t.to(dtypes[k])
            out[k] = t.to(device) if device.type != "cpu" else t
        else:
            out[k] = v
    return out


def _block_col(block: Block, col: str) -> Optional[np.ndarray]:
    if _block_len(block) == 0:
        return None
    if isinstance(block, dict):
        return np.asarray(block[col])
    vals = [r[col] for r in _block_rows(block)]
    try:
        return np.asarray(vals)
    except ValueError:  # ragged values (per-row lists): keep them as rows
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = v
        return out


def _block_col_sum(block: Block, col: str):
    v = _block_col(block, col)
    return None if v is None else v.sum()


def _block_col_min(block: Block, col: str):
    v = _block_col(block, col)
    return None if v is None else v.min()


def _block_col_max(block: Block, col: str):
    v = _block_col(block, col)
    return None if v is None else v.max()


def _block_col_sum_count(block: Block, col: str):
    v = _block_col(block, col)
    return None if v is None else (v.sum(), len(v))


def _write_block_json(block: Block, path: str) -> None:
    import json

    with open(path, "w") as f:
        for r in _block_rows(block):
            if isinstance(r, dict):
                r = {k: (v.item() if isinstance(v, np.generic) else
                         v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in r.items()}
            f.write(json.dumps(r) + "\n")


def _write_block_csv(block: Block, path: str) -> None:
    import csv

    rows = _block_rows(block)
    with open(path, "w", newline="") as f:
        if not rows:
            return
        if isinstance(rows[0], dict):
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            for r in rows:
                w.writerow({k: (v.item() if isinstance(v, np.generic) else v)
                            for k, v in r.items()})
        else:
            w = csv.writer(f)
            for r in rows:
                w.writerow([r])


def _tensor_to_arrow(arr: np.ndarray):
    """Multi-dim numpy -> (nested) FixedSizeList arrow array, so tensor
    columns (e.g. [N, obs_dim] observations) round-trip through parquet
    (reference ArrowTensorArray, python/ray/air/util/tensor_extensions)."""
    import pyarrow as pa

    out = pa.array(arr.reshape(-1))
    for dim in reversed(arr.shape[1:]):
        out = pa.FixedSizeListArray.from_arrays(out, dim)
    return out


def _arrow_to_numpy(column) -> np.ndarray:
    """Arrow column -> numpy; (nested) FixedSizeList columns reassemble to
    a contiguous [N, ...] tensor instead of degrading to object arrays;
    dictionary-encoded columns decode to their values; variable-length
    lists become object arrays of per-row numpy arrays (lossless)."""
    import pyarrow as pa

    col = column.combine_chunks() if hasattr(column, "combine_chunks") \
        else column
    if pa.types.is_dictionary(col.type):
        col = col.dictionary_decode()
    shape = [len(col)]
    typ = col.type
    while pa.types.is_fixed_size_list(typ):
        shape.append(typ.list_size)
        typ = typ.value_type
    if len(shape) > 1:
        flat = col
        while hasattr(flat, "flatten") and pa.types.is_fixed_size_list(
                flat.type):
            flat = flat.flatten()
        return flat.to_numpy(zero_copy_only=False).reshape(shape)
    if pa.types.is_list(typ) or pa.types.is_large_list(typ):
        out = np.empty(len(col), dtype=object)
        for i, item in enumerate(col):
            out[i] = (None if not item.is_valid
                      else np.asarray(item.as_py()))
        return out
    return col.to_numpy(zero_copy_only=False)


def _table_to_block(table) -> Block:
    """Arrow table -> dict-of-numpy block, losslessly: struct columns
    flatten to dotted ``parent.child`` keys (the reference keeps structs
    arrow-side in ArrowBlockAccessor; this block model is
    columnar numpy — device-feedable — so structs decompose instead of
    degrading to object arrays)."""
    import pyarrow as pa

    out: Dict[str, np.ndarray] = {}

    def add(name: str, col):
        chunked = col.combine_chunks() if hasattr(col, "combine_chunks") \
            else col
        if pa.types.is_struct(chunked.type):
            for field in chunked.type:
                add(f"{name}.{field.name}", chunked.field(field.name))
        else:
            out[name] = _arrow_to_numpy(chunked)

    for c in table.column_names:
        add(c, table[c])
    return out


def _write_block_parquet(block: Block, path: str) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    if isinstance(block, dict):
        cols = {}
        for k, v in block.items():
            v = np.asarray(v)
            cols[k] = _tensor_to_arrow(v) if v.ndim > 1 else pa.array(v)
        table = pa.table(cols)
    else:
        rows = _block_rows(block)
        cols = {k: [r[k] for r in rows] for k in (rows[0] if rows else {})}
        table = pa.table(cols)
    pq.write_table(table, path)


def _reverse_block(block: Block) -> Block:
    if isinstance(block, dict):
        return {k: np.asarray(v)[::-1].copy() for k, v in block.items()}
    return list(reversed(_block_rows(block)))


def _zip_merge(a_block: Block, ranges: List[tuple], *b_blocks: Block) -> Block:
    pieces = [_slice_block(b, s, e) for b, (s, e) in zip(b_blocks, ranges)]
    b_all = _concat_blocks(pieces) if pieces else []
    rows_a = _block_rows(a_block)
    rows_b = _block_rows(b_all)
    merged = []
    for ra, rb in zip(rows_a, rows_b):
        ra = ra if isinstance(ra, dict) else {"value": ra}
        rb = rb if isinstance(rb, dict) else {"value_1": rb}
        m = dict(ra)
        for k, v in rb.items():
            m[k if k not in m else f"{k}_1"] = v
        merged.append(m)
    return _rows_to_block(merged)




class GroupedData:
    """Result of `Datastream.groupby`: per-key aggregations over
    hash-co-located partitions (reference `python/ray/data/grouped_data.py`)."""

    def __init__(self, block_refs: List[ObjectRef], key):
        self._refs = block_refs
        self._key = key

    def _agg(self, init, accum, col: Optional[str], out_name: str) -> Datastream:
        key = self._key

        def agg_block(block: Block) -> Block:
            from ray_tpu_torch.data.shuffle import _key_values

            n = _block_len(block)
            if n == 0:
                return []
            kv = _key_values(block, key)
            rows = _block_rows(block)
            groups: Dict[Any, Any] = {}
            for i in builtins.range(n):
                k = kv[i].item() if hasattr(kv[i], "item") else kv[i]
                v = rows[i][col] if col is not None else rows[i]
                groups[k] = accum(groups.get(k, init), v)
            gname = key if isinstance(key, str) else "key"
            return _rows_to_block(
                [{gname: k, out_name: v} for k, v in groups.items()])

        task = ray_tpu_torch.remote(agg_block)
        return Datastream([task.remote(r) for r in self._refs])

    def count(self) -> Datastream:
        return self._agg(0, lambda acc, _: acc + 1, None, "count()")

    def sum(self, col: str) -> Datastream:
        return self._agg(0, lambda acc, v: acc + v, col, f"sum({col})")

    def min(self, col: str) -> Datastream:
        return self._agg(float("inf"), lambda acc, v: builtins.min(acc, v),
                         col, f"min({col})")

    def max(self, col: str) -> Datastream:
        return self._agg(float("-inf"), lambda acc, v: builtins.max(acc, v),
                         col, f"max({col})")

    def mean(self, col: str) -> Datastream:
        summed = self._agg((0.0, 0), lambda acc, v: (acc[0] + v, acc[1] + 1),
                           col, "_sc")
        gname = self._key if isinstance(self._key, str) else "key"

        def finish(row):
            s, c = row["_sc"]
            return {gname: row[gname], f"mean({col})": s / builtins.max(c, 1)}

        return summed.map(finish)

    def map_groups(self, fn: Callable[[List[Any]], Any]) -> Datastream:
        key = self._key

        def apply(block: Block) -> Block:
            from ray_tpu_torch.data.shuffle import _key_values

            n = _block_len(block)
            if n == 0:
                return []
            kv = _key_values(block, key)
            rows = _block_rows(block)
            groups: Dict[Any, List[Any]] = {}
            for i in builtins.range(n):
                k = kv[i].item() if hasattr(kv[i], "item") else kv[i]
                groups.setdefault(k, []).append(rows[i])
            out: List[Any] = []
            for g in groups.values():
                res = fn(g)
                out.extend(res if isinstance(res, list) else [res])
            return _rows_to_block(out)

        task = ray_tpu_torch.remote(apply)
        return Datastream([task.remote(r) for r in self._refs])


@ray_tpu_torch.remote
class _SplitCoordinator:
    """Serves block refs round-robin to n consumers, epoch-synchronized.

    Blocks with pending ops execute lazily on demand (reference
    StreamSplitDataIterator over the streaming executor,
    `stream_split_iterator.py:41`): each next_block submits the consumer's
    block if needed plus one block of prefetch, so at most ~2 executed
    blocks per consumer are resident at a time."""

    def __init__(self, refs: List[ObjectRef], n: int, ops: Optional[list] = None):
        self.refs = refs
        self.n = n
        self.ops = list(ops or [])
        self.epoch_positions: Dict[int, int] = {}
        self._prefetched: Dict[int, Any] = {}  # pos -> executed block ref

    def _executed(self, pos: int):
        if not self.ops:
            return self.refs[pos]
        ref = self._prefetched.pop(pos, None)
        if ref is None:
            ref = _exec_block.remote(self.refs[pos], self.ops)
        return ref

    def next_block(self, consumer: int):
        pos = self.epoch_positions.get(consumer, consumer)
        if pos >= len(self.refs):
            return None
        self.epoch_positions[consumer] = pos + self.n
        ref = self._executed(pos)
        nxt = pos + self.n
        if self.ops and nxt < len(self.refs) and nxt not in self._prefetched:
            self._prefetched[nxt] = _exec_block.remote(self.refs[nxt], self.ops)
        return ref

    def reset(self, consumer: int):
        self.epoch_positions[consumer] = consumer
        return True


class DataIterator:
    """Per-worker view of a streaming split (cf. reference DataIterator)."""

    def __init__(self, coordinator, index: int):
        self._coord = coordinator
        self._index = index

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False) -> Iterator[Block]:
        ray_tpu_torch.get(self._coord.reset.remote(self._index))
        carry: Optional[Block] = None
        while True:
            ref = ray_tpu_torch.get(self._coord.next_block.remote(self._index))
            if ref is None:
                break
            block = ray_tpu_torch.get(ref)
            if carry is not None:
                block = _concat_blocks([carry, block])
                carry = None
            n = _block_len(block)
            i = 0
            while n - i >= batch_size:
                yield _slice_block(block, i, i + batch_size)
                i += batch_size
            if i < n:
                carry = _slice_block(block, i, n)
        if carry is not None and not drop_last:
            yield carry

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device: str = "cuda",
                           drop_last: bool = False) -> Iterator[Dict[str, Any]]:
        """As `Datastream.iter_torch_batches`: on the card by default."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield _to_torch_batch(batch, dtypes, device)

    def iter_rows(self) -> Iterator[Any]:
        for batch in self.iter_batches(batch_size=256):
            yield from _block_rows(batch)

    def __reduce__(self):
        return (DataIterator, (self._coord, self._index))


# ------------------------------------------------------------ constructors


def from_items(items: List[Any], *, parallelism: int = 8) -> Datastream:
    n = max(1, min(parallelism, len(items) or 1))
    per = -(-len(items) // n) if items else 1
    refs = [ray_tpu_torch.put(_rows_to_block(items[i:i + per]))
            for i in builtins.range(0, max(len(items), 1), per)]
    return Datastream(refs)


def range(n: int, *, parallelism: int = 8) -> Datastream:  # noqa: A001
    per = -(-n // parallelism) if n else 1
    refs = []
    for start in builtins.range(0, max(n, 1), per):
        end = min(start + per, n)
        refs.append(ray_tpu_torch.put({"id": np.arange(start, end)}))
    return Datastream(refs)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Datastream:
    per = -(-n // parallelism) if n else 1
    refs = []
    for start in builtins.range(0, max(n, 1), per):
        end = min(start + per, n)
        ids = np.arange(start, end)
        data = np.broadcast_to(ids.reshape(-1, *([1] * len(shape))),
                               (end - start, *shape)).copy()
        refs.append(ray_tpu_torch.put({"data": data}))
    return Datastream(refs)


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]],
               *, parallelism: int = 8) -> Datastream:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    n = len(next(iter(arrays.values())))
    per = -(-n // parallelism) if n else 1
    refs = []
    for start in builtins.range(0, max(n, 1), per):
        end = min(start + per, n)
        refs.append(ray_tpu_torch.put({k: v[start:end] for k, v in arrays.items()}))
    return Datastream(refs)


def read_text(paths: Union[str, List[str]]) -> Datastream:
    paths = [paths] if isinstance(paths, str) else list(paths)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        with open(path) as f:
            return [{"text": line.rstrip("\n")} for line in f]

    return Datastream([load.remote(p) for p in paths])


def read_json(paths: Union[str, List[str]]) -> Datastream:
    paths = [paths] if isinstance(paths, str) else list(paths)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        import json

        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return _rows_to_block(rows)

    return Datastream([load.remote(p) for p in paths])


@ray_tpu_torch.remote
def _load_csv(path: str, columns, filters) -> Block:
    import csv

    with open(path) as f:
        rows = [dict(r) for r in csv.DictReader(f)]
    if columns:
        rows = [{c: r[c] for c in columns} for r in rows]
    return _rows_to_block(rows)


def read_csv(paths: Union[str, List[str]], *,
             columns: Optional[List[str]] = None) -> Datastream:
    """CSV read; `columns` (given or pushed down from a later select)
    prunes parsed columns at the reader."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    return Datastream(None, source=_SourceSpec(
        "csv", paths, _load_csv, supports_columns=True, columns=columns))


@ray_tpu_torch.remote
def _load_parquet(path: str, columns, filters) -> Block:
    import pyarrow.parquet as pq

    table = pq.read_table(path, columns=columns, filters=filters)
    return _table_to_block(table)


def read_parquet(paths: Union[str, List[str]], *,
                 columns: Optional[List[str]] = None,
                 filters: Optional[list] = None) -> Datastream:
    """Parquet read with FILE-LAYER pruning (reference
    parquet_datasource.py:179,214): `columns` decodes only those columns;
    `filters` ([(col, op, value), ...]) prunes row groups by statistics
    before decoding. Both also arrive automatically via pushdown from
    later `select_columns`/`filter(col(...) ...)` calls — the read is
    lazy until blocks are first consumed."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    return Datastream(None, source=_SourceSpec(
        "parquet", paths, _load_parquet, supports_columns=True,
        supports_filters=True, columns=columns, filters=filters))


def read_numpy(paths: Union[str, List[str]]) -> Datastream:
    """.npy files, one tensor column per file (reference numpy datasource)."""
    paths = [paths] if isinstance(paths, str) else list(paths)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        return {"data": np.load(path)}

    return Datastream([load.remote(p) for p in paths])


def read_binary_files(paths: Union[str, List[str]],
                      include_paths: bool = False) -> Datastream:
    """Raw bytes per file (reference binary datasource)."""
    paths = [paths] if isinstance(paths, str) else list(paths)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        row = {"bytes": data}
        if include_paths:
            row["path"] = path
        return [row]

    return Datastream([load.remote(p) for p in paths])


def read_tfrecords(paths: Union[str, List[str]]) -> Datastream:
    """tf.train.Example TFRecord files, decoded without a TF dependency
    (ray_tpu_torch.data.tfrecord; reference tfrecords_datasource.py). Scalar
    features unwrap to scalars, multi-element ones stay arrays/lists."""
    paths = [paths] if isinstance(paths, str) else list(paths)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        from ray_tpu_torch.data.tfrecord import decode_example, read_records

        rows = []
        for rec in read_records(path):
            row = {}
            for k, v in decode_example(rec).items():
                if len(v) == 1:
                    v = v[0]
                row[k] = v
            rows.append(row)
        return _rows_to_block(rows)

    return Datastream([load.remote(p) for p in paths])


def _write_block_tfrecords(block: Block, path: str) -> None:
    from ray_tpu_torch.data.tfrecord import encode_example, write_records

    write_records(path, [encode_example(
        {k: v for k, v in row.items()}) for row in _block_rows(block)])


def from_pandas(dfs) -> Datastream:
    """One block per DataFrame (reference ray.data.from_pandas)."""
    import pandas as pd

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    return Datastream([
        ray_tpu_torch.put({c: df[c].to_numpy() for c in df.columns}) for df in dfs])


def from_arrow(tables) -> Datastream:
    """One block per pyarrow Table (reference ray.data.from_arrow)."""
    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    return Datastream([
        ray_tpu_torch.put(_table_to_block(t))
        for t in tables])


