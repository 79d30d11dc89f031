"""Distributed two-stage shuffle: map tasks partition, reduce tasks merge.

Mirrors the reference's push-based shuffle / sort design
(`python/ray/data/_internal/push_based_shuffle.py`,
`_internal/planner/exchange/sort_task_spec.py`): stage 1 runs one task per
input block that splits it into N output partitions (by range boundary for
sort, by hash for groupby, by seeded RNG for random_shuffle); stage 2 runs
one task per output partition that merges its pieces. All rows move through
the object store — the driver never materializes the dataset.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, List, Optional, Union

import numpy as np

import ray_tpu_torch

KeyT = Union[str, Callable[[Any], Any]]


def _stable_hash(k) -> int:
    if isinstance(k, (int, np.integer)):
        return int(k) & 0x7FFFFFFF
    import zlib

    return zlib.crc32(repr(k).encode())


def _key_values(block, key: KeyT) -> np.ndarray:
    """Vector of sort/group keys for a block."""
    from ray_tpu_torch.data.datastream import _block_rows

    if isinstance(block, dict) and isinstance(key, str):
        return np.asarray(block[key])
    rows = _block_rows(block)
    if callable(key):
        return np.asarray([key(r) for r in rows])
    return np.asarray([r[key] for r in rows])


def _take_rows(block, idx: np.ndarray):
    from ray_tpu_torch.data.datastream import _block_rows, _rows_to_block

    if isinstance(block, dict):
        return {k: np.asarray(v)[idx] for k, v in block.items()}
    rows = _block_rows(block)
    return _rows_to_block([rows[i] for i in idx])


def _sample_boundaries(blocks: List, key: KeyT, n: int,
                       sample_per_block: int = 64) -> List[Any]:
    """Approximate range boundaries from per-block key samples."""
    samples: List[Any] = []
    for b in blocks:
        kv = _key_values(b, key)
        if len(kv) == 0:
            continue
        take = min(sample_per_block, len(kv))
        sel = np.linspace(0, len(kv) - 1, take).astype(int)
        samples.extend(kv[sel].tolist())
    if not samples:
        return []
    samples.sort()
    return [samples[int(len(samples) * (i + 1) / n)]
            for i in range(n - 1) if int(len(samples) * (i + 1) / n) < len(samples)]


def _partition_block(block_or_ref, ops, n: int, mode: str, key, boundaries,
                     seed: int):
    """Stage-1 map task: apply pending ops, split into n partitions."""
    from ray_tpu_torch.data.datastream import _apply_ops, _block_len

    block = _apply_ops(block_or_ref, ops)
    m = _block_len(block)
    if m == 0:
        empty = _take_rows(block, np.array([], dtype=int))
        return tuple(empty for _ in range(n)) if n > 1 else empty
    if mode == "sort":
        kv = _key_values(block, key)
        assign = np.array([bisect.bisect_right(boundaries, k) for k in kv.tolist()])
    elif mode == "hash":
        kv = _key_values(block, key)
        # process-independent hash: map tasks run in different worker
        # processes, where Python's salted hash() would scatter equal keys
        assign = np.array([_stable_hash(k) % n for k in kv.tolist()])
    else:  # random
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, n, size=m)
    parts = tuple(_take_rows(block, np.nonzero(assign == p)[0])
                  for p in range(n))
    return parts if n > 1 else parts[0]


def _merge_partition(mode: str, key, seed: int, *pieces):
    """Stage-2 reduce task: merge this partition's pieces from every map."""
    from ray_tpu_torch.data.datastream import _block_len, _concat_blocks

    merged = _concat_blocks(list(pieces))
    m = _block_len(merged)
    if m == 0:
        return merged
    if mode == "sort":
        kv = _key_values(merged, key)
        order = np.argsort(kv, kind="stable")
        return _take_rows(merged, order)
    if mode == "random":
        rng = np.random.default_rng(seed)
        return _take_rows(merged, rng.permutation(m))
    return merged  # hash: grouping only needs co-location


def shuffle_refs(block_refs: List, ops, *, mode: str, key: Optional[KeyT] = None,
                 num_partitions: Optional[int] = None,
                 seed: Optional[int] = None) -> List:
    """Run the two-stage exchange; returns the new block refs."""
    n_in = len(block_refs)
    n = num_partitions or max(1, n_in)
    boundaries: List[Any] = []
    if mode == "sort":
        # boundary sampling needs materialized key columns: run the pending
        # ops once on a sample of blocks (they re-run in stage 1; cheap
        # relative to the exchange, same trade the reference makes).
        probe = [_apply_remote.remote(r, ops) for r in block_refs[:8]]
        boundaries = _sample_boundaries(ray_tpu_torch.get(probe), key, n)
        n = len(boundaries) + 1

    part = ray_tpu_torch.remote(_partition_block).options(num_returns=n)
    # unseeded shuffles must differ between calls (per-epoch reshuffling)
    base_seed = seed if seed is not None else int(
        np.random.SeedSequence().entropy % (2 ** 31))
    partss = []
    for i, ref in enumerate(block_refs):
        out = part.remote(ref, ops, n, mode, key, boundaries, base_seed + i)
        partss.append([out] if n == 1 else out)

    merge = ray_tpu_torch.remote(_merge_partition)
    return [merge.remote(mode, key, base_seed + 7919 * p,
                         *[parts[p] for parts in partss])
            for p in range(n)]


@ray_tpu_torch.remote
def _apply_remote(block_or_ref, ops):
    from ray_tpu_torch.data.datastream import _apply_ops

    return _apply_ops(block_or_ref, ops)
