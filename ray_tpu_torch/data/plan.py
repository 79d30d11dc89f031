"""Logical plan + optimizer passes for Datastream.

Mirrors the reference's logical-plan layer (`python/ray/data/_internal/
logical/`): transforms append LOGICAL operators; before execution the chain
runs through rule passes, then LOWERS to the physical fused-op list the
block executor runs. Rules are small, unit-testable rewrites — fusion and
pushdowns are explicit passes, not side effects of how transforms happen to
be recorded.

Logical operators (tuples, like the physical ops they extend):
  ("map", fn) ("flat_map", fn) ("filter", fn) ("map_batches", fn)
  ("project", {"select": [..]} | {"drop": [..]} | {"rename": {..}})
  ("filter_expr", ColumnPredicate)   # pushable into parquet readers
  ("limit", n)

Passes:
  ProjectionFusion  — adjacent projections collapse into one (a
                      select+rename+drop chain becomes a single block pass)
  LimitPushdown     — a limit hops backwards over 1:1 row-preserving ops
                      (map / project), so expensive UDFs run on at most n
                      rows instead of whole blocks
  CountProjection   — used by count(): trailing count-preserving ops are
                      dropped entirely (a map-only chain counts SOURCE
                      blocks without running any UDF)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["optimize", "lower", "ops_for_count", "explain_ops",
           "ROW_PRESERVING"]

# ops that neither add nor remove rows (1:1): limits and counts commute
ROW_PRESERVING = frozenset({"map", "project"})


# ------------------------------------------------------------------- rules


def _fuse_projections(ops: List[tuple]) -> Tuple[List[tuple], bool]:
    """Merge adjacent ("project", spec) ops into one composite spec."""
    out: List[tuple] = []
    changed = False
    for op in ops:
        if op[0] == "project" and out and out[-1][0] == "project":
            out[-1] = ("project", _compose_projections(out[-1][1], op[1]))
            changed = True
        else:
            out.append(op)
    return out, changed


def _compose_projections(first: Dict[str, Any],
                         second: Dict[str, Any]) -> Dict[str, Any]:
    """One spec equivalent to applying `first` then `second`. Specs are
    kept as an ordered STEP LIST under "steps" once composed (projection
    algebra over arbitrary select/drop/rename chains is simplest as a
    pipeline; the win is one block pass + one op slot, and further rules
    see a single op)."""
    steps = list(first.get("steps") or [first])
    steps += list(second.get("steps") or [second])
    return {"steps": steps}


def _limit_pushdown(ops: List[tuple]) -> Tuple[List[tuple], bool]:
    """Move each limit before any immediately-preceding row-preserving op:
    [map, limit n] == [limit n, map] with the map touching <= n rows."""
    ops = list(ops)
    changed = False
    for i in range(1, len(ops)):
        if ops[i][0] == "limit" and ops[i - 1][0] in ROW_PRESERVING:
            ops[i - 1], ops[i] = ops[i], ops[i - 1]
            changed = True
    return ops, changed


_RULES: List[Tuple[str, Callable[[List[tuple]], Tuple[List[tuple], bool]]]] = [
    ("ProjectionFusion", _fuse_projections),
    ("LimitPushdown", _limit_pushdown),
]


def optimize(ops: List[tuple]) -> Tuple[List[tuple], List[str]]:
    """Run rule passes to fixpoint; returns (ops, applied rule names)."""
    applied: List[str] = []
    for _ in range(len(ops) + 2):  # fixpoint bound: each pass strictly shrinks/reorders
        any_change = False
        for name, rule in _RULES:
            ops, changed = rule(ops)
            if changed:
                any_change = True
                if name not in applied:
                    applied.append(name)
        if not any_change:
            break
    return ops, applied


def ops_for_count(ops: List[tuple]) -> Tuple[List[tuple], bool]:
    """CountProjection: drop trailing count-preserving ops — counting rows
    needs only the prefix that can change row counts. Returns (ops,
    applied)."""
    n = len(ops)
    while n > 0 and ops[n - 1][0] in ROW_PRESERVING:
        n -= 1
    return list(ops[:n]), n != len(ops)


# ------------------------------------------------------------------ lower


def _project_fn(spec: Dict[str, Any]) -> Callable:
    steps = spec.get("steps") or [spec]

    def run(block):
        for st in steps:
            if "select" in st:
                keep = st["select"]
                block = {k: block[k] for k in keep}
            elif "drop" in st:
                dropped = set(st["drop"])
                block = {k: v for k, v in block.items() if k not in dropped}
            elif "rename" in st:
                m = st["rename"]
                block = {m.get(k, k): v for k, v in block.items()}
        return block

    return run


def lower(ops: List[tuple]) -> List[tuple]:
    """Logical -> physical: projections become one batched block fn; the
    executor-side kinds (map/map_batches/flat_map/filter/limit) pass
    through."""
    out: List[tuple] = []
    for op in ops:
        if op[0] == "project":
            out.append(("map_batches", _project_fn(op[1])))
        else:
            out.append(op)
    return out


# ----------------------------------------------------------------- explain


def _op_label(op: tuple) -> str:
    kind = op[0]
    if kind == "project":
        spec = op[1]
        steps = spec.get("steps") or [spec]
        return "Project[%s]" % "+".join(next(iter(s)) for s in steps)
    if kind == "filter_expr":
        return f"Filter[{op[1]!r}]"
    if kind == "limit":
        return f"Limit[{op[1]}]"
    fn = op[1]
    name = getattr(fn, "__name__", type(fn).__name__)
    return f"{kind.title().replace('_', '')}({name})"


def explain_ops(num_blocks: int, logical: List[tuple],
                source_desc: str = None) -> str:
    optimized, applied = optimize(list(logical))
    physical = lower(optimized)
    lines = [source_desc or f"Source[{num_blocks} blocks]"]
    lines += [f"  -> {_op_label(op)}" for op in logical]
    lines.append("Optimized (rules: %s):" % (", ".join(applied) or "none"))
    lines += [f"  -> {_op_label(op)}" for op in optimized]
    lines.append("Physical ops: [%s]" % ", ".join(op[0] for op in physical))
    return "\n".join(lines)
