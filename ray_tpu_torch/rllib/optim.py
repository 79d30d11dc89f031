"""Optimizer transforms for the Learner stack: optax's shape over dicts of
tensors.

The reference's learners build `optax.adam` and `optax.rmsprop` and compose
them with `optax.multi_transform` (ray_tpu/rllib/learner.py:119,
impala.py:123, learner.py:59-84); its Decision Transformer trains with
`optax.adamw` (dt.py:190). The card's host has no optax, so these
are its transforms written out in torch, op for op as optax 0.2.6 computes
them in float32:

- `adam(lr, b1, b2, eps)`: `scale_by_adam` then `scale(-lr)`.
  mu = (1 - b1)·g + b1·mu, nu = (1 - b2)·g² + b2·nu, count += 1,
  mu_hat = mu / (1 - b1^count), nu_hat = nu / (1 - b2^count) (the
  correction's power taken in float32, as optax takes it),
  u = mu_hat / (sqrt(nu_hat) + eps), then u·(-lr).
- `adamw(lr, b1, b2, eps, weight_decay)`: optax's defaults and order —
  `scale_by_adam`, then decoupled weight decay on every leaf (no mask),
  u + weight_decay·p, then `scale(-lr)`.
- `rmsprop(lr, decay, eps)`: optax's defaults (no centering, no momentum,
  no bias correction, `eps_in_sqrt=True`): nu = (1 - decay)·g² + decay·nu,
  u = g·rsqrt(nu + eps), then u·(-lr).
- `multi_transform(transforms, labels)`: each leaf updated by the
  transform its label names, each transform's state over its own leaves.
- `apply_updates(params, updates)`: p + u, in p's dtype, as new tensors
  (the old ones are never written).

A tree is a dict of tensors, nested dicts allowed; a transform is a
`GradientTransformation(init, update)` with `update(grads, state, params)
-> (updates, state)`, as in optax. Nothing here records autograd: the
Learner calls `update` under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import torch

__all__ = ["GradientTransformation", "adam", "adamw", "rmsprop",
           "multi_transform",
           "apply_updates", "tree_map", "tree_items", "tree_from_items"]


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts (every tree of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix=""):
    """(path, leaf) of nested dicts in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in float32 (optax's `tree_bias_correction`)."""
    return 1 - torch.tensor(decay, dtype=torch.float32,
                            device=count.device) ** count


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return adamw(learning_rate, b1, b2, eps, weight_decay=None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: Union[float, None] = 1e-4
          ) -> GradientTransformation:
    """optax.adamw (with `weight_decay=None`, optax.adam, which has no
    decay step at all)."""

    def init(params):
        leaf = next((v for _, v in tree_items(params)), None)
        return ScaleByAdamState(
            torch.zeros((), dtype=torch.int32,
                        device=None if leaf is None else leaf.device),
            tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g ** 2) + b2 * t, grads,
                      state.nu)
        count = state.count + 1
        c1, c2 = _correction(b1, count), _correction(b2, count)
        updates = tree_map(
            lambda m, v: (m / c1.to(m.dtype))
            / (torch.sqrt(v / c2.to(v.dtype)) + eps), mu, nu)
        if weight_decay is not None:
            updates = tree_map(lambda u, p: u + weight_decay * p, updates,
                               params)
        updates = tree_map(lambda u: u * -learning_rate, updates)
        return updates, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


class ScaleByRmsState(NamedTuple):
    nu: Any


def rmsprop(learning_rate: float, decay: float = 0.9,
            eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByRmsState(tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        nu = tree_map(lambda g, t: (1 - decay) * (g ** 2) + decay * t, grads,
                      state.nu)
        updates = tree_map(lambda g, n: torch.rsqrt(n + eps) * g, grads, nu)
        updates = tree_map(lambda u: u * -learning_rate, updates)
        return updates, ScaleByRmsState(nu)

    return GradientTransformation(init, update)


def _labels_of(labels, params) -> Dict[str, str]:
    tree = labels(params) if callable(labels) else labels
    return dict(tree_items(tree))


def _select(tree, paths) -> Dict[str, Any]:
    """The leaves of `tree` at `paths`, as a flat dict by path."""
    leaves = dict(tree_items(tree))
    return {p: leaves[p] for p in paths}


def tree_from_items(flat: Dict[str, Any]):
    """Nested dicts from {"a/b": leaf} (`tree_items`'s inverse)."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class MultiTransformState(NamedTuple):
    inner_states: Dict[str, Any]


def multi_transform(transforms: Dict[str, GradientTransformation],
                    param_labels: Union[Any, Callable[[Any], Any]]
                    ) -> GradientTransformation:
    """optax.multi_transform: leaf by leaf, the transform its label names;
    each transform sees (and keeps state over) only its own leaves."""

    def groups(params):
        labels = _labels_of(param_labels, params)
        missing = set(labels.values()) - set(transforms)
        if missing:
            raise ValueError(f"no transform for labels {sorted(missing)}")
        return {name: [p for p, lab in labels.items() if lab == name]
                for name in transforms}

    def init(params):
        return MultiTransformState({
            name: transforms[name].init(
                tree_from_items(_select(params, paths)))
            for name, paths in groups(params).items()})

    def update(grads, state, params=None):
        flat: Dict[str, Any] = {}
        inner = {}
        for name, paths in groups(grads).items():
            sub_params = (None if params is None
                          else tree_from_items(_select(params, paths)))
            upd, inner[name] = transforms[name].update(
                tree_from_items(_select(grads, paths)),
                state.inner_states[name], sub_params)
            flat.update(_select(upd, paths))
        order = [p for p, _ in tree_items(grads)]
        updates = tree_from_items({p: flat[p] for p in order})
        return updates, MultiTransformState(inner)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates, each leaf in its param's dtype (optax's
    `apply_updates`), as new tensors."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
