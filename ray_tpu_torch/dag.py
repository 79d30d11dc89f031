"""Lazy task DAGs: `.bind()` graphs executed on demand.

Mirrors the reference's `ray.dag` substrate (`python/ray/dag/dag_node.py`,
function_node/class_node/input_node): `fn.bind(...)` builds a node without
executing; `node.execute(input)` walks the graph submitting tasks with
upstream ObjectRefs as arguments, so the whole DAG runs as a pipelined set
of tasks. Serve's graph building composes on this.

Importing this module adds `.bind()` to the port's `RemoteFunction` and
`ActorClass` (only where they lack it; Serve's `Deployment.bind` is
Serve's own). A `ClassNode` of an actor asking for `num_gpus=1` runs on
the card its grant names, as any of the port's actors does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch


class DAGNode:
    def execute(self, *inputs):
        refs = self._execute(inputs, {})
        return refs

    def _execute(self, inputs, cache):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for the value passed at execute() time."""

    def __init__(self, index: int = 0):
        self.index = index

    def _execute(self, inputs, cache):
        return inputs[self.index]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs

    def _execute(self, inputs, cache):
        key = id(self)
        if key in cache:
            return cache[key]
        args = [a._execute(inputs, cache) if isinstance(a, DAGNode) else a
                for a in self._args]
        kwargs = {k: (v._execute(inputs, cache) if isinstance(v, DAGNode) else v)
                  for k, v in self._kwargs.items()}
        ref = self._fn.remote(*args, **kwargs)
        cache[key] = ref
        return ref


class ClassNode(DAGNode):
    """An actor instantiation in the graph; method calls become nodes."""

    def __init__(self, actor_cls, args, kwargs):
        self._cls = actor_cls
        self._args = args
        self._kwargs = kwargs
        self._handle = None

    def _get_handle(self, inputs, cache):
        if self._handle is None:
            args = [a._execute(inputs, cache) if isinstance(a, DAGNode) else a
                    for a in self._args]
            kwargs = {k: (v._execute(inputs, cache) if isinstance(v, DAGNode) else v)
                      for k, v in self._kwargs.items()}
            self._handle = self._cls.remote(*args, **kwargs)
        return self._handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)

    def _execute(self, inputs, cache):
        return self._get_handle(inputs, cache)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        self._class_node = class_node
        self._method = method
        self._args = args
        self._kwargs = kwargs

    def _execute(self, inputs, cache):
        key = id(self)
        if key in cache:
            return cache[key]
        handle = self._class_node._get_handle(inputs, cache)
        args = [a._execute(inputs, cache) if isinstance(a, DAGNode) else a
                for a in self._args]
        kwargs = {k: (v._execute(inputs, cache) if isinstance(v, DAGNode) else v)
                  for k, v in self._kwargs.items()}
        ref = getattr(handle, self._method).remote(*args, **kwargs)
        cache[key] = ref
        return ref


def _bind_function(remote_fn, *args, **kwargs) -> FunctionNode:
    return FunctionNode(remote_fn, args, kwargs)


def _bind_class(actor_cls, *args, **kwargs) -> ClassNode:
    return ClassNode(actor_cls, args, kwargs)


def install_bind() -> None:
    """Add `.bind()` to RemoteFunction and ActorClass (done at import)."""
    from ray_tpu_torch.core.actor import ActorClass
    from ray_tpu_torch.core.api import RemoteFunction

    if not hasattr(RemoteFunction, "bind"):
        RemoteFunction.bind = lambda self, *a, **k: _bind_function(self, *a, **k)
    if not hasattr(ActorClass, "bind"):
        ActorClass.bind = lambda self, *a, **k: _bind_class(self, *a, **k)


install_bind()
