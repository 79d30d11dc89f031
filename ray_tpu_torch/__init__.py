"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The layout mirrors ``ray_tpu/`` so each module's counterpart is found under
the same path. Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas is a hand-written CUDA kernel under ``ops/kernels/csrc``,
built with nvcc at first use. The package imports torch and numpy only —
never jax, never ray_tpu.

Entry points of the device layer take an explicit ``device`` and default
to ``"cuda"``; on a machine without CUDA they raise rather than fall back
to the CPU.

The distributed runtime (``core/``, ``util/``, ``client/``) is ray_tpu's,
with the chip grant a GPU grant::

    import ray_tpu_torch as ray
    ray.init(num_cpus=8, resources={"GPU": 1})
    @ray.remote(num_gpus=1)
    def f(x): return x + 1          # ray.get_gpu_ids() == [0] in here
    ray.get(f.remote(1))

Serve (``ray_tpu_torch.serve``) runs on it; a replica takes a card with
``ray_actor_options={"num_gpus": 1}``.

Its API below is bound lazily (PEP 562), so ``import ray_tpu_torch``
loads neither the runtime nor torch.
"""

from ray_tpu_torch._version import __version__

_API = {
    "core.api": (
        "get_gpu_ids", "init", "shutdown", "is_initialized", "remote",
        "get", "put", "push", "wait", "kill", "cancel", "get_actor",
        "method", "nodes", "cluster_resources", "available_resources",
        "get_runtime_context", "timeline"),
    "core.object_ref": ("ObjectRef", "ObjectRefGenerator"),
    "core.actor": ("ActorClass", "ActorHandle"),
    "core.exceptions": (
        "RayTpuError", "TaskError", "ActorError", "ActorDiedError",
        "OutOfMemoryError", "WorkerCrashedError", "ObjectLostError",
        "GetTimeoutError", "PlacementInfeasibleError", "RequestTimeoutError",
        "BackPressureError"),
}
_LAZY = {name: mod for mod, names in _API.items() for name in names}

__all__ = (["__version__"] + list(_LAZY)
           + ["models", "ops", "parallel", "train", "bench", "bridge",
              "multichip", "util", "serve"])


def __getattr__(name):
    import importlib

    mod = _LAZY.get(name)
    if mod is not None:
        value = getattr(importlib.import_module(f"ray_tpu_torch.{mod}"), name)
        globals()[name] = value
        return value
    if name in ("util", "serve"):
        # `ray_tpu_torch.util` and `.serve` like the reference's `ray.util`
        # and `ray.serve`
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
