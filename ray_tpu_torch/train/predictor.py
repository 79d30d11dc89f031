"""Predictor + BatchPredictor: checkpoint-to-inference bridge.

Mirrors the reference's `python/ray/train/predictor.py` and
`batch_predictor.py`: a `Predictor` wraps model state restored from an
AIR `Checkpoint` and maps input batches to prediction batches; a
`BatchPredictor` scales that over a `Datastream` with a pool of predictor
actors (the reference uses `Datastream.map_batches(..., compute=actors)`).

On the GPU: `TorchPredictor` (the reference's `JaxPredictor`) puts the
checkpoint's params on its device, the card unless the caller asks for
the CPU, and runs `apply_fn` eagerly under `torch.inference_mode()` (the
reference jits it), one call per block; `resources_per_actor={"GPU": 1}`
pins each predictor actor to a card of its own. Predictions come back as
numpy; numpy has no bfloat16, so a bf16 output comes back as float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """Base predictor: subclass with `_predict_numpy` or pass `predict_fn`."""

    def __init__(self, predict_fn: Optional[Callable] = None):
        self._predict_fn = predict_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self._predict_fn is None:
            raise NotImplementedError
        return self._predict_fn(batch)


def _to_device(tree: Any, device) -> Any:
    """`tree` (dicts, lists, tuples) with every numeric array or tensor
    leaf a tensor on `device`; other leaves as they are."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)) and tree.dtype.kind in "biufc":
        arr = np.ascontiguousarray(tree)
        if not arr.flags.writeable:  # a block read from the store is a view
            arr = arr.copy()
        return torch.from_numpy(arr).to(device)
    return tree


def _to_numpy(v: Any) -> np.ndarray:
    """A prediction as numpy: tensors through the host, bf16 as float32."""
    import torch

    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class TorchPredictor(Predictor):
    """Applies `apply_fn(params, batch) -> predictions` under
    `torch.inference_mode()`, with params restored from a checkpoint dict
    (key 'params' by convention, matching train.step's checkpointing) and
    put on `device` (the card by default), and each batch's arrays moved
    there as tensors."""

    def __init__(self, params: Any, apply_fn: Callable, *, device="cuda"):
        super().__init__()
        from ray_tpu_torch.ops.kernels._util import require_cuda

        self._device = require_cuda(device)
        self._params = _to_device(params, self._device)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, device="cuda") -> "TorchPredictor":
        data = checkpoint.to_dict()
        params = data.get("params", data)
        return cls(params, apply_fn, device=device)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        with torch.inference_mode():
            out = self._apply(self._params, _to_device(batch, self._device))
        if not isinstance(out, dict):
            out = {"predictions": out}
        return {k: _to_numpy(v) for k, v in out.items()}


@ray_tpu_torch.remote
class _PredictorActor:
    def __init__(self, predictor_cls, checkpoint: Checkpoint, kwargs: dict):
        self._predictor = predictor_cls.from_checkpoint(checkpoint, **kwargs)

    def predict(self, block) -> Any:
        if isinstance(block, dict):
            return self._predictor.predict(block)
        if not block:  # empty partition
            return []
        # row-list blocks: predict per row dict-of-scalars via a stacked batch
        batch = {k: np.asarray([r[k] for r in block]) for k in block[0]}
        out = self._predictor.predict(batch)
        n = len(block)
        return [{k: v[i] for k, v in out.items()} for i in range(n)]


class BatchPredictor:
    """Distributed inference over a Datastream
    (reference `batch_predictor.py`)."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kwargs):
        self._checkpoint = checkpoint
        self._cls = predictor_cls
        self._kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls,
                        **kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kwargs)

    def predict(self, data, *, num_actors: int = 2,
                resources_per_actor: Optional[Dict[str, float]] = None):
        """Map every block of `data` (Datastream) through predictor actors;
        returns a new Datastream of prediction blocks."""
        from ray_tpu_torch.data.datastream import Datastream

        opts: Dict[str, Any] = {}
        if resources_per_actor:
            opts["resources"] = dict(resources_per_actor)
        else:
            opts["num_cpus"] = 1
        actors = [
            _PredictorActor.options(**opts).remote(
                self._cls, self._checkpoint, self._kwargs)
            for _ in range(num_actors)]
        try:
            refs = data._executed_refs()
            out_refs = []
            for i, ref in enumerate(refs):
                actor = actors[i % num_actors]
                out_refs.append(actor.predict.remote(ref))
            blocks = ray_tpu_torch.get(out_refs)
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        return Datastream([ray_tpu_torch.put(b) for b in blocks])
