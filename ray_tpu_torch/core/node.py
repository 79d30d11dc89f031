"""Node assembly: boot GCS + raylet for a head node.

Equivalent of the reference's `python/ray/_private/node.py` process
supervisor (`start_head_processes:1139`), redesigned: GCS and raylet are
asyncio servers on threads inside one process rather than separate C++
binaries — worker processes are still real subprocesses. `Cluster`
(cluster.py) adds more raylets for multi-node semantics.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.raylet import Raylet
from ray_tpu_torch.core.scheduler import NVLINK_DOMAIN_LABEL


def default_node_resources(num_cpus: Optional[int] = None,
                           resources: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    r = dict(resources or {})
    r.setdefault("CPU", float(num_cpus if num_cpus is not None else (os.cpu_count() or 1)))
    return r


def detect_gpu_labels() -> Dict[str, str]:
    """Detect the host's NVLink domain label, if any: from the environment
    (`RAY_TPU_TORCH_NVLINK_DOMAIN`) only, so detection never initializes
    CUDA in the node's process."""
    labels: Dict[str, str] = {}
    if os.environ.get("RAY_TPU_TORCH_NVLINK_DOMAIN"):
        labels[NVLINK_DOMAIN_LABEL] = os.environ["RAY_TPU_TORCH_NVLINK_DOMAIN"]
    return labels


class HeadNode:
    def __init__(
        self,
        num_cpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
    ):
        self._gcs = GcsServer()
        self._resources = default_node_resources(num_cpus, resources)
        self._labels = {**detect_gpu_labels(), **(labels or {})}
        self._object_store_memory = object_store_memory
        self._raylet: Optional[Raylet] = None

    def start(self) -> None:
        self._gcs.start()
        self._raylet = Raylet(
            gcs_address=self._gcs.address,
            resources=dict(self._resources),
            labels=self._labels,
            object_store_memory=self._object_store_memory,
        )
        self._raylet.start()

    @property
    def gcs_address(self) -> str:
        return self._gcs.address

    @property
    def raylet_address(self) -> str:
        return self._raylet.address

    @property
    def gcs(self) -> GcsServer:
        return self._gcs

    @property
    def raylet(self) -> Raylet:
        return self._raylet

    def stop(self) -> None:
        if self._raylet is not None:
            self._raylet.stop()
        self._gcs.stop()
