"""The autoscaler: `StandardAutoscaler` (demand-driven launches and
dead-node reap-and-replace) over the `NodeProvider` interface, with
`FakeNodeProvider`'s in-process raylets and the GPU hosts of
`GceGpuNodeProvider` (Compute Engine) and `KubernetesGpuNodeProvider`
(`nvidia.com/gpu` Pods); `launcher` brings a cluster up and down from a
YAML (`python -m ray_tpu_torch up|down|exec|submit|attach`)."""

from ray_tpu_torch.autoscaler.autoscaler import NodeType, StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (FakeNodeProvider,
                                                    GceGpuNodeProvider,
                                                    KubernetesGpuNodeProvider,
                                                    NodeProvider)

__all__ = ["FakeNodeProvider", "GceGpuNodeProvider",
           "KubernetesGpuNodeProvider", "NodeProvider", "NodeType",
           "StandardAutoscaler"]
