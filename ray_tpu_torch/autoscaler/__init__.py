"""The autoscaler's core: `StandardAutoscaler` (demand-driven launches and
dead-node reap-and-replace) over the `NodeProvider` interface, with
`FakeNodeProvider`'s in-process raylets. The cloud providers for GPU hosts
and the cluster launcher that drives them are still to port (ROADMAP.md,
A.8)."""

from ray_tpu_torch.autoscaler.autoscaler import NodeType, StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (FakeNodeProvider,
                                                    NodeProvider)

__all__ = ["FakeNodeProvider", "NodeProvider", "NodeType",
           "StandardAutoscaler"]
