"""Node providers: the pluggable cloud interface.

Mirrors the reference's `NodeProvider` plugin surface
(`python/ray/autoscaler/node_provider.py:13`; aws/gcp/... subclasses).
`FakeNodeProvider` launches real in-process raylets (the reference's
`FakeMultiNodeProvider`, `fake_multi_node/node_provider.py:237`), so the
autoscaler's end-to-end behavior (and the node and partition storms of
`core/burst.py`) is testable on one machine. Cloud providers for GPU hosts
come with the cluster launcher (ROADMAP.md, A.8).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List


class NodeProvider:
    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Backs node launches with in-process raylets joined to a real GCS."""

    def __init__(self, gcs_address: str):
        self.gcs_address = gcs_address
        self._nodes: Dict[str, Any] = {}
        # partition chaos: ids whose terminate_node must NOT actually kill
        # the raylet — it leaves the provider listing (the cloud API
        # accepted the delete) while the process lives on (the API can't
        # reach the partitioned host). The zombie is what incarnation
        # fencing exists for; the harness releases it at heal time.
        self._hold_termination: set = set()
        self._zombies: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        from ray_tpu_torch.core.raylet import Raylet

        raylet = Raylet(gcs_address=self.gcs_address,
                        resources=dict(resources), labels=dict(labels))
        # the raylet registers with the GCS inside start(), so the GCS
        # view leads the provider listing by a beat: a node is listed here
        # only once fully booted (observers picking kill victims off
        # non_terminated_nodes() must never get a mid-boot raylet)
        try:
            raylet.start()
        except Exception:
            # a boot that failed after registering must not linger as a
            # heartbeating ghost the provider denies owning
            try:
                raylet.stop()
            except Exception:
                pass
            raise
        pid = f"fake-{node_type}-{uuid.uuid4().hex[:8]}"
        with self._lock:
            self._nodes[pid] = raylet
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        """Idempotent: terminating an already-gone id (double reap after a
        node self-died) is a no-op, and a crashed raylet's teardown errors
        are swallowed — the node is dead either way."""
        with self._lock:
            raylet = self._nodes.pop(provider_node_id, None)
            if raylet is not None \
                    and provider_node_id in self._hold_termination:
                # partitioned host: the delete "succeeds" at the API but
                # can't reach the process — a zombie raylet survives
                self._zombies[provider_node_id] = raylet
                return
        if raylet is not None:
            try:
                raylet.stop()
            except Exception:
                pass  # already crashed (kill_node); nothing left to stop

    def hold_termination(self, provider_node_id: str) -> None:
        """Arm the partition-zombie behavior for one node (see
        _hold_termination)."""
        with self._lock:
            self._hold_termination.add(provider_node_id)

    def release_zombie(self, provider_node_id: str):
        """Heal-side cleanup: stop holding the zombie's termination.
        Returns the still-running raylet (the harness keeps it alive to
        prove fencing, then stops it) or None."""
        with self._lock:
            self._hold_termination.discard(provider_node_id)
            return self._zombies.pop(provider_node_id, None)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def raylet_for(self, provider_node_id: str):
        return self._nodes.get(provider_node_id)

    def kill_node(self, provider_node_id: str, vanish: bool = False) -> None:
        """Chaos: whole-node SIGKILL — the raylet, its workers and its fork
        templates die together, with NO drain notify. With `vanish=False`
        the corpse stays listed (a crashed VM the cloud API still shows —
        the autoscaler must terminate-and-replace it); with `vanish=True`
        it also leaves the provider view (a preempted slice)."""
        with self._lock:
            raylet = (self._nodes.pop(provider_node_id, None) if vanish
                      else self._nodes.get(provider_node_id))
        if raylet is not None:
            raylet.crash()
