"""In-process multi-node test cluster.

Equivalent of the reference's `ray.cluster_utils.Cluster`
(`python/ray/cluster_utils.py:99`, `add_node:165`, `remove_node:238`): run
multiple raylets on one machine so multi-node semantics — spillback, node
death, cross-node object transfer, placement groups — are testable without
real hosts. `remove_node` simulates node failure by hard-stopping the raylet
(its workers are killed), exercising the GCS health-check + actor-restart
paths.
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch.core.gcs import GcsServer, StandbyHead
from ray_tpu_torch.core.raylet import Raylet


class Cluster:
    def __init__(self, gcs_snapshot_path: Optional[str] = None,
                 snapshot_uri: Optional[str] = None):
        """`snapshot_uri` selects the control-plane SnapshotStore
        ("file://<dir>" / "memory://<name>"); `gcs_snapshot_path` is the
        legacy file spelling. Either enables `restart_gcs()` (same
        address), `replace_head()` (NEW address) and the standby-head
        paths (`start_standby()` / `rolling_head_upgrade()`)."""
        self.gcs = GcsServer(snapshot_path=gcs_snapshot_path,
                             snapshot_uri=snapshot_uri)
        self.gcs.start()
        self._raylets: list[Raylet] = []
        self._standbys: list[StandbyHead] = []
        self.head: Optional[Raylet] = None

    @property
    def gcs_address(self) -> str:
        return self.gcs.address

    def add_node(
        self,
        num_cpus: float = 1,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
    ) -> Raylet:
        r = dict(resources or {})
        r.setdefault("CPU", float(num_cpus))
        raylet = Raylet(
            gcs_address=self.gcs.address,
            resources=r,
            labels=labels,
            object_store_memory=object_store_memory,
        )
        raylet.start()
        self._raylets.append(raylet)
        if self.head is None:
            self.head = raylet
        return raylet

    def connect(self, **init_kwargs):
        """Connect the current process as a driver to this cluster."""
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.gcs.address, **init_kwargs)

    def restart_gcs(self) -> None:
        """Kill and restart the GCS on the SAME address (reference
        test_gcs_fault_tolerance.py pattern): raylets, drivers and actor
        workers detect the drop and re-register over their reconnecting
        clients, rebuilding live cluster state."""
        host, port = self.gcs.address.rsplit(":", 1)
        snapshot_uri = self.gcs._snapshot_uri
        self.gcs.stop()
        self.gcs = GcsServer(host=host, snapshot_uri=snapshot_uri,
                             port=int(port))
        self.gcs.start()

    def kill_head(self) -> None:
        """Crash-stop the GCS (no final snapshot flush, links just drop) —
        the failure a replacement head must recover from."""
        self.gcs.kill()

    def replace_head(self) -> str:
        """Start a REPLACEMENT GCS on a NEW address (control-plane HA): it
        restores node/actor/PG/KV state from the snapshot store, dials the
        snapshot-known raylets to announce its address, and the fleet
        (raylets, workers, drivers) re-registers over re-resolving
        reconnecting clients with backoff. Call `kill_head()` first to
        simulate the loss; returns the new GCS address."""
        host = self.gcs.address.rsplit(":", 1)[0]
        snapshot_uri = self.gcs._snapshot_uri
        if not snapshot_uri:
            raise ValueError("replace_head() needs a snapshot store "
                             "(pass snapshot_uri= to Cluster)")
        if not self.gcs._shutdown.is_set():
            self.gcs.kill()
        self.gcs = GcsServer(host=host, snapshot_uri=snapshot_uri, port=0)
        return self.gcs.start()

    def start_standby(self) -> StandbyHead:
        """Start a warm standby head tailing this cluster's snapshot store:
        it promotes itself (lease-epoch CAS) when the active head's lease
        expires or is relinquished. `adopt_promoted()` swaps it in as
        `self.gcs` once promoted."""
        uri = self.gcs._snapshot_uri
        if not uri:
            raise ValueError("standby head needs a snapshot store "
                             "(pass snapshot_uri= to Cluster)")
        standby = StandbyHead(uri, host=self.gcs.address.rsplit(":", 1)[0])
        standby.start()
        self._standbys.append(standby)
        return standby

    def adopt_promoted(self, standby: StandbyHead,
                       timeout: float = 60.0) -> str:
        """Wait for `standby` to promote and install it as this cluster's
        head. Returns the new GCS address."""
        promoted = standby.wait_promoted(timeout)
        if promoted is None:
            raise TimeoutError("standby did not promote within "
                               f"{timeout}s: {standby.stats()}")
        self.gcs = promoted
        return promoted.address

    def rolling_head_upgrade(self, timeout: float = 60.0) -> str:
        """Zero-downtime head upgrade: start a standby, DRAIN the active
        head's lease (expire it now, no TTL wait), let the standby promote
        via the epoch CAS and re-adopt the fleet, then retire the old head
        (no final flush — the store belongs to the new epoch). In-flight
        work rides worker/raylet links throughout; control-plane calls
        retry across the switchover. Returns the new GCS address."""
        old = self.gcs
        standby = self.start_standby()
        old._write_snapshot()  # hand over the freshest possible state
        old.drain_lease()
        address = self.adopt_promoted(standby, timeout)
        old.retire()
        return address

    def remove_node(self, raylet: Raylet) -> None:
        """Simulate node failure: kill raylet + its workers abruptly."""
        self._raylets.remove(raylet)
        if self.head is raylet:
            self.head = self._raylets[0] if self._raylets else None
        raylet.stop()
        # Tell GCS immediately instead of waiting for the health timeout so
        # tests are fast; the timeout path is tested separately.
        import ray_tpu_torch.core.rpc as rpc

        try:
            c = rpc.connect_with_retry(self.gcs.address, timeout=5)
            c.call("drain_node", {"node_id": raylet.node_id.binary()})
            c.close()
        except Exception:
            pass

    def shutdown(self) -> None:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        for s in self._standbys:
            try:
                s.stop()
                # a promoted-but-never-adopted standby owns a live GcsServer
                if s.promoted is not None and s.promoted is not self.gcs:
                    s.promoted.stop()
            except Exception:
                pass
        self._standbys.clear()
        for r in self._raylets:
            try:
                r.stop()
            except Exception:
                pass
        self._raylets.clear()
        self.gcs.stop()
