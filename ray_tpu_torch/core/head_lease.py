"""Head lease + fencing tokens over the SnapshotStore.

The coordination primitive behind the standby head (ROADMAP item 5; the
role etcd/Redis leader election plays for the reference's HA GCS,
`gcs_server.h` + the Ray 2.x GCS fault-tolerance design): the ACTIVE head
holds a TTL lease stored beside the versioned snapshots, renewing it every
ttl/3; a STANDBY head tails the snapshot stream and, when the lease
expires (crash) or is relinquished (rolling upgrade), takes over by
bumping the lease **epoch** — the fencing token.

The epoch is what makes takeover safe on a dumb blob store with no server
side CAS:

  * every ownership CHANGE increments the epoch; renewal never does;
  * acquire() is a compare-and-swap in the only way a keyed blob store
    allows: read (verify expired/expected epoch) -> write (epoch+1) ->
    settle -> re-read and verify we are still the recorded owner. Two
    racing claimants both write, exactly one survives the verify;
  * every fencing-relevant write the OLD head attempts afterwards
    (snapshot save, raylet-facing announce) carries its stale epoch and is
    REJECTED — `check()` raises `LeaseLostError` before a snapshot write,
    and raylets log-and-drop announces whose epoch trails the one they
    adopted. A revived stale head cannot split the brain; its writes
    bounce instead of racing.

`fault_point("lease_renew")` fires before the renewal WRITE (after the
fencing read), so a seeded `drop:lease_renew` rule models lost renewals —
the lease expires under a perfectly healthy head and the standby promotes
— while fencing discovery (reading a bumped epoch) still works.
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
import uuid
from typing import Optional

from ray_tpu_torch.core.snapshot_store import (SnapshotCorruptError, SnapshotStore,
                                         decode_blob, encode_blob)

logger = logging.getLogger(__name__)

# Lives beside the "gcs-<seq>" snapshot keys; VersionedSnapshots skips
# non-numeric tails, so the lease never collides with version pruning.
LEASE_KEY = "gcs-lease"


class LeaseLostError(RuntimeError):
    """The store's lease epoch advanced past ours: a newer head took over.
    The holder is FENCED — it must stop writing and retire."""


class LeaseHeldError(RuntimeError):
    """Acquire refused: another owner's lease is still live."""


def new_owner_token() -> str:
    """Unique per-process-instance owner identity (an address is not
    enough: a restarted head on the same address is a DIFFERENT holder)."""
    return uuid.uuid4().hex[:12]


class HeadLease:
    def __init__(self, store: SnapshotStore, key: str = LEASE_KEY,
                 ttl_s: Optional[float] = None):
        from ray_tpu_torch.core.config import get_config

        self.store = store
        self.key = key
        self.ttl_s = ttl_s if ttl_s is not None \
            else get_config().head_lease_ttl_s
        self._lock = threading.Lock()
        # holder's node endpoint, set by the owning head: gives the
        # lease_renew fault point a partition SIDE — a partition rule
        # cutting this origin from the "store" group starves renewals
        # exactly like a real head-in-minority network split
        self.origin: Optional[str] = None

    # ------------------------------------------------------------------ io
    def read(self) -> Optional[dict]:
        blob = self.store.get(self.key)
        if blob is None:
            return None
        try:
            return pickle.loads(decode_blob(blob))
        except (SnapshotCorruptError, Exception) as e:  # torn/corrupt write
            logger.warning("head lease record unreadable (%s); treating as "
                           "absent", e)
            return None

    def _write(self, record: dict) -> None:
        self.store.put(self.key, encode_blob(
            pickle.dumps(record, protocol=5)))

    # ------------------------------------------------------------ protocol
    def acquire(self, owner: str, expect_epoch: Optional[int] = None,
                force: bool = False, settle_s: float = 0.05,
                floor: int = 0) -> int:
        """Take the lease, bumping the fencing epoch. Without `force` the
        current lease must be expired (or already ours); `expect_epoch`
        additionally demands the epoch we SAW expire is still the recorded
        one (a standby must not promote over a head that renewed in the
        window). `floor` guards against a torn/lost lease RECORD resetting
        the epoch: callers pass (last epoch seen in the snapshot stream)+1
        so the new epoch can never trail one the fleet already adopted.
        Returns the new epoch; raises LeaseHeldError / LeaseLostError when
        the claim is refused or lost to a racer."""
        with self._lock:
            cur = self.read()
            now = time.time()
            if cur is not None and not force and cur.get("owner") != owner:
                if cur.get("expires_at", 0.0) > now:
                    raise LeaseHeldError(
                        f"lease epoch {cur.get('epoch')} held by "
                        f"{cur.get('owner')} for another "
                        f"{cur.get('expires_at', 0.0) - now:.2f}s")
                if expect_epoch is not None \
                        and cur.get("epoch") != expect_epoch:
                    raise LeaseLostError(
                        f"lease advanced to epoch {cur.get('epoch')} past "
                        f"the observed {expect_epoch}")
            epoch = max(
                (int(cur.get("epoch", 0)) + 1) if cur is not None else 1,
                floor)
            self._write({
                "epoch": epoch, "owner": owner,
                "expires_at": now + self.ttl_s, "renewed_at": now,
                "acquired_at": now,
            })
        # CAS verify: on a dumb store two claimants can both write; after a
        # settle window exactly one is the recorded owner.
        if settle_s > 0:
            time.sleep(settle_s)
        check = self.read()
        if check is None or check.get("owner") != owner \
                or check.get("epoch") != epoch:
            raise LeaseLostError(
                f"acquire of epoch {epoch} lost to "
                f"{check.get('owner') if check else 'a deleted record'}")
        return epoch

    def renew(self, owner: str, epoch: int, **extra) -> None:
        """Extend the TTL of a lease we hold. Reads FIRST so a bumped epoch
        is discovered (LeaseLostError -> the holder fences itself) even
        when our own writes are being dropped; the injected `lease_renew`
        fault fires between the fencing read and the write."""
        from ray_tpu_torch.core import rpc

        with self._lock:
            cur = self.read()
            if cur is not None and (
                    int(cur.get("epoch", 0)) > epoch
                    or (int(cur.get("epoch", 0)) == epoch
                        and cur.get("owner") != owner)):
                raise LeaseLostError(
                    f"lease epoch advanced to {cur.get('epoch')} "
                    f"(owner {cur.get('owner')}); this head holds stale "
                    f"epoch {epoch}")
            if cur is not None and cur.get("relinquished"):
                # an in-flight renewal racing drain_lease() must not
                # resurrect the relinquished lease for a full TTL — the
                # whole point of relinquish is "a standby may take over NOW"
                return
            rpc.fault_point("lease_renew", origin=self.origin, dest="store")
            now = time.time()
            rec = {"epoch": epoch, "owner": owner,
                   "expires_at": now + self.ttl_s, "renewed_at": now,
                   "acquired_at": (cur or {}).get("acquired_at", now)}
            rec.update(extra)
            self._write(rec)

    def relinquish(self, owner: str, epoch: int) -> None:
        """Rolling-upgrade handoff: expire the lease NOW (epoch unchanged)
        so a standby promotes immediately instead of waiting out the TTL.
        The caller must stop renewing first."""
        with self._lock:
            cur = self.read()
            if cur is not None and int(cur.get("epoch", 0)) > epoch:
                raise LeaseLostError(
                    f"cannot relinquish epoch {epoch}: store already at "
                    f"{cur.get('epoch')}")
            now = time.time()
            self._write({"epoch": epoch, "owner": owner,
                         "expires_at": now, "renewed_at": now,
                         "relinquished": True,
                         "acquired_at": (cur or {}).get("acquired_at", now)})

    def check(self, epoch: int) -> None:
        """Fencing gate for durable writes: raises LeaseLostError when the
        store's epoch has advanced past `epoch` (a newer head owns the
        state; our write must be rejected, not raced)."""
        cur = self.read()
        if cur is not None and int(cur.get("epoch", 0)) > epoch:
            raise LeaseLostError(
                f"fenced: store lease at epoch {cur.get('epoch')}, "
                f"this head at {epoch}")
