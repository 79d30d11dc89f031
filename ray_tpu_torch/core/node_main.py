"""Standalone node daemon: `ray_tpu_torch start` entry.

Equivalent of the reference's `ray start` process assembly (SURVEY
appendix A, `python/ray/scripts/scripts.py:529`): `--head` runs GCS +
raylet in this process; otherwise a raylet joins an existing GCS.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch start")
    parser.add_argument("--head", action="store_true")
    parser.add_argument("--address", help="GCS address to join (worker node)")
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    parser.add_argument("--resources", default="{}",
                        help='extra resources JSON, e.g. \'{"GPU": 8}\'')
    parser.add_argument("--labels", default="{}",
                        help='node labels JSON, e.g. '
                             '\'{"nvlink_domain": "d0"}\'')
    parser.add_argument("--object-store-memory", type=int, default=None)
    parser.add_argument("--snapshot-path", default=None,
                        help="legacy file path for GCS persistence "
                             "(head only); prefer --snapshot-uri")
    parser.add_argument("--snapshot-uri", default=None,
                        help="SnapshotStore URI for control-plane HA "
                             "(file:///dir or memory://name, head only): a "
                             "replacement head restores node/actor/PG/KV "
                             "state from it, even on a new address")
    parser.add_argument("--standby", action="store_true",
                        help="run a warm STANDBY head: tail the snapshot "
                             "store (--snapshot-uri required), and take "
                             "over via the lease/fencing-epoch CAS when "
                             "the active head's lease expires or is "
                             "relinquished (sub-second promotion; "
                             "RAY_TPU_TORCH_HEAD_LEASE_TTL_S tunes the TTL)")
    parser.add_argument("--gcs-port", type=int, default=0,
                        help="fixed GCS port (head only; cluster-launcher "
                             "startup scripts need a known join address)")
    parser.add_argument("--gcs-host", default="127.0.0.1",
                        help="GCS bind host (head only; 0.0.0.0 for "
                             "clusters whose workers join over the network)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(level=args.log_level)
    resources = json.loads(args.resources)
    if args.num_cpus is not None:
        resources["CPU"] = args.num_cpus
    if args.num_gpus is not None:
        resources["GPU"] = args.num_gpus
    labels = json.loads(args.labels)

    from ray_tpu_torch.core.gcs import GcsServer, StandbyHead
    from ray_tpu_torch.core.node import default_node_resources, detect_gpu_labels
    from ray_tpu_torch.core.raylet import Raylet

    stop = {"flag": False}

    def handle(sig, frame):
        stop["flag"] = True

    if args.standby:
        # Standby head process: no raylet, no registrations — just the
        # snapshot tail + lease watch. On promotion it IS the head (its
        # promote_announce re-adopts the fleet); it serves until signaled.
        if not args.snapshot_uri:
            parser.error("--standby requires --snapshot-uri")
        standby = StandbyHead(args.snapshot_uri, host=args.gcs_host,
                              port=args.gcs_port)
        standby.start()
        print(f"ray_tpu_torch STANDBY head tailing {args.snapshot_uri} "
              f"(promotes when the active head's lease lapses)")
        signal.signal(signal.SIGINT, handle)
        signal.signal(signal.SIGTERM, handle)
        announced = False
        while not stop["flag"]:
            time.sleep(0.2)
            promoted = standby.promoted
            if promoted is not None and not announced:
                announced = True
                print(f"standby PROMOTED to active head. "
                      f"GCS address: {promoted.address} "
                      f"(epoch {promoted.fence_epoch})")
        standby.stop()
        if standby.promoted is not None:
            standby.promoted.stop()
        return

    labels = {**detect_gpu_labels(), **labels}
    gcs_address = args.address
    gcs = None
    if args.head:
        gcs = GcsServer(snapshot_path=args.snapshot_path,
                        snapshot_uri=args.snapshot_uri,
                        port=args.gcs_port, host=args.gcs_host)
        # rolling upgrade: when a promoted standby fences this head, exit
        # cleanly instead of serving a dead epoch
        gcs.on_fenced = lambda: stop.__setitem__("flag", True)
        gcs_address = gcs.start()
        print(f"ray_tpu_torch head started. GCS address: {gcs_address}")
        print(f"Connect with: ray_tpu_torch.init(address=\"{gcs_address}\")")
    elif not gcs_address:
        parser.error("either --head or --address is required")

    raylet = Raylet(
        gcs_address=gcs_address,
        resources=default_node_resources(None, resources),
        labels=labels,
        object_store_memory=args.object_store_memory,
    )
    raylet.allow_chaos_kill = True  # standalone daemon: kill-random-node ok
    raylet.ship_spans = True        # no worker buffer here: ship our ring
    raylet.start()
    print(f"raylet started on node {raylet.node_id.hex()[:12]} "
          f"({raylet.address})")

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    while not stop["flag"]:
        time.sleep(0.5)
    raylet.stop()
    if gcs is not None:
        gcs.stop()


if __name__ == "__main__":
    main()
