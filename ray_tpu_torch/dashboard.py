"""Dashboard-lite: HTTP JSON endpoints for cluster state + metrics.

Equivalent role to the reference's aiohttp dashboard head
(`dashboard/head.py` + modules): machine-readable endpoints instead of the
React client —

    GET /api/nodes       GET /api/actors     GET /api/tasks
    GET /api/jobs        GET /api/placement_groups
    GET /api/cluster_resources
    GET /metrics         (Prometheus text format)
    GET /timeline        (chrome://tracing JSON)

The port's gauges are the reference's with `ray_tpu_torch_` for
`ray_tpu_`; the cards are the `GPU` resource. Nothing here touches CUDA:
a scrape reads the control plane only, so the dashboard's process makes
no CUDA context.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple


_cluster_gauges = {}


def _update_cluster_gauges() -> None:
    """Refresh the framework-level gauges the Grafana dashboards query
    (`ray_tpu_torch/grafana.py`) from control-plane state, per /metrics
    scrape."""
    from ray_tpu_torch import state as state_api
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.util.metrics import Gauge

    g = _cluster_gauges
    if not g:
        g["nodes"] = Gauge("ray_tpu_torch_nodes_alive", "alive nodes")
        g["actors"] = Gauge("ray_tpu_torch_actors_alive", "alive actors")
        g["tasks_pending"] = Gauge(
            "ray_tpu_torch_tasks_pending", "tasks not yet finished")
        g["tasks_finished"] = Gauge(
            "ray_tpu_torch_tasks_finished_total",
            "finished tasks (cumulative)")
        g["store_used"] = Gauge(
            "ray_tpu_torch_object_store_used_bytes",
            "local store used bytes")
        g["store_capacity"] = Gauge(
            "ray_tpu_torch_object_store_capacity_bytes",
            "local store capacity")
        g["store_spilled"] = Gauge(
            "ray_tpu_torch_object_store_spilled_objects",
            "objects spilled to disk")
    try:
        nodes = state_api.list_nodes()
        g["nodes"].set(float(sum(1 for n in nodes if n.get("alive"))))
        actors = state_api.list_actors()
        g["actors"].set(float(
            sum(1 for a in actors if a.get("state") == "ALIVE")))
        # cumulative GCS counters, NOT the windowed task-event list — the
        # _total series must keep increasing past the event window
        counts = core_api._global_worker().gcs.call("task_counts", timeout=5)
        g["tasks_finished"].set(float(counts["finished"] + counts["failed"]))
        g["tasks_pending"].set(float(counts["pending"]))
    except (OSError, RuntimeError, TimeoutError, KeyError):
        pass  # GCS mid-restart: scrape returns last values
    try:
        worker = core_api._global_worker()
        stats = worker.raylet.call("object_store_stats", timeout=5)
        g["store_used"].set(float(stats.get("used_bytes", 0)))
        g["store_capacity"].set(float(stats.get("capacity_bytes", 0)))
        g["store_spilled"].set(float(stats.get("num_spilled", 0)))
    except (OSError, RuntimeError, TimeoutError):
        pass  # raylet scrape is best-effort
    try:
        from ray_tpu_torch.serve import api as serve_api

        serve_api._update_serve_gauges()
    except Exception:  # serve may not be running at all in this cluster
        pass


def start_dashboard(port: int = 0) -> Tuple[ThreadingHTTPServer, int]:
    """Serve dashboard endpoints from this (driver) process; returns port."""
    from ray_tpu_torch import state as state_api
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.util import metrics as metrics_mod
    from ray_tpu_torch.util import tracing

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            try:
                if self.path in ("/", "/index.html"):
                    from ray_tpu_torch.dashboard_ui import DASHBOARD_HTML

                    body, ctype = DASHBOARD_HTML, "text/html"
                elif self.path == "/api/nodes":
                    body, ctype = json.dumps(state_api.list_nodes()), "application/json"
                elif self.path == "/api/actors":
                    body, ctype = json.dumps(state_api.list_actors()), "application/json"
                elif self.path == "/api/tasks":
                    body, ctype = json.dumps(state_api.list_tasks()), "application/json"
                elif self.path == "/api/jobs":
                    body, ctype = json.dumps(state_api.list_jobs()), "application/json"
                elif self.path == "/api/placement_groups":
                    body, ctype = json.dumps(state_api.list_placement_groups()), "application/json"
                elif self.path == "/api/cluster_resources":
                    body, ctype = json.dumps({
                        "total": core_api.cluster_resources(),
                        "available": core_api.available_resources(),
                    }), "application/json"
                elif self.path == "/metrics":
                    _update_cluster_gauges()
                    body, ctype = metrics_mod.export_prometheus(), "text/plain"
                elif self.path == "/timeline":
                    body, ctype = json.dumps(
                        {"traceEvents": tracing.get_events()}), "application/json"
                elif self.path == "/api/serve/applications":
                    from ray_tpu_torch import serve as serve_mod

                    body, ctype = json.dumps(serve_mod.status()), "application/json"
                elif self.path.startswith("/api/profile"):
                    # GET /api/profile?kind=cpu|memory&duration=5[&pid=N]
                    # starts in-worker sampling on every node and returns
                    # tokens; GET /api/profile_result?node=ADDR&token=T
                    # polls (reference dashboard reporter profile trigger)
                    from urllib.parse import parse_qs, urlparse

                    from ray_tpu_torch.core import rpc as _rpc
                    from ray_tpu_torch.core.api import get_runtime_context

                    qs = parse_qs(urlparse(self.path).query)
                    if self.path.startswith("/api/profile_result"):
                        # poll hot path: talks only to the named raylet
                        c = _rpc.connect_with_retry(qs["node"][0], timeout=5)
                        try:
                            out = c.call("profile_result",
                                         {"token": qs["token"][0]})
                        finally:
                            c.close()
                    else:
                        from ray_tpu_torch.util.profiler import trigger_profile

                        gcs = _rpc.connect_with_retry(
                            get_runtime_context().gcs_address, timeout=5)
                        try:
                            started = trigger_profile(
                                gcs,
                                int(qs["pid"][0]) if "pid" in qs else None,
                                qs.get("kind", ["cpu"])[0],
                                float(qs.get("duration", ["5"])[0]))
                        finally:
                            gcs.close()
                        by_node: dict = {}
                        for addr, pid, token in started:
                            by_node.setdefault(addr, []).append(
                                {"pid": pid, "token": token})
                        out = [{"node": addr, "started": s}
                               for addr, s in by_node.items()]
                    body, ctype = json.dumps(out), "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:
                data = json.dumps({"error": str(e)}).encode()
                self.send_response(500)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        def do_PUT(self):
            """Declarative REST deploy (reference `serve deploy` REST mode,
            `python/ray/serve/schema.py`): PUT /api/serve/applications with
            the JSON/YAML config body deploys every application."""
            if self.path != "/api/serve/applications":
                self.send_response(404)
                self.end_headers()
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n).decode()
                try:
                    cfg = json.loads(raw)
                except ValueError:
                    import yaml

                    cfg = yaml.safe_load(raw)
                from ray_tpu_torch.serve.config import deploy_config

                deployed = deploy_config(cfg)
                data = json.dumps({"deployed": deployed}).encode()
                self.send_response(200)
            except Exception as e:
                data = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]
