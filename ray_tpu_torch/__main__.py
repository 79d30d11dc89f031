"""CLI: `python -m ray_tpu_torch <command>`.

Command surface mirrors the reference CLI (SURVEY appendix A): start,
status, list (actors/nodes/tasks/pgs/jobs), summary, timeline, job submit,
the cluster launcher (up/down/exec/submit/attach), serve, debug and
metrics. `start` runs `core/node_main.py` (`--num-gpus n` gives a node its
cards). No command but `rllib` touches CUDA. `rllib train|evaluate` runs
the reference's loop over the port's algorithms (those of this package's
`rllib`; another name prints the reference's "unknown algorithm" line) with
their learners on `--device` (the card by default; without one, and without
`--device cpu`, it exits 2 with one line naming the missing card).
"""

from __future__ import annotations

import argparse
import json
import sys


def _connect(address: str):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "start":
        # argparse REMAINDER can't forward leading options; dispatch directly
        from ray_tpu_torch.core.node_main import main as node_main

        node_main(argv[1:])
        return 0

    if argv and argv[0] == "client-server":
        from ray_tpu_torch.client.server import main as client_server_main

        return client_server_main(argv[1:])

    if argv and argv[0] in ("up", "down", "exec", "submit", "attach"):
        # cluster launcher (reference `ray up/down/exec/attach/submit`,
        # scripts.py:1223): dispatched directly — exec/submit forward
        # arbitrary trailing commands argparse REMAINDER would mangle
        from ray_tpu_torch.autoscaler import launcher as _launcher

        cmd, rest = argv[0], argv[1:]
        if not rest or rest[0] in ("-h", "--help"):
            print(f"usage: python -m ray_tpu_torch {cmd} cluster.yaml ...",
                  file=sys.stderr)
            return 0 if rest else 2
        yaml_path = rest[0]
        try:
            if cmd == "up":
                return _launcher.cli_up(yaml_path,
                                        block="--block" in rest[1:])
            if cmd == "down":
                return _launcher.cli_down(yaml_path)
            if cmd == "exec":
                if len(rest) < 2:
                    print("usage: python -m ray_tpu_torch exec cluster.yaml "
                          "-- cmd ...", file=sys.stderr)
                    return 2
                cmd_args = rest[1:]
                if cmd_args and cmd_args[0] == "--":
                    cmd_args = cmd_args[1:]
                return _launcher.cli_exec(yaml_path, cmd_args)
            if cmd == "submit":
                if len(rest) < 2:
                    print("usage: python -m ray_tpu_torch submit "
                          "cluster.yaml script.py ...", file=sys.stderr)
                    return 2
                return _launcher.cli_submit(yaml_path, rest[1], rest[2:])
            return _launcher.cli_attach(yaml_path)
        except (FileNotFoundError, ValueError) as e:
            # bad yaml path / malformed config: one-line error, not a trace
            print(f"ray_tpu_torch {cmd}: {e}", file=sys.stderr)
            return 2

    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("start", help="start a node daemon (head or worker)")

    p_status = sub.add_parser("status", help="cluster resource summary")
    p_status.add_argument("--address", required=True)

    p_list = sub.add_parser("list", help="list cluster entities")
    p_list.add_argument("what", choices=["actors", "nodes", "tasks",
                                         "placement-groups", "jobs"])
    p_list.add_argument("--address", required=True)

    p_sum = sub.add_parser("summary", help="task state summary")
    p_sum.add_argument("--address", required=True)

    p_tl = sub.add_parser("timeline", help="dump chrome trace json")
    p_tl.add_argument("--output", default="timeline.json")
    p_tl.add_argument("--address", default=None,
                      help="GCS address: include cluster-wide worker spans")
    p_tl.add_argument("--trace", default=None, metavar="TRACE_ID",
                      help="one causal tree only (requires --address); "
                           "'list' prints recent trace ids instead")

    p_tr = sub.add_parser(
        "trace", help="critical-path breakdown of one task "
        "(submit -> lease -> dispatch -> run -> result-deliver)")
    p_tr.add_argument("task_id",
                      help="task id hex (python -m ray_tpu_torch list tasks)")
    p_tr.add_argument("--address", required=True)

    p_mem = sub.add_parser("memory", help="object store usage per node")
    p_mem.add_argument("--address", required=True)

    p_jobs = sub.add_parser(
        "jobs", help="per-job state: status, live/detached actors, "
        "pending tasks, owned bytes, fate-sharing reap counters")
    p_jobs.add_argument("--address", required=True)

    p_logs = sub.add_parser("logs", help="recent worker stdout/stderr")
    p_logs.add_argument("--address", required=True)
    p_logs.add_argument("--lines", type=int, default=200)

    p_stack = sub.add_parser("stack", help="dump local worker stack traces")
    p_stack.add_argument("--address", required=True)

    p_prof = sub.add_parser(
        "profile",
        help="on-demand cpu/memory profile of live workers (py-spy role)")
    p_prof.add_argument("--address", required=True)
    p_prof.add_argument("--pid", type=int, default=None,
                        help="one worker pid (default: every worker)")
    p_prof.add_argument("--kind", choices=("cpu", "memory"), default="cpu")
    p_prof.add_argument("--duration", type=float, default=5.0)
    p_prof.add_argument("--output", default=None,
                        help="write full JSON here (default: print summary)")

    p_health = sub.add_parser("healthcheck", help="exit 0 if GCS responds")
    p_health.add_argument("--address", required=True)

    p_gc = sub.add_parser("global-gc", help="gc.collect() in every worker")
    p_gc.add_argument("--address", required=True)

    p_chaos = sub.add_parser("kill-random-node",
                             help="chaos: hard-kill a random non-head node")
    p_chaos.add_argument("--address", required=True)

    sub.add_parser("microbenchmark", help="core-primitive ops/s suite")

    p_env = sub.add_parser(
        "envelope", help="scalability-envelope suite (tasks/actors/PGs/"
        "broadcast + microbenchmark), writes a JSON artifact")
    p_env.add_argument("--out", default=None)
    p_env.add_argument("--scale", type=float, default=1.0)
    p_env.add_argument("--elastic", action="store_true",
                       help="also run the burst-elasticity chaos scenario")

    p_serve = sub.add_parser("serve", help="model serving")
    serve_sub = p_serve.add_subparsers(dest="serve_cmd", required=True)
    p_sv_deploy = serve_sub.add_parser("deploy")
    p_sv_deploy.add_argument("config_file")
    p_sv_deploy.add_argument("--address", required=True)
    p_sv_status = serve_sub.add_parser("status")
    p_sv_status.add_argument("--address", required=True)
    p_sv_down = serve_sub.add_parser("shutdown")
    p_sv_down.add_argument("--address", required=True)
    p_sv_run = serve_sub.add_parser(
        "run", help="import module:deployment and serve.run it")
    p_sv_run.add_argument("import_path", help="module.sub:attr")
    p_sv_run.add_argument("--address", required=True)
    p_sv_run.add_argument("--port", type=int, default=8000)
    p_sv_run.add_argument("--blocking", action="store_true")

    p_job = sub.add_parser("job", help="job submission")
    job_sub = p_job.add_subparsers(dest="job_cmd", required=True)
    p_job_submit = job_sub.add_parser("submit")
    p_job_submit.add_argument("--address", required=True)
    p_job_submit.add_argument("--working-dir", default=None)
    p_job_submit.add_argument("entrypoint", nargs=argparse.REMAINDER)
    p_job_list = job_sub.add_parser("list")
    p_job_list.add_argument("--address", required=True)
    for cmdname in ("status", "logs", "stop"):
        p = job_sub.add_parser(cmdname)
        p.add_argument("job_id")
        p.add_argument("--address", required=True)

    p_rllib = sub.add_parser("rllib", help="RL training (reference rllib CLI)")
    rllib_sub = p_rllib.add_subparsers(dest="rllib_cmd", required=True)
    p_rl_train = rllib_sub.add_parser("train")
    p_rl_train.add_argument("--algo", required=True,
                            help="registered algorithm, e.g. ppo/dqn/impala")
    p_rl_train.add_argument("--stop-iters", type=int, default=10)
    p_rl_train.add_argument("--stop-reward", type=float, default=None)
    p_rl_train.add_argument("--num-workers", type=int, default=2)
    p_rl_train.add_argument("--checkpoint-path", default=None)
    p_rl_eval = rllib_sub.add_parser("evaluate")
    p_rl_eval.add_argument("--algo", required=True)
    p_rl_eval.add_argument("--checkpoint-path", required=True)
    p_rl_eval.add_argument("--episodes", type=int, default=5)
    for p in (p_rl_train, p_rl_eval):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="the learners' device (default: the card)")

    p_debug = sub.add_parser("debug",
                             help="attach to a remote rpdb breakpoint")
    p_debug.add_argument("--address", required=True)
    p_debug.add_argument("--index", type=int, default=0,
                         help="which breakpoint (from the listed order)")

    p_metrics = sub.add_parser("metrics", help="observability tooling")
    metrics_sub = p_metrics.add_subparsers(dest="metrics_cmd", required=True)
    p_mx = metrics_sub.add_parser(
        "export-dashboards",
        help="write Grafana dashboard JSON for provisioning")
    p_mx.add_argument("--out-dir", default=None,
                      help="default: build/grafana_dashboards_torch")
    p_mx.add_argument("--which", nargs="*", default=None,
                      choices=["core", "train", "serve"])

    args = parser.parse_args(argv)

    if args.cmd == "debug":
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.util import rpdb

        gcs = _rpc.connect_with_retry(args.address, timeout=5)
        try:
            bps = rpdb.list_breakpoints(gcs)
        finally:
            gcs.close()
        if not bps:
            print("no active breakpoints")
            return 1
        for i, bp in enumerate(bps):
            print(f"[{i}] pid={bp.get('pid')} {bp['host']}:{bp['port']} "
                  f"task={bp.get('task_id')} actor={bp.get('actor_id')}")
        bp = bps[min(args.index, len(bps) - 1)]
        print(f"attaching to {bp['host']}:{bp['port']} "
              f"(Ctrl-D to detach)...")
        rpdb.attach(bp["host"], bp["port"])
        return 0

    if args.cmd == "metrics":
        from ray_tpu_torch.grafana import DEFAULT_OUT_DIR, export_dashboards

        for path in export_dashboards(args.out_dir or DEFAULT_OUT_DIR,
                                      args.which):
            print(f"wrote {path}")
        return 0

    if args.cmd == "status":
        rt = _connect(args.address)
        print(json.dumps({
            "total": rt.cluster_resources(),
            "available": rt.available_resources(),
            "nodes": len(rt.nodes()),
        }, indent=2))
        return 0

    if args.cmd == "list":
        _connect(args.address)
        from ray_tpu_torch import state

        fn = {
            "actors": state.list_actors,
            "nodes": state.list_nodes,
            "tasks": state.list_tasks,
            "placement-groups": state.list_placement_groups,
            "jobs": state.list_jobs,
        }[args.what]
        print(json.dumps(fn(), indent=2, default=str))
        return 0

    if args.cmd == "summary":
        _connect(args.address)
        from ray_tpu_torch import state

        print(json.dumps(state.summarize_tasks(), indent=2))
        return 0

    if args.cmd == "microbenchmark":
        from ray_tpu_torch.microbenchmark import main as micro_main

        return micro_main([])

    if args.cmd == "envelope":
        from ray_tpu_torch.envelope import main as env_main

        argv = []
        if args.out:
            argv += ["--out", args.out]
        argv += ["--scale", str(args.scale)]
        if args.elastic:
            argv += ["--elastic"]
        return env_main(argv)

    if args.cmd == "timeline":
        from ray_tpu_torch.util import timeline as _timeline
        from ray_tpu_torch.util import tracing

        if args.trace and not args.address:
            print("--trace requires --address", file=sys.stderr)
            return 2
        extra = []
        offsets = {}
        if args.address:
            from ray_tpu_torch.core import rpc as _rpc

            gcs = _rpc.connect_with_retry(args.address, timeout=5)
            try:
                if args.trace == "list":
                    for t in gcs.call("list_traces", {"limit": 50},
                                      timeout=10):
                        print(f"{t['trace_id']}  spans={t['spans']:<6d} "
                              f"last_ts_us={t['last_ts_us']:.0f}")
                    return 0
                if args.trace:
                    reply = gcs.call("get_trace",
                                     {"trace_id": args.trace}, timeout=10)
                    doc = _timeline.merge_chrome(reply["spans"],
                                                 reply.get("offsets"))
                    with open(args.output, "w") as f:
                        json.dump(doc, f)
                    print(f"wrote {args.output} "
                          f"({len(doc['traceEvents'])} spans of trace "
                          f"{args.trace})")
                    return 0
                extra = gcs.call("get_profile_events", timeout=10)
                offsets = gcs.call("get_span_offsets", timeout=10)
            finally:
                gcs.close()
        # fleet-merged dump: local ring + every span the GCS holds, clock-
        # aligned per source and time-sorted into one chrome document
        doc = _timeline.merge_chrome(
            tracing.get_events() + list(extra or []), offsets)
        with open(args.output, "w") as f:
            json.dump(doc, f)
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "trace":
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.util import timeline as _timeline

        gcs = _rpc.connect_with_retry(args.address, timeout=5)
        try:
            reply = gcs.call("get_trace", {"task_id": args.task_id},
                             timeout=10)
            stats = gcs.call("gcs_stats", timeout=10)
        finally:
            gcs.close()
        spans = _timeline.apply_offsets(reply.get("spans") or [],
                                        reply.get("offsets") or {})
        segs = _timeline.stage_segments(spans, args.task_id)
        if not segs:
            print(f"no trace recorded for task {args.task_id} "
                  f"(is tracing on? RAY_TPU_TORCH_TRACING_ENABLED=1)",
                  file=sys.stderr)
            return 1
        t0 = min(s[1] for s in segs)
        t_end = max(s[1] + s[2] for s in segs)
        print(f"task {args.task_id} (trace {reply.get('trace_id')}): "
              f"{(t_end - t0) / 1e3:.2f} ms submit -> result-deliver")
        prev_end = None
        for stage, start, dur in segs:
            gap = ""
            if prev_end is not None and start - prev_end > 50:
                gap = f"  (+{(start - prev_end) / 1e3:.2f} ms between)"
            print(f"  {stage:<15s} +{(start - t0) / 1e3:9.2f} ms  "
                  f"{dur / 1e3:8.2f} ms{gap}")
            prev_end = start + dur
        stage_lat = ((stats.get("tracing") or {})
                     .get("stage_latency_us") or {})
        if stage_lat:
            print("fleet stage latency, p50/p99 ms:")
            for stage in _timeline.STAGE_ORDER:
                s = stage_lat.get(stage)
                if s:
                    print(f"  {stage:<15s} "
                          f"{s['p50_us'] / 1e3:8.2f} / "
                          f"{s['p99_us'] / 1e3:8.2f}  (n={s['count']})")
        return 0

    if args.cmd in ("memory", "stack", "healthcheck", "global-gc",
                    "kill-random-node", "logs", "profile", "jobs"):
        # raw GCS/raylet RPC — no driver registration needed
        from ray_tpu_torch.core import rpc as _rpc

        try:
            gcs = _rpc.connect_with_retry(args.address, timeout=5)
        except ConnectionError as e:
            if args.cmd == "healthcheck":
                print(f"unhealthy: {e}")
                return 1
            raise
        try:
            try:
                nodes = gcs.call("get_all_nodes", timeout=10)
            except Exception as e:
                if args.cmd == "healthcheck":
                    print(f"unhealthy: {e}")
                    return 1
                raise
            alive = [n for n in nodes if n["alive"]]
            if args.cmd == "healthcheck":
                print(json.dumps({"healthy": True, "alive_nodes": len(alive)}))
                return 0
            if args.cmd == "global-gc":
                gcs.call("global_gc")
                print("global gc triggered")
                return 0
            if args.cmd == "kill-random-node":
                import random

                victims = alive[1:] or alive  # prefer non-head
                if not victims:
                    print("no alive nodes to kill")
                    return 1
                v = random.choice(victims)
                c = _rpc.connect_with_retry(v["address"], timeout=5)
                try:
                    accepted = c.call("die", timeout=5)
                except (_rpc.RpcDisconnected, TimeoutError):
                    accepted = True  # died before replying — success
                finally:
                    c.close()
                if not accepted:
                    print(f"node {v['node_id'].hex()[:8]} refused "
                          f"(driver-embedded raylet)")
                    return 1
                print(f"killed node {v['node_id'].hex()[:8]}")
                return 0
            if args.cmd == "logs":
                for entry in gcs.call("get_recent_logs",
                                      {"lines": args.lines}):
                    for line in entry.get("lines", []):
                        print(f"(pid={entry.get('pid')}, "
                              f"{entry.get('stream')}) {line}")
                return 0
            if args.cmd == "jobs":
                st = gcs.call("gcs_stats", timeout=10)
                jobs_blk = st.get("jobs", [])
                # live per-driver numbers (pending tasks, owned bytes)
                # come from each RUNNING driver's own owner_stats RPC —
                # ownership lives in the driver, not the GCS
                for j in jobs_blk:
                    if j.get("status") != "RUNNING" \
                            or not j.get("driver_address"):
                        continue
                    try:
                        c = _rpc.connect_with_retry(j["driver_address"],
                                                    timeout=3)
                        try:
                            own = c.call("owner_stats", timeout=5)
                        finally:
                            c.close()
                        j["pending_tasks"] = own.get("pending_tasks")
                        j["owned_objects"] = own.get("owned_objects")
                        j["owned_bytes"] = own.get("owned_bytes")
                    except Exception as e:
                        j["owner_stats_error"] = str(e)
                print(json.dumps(
                    {"jobs": jobs_blk,
                     "job_failure": st.get("job_failure", {})},
                    indent=2, default=str))
                return 0
            if args.cmd == "memory":
                out = []
                for n in alive:
                    c = _rpc.connect_with_retry(n["address"], timeout=5)
                    st = c.call("object_store_stats")
                    st["node_id"] = st["node_id"].hex()
                    out.append(st)
                    c.close()
                # cluster storage roll-up (same block gcs_stats aggregates
                # from heartbeats, but computed live from the nodes here)
                storage = {
                    "used_bytes": sum(s.get("used_bytes", 0) for s in out),
                    "capacity_bytes": sum(s.get("capacity_bytes", 0)
                                          for s in out),
                    "pinned_bytes": sum(s.get("pinned_bytes", 0)
                                        for s in out),
                    "spilled_bytes": sum(s.get("spilled_bytes", 0)
                                         for s in out),
                    "nodes_spill_degraded": [
                        s["node_id"] for s in out if s.get("spill_degraded")],
                }
                print(json.dumps({"storage": storage, "nodes": out},
                                 indent=2))
                return 0
            if args.cmd == "profile":
                import time as _time

                from ray_tpu_torch.util.profiler import (poll_profile_results,
                                                   trigger_profile)

                pending = trigger_profile(gcs, args.pid, args.kind,
                                          args.duration)
                if not pending:
                    print("no matching workers")
                    return 1
                reports, pending = poll_profile_results(
                    pending, _time.monotonic() + args.duration + 30,
                    poll_interval_s=min(args.duration / 2 + 0.2, 2.0))
                if args.output:
                    with open(args.output, "w") as fh:
                        json.dump(reports, fh, indent=2)
                    print(f"wrote {len(reports)} profiles to {args.output}")
                else:
                    for rep in reports:
                        print(f"==== pid {rep.get('pid')} "
                              f"({rep.get('kind')}) ====")
                        if rep.get("error"):
                            print(f"  error: {rep['error']}")
                        elif rep.get("kind") == "memory":
                            print(f"  rss {rep.get('rss_before')} -> "
                                  f"{rep.get('rss_after')}")
                            for site in rep.get("sites", [])[:10]:
                                print(f"  {site['size_bytes']:>12,}B "
                                      f"x{site['count']:<6} "
                                      f"{site['traceback'][-1].strip()}")
                        else:
                            total = sum(s["count"]
                                        for s in rep.get("stacks", []))
                            for s in rep.get("stacks", [])[:10]:
                                leaf = s["stack"].rsplit(";", 1)[-1]
                                pct = 100 * s["count"] / max(total, 1)
                                print(f"  {pct:5.1f}% {leaf}")
                if pending:
                    print(f"({len(pending)} workers did not report in time)")
                return 0
            if args.cmd == "stack":
                import os as _os
                import signal as _signal
                import time as _time

                import tempfile as _tempfile

                # where the port's workers dump (core/worker_main.py)
                stack_dir = _os.path.join(_tempfile.gettempdir(),
                                          "ray_tpu_torch", "stacks")
                signaled = {}  # pid -> file offset before this dump
                for n in alive:
                    c = _rpc.connect_with_retry(n["address"], timeout=5)
                    for w in c.call("list_workers"):
                        path = _os.path.join(stack_dir, f"{w['pid']}.txt")
                        try:
                            offset = _os.path.getsize(path)
                        except OSError:
                            offset = 0
                        try:
                            _os.kill(w["pid"], _signal.SIGUSR1)
                            signaled[w["pid"]] = offset
                        except (ProcessLookupError, PermissionError):
                            continue
                    c.close()
                _time.sleep(0.5)
                # print only live workers' dumps, and only this invocation's
                # (faulthandler appends; earlier dumps are before offset)
                for pid, offset in sorted(signaled.items()):
                    path = _os.path.join(stack_dir, f"{pid}.txt")
                    try:
                        with open(path) as fh:
                            fh.seek(offset)
                            content = fh.read().strip()
                    except OSError:
                        continue
                    if content:
                        print(f"==== worker pid {pid} ====")
                        print(content)
                return 0
        finally:
            gcs.close()

    if args.cmd == "serve":
        _connect(args.address)
        from ray_tpu_torch import serve

        if args.serve_cmd == "run":
            import importlib

            mod_name, _, attr = args.import_path.partition(":")
            if not attr:
                print("import_path must be module:attribute", file=sys.stderr)
                return 2
            sys.path.insert(0, "")
            target = getattr(importlib.import_module(mod_name), attr)
            serve.run(target.bind() if hasattr(target, "bind") else target)
            _, port = serve.start_http_proxy(port=args.port)
            print(f"serving on http://127.0.0.1:{port}")
            if args.blocking:
                import time as _time

                while True:
                    _time.sleep(3600)
            return 0
        if args.serve_cmd == "deploy":
            print(json.dumps(serve.deploy_config_file(args.config_file)))
        elif args.serve_cmd == "status":
            print(json.dumps(serve.status(), indent=2))
        else:
            serve.shutdown()
            print("serve shut down")
        return 0

    if args.cmd == "job":
        from ray_tpu_torch.job_submission import JobSubmissionClient

        client = JobSubmissionClient(args.address)
        if args.job_cmd == "submit":
            entry = args.entrypoint
            if entry and entry[0] == "--":
                entry = entry[1:]
            job_id = client.submit_job(
                entrypoint=" ".join(entry), working_dir=args.working_dir)
            print(job_id)
        elif args.job_cmd == "status":
            print(client.get_job_status(args.job_id))
        elif args.job_cmd == "logs":
            print(client.get_job_logs(args.job_id))
        elif args.job_cmd == "stop":
            ok = client.stop_job(args.job_id)
            print("stopped" if ok else "not running")
            return 0 if ok else 1
        else:
            print(json.dumps(client.list_jobs(), indent=2, default=str))
        return 0

    if args.cmd == "rllib":
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print(f"python -m ray_tpu_torch rllib {args.rllib_cmd}: no CUDA "
                  f"card on this host for the learner; pass --device cpu to "
                  f"train on the CPU", file=sys.stderr)
            return 2
        _connect(args.address) if hasattr(args, "address") else None
        import ray_tpu_torch as _rt

        if not _rt.is_initialized():
            _rt.init(num_cpus=4)
        from ray_tpu_torch import rllib as _rllib

        by_name = {n[:-6].lower(): getattr(_rllib, n) for n in dir(_rllib)
                   if n.endswith("Config")}
        cfg_cls = by_name.get(args.algo.lower())
        if cfg_cls is None:
            print(f"unknown algorithm {args.algo!r}; "
                  f"available: {' '.join(sorted(by_name))}")
            return 1
        cfg = cfg_cls()
        if hasattr(cfg, "device"):
            cfg.device = args.device
        if hasattr(cfg, "rollouts") and args.rllib_cmd == "train":
            try:
                cfg.rollouts(num_rollout_workers=args.num_workers)
            except TypeError:
                pass
        algo = cfg.build()
        try:
            if args.rllib_cmd == "train":
                last = {}
                for i in range(args.stop_iters):
                    last = algo.train()
                    reward = last.get("episode_reward_mean")
                    print(f"iter {i + 1}: reward={reward}")
                    if (args.stop_reward is not None and reward is not None
                            and reward >= args.stop_reward):
                        break
                if args.checkpoint_path:
                    ckpt = algo.save()
                    ckpt.to_directory(args.checkpoint_path)
                    print(f"checkpoint: {args.checkpoint_path}")
            else:  # evaluate
                from ray_tpu_torch.air.checkpoint import Checkpoint

                algo.restore(Checkpoint.from_directory(args.checkpoint_path))
                ev = algo.evaluate(num_episodes=args.episodes)
                print(json.dumps(ev, indent=2))
        finally:
            algo.stop()
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
