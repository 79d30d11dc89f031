"""The port's operator surface against ray_tpu's, on the same inputs.

Each scenario of the reference's own tests (test_dag_workflow_autoscaler,
test_aux, test_cli_observability, test_dashboard_serve_rest and
test_predictor_util's joblib case) runs through both packages, one runtime
of each alive side by side in this process, and the outputs are compared:
results, endpoint key sets, statuses, logs, span names, and metric and
label names after mapping `ray_tpu_` to `ray_tpu_torch_` and TPU to GPU.
Also: `rllib` exits 2 on the port without a card and trains with
`--device cpu`, and `save_sharded` sets the port's checkpoint gauge.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import ray_tpu.dag  # noqa: F401  (installs .bind())
import ray_tpu_torch.dag  # noqa: F401
from torch_runtime import both_runtimes, rerun_if_killed, rerun_if_pkilled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
ACC = {"ref": "TPU", "port": "GPU"}


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{PKGS[pkg].__name__}.{name}")


def _to_port(text: str) -> str:
    """The reference's names in the port's."""
    text = re.sub(r"\btpu([TA])\b", r"gpu\1", text)  # the page's variables
    return (text.replace("ray_tpu", "ray_tpu_torch")
            .replace("ray-tpu-", "ray-tpu-torch-")
            .replace("TPU chips", "GPUs").replace("TPU", "GPU"))


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=8) as (ref, port):
        yield {"ref": ref["gcs_address"], "port": port["gcs_address"]}


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


# --------------------------------------------------------------------- DAGs


def _function_graph(pkg):
    rt = PKGS[pkg]

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def double(x):
        return x * 2

    with _mod(pkg, "dag").InputNode() as inp:
        graph = double.bind(add.bind(inp, 10))
    return rt.get(graph.execute(5), timeout=60)


def _actor_graph(pkg):
    rt = PKGS[pkg]

    @rt.remote
    class Acc:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

    node = Acc.bind(100)
    return rt.get(node.add.bind(1).execute(), timeout=60)


@pytest.mark.parametrize("graph", [_function_graph, _actor_graph])
def test_dag_graphs_match_reference(both, graph):
    got = {pkg: rerun_if_killed(graph, pkg) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] in (30, 101)


def test_dag_gpu_actor_runs_on_its_grant_and_serve_keeps_its_bind(both):
    """An InputNode feeding a CPU task feeding a num_gpus=1 actor's method,
    the shape of the job the card runs; Serve's Deployment.bind stays
    Serve's."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.actor import ActorClass
    from ray_tpu_torch.core.api import RemoteFunction
    from ray_tpu_torch.dag import ClassMethodNode, InputNode

    @ray_tpu_torch.remote
    def make(seed):
        return np.arange(4) + seed

    @ray_tpu_torch.remote(num_gpus=1)
    class Trainer:
        def run(self, batch):
            import os

            return {"sum": int(batch.sum()), "pid": os.getpid(),
                    "ids": ray_tpu_torch.get_gpu_ids()}

    def program():
        with InputNode() as inp:
            node = Trainer.bind().run.bind(make.bind(inp))
        assert isinstance(node, ClassMethodNode)
        return ray_tpu_torch.get(node.execute(3), timeout=60)

    out = rerun_if_killed(program)
    assert out["sum"] == 18 and len(out["ids"]) == 1
    assert out["pid"] != os.getpid()
    assert "bind" in vars(RemoteFunction) and "bind" in vars(ActorClass)

    def echo(x):
        return x

    d = serve.deployment(echo)
    assert isinstance(d.bind(), serve.Deployment)


# ------------------------------------------------------- dashboard (test_aux)


DASH_PATHS = ("/api/nodes", "/api/actors", "/api/tasks", "/api/jobs",
              "/api/placement_groups", "/api/cluster_resources", "/metrics",
              "/timeline", "/")


def _dashboard_view(pkg):
    rt = PKGS[pkg]

    @rt.remote
    def noop():
        return 1

    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    a = Pinger.remote()
    rt.get([noop.remote() for _ in range(3)] + [a.ping.remote()],
           timeout=60)
    server, port = _mod(pkg, "dashboard").start_dashboard()
    try:
        deadline = time.monotonic() + 30
        while True:  # task counts reach the GCS through the event buffer
            status, text = _get(port, "/metrics")
            m = re.search(r"^ray_tpu(?:_torch)?_tasks_finished_total "
                          r"([0-9.e+-]+)$", text, re.MULTILINE)
            if (m and float(m.group(1)) >= 4.0) \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.3)
        view = {}
        for path in DASH_PATHS:
            status, body = _get(port, path)
            view[path] = (status, body)
        status, _ = 0, None
        try:
            _get(port, "/nope")
        except urllib.error.HTTPError as e:
            status = e.code
        view["/nope"] = (status, "")
    finally:
        server.shutdown()
        rt.kill(a)
    return view


def _keys(body: str):
    doc = json.loads(body)
    if isinstance(doc, list):
        return sorted({k for item in doc for k in item})
    return sorted(doc)


def test_dashboard_endpoints_match_reference(both):
    views = {pkg: rerun_if_killed(_dashboard_view, pkg) for pkg in PKGS}
    ref, port = views["ref"], views["port"]
    assert {p: s for p, (s, _) in port.items()} == \
        {p: s for p, (s, _) in ref.items()}
    assert port["/nope"][0] == 404 and port["/api/nodes"][0] == 200
    for path in ("/api/nodes", "/api/actors", "/api/tasks", "/api/jobs",
                 "/api/placement_groups", "/api/cluster_resources",
                 "/timeline"):
        assert _keys(port[path][1]) == _keys(ref[path][1]), path
    nodes = {pkg: json.loads(v["/api/nodes"][1]) for pkg, v in views.items()}
    assert len(nodes["port"]) == len(nodes["ref"]) == 1
    assert nodes["port"][0]["resources_total"]["GPU"] == 8
    res = json.loads(port["/api/cluster_resources"][1])
    assert res["total"]["GPU"] == 8 and "TPU" not in res["total"]
    assert json.loads(port["/timeline"][1])["traceEvents"] is not None
    actors = json.loads(port["/api/actors"][1])
    assert any(a["class_name"] == "Pinger" and a["state"] == "ALIVE"
               for a in actors)
    # the page: the reference's, with GPUs for TPU chips
    assert _to_port(ref["/"][1]) == port["/"][1]
    assert "GPUs in use" in port["/"][1] and "TPU" not in port["/"][1]

    # the scrape's own gauges (the registry is the process's, so other
    # series depend on what ran before in it)
    gauges = {pkg: sorted(g.name for g in
                          _mod(pkg, "dashboard")._cluster_gauges.values())
              for pkg in PKGS}
    assert [_to_port(n) for n in gauges["ref"]] == gauges["port"]
    assert len(gauges["port"]) == 7
    for pkg, view in views.items():
        for name in gauges[pkg]:
            assert re.search(rf"^{name} [0-9.e+-]+$", view["/metrics"][1],
                             re.MULTILINE), (pkg, name)
    values = dict(re.findall(r"^(ray_tpu_torch_[a-z_]+) ([0-9.e+-]+)$",
                             port["/metrics"][1], re.MULTILINE))
    assert float(values["ray_tpu_torch_nodes_alive"]) == 1.0
    assert float(values["ray_tpu_torch_actors_alive"]) >= 1.0
    assert float(values["ray_tpu_torch_tasks_finished_total"]) >= 4.0


def test_metrics_scrape_exports_dashboard_series(both):
    """Every core-dashboard panel of the port's Grafana factory reads a
    series the port's /metrics scrape exports."""
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.grafana import generate_default_dashboard

    server, port = start_dashboard()
    try:
        _, text = _get(port, "/metrics")
    finally:
        server.shutdown()
    exprs = [t["expr"] for p in generate_default_dashboard()["panels"]
             for t in p["targets"]]
    assert exprs
    for expr in exprs:
        for series in re.findall(r"ray_tpu[a-z_]+", expr):
            assert series.startswith("ray_tpu_torch_"), series
            assert series in text, series


# ------------------------------------------------------------ job submission


def _jobs(pkg):
    js = _mod(pkg, "job_submission")
    client = js.JobSubmissionClient()
    out = {}
    env_var = "RAY_TPU_TORCH_ADDRESS" if pkg == "port" else "RAY_TPU_ADDRESS"
    ok = client.submit_job(
        entrypoint=f"echo hello-from-job ${env_var} && exit 0")
    bad = client.submit_job(entrypoint="exit 3")
    out["statuses"] = (client.wait_until_finish(ok, timeout=60),
                       client.wait_until_finish(bad, timeout=60))
    out["logs"] = client.get_job_logs(ok)
    out["listed"] = sorted(j["job_id"] for j in client.list_jobs()
                           if j["job_id"] in (ok, bad))
    out["ids"] = (ok, bad)
    out["record_keys"] = sorted(client.list_jobs()[0])
    out["unknown"] = client.get_job_status("no-such-job")
    return out


def test_job_submission_matches_reference(both):
    got = {pkg: rerun_if_pkilled(_jobs, pkg) for pkg in PKGS}
    ref, port = got["ref"], got["port"]
    assert port["statuses"] == ref["statuses"] == ("SUCCEEDED", "FAILED")
    assert port["unknown"] == ref["unknown"] == "UNKNOWN"
    assert port["record_keys"] == ref["record_keys"]
    assert port["listed"] == sorted(port["ids"])
    assert all(j.startswith("rtt-job-") for j in port["ids"])
    assert all(j.startswith("raytpu-job-") for j in ref["ids"])
    # the entrypoint joins its own package's cluster
    assert port["logs"].split() == ["hello-from-job", both["port"]]
    assert ref["logs"].split() == ["hello-from-job", both["ref"]]


def test_job_records_live_in_the_ports_namespace(both):
    from ray_tpu_torch import job_submission
    from ray_tpu_torch.core.api import _global_worker

    client = job_submission.JobSubmissionClient()
    jid = client.submit_job(entrypoint="exit 0")
    client.wait_until_finish(jid, timeout=60)
    keys = _global_worker().gcs.call(
        "kv_keys", {"namespace": "ray_tpu_torch_job_submission",
                    "prefix": b""})
    assert jid.encode() in [bytes(k) for k in keys]
    assert not _global_worker().gcs.call(
        "kv_keys", {"namespace": "job_submission", "prefix": b""})


def _job_cli(pkg, address, tmp_path, capsys):
    main = _mod(pkg, "__main__").main
    script = tmp_path / f"job_script_{pkg}.py"
    script.write_text(
        "import time\nprint('hello-job', flush=True)\ntime.sleep(30)\n")

    def cli(*argv):
        rc = main(list(argv))
        return rc, capsys.readouterr().out

    rc, out = cli("job", "submit", "--address", address, "--",
                  sys.executable, str(script))
    assert rc == 0
    job_id = out.strip().splitlines()[-1]
    seen = []
    deadline = time.monotonic() + 30
    status = ""
    while time.monotonic() < deadline and "RUNNING" not in status:
        rc, status = cli("job", "status", job_id, "--address", address)
        time.sleep(0.3)
    seen.append(status.strip())
    deadline = time.monotonic() + 20
    logs = ""
    while time.monotonic() < deadline and "hello-job" not in logs:
        rc, logs = cli("job", "logs", job_id, "--address", address)
        time.sleep(0.3)
    seen.append(logs.strip())
    rc, out = cli("job", "stop", job_id, "--address", address)
    seen.append((rc, out.strip()))
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        rc, status = cli("job", "status", job_id, "--address", address)
        if "STOPPED" in status or "FAILED" in status:
            break
        time.sleep(0.3)
    seen.append(status.strip())
    return seen


def test_job_cli_status_logs_stop_match_reference(both, tmp_path, capsys):
    got = {pkg: rerun_if_pkilled(_job_cli, pkg, both[pkg], tmp_path, capsys)
           for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == ["RUNNING", "hello-job", (0, "stopped"), "STOPPED"]


# ------------------------------------------------------- CLI (observability)


def _cli(pkg, capsys, *argv):
    rc = _mod(pkg, "__main__").main(list(argv))
    return rc, capsys.readouterr().out


def test_healthcheck_memory_global_gc_match_reference(both, capsys):
    def program(pkg):
        rt = PKGS[pkg]
        ref = rt.put(np.zeros(200_000, np.float64))  # 1.6 MB -> the store

        @rt.remote
        def touch():
            return 1

        assert rt.get(touch.remote(), timeout=60) == 1
        health = _cli(pkg, capsys, "healthcheck", "--address", both[pkg])
        mem = _cli(pkg, capsys, "memory", "--address", both[pkg])
        gc_ = _cli(pkg, capsys, "global-gc", "--address", both[pkg])
        del ref
        return health, mem, gc_

    got = {pkg: rerun_if_pkilled(program, pkg) for pkg in PKGS}
    (h_r, m_r, g_r), (h_p, m_p, g_p) = got["ref"], got["port"]
    assert h_p == h_r and h_p[0] == 0
    assert json.loads(h_p[1]) == {"healthy": True, "alive_nodes": 1}
    assert m_p[0] == m_r[0] == 0
    mem_r, mem_p = json.loads(m_r[1]), json.loads(m_p[1])
    assert sorted(mem_p) == sorted(mem_r)
    assert sorted(mem_p["storage"]) == sorted(mem_r["storage"])
    assert sorted(mem_p["nodes"][0]) == sorted(mem_r["nodes"][0])
    assert mem_p["nodes"][0]["num_objects"] >= 1
    assert mem_p["nodes"][0]["used_bytes"] > 1_000_000
    assert mem_p["storage"]["nodes_spill_degraded"] == []
    assert g_p == g_r and "triggered" in g_p[1]


def test_healthcheck_fails_without_a_cluster(capsys):
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    rc, out = _cli("port", capsys, "healthcheck", "--address", dead)
    assert rc == 1 and out.startswith("unhealthy:")


def test_grafana_factory_matches_reference(tmp_path):
    ref_g, port_g = _mod("ref", "grafana"), _mod("port", "grafana")
    for name in ("generate_default_dashboard", "generate_train_dashboard",
                 "generate_serve_dashboard"):
        ref_dash = getattr(ref_g, name)()
        port_dash = getattr(port_g, name)()
        assert json.loads(_to_port(json.dumps(ref_dash))) == port_dash
        exprs = [t["expr"] for p in port_dash["panels"]
                 for t in p["targets"]]
        assert all(re.findall(r"ray_tpu[a-z_]*", e)
                   and all(s.startswith("ray_tpu_torch_")
                           for s in re.findall(r"ray_tpu[a-z_]*", e))
                   for e in exprs)
    dash = port_g.generate_default_dashboard()
    assert dash["uid"] == "ray-tpu-torch-core"
    assert dash["tags"] == ["ray_tpu_torch"]
    paths = {pkg: _mod(pkg, "grafana").export_dashboards(
        str(tmp_path / pkg)) for pkg in PKGS}
    assert [os.path.basename(p) for p in paths["port"]] == \
        [_to_port(os.path.basename(p)) for p in paths["ref"]]
    for r, p in zip(paths["ref"], paths["port"]):
        with open(r) as f:
            ref_doc = f.read()
        with open(p) as f:
            assert json.loads(_to_port(ref_doc)) == json.load(f)


def test_cli_metrics_export_dashboards_matches_reference(tmp_path, capsys):
    for pkg in PKGS:
        out = str(tmp_path / pkg)
        assert _mod(pkg, "__main__").main(
            ["metrics", "export-dashboards", "--out-dir", out,
             "--which", "train"]) == 0
    capsys.readouterr()
    assert os.listdir(tmp_path / "ref") == ["ray_tpu_train.json"]
    assert os.listdir(tmp_path / "port") == ["ray_tpu_torch_train.json"]
    with open(tmp_path / "ref" / "ray_tpu_train.json") as f:
        ref_doc = f.read()
    with open(tmp_path / "port" / "ray_tpu_torch_train.json") as f:
        assert json.load(f) == json.loads(_to_port(ref_doc))


def _breakpoint(pkg):
    rt = PKGS[pkg]
    rpdb = _mod(pkg, "util.rpdb")
    gcs = _mod(pkg, "core.api")._global_worker().gcs
    set_trace_mod = f"{rt.__name__}.util.rpdb"

    @rt.remote
    def buggy():
        import importlib

        x = 41
        importlib.import_module(set_trace_mod).set_trace()
        return x + 1

    ref = buggy.remote()
    deadline = time.time() + 30
    bps = []
    while time.time() < deadline and not bps:
        bps = rpdb.list_breakpoints(gcs)
        time.sleep(0.2)
    assert bps, "breakpoint never registered"
    entry_keys = sorted(bps[0])
    conn = socket.create_connection((bps[0]["host"], bps[0]["port"]),
                                    timeout=10)
    f = conn.makefile("rw")
    f.write("p x\n")
    f.flush()
    out = ""
    conn.settimeout(10)
    while "41" not in out:
        out += conn.recv(4096).decode()
    f.write("c\n")
    f.flush()
    result = rt.get(ref, timeout=30)
    conn.close()
    deadline = time.time() + 10
    while time.time() < deadline and rpdb.list_breakpoints(gcs):
        time.sleep(0.2)
    return {"result": result, "keys": entry_keys, "prompt": "(rpdb)" in out,
            "left": rpdb.list_breakpoints(gcs)}


def test_remote_pdb_breakpoint_matches_reference(both):
    got = {pkg: rerun_if_killed(_breakpoint, pkg) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == {"result": 42, "keys": got["ref"]["keys"],
                           "prompt": True, "left": []}
    from ray_tpu_torch.util import rpdb

    assert rpdb._KV_NS == "ray_tpu_torch_rpdb"


def test_debug_cli_without_breakpoints(both, capsys):
    rc = {pkg: _cli(pkg, capsys, "debug", "--address", both[pkg])
          for pkg in PKGS}
    assert rc["port"] == rc["ref"] == (1, "no active breakpoints\n")


# --------------------------------------------------- daemon and otel (aux)


def _daemon_and_driver(pkg):
    rt = PKGS[pkg].__name__
    proc = subprocess.Popen(
        [sys.executable, "-m", rt, "start", "--head", "--num-cpus", "2",
         "--resources", json.dumps({ACC[pkg]: 1})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        address = None
        deadline = time.time() + 60
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "GCS address:" in line:
                address = line.split("GCS address:")[1].strip()
                break
        assert address, "daemon did not print its GCS address"
        driver = subprocess.run(
            [sys.executable, "-c",
             f"import {rt}\n"
             f"{rt}.init(address='{address}')\n"
             f"@{rt}.remote\n"
             "def f(x):\n"
             "    return x + 1\n"
             f"print('RESULT', {rt}.get(f.remote(41)),"
             f" {rt}.cluster_resources().get('{ACC[pkg]}'))\n"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        return [l for l in driver.stdout.splitlines()
                if l.startswith("RESULT")], driver.stderr
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_cli_start_daemon_and_connect_matches_reference():
    got = {pkg: _daemon_and_driver(pkg) for pkg in PKGS}
    assert got["port"][0] == got["ref"][0] == ["RESULT 42 1.0"], got


def _otel_spans(pkg):
    tracing = _mod(pkg, "util.tracing")
    otel = _mod(pkg, "util.otel")
    finished, tracers = [], []

    class _Span:
        def __init__(self, name, start_time):
            self.name, self.start_time, self.attributes = name, start_time, {}

        def set_attribute(self, k, v):
            self.attributes[k] = v

        def end(self, end_time=None):
            self.end_time = end_time
            finished.append(self)

    class _Tracer:
        def start_span(self, name, start_time=None):
            return _Span(name, start_time)

    class _Provider:
        def get_tracer(self, name):
            tracers.append(name)
            return _Tracer()

    otel.enable_otel_tracing(_Provider())
    try:
        with tracing.span("unit::otel", "test", foo="bar"):
            pass
    finally:
        otel.disable_otel_tracing()
    with tracing.span("unit::otel::after", "test"):
        pass
    # only this test's spans: the runtimes' threads may record their own
    return tracers, [(s.name, s.attributes, s.end_time >= s.start_time)
                     for s in finished if s.name.startswith("unit::")]


def test_otel_bridge_exports_the_reference_spans():
    got = {pkg: _otel_spans(pkg) for pkg in PKGS}
    assert got["ref"][1] == got["port"][1] == [
        ("unit::otel", {"category": "test", "foo": "bar"}, True)]
    assert got["port"][0] == ["ray_tpu_torch"]


# ----------------------------------------------------- dashboard UI and REST


def _rest_deploy(pkg, tmp_path):
    rt = PKGS[pkg]
    serve = _mod(pkg, "serve")
    app_dir = tmp_path / f"restapp_{pkg}"
    app_dir.mkdir(exist_ok=True)
    mod_name = f"rest_demo_app_{pkg}"
    (app_dir / f"{mod_name}.py").write_text(
        f"from {rt.__name__} import serve\n\n"
        "@serve.deployment(num_replicas=1)\n"
        "def hello(x):\n"
        "    return f'hi {x}'\n\n"
        "app = hello.bind()\n")
    server, port = _mod(pkg, "dashboard").start_dashboard()
    sys.path.insert(0, str(app_dir))
    try:
        cfg = {"applications": [
            {"name": "demo", "import_path": f"{mod_name}:app"}]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/serve/applications",
            data=json.dumps(cfg).encode(), method="PUT")
        deployed = json.loads(urllib.request.urlopen(req, timeout=60).read())
        h = serve.get_deployment_handle("hello")
        answer = rt.get(h.remote("rest"), timeout=60)
        _, status = _get(port, "/api/serve/applications")
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/serve/applications",
            data=json.dumps({"nope": 1}).encode(), method="PUT")
        try:
            urllib.request.urlopen(bad, timeout=30)
            bad_code = 200
        except urllib.error.HTTPError as e:
            bad_code = e.code
        return deployed, answer, sorted(json.loads(status)), bad_code
    finally:
        try:
            serve.shutdown()
        finally:
            sys.path.remove(str(app_dir))
            server.shutdown()


def test_serve_rest_deploy_roundtrip_matches_reference(both, tmp_path):
    got = {pkg: rerun_if_pkilled(_rest_deploy, pkg, tmp_path,
                                 reset=_mod(pkg, "serve").shutdown)
           for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"deployed": {"demo": "hello"}}
    assert got["port"][1] == "hi rest" and "hello" in got["port"][2]
    assert got["port"][3] == 400


# ------------------------------------------------------------------- joblib


def test_joblib_backend_matches_reference(both):
    joblib = pytest.importorskip("joblib")
    got = {}
    for pkg in PKGS:
        _mod(pkg, "util.joblib").register_backend()
        name = PKGS[pkg].__name__

        def program():
            with joblib.parallel_backend(name, n_jobs=2):
                return joblib.Parallel()(joblib.delayed(lambda x: x * 10)(i)
                                         for i in range(6))

        got[pkg] = rerun_if_killed(program)
    assert got["port"] == got["ref"] == [0, 10, 20, 30, 40, 50]


# ------------------------------------------------------- rllib, the gauge


def test_rllib_subcommand_exits_2_with_one_line(capsys, tmp_path):
    """Without a card (and without `--device cpu`) `rllib train` and
    `rllib evaluate` exit 2 with one line naming the missing card; with
    `--device cpu` an iteration trains, checkpoints and evaluates."""
    import torch

    from ray_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for argv in (["rllib", "train", "--algo", "ppo"],
                 ["rllib", "evaluate", "--algo", "ppo",
                  "--checkpoint-path", "/nonexistent"]):
        assert main(argv) == 2
        out = capsys.readouterr()
        assert out.out == ""
        assert len(out.err.strip().splitlines()) == 1
        assert "rllib" in out.err and "no CUDA card" in out.err
    ckpt = str(tmp_path / "ppo")
    started = not ray_tpu_torch.is_initialized()
    try:
        assert main(["rllib", "train", "--algo", "ppo", "--stop-iters", "1",
                     "--num-workers", "1", "--device", "cpu",
                     "--checkpoint-path", ckpt]) == 0
        assert main(["rllib", "evaluate", "--algo", "ppo", "--device", "cpu",
                     "--checkpoint-path", ckpt, "--episodes", "1"]) == 0
    finally:
        if started:
            ray_tpu_torch.shutdown()
    out = capsys.readouterr().out
    assert "iter 1: reward=" in out and f"checkpoint: {ckpt}" in out
    assert json.loads(out[out.index("{"):])["num_episodes"] == 1
    # it parses as the reference's: a missing --algo is argparse's error
    with pytest.raises(SystemExit) as e:
        main(["rllib", "train"])
    assert e.value.code == 2
    capsys.readouterr()


def test_save_sharded_sets_the_checkpoint_gauge(tmp_path):
    import torch

    from ray_tpu_torch.train import checkpointing
    from ray_tpu_torch.util.metrics import export_prometheus

    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "step": 3}
    checkpointing.save_sharded(state, str(tmp_path / "ckpt"))
    text = export_prometheus()
    m = re.search(r"^ray_tpu_torch_checkpoint_save_seconds ([0-9.e+-]+)$",
                  text, re.MULTILINE)
    assert m, text
    seconds = checkpointing.pop_last_save_seconds()
    assert seconds > 0 and float(m.group(1)) == seconds
    assert "# HELP ray_tpu_torch_checkpoint_save_seconds last checkpoint " \
           "save time" in text


def test_cli_has_every_reference_subcommand(capsys):
    """The port's parser is the reference's: the same subcommands, and the
    same ones under `serve`, `job`, `rllib` and `metrics`."""
    def commands(pkg, *argv):
        with pytest.raises(SystemExit) as e:
            _mod(pkg, "__main__").main([*argv, "--help"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        return re.search(r"\{([a-z,-]+)\}", out).group(1).split(",")

    for argv in ((), ("serve",), ("job",), ("rllib",), ("metrics",)):
        assert commands("port", *argv) == commands("ref", *argv), argv
    assert "start" in commands("port") and "debug" in commands("port")
