"""The port's Serve against the reference's: the same driver programs run on
ray_tpu + ray_tpu.serve and on ray_tpu_torch + ray_tpu_torch.serve, both
runtimes alive in this process, and give equal results and exceptions of
the same types; `LLMDeployment` on `tiny` serves the JAX package's tokens
exactly, through the handle and the HTTP stream, in float32 and w8a16.

Each program takes a dict with the runtime module, its serve package and
the package's name. Deployments are defined inside the programs, so
cloudpickle ships them by value to replicas that cannot import this test
module. Exceptions are compared by type name (each package has its own
classes). The slow tests (`-m slow`) run the multi-replica behaviours:
autoscaling, rolling redeploy, the controller crash, per-node proxies and
the full storm.
"""

import http.client
import json
import os
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
from torch_runtime import both_runtimes as _both
from torch_runtime import rerun_if_pkilled

SIDES = {
    "ref": {"rt": ray_tpu, "serve": ray_tpu.serve, "pkg": "ray_tpu"},
    "port": {"rt": ray_tpu_torch, "serve": ray_tpu_torch.serve,
             "pkg": "ray_tpu_torch"},
}


def _reset(a):
    """Serve torn down on `a`'s runtime (after an outside pkill)."""
    try:
        a["serve"].shutdown()
    except Exception:  # the controller died with its worker
        pass
    a.pop("http_port", None)


def _run(program, a):
    return rerun_if_pkilled(program, a, reset=lambda: _reset(a))


def _both_sides(program):
    """(reference result, port result) of `program`."""
    return _run(program, SIDES["ref"]), _run(program, SIDES["port"])


def _http_port(a):
    """The runtime's one HTTP proxy, started at its first use."""
    if "http_port" not in a:
        _, a["http_port"] = a["serve"].start_http_proxy()
    return a["http_port"]


def _http(port, method, path, body=None, raw=None, ctype=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    if raw is None and body is not None:
        raw, ctype = json.dumps(body).encode(), "application/json"
    conn.request(method, path, body=raw,
                 headers={"Content-Type": ctype} if ctype else {})
    resp = conn.getresponse()
    out = (resp.status, resp.headers.get("Content-Type"), resp.read())
    conn.close()
    return out


def _stream(port, path, body):
    """The JSON lines of a chunked `?stream=1` response, as they arrive."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    status, items = resp.status, []
    while True:
        line = resp.readline()
        if not line:
            break
        if line.strip():
            items.append(json.loads(line))
    conn.close()
    return status, items


def _raises(fn):
    """(exception type name, message) of `fn()`, or None."""
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _poll(fn, ok, timeout=30.0):
    """`fn()` until `ok(value)` or the timeout; the last value."""
    deadline = time.monotonic() + timeout
    v = fn()
    while not ok(v) and time.monotonic() < deadline:
        time.sleep(0.2)
        v = fn()
    return v


# ---------------------------------------------------------------- programs


def prog_function_and_class(a):
    rt, serve = a["rt"], a["serve"]

    @serve.deployment
    def echo(payload):
        return {"echo": payload}

    @serve.deployment(num_replicas=1)
    class Model:
        def __init__(self, scale):
            self.scale = scale

        def __call__(self, x):
            return x * self.scale

        def info(self):
            return {"scale": self.scale}

    h = serve.run(echo.bind())
    out = {"echo": rt.get(h.remote({"x": 1}), timeout=60)}
    h = serve.run(Model.bind(3))
    out["call"] = rt.get(h.remote(7), timeout=60)
    out["info"] = rt.get(h.options(method_name="info").remote(), timeout=60)
    out["missing_method"] = _raises(lambda: rt.get(
        h.options(method_name="nope").remote(), timeout=60))[0]
    out["status"] = serve.status()
    for name in ("echo", "Model"):
        out[f"delete_{name}"] = serve.delete(name)
    out["delete_again"] = serve.delete("echo")
    return out


def prog_redeploy_and_reconfigure(a):
    rt, serve = a["rt"], a["serve"]

    def version(v):
        @serve.deployment(name="svc")
        def app(_):
            return v

        return app

    h = serve.run(version("v1").bind())
    out = {"v1": rt.get(h.remote(None), timeout=60)}
    h = serve.run(version("v2").bind())
    out["v2"] = _poll(lambda: rt.get(h.remote(None), timeout=60),
                      lambda v: v == "v2")

    @serve.deployment(user_config={"factor": 10})
    class Scaler:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            import os

            return {"pid": os.getpid(), "y": x * self.factor}

    h = serve.run(Scaler.bind())
    first = rt.get(h.remote(1), timeout=60)
    serve.run(Scaler.options(user_config={"factor": 99}).bind())
    second = _poll(lambda: rt.get(h.remote(1), timeout=60),
                   lambda o: o["y"] == 99)
    out["reconfigure_call"] = serve.reconfigure("Scaler", {"factor": 7})
    third = rt.get(h.remote(1), timeout=60)
    out["ys"] = [first["y"], second["y"], third["y"]]
    out["same_replica"] = first["pid"] == second["pid"] == third["pid"]
    out["unknown"] = _raises(lambda: serve.reconfigure("nope", {}))[0]
    for name in ("svc", "Scaler"):
        serve.delete(name)
    return out


def prog_graph(a):
    rt, serve = a["rt"], a["serve"]

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Ingress:
        def __init__(self, doubler, pkg):
            import importlib

            self.doubler = doubler
            self.rt = importlib.import_module(pkg)

        def __call__(self, x):
            return self.rt.get(self.doubler.remote(x)) + 1

    h = serve.run(Ingress.bind(Doubler.bind(), a["pkg"]))
    out = {"composed": rt.get(h.remote(21), timeout=60),
           "status": {k: v for k, v in serve.status().items()
                      if k in ("Doubler", "Ingress")}}

    @serve.deployment
    class A:
        pass

    x = A.bind()
    y = A.options(name="B").bind(x)
    x.init_args = (y,)  # a -> b -> a
    kind, msg = _raises(lambda: serve.run(x))
    out["cycle"] = (kind, "cycle" in msg)
    kind, msg = _raises(lambda: serve.run(A.bind(A.bind())))
    out["duplicate_names"] = (kind, "duplicate" in msg)
    for name in ("Doubler", "Ingress"):
        serve.delete(name)
    return out


def prog_batch(a):
    rt, serve = a["rt"], a["serve"]

    @serve.deployment(max_concurrent_queries=16)
    class Doubler:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        def sizes(self):
            return self.batch_sizes

    @serve.deployment(max_concurrent_queries=8)
    class Boom:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def __call__(self, xs):
            raise RuntimeError("batch failed")

    h = serve.run(Doubler.bind())
    out = {"results": rt.get([h.remote(i) for i in range(16)], timeout=60)}
    sizes = rt.get(h.options(method_name="sizes").remote(), timeout=60)
    out["sizes"] = (sum(sizes), max(sizes) > 1)
    h = serve.run(Boom.bind())
    out["error"] = _raises(lambda: rt.get(h.remote(1), timeout=60))
    for name in ("Doubler", "Boom"):
        serve.delete(name)
    return out


def prog_http(a):
    serve = a["serve"]

    @serve.deployment
    def add_one(payload):
        return payload["x"] + 1

    @serve.deployment
    def Echo(payload):
        return payload

    @serve.deployment
    def mirror(data):
        return data[::-1]

    @serve.deployment
    def ticker(payload):
        import time

        for i in range(4):
            time.sleep(0.3)
            yield {"tok": i}

    app = serve.App()

    @app.middleware
    def stamp(request, call_next):
        out = call_next(request)
        if isinstance(out, dict):
            out["via"] = out.get("via", "") + "mw"
        return out

    @serve.deployment
    @serve.ingress(app)
    class Store:
        def __init__(self):
            self.items = {"1": "apple"}

        @app.get("/items/{item_id}")
        def get_item(self, request, item_id):
            return {"item": self.items[item_id]}

        @app.post("/items/{item_id}")
        def put_item(self, request, item_id):
            self.items[item_id] = request.payload["value"]
            return {"stored": item_id}

        @app.get("/search")
        def search(self, request):
            q = request.query.get("q", "")
            return {"hits": [k for k, v in self.items.items() if q in v]}

    for d in (add_one, Echo, mirror, ticker, Store):
        serve.run(d.bind(), name=d.name)
    port = _http_port(a)
    out = {}
    status, _, body = _http(port, "POST", "/add_one", {"x": 41})
    out["post"] = (status, json.loads(body))
    status, _, body = _http(port, "GET", "/Echo?a=1&b=x")
    out["get"] = (status, json.loads(body))
    blob = bytes(range(256)) * 4
    status, ctype, body = _http(port, "POST", "/mirror", raw=blob,
                                ctype="application/octet-stream")
    out["binary"] = (status, ctype, body == blob[::-1])
    t0 = time.monotonic()
    out["stream"] = _stream(port, "/ticker?stream=1", {})
    out["streamed_in_s"] = time.monotonic() - t0 >= 1.0
    out["routes"] = [
        (s, json.loads(b)) for s, _, b in (
            _http(port, "GET", "/Store/items/1"),
            _http(port, "POST", "/Store/items/2", {"value": "pear"}),
            _http(port, "GET", "/Store/search?q=pear"))]
    status, _, body = _http(port, "GET", "/Store/nope/deeper")
    out["route_404"] = (status, "matched no route" in json.loads(
        body)["error"])
    for d in (add_one, Echo, mirror, ticker, Store):
        serve.delete(d.name)
    return out


def prog_rpc(a):
    rt, serve = a["rt"], a["serve"]
    rpc = __import__(f"{a['pkg']}.core.rpc", fromlist=["RpcClient"])

    @serve.deployment
    class Adder:
        def __call__(self, a, b):
            return a + b

    serve.run(Adder.bind())
    actor, port = serve.start_rpc_proxy()
    c = rpc.RpcClient(f"127.0.0.1:{port}")
    try:
        out = {"sum": c.call("serve_request",
                             {"deployment": "Adder", "args": (19, 23)},
                             timeout=60)}
        out["bad_method"] = _raises(lambda: c.call(
            "serve_request", {"deployment": "Adder",
                              "method": "no_such_method", "args": (1, 2)},
            timeout=60))[0]
    finally:
        c.close()
    rt.kill(actor)
    serve.delete("Adder")
    return out


def prog_grpc(a):
    import grpc

    serve = a["serve"]

    @serve.deployment
    def echo(payload):
        return {"echo": payload}

    @serve.deployment
    def ticker(payload):
        import time

        for i in range(3):
            time.sleep(0.2)
            yield {"tok": i}

    serve.run(echo.bind(), name="e")
    serve.run(ticker.bind(), name="t")
    actor, port = serve.start_grpc_proxy()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        predict = ch.unary_unary("/rayserve.Ingress/Predict")
        out = {"unary": json.loads(predict(
            json.dumps({"x": 41}).encode(),
            metadata=(("deployment", "echo"),), timeout=60))}
        stream = ch.unary_stream("/rayserve.Ingress/PredictStream")
        out["stream"] = [json.loads(m)["result"] for m in stream(
            b"{}", metadata=(("deployment", "ticker"),), timeout=60)]
        try:
            predict(b"{}", timeout=30)
            out["no_metadata"] = None
        except grpc.RpcError as e:
            out["no_metadata"] = str(e.code())
    finally:
        ch.close()
    a["rt"].kill(actor)
    serve.delete("echo")
    serve.delete("ticker")
    return out


def prog_yaml(a, tmp):
    rt, serve = a["rt"], a["serve"]
    mod = f"serve_yaml_app_{a['pkg']}"
    (tmp / f"{mod}.py").write_text(
        f"from {a['pkg']} import serve\n"
        "@serve.deployment\n"
        "def Hello(payload):\n"
        "    return 'hello ' + str(payload.get('who'))\n"
        "app = Hello.bind()\n")
    cfg = tmp / f"{a['pkg']}.yaml"
    cfg.write_text(
        "applications:\n"
        "  - name: hello_app\n"
        f"    import_path: {mod}:app\n"
        "    deployments:\n"
        "      - name: Hello\n"
        "        num_replicas: 1\n")
    sys.path.insert(0, str(tmp))
    try:
        out = {"deployed": serve.deploy_config_file(str(cfg))}
        h = serve.get_deployment_handle("Hello")
        out["call"] = rt.get(h.remote({"who": "gpu"}), timeout=60)
        out["target"] = serve.status()["Hello"]["target"]
        (tmp / "bad.yaml").write_text("nothing: here\n")
        out["bad"] = _raises(lambda: serve.deploy_config_file(
            str(tmp / "bad.yaml")))[0]
    finally:
        sys.path.remove(str(tmp))
    serve.delete("Hello")
    return out


def _metric_names(snap, pkg):
    prefix = f"{pkg}_serve_"
    assert all(k.startswith(prefix) for k in snap), sorted(snap)
    return sorted(k[len(prefix):] for k in snap)


def prog_metrics(a):
    """The serve series, by name: the driver's router, the HTTP proxy's
    (pulled as `_update_serve_gauges` does for a scrape, through the state
    API's actor listing) and the controller-fed gauges."""
    rt, serve, pkg = a["rt"], a["serve"], a["pkg"]
    metrics = __import__(f"{pkg}.util.metrics", fromlist=["snapshot"])

    @serve.deployment
    def pingpong(payload):
        return {"pong": payload.get("n", 0)}

    h = serve.run(pingpong.bind())
    for i in range(3):
        rt.get(h.remote({"n": i}), timeout=60)
    port = _http_port(a)
    for i in range(3):
        _http(port, "POST", "/pingpong", {"n": i})
    out = {"driver": _metric_names(metrics.snapshot(f"{pkg}_serve_"), pkg)}
    proxy = rt.get_actor(serve.api.PROXY_NAME)
    proxy_snap = rt.get(proxy.metrics_snapshot.remote(), timeout=60)
    out["proxy"] = _metric_names(proxy_snap, pkg)
    requests = proxy_snap[f"{pkg}_serve_requests_total"]["values"]
    out["proxy_requests"] = [v for k, v in requests.items()
                             if "pingpong" in str(k)]
    serve.api._update_serve_gauges()
    out["after_scrape"] = _metric_names(metrics.snapshot(f"{pkg}_serve_"),
                                        pkg)
    state = __import__(f"{pkg}.state", fromlist=["list_actors"])
    out["proxy_listed"] = any(
        x["name"] == serve.api.PROXY_NAME and x["state"] == "ALIVE"
        for x in state.list_actors())
    serve.delete("pingpong")
    return out


def prog_deadlines(a):
    rt, serve = a["rt"], a["serve"]
    cfg_mod = __import__(f"{a['pkg']}.serve.config", fromlist=["x"])

    @serve.deployment
    def stall(_):
        import time

        time.sleep(2)
        return "late"

    h = serve.run(stall.bind())
    serve.reset_router_stats()
    cfg_mod.set_serve_config(max_queue_per_replica=1)
    try:
        first = h.remote(None, _timeout_s=20)
        out = {"shed": _raises(lambda: h.remote(None))[0],
               "router_shed": serve.router_stats()["shed"],
               "first": rt.get(first, timeout=30)}
    finally:
        cfg_mod.reset_serve_config()
    t0 = time.monotonic()
    out["timeout"] = _raises(lambda: rt.get(h.remote(None, _timeout_s=0.5),
                                            timeout=10))[0]
    out["fast"] = time.monotonic() - t0 < 1.5
    serve.reset_router_stats()
    serve.delete("stall")
    return out


PROGRAMS = {p.__name__[len("prog_"):]: p for p in (
    prog_function_and_class, prog_redeploy_and_reconfigure, prog_graph,
    prog_batch, prog_http, prog_rpc, prog_metrics, prog_deadlines)}


# what each program's port result must hold, beside equality with ray_tpu's
CHECKS = {
    "function_and_class": lambda o: (
        o["echo"] == {"echo": {"x": 1}} and o["call"] == 21
        and o["info"] == {"scale": 3} and o["delete_echo"]
        and not o["delete_again"]),
    "redeploy_and_reconfigure": lambda o: (
        (o["v1"], o["v2"]) == ("v1", "v2") and o["ys"] == [10, 99, 7]
        and o["same_replica"] and o["reconfigure_call"]),
    "graph": lambda o: (
        o["composed"] == 43 and o["cycle"] == ("ValueError", True)
        and o["duplicate_names"] == ("ValueError", True)
        and o["status"]["Ingress"]["replicas"] == 1),
    "batch": lambda o: (
        o["results"] == [2 * i for i in range(16)]
        and o["sizes"] == (16, True)
        and o["error"] == ("RuntimeError", "batch failed")),
    "http": lambda o: (
        o["post"] == (200, {"result": 42})
        and o["get"] == (200, {"result": {"a": "1", "b": "x"}})
        and o["binary"] == (200, "application/octet-stream", True)
        and o["stream"] == (200, [{"tok": i} for i in range(4)])
        and o["routes"][0] == (200, {"result": {"item": "apple",
                                                "via": "mw"}})
        and o["routes"][2] == (200, {"result": {"hits": ["2"],
                                                "via": "mw"}})
        and o["route_404"] == (404, True)),
    "rpc": lambda o: o["sum"] == 42 and o["bad_method"] == "RpcCallError",
    "metrics": lambda o: (
        {"requests_total", "latency_seconds"} <= set(o["proxy"])
        and {"replicas", "queue_depth"} <= set(o["after_scrape"])
        and o["proxy_requests"] == [3] and o["proxy_listed"]),
    "deadlines": lambda o: (
        o["shed"] == "BackPressureError" and o["router_shed"] == 1
        and o["first"] == "late" and o["timeout"] == "RequestTimeoutError"
        and o["fast"]),
}


PROMPTS = [([5, 17, 400, 3], 6), ([9, 2], 5), ([1, 2, 3, 4, 5, 6, 7], 4)]


@pytest.fixture(scope="module")
def tiny_params():
    """`tiny` (float32) from PRNGKey(0): the JAX tree and the port's copy
    carried over bit for bit."""
    from ray_tpu.models import ModelConfig as JaxConfig
    from ray_tpu.models import init_params
    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig

    jcfg, cfg = JaxConfig.tiny(), ModelConfig.tiny()
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                         device="cpu")
    return {"ref": (jp, jcfg), "port": (tp, cfg)}


def prog_llm(a, params, cfg, quantize):
    """Each prompt through the handle one at a time, then the first again
    as an HTTP token stream."""
    rt, serve = a["rt"], a["serve"]
    serving = __import__(f"{a['pkg']}.models.serving",
                         fromlist=["LLMDeployment"])
    kw = {"device": "cpu"} if a["pkg"] == "ray_tpu_torch" else {}
    D = serve.deployment(serving.LLMDeployment(
        params, cfg, num_slots=2, max_len=64, quantize_weights=quantize,
        **kw))
    h = serve.run(D.bind())
    out = {"handle": [rt.get(h.remote({"prompt": p, "max_new_tokens": n}),
                             timeout=300) for p, n in PROMPTS]}
    prompt, n = PROMPTS[0]
    out["http"] = _stream(_http_port(a), "/LLMDeployment/stream?stream=1",
                          {"prompt": prompt, "max_new_tokens": n})
    serve.delete("LLMDeployment")
    return out


def prog_autoscale(a):
    rt, serve = a["rt"], a["serve"]

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_num_ongoing_requests_per_replica": 1.0,
        "upscale_delay_s": 0.1})
    class Slow:
        def __call__(self, _):
            import time

            time.sleep(1.0)
            return "ok"

    h = serve.run(Slow.bind())
    refs = [h.remote(None) for _ in range(8)]
    target = _poll(lambda: serve.status()["Slow"]["target"],
                   lambda t: t > 1, timeout=30)
    out = {"scaled": target > 1, "results": rt.get(refs, timeout=60)}
    serve.delete("Slow")
    return out


def prog_rolling(a):
    rt, serve = a["rt"], a["serve"]

    def make(version):
        @serve.deployment(num_replicas=2, name="roller")
        def app(x):
            return {"v": version, "x": x}

        return app

    h = serve.run(make(1).bind())
    out = {"v1": rt.get(h.remote(0), timeout=60)["v"]}
    h = serve.run(make(2).bind())
    seen, settled = set(), False
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline and not settled:
        seen.add(rt.get(h.remote(1), timeout=30)["v"])  # never fails
        settled = all(rt.get(h.remote(i), timeout=30)["v"] == 2
                      for i in range(6))
        time.sleep(0.2)
    out.update(seen=sorted(seen) == [1, 2] or seen == {2}, settled=settled)
    serve.delete("roller")
    return out


def prog_controller_crash(a):
    rt, serve = a["rt"], a["serve"]

    def make(version):
        @serve.deployment(num_replicas=2, name="survivor")
        def app(x):
            import os

            return {"v": version, "pid": os.getpid()}

        return app

    h = serve.run(make(1).bind())
    pids = {rt.get(h.remote(0), timeout=60)["pid"] for _ in range(10)}
    rt.kill(rt.get_actor(serve.api.CONTROLLER_NAME))
    time.sleep(1.0)
    h = serve.run(make(2).bind())
    out = {"replicas_before": len(pids),
           "status": serve.status()["survivor"]}
    settled = False
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline and not settled:
        settled = all(rt.get(h.remote(i), timeout=30)["v"] == 2
                      for i in range(6))
        time.sleep(0.2)
    out["rolled_to_v2"] = settled
    serve.delete("survivor")
    return out


@pytest.fixture(scope="class")
def both_runtimes():
    """One node of each runtime, alive together: 4 CPUs and two
    accelerators (ray_tpu's TPU chips, the port's GPUs). Serve is shut down
    on both before the runtimes go."""
    with _both(num_cpus=4, accelerators=2):
        try:
            yield
        finally:
            for a in SIDES.values():
                _reset(a)


@pytest.mark.usefixtures("both_runtimes")
class TestOnBothRuntimes:
    @pytest.mark.parametrize("program", list(PROGRAMS))
    def test_program(self, program):
        ref, port = _both_sides(PROGRAMS[program])
        assert port == ref
        assert CHECKS[program](port), port

    def test_grpc_ingress(self):
        pytest.importorskip("grpc", reason="grpc does not import")
        ref, port = _both_sides(prog_grpc)
        assert port == ref
        assert port["unary"] == {"result": {"echo": {"x": 41}}}
        assert port["stream"] == [{"tok": i} for i in range(3)]
        assert port["no_metadata"] is not None

    def test_yaml_config_deploy(self, tmp_path):
        pytest.importorskip("yaml", reason="yaml does not import")
        ref = rerun_if_pkilled(prog_yaml, SIDES["ref"], tmp_path,
                               reset=lambda: _reset(SIDES["ref"]))
        port = rerun_if_pkilled(prog_yaml, SIDES["port"], tmp_path,
                                reset=lambda: _reset(SIDES["port"]))
        assert port == ref
        assert port["deployed"] == {"hello_app": "Hello"}
        assert (port["call"], port["target"]) == ("hello gpu", 1)
        assert port["bad"] == "ValueError"

    @pytest.mark.parametrize("quantize", [False, True],
                             ids=["float32", "w8a16"])
    def test_llm_deployment_serves_the_jax_tokens(self, tiny_params,
                                                  quantize):
        ref = rerun_if_pkilled(prog_llm, SIDES["ref"], *tiny_params["ref"],
                               quantize, reset=lambda: _reset(SIDES["ref"]))
        port = rerun_if_pkilled(prog_llm, SIDES["port"],
                                *tiny_params["port"], quantize,
                                reset=lambda: _reset(SIDES["port"]))
        assert port == ref
        for (prompt, n), toks in zip(PROMPTS, port["handle"]):
            assert toks[:len(prompt)] == prompt
            assert len(toks) == len(prompt) + n
        status, streamed = port["http"]
        assert status == 200
        assert PROMPTS[0][0] + streamed == port["handle"][0]

    def test_quick_storm_resolves_every_request(self, tmp_path):
        """run_storm at the CLI's --quick profile on the port: under ~4x
        load, seeded drops at the replica call and a replica killed every
        2 s, every request resolves as a result, a typed shed or a typed
        timeout."""
        from ray_tpu_torch.serve.storm import (QUICK_PROFILE, StormProfile,
                                               run_storm)

        profile = StormProfile(seed=20260804, **QUICK_PROFILE)
        artifact = tmp_path / "storm.json"
        result = rerun_if_pkilled(run_storm, profile, str(artifact),
                                  reset=lambda: _reset(SIDES["port"]))
        req = result["requests"]
        assert req["hung"] == 0, req
        assert req["submitted"] == (req["accepted"] + req["shed"]
                                    + req["timeout"] + req["replica_death"]
                                    + req["other_error"]), req
        assert req["other_error"] == 0 and req["accepted"] > 0, req
        assert result["replicas"]["kills"] >= 1, result["replicas"]
        assert json.loads(artifact.read_text())["zero_hung"] is True

    @pytest.mark.slow
    @pytest.mark.parametrize("program", [prog_autoscale, prog_rolling,
                                         prog_controller_crash],
                             ids=["autoscale", "rolling", "controller_crash"])
    def test_multi_replica_programs(self, program):
        ref, port = _both_sides(program)
        assert port == ref
        assert all(v for k, v in port.items()
                   if k in ("scaled", "seen", "settled", "rolled_to_v2"))


def _per_node_proxies(a):
    """Two nodes of the runtime's cluster, one proxy pinned to each, both
    serving one deployment."""
    rt, serve = a["rt"], a["serve"]
    cluster_mod = __import__(f"{a['pkg']}.core.cluster",
                             fromlist=["Cluster"])
    cluster = cluster_mod.Cluster()
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        @serve.deployment(num_replicas=2)
        def echo(x):
            return {"echo": x}

        serve.run(echo.bind(), name="pn")
        proxies = serve.start_http_proxies_per_node()
        out = {"nodes": len({p[0] for p in proxies})}
        out["answers"] = [json.loads(urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/echo",
                                   data=json.dumps("hi").encode(),
                                   method="POST"), timeout=60).read())
            for _, _, _, port in proxies]
        serve.shutdown()
        return out
    finally:
        cluster.shutdown()


@pytest.mark.slow
def test_per_node_http_proxies():
    """A cluster of two nodes per runtime (one runtime at a time: a
    `Cluster` connects this process as its driver)."""
    ref, port = (_per_node_proxies(SIDES[s]) for s in ("ref", "port"))
    assert port == ref
    assert port["nodes"] == 2
    assert port["answers"] == [{"result": {"echo": "hi"}}] * 2


@pytest.mark.slow
def test_full_storm_resolves_every_request(tmp_path):
    """The storm's default 30 s profile on the port, as the CLI runs it."""
    from ray_tpu_torch.serve import storm

    artifact = tmp_path / "storm.json"
    assert storm.main(["--seed", "20260804", "--json", str(artifact)]) == 0
    result = json.loads(artifact.read_text())
    req = result["requests"]
    assert req["hung"] == 0 and req["other_error"] == 0, req
    assert req["shed"] > 0 and result["replicas"]["kills"] >= 3
    assert result["router"]["retries"] >= 1
    assert result["fault_stats"].get("drop", 0) >= 1
    assert os.path.exists(artifact)
