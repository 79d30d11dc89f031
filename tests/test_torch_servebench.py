"""models/servebench's runner on the CPU, quick profile: the artifact has
the JAX package's keys (its committed SERVEBENCH_r16.json); the latency row
runs a Serve deployment of `LLMDeployment` on the port's runtime, started
and stopped around it; and `main` writes only the path it is given, never
the JAX package's artifact. Also the spans a deploy of `LLMDeployment`
leaves in `timeline()`. (The storm's `--kill-head` verdict is held against
the reference in tests/test_torch_harness_parity.py.)"""

import functools
import json
import os
from pathlib import Path

import pytest

from ray_tpu_torch.models import servebench

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "SERVEBENCH_r16.json"
# what the port adds: the card's name beside its backend
PORT_ONLY = {"device_name", "w8a16.weight_traffic_halves_claim.device_name"}


def _paths(node, prefix=""):
    """Every key path of a JSON tree (list rows by their first element)."""
    out = set()
    for k, v in node.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _paths(v, f"{prefix}{k}.")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= _paths(v[0], f"{prefix}{k}[].")
    return out


def _on_the_cpu(mp):
    """`main` runs on the card; bind its `run_servebench` to the CPU."""
    mp.setattr(servebench, "run_servebench",
               functools.partial(servebench.run_servebench, device="cpu"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One quick-profile `main` run on the CPU from an empty directory,
    with the reference artifact's pre-change numbers as the baseline."""
    work = tmp_path_factory.mktemp("servebench")
    base = work / "baseline.json"
    base.write_text(json.dumps(
        json.loads(REFERENCE.read_text())["baseline_pre_change"]))
    out = work / "out" / "art.json"
    out.parent.mkdir()
    ref_stat = REFERENCE.stat()
    default_existed = os.path.exists(servebench.DEFAULT_ARTIFACT)
    with pytest.MonkeyPatch.context() as mp:
        _on_the_cpu(mp)
        mp.chdir(work)
        rc = servebench.main(["--no-latency", "--json", str(out),
                              "--baseline", str(base)])
    return {"rc": rc, "work": work, "out": out, "ref_stat": ref_stat,
            "default_existed": default_existed,
            "art": json.loads(out.read_text())}


def test_artifact_has_the_reference_keys_latency_aside(run):
    assert run["rc"] == 0
    ref = json.loads(REFERENCE.read_text())
    want = {p for p in _paths(ref) if not p.startswith("latency_under_load")}
    assert _paths(run["art"]) == want | PORT_ONLY


def test_artifact_values_on_the_cpu(run):
    art = run["art"]
    assert (art["profile"], art["backend"], art["device_name"],
            art["n_chips"]) == ("quick", "cpu", "cpu", 1)
    assert art["model"] == {"d_model": 256, "n_layers": 4, "n_heads": 8,
                            "n_kv_heads": 4, "d_ff": 1024,
                            "vocab_size": 2048, "dtype": "float32",
                            "max_len": 512}
    assert [r["num_slots"] for r in art["slot_sweep"]] == [1, 4, 8]
    assert art["decode"]["num_slots"] == 8
    assert art["decode"]["decode_tokens_per_s"] == \
        art["slot_sweep"][-1]["decode_tokens_per_s"]
    q = art["w8a16"]
    assert q["logits_parity_ok"] and q["logits_max_abs_diff_rel"] < 0.08
    claim = q["weight_traffic_halves_claim"]
    # int8 values and a float32 scale a row, against float32 weights
    assert claim["bytes_claim_validated"] and 0.25 < q["weight_bytes_ratio"] < 0.27
    assert claim["backend"] == "cpu"
    # the note gives the measured ratio, and no cause the run did not measure
    if not claim["throughput_claim_validated_on_this_backend"]:
        assert claim["note"].endswith(
            f"{q['speedup_vs_unquantized']:.3f}x the unquantized model's "
            "tokens/s")
    assert (claim["throughput_claim_validated_on_this_backend"]
            == (q["speedup_vs_unquantized"] >= 1.5))
    assert art["prefill"]["batch"] == 4 and art["prefill"]["prompt_len"] == 64
    assert art["decode"]["speedup_vs_baseline"] > 0


def test_main_writes_only_the_path_it_is_given(run):
    assert sorted(p.name for p in run["work"].rglob("*")) == [
        "art.json", "baseline.json", "out"]
    assert os.path.exists(servebench.DEFAULT_ARTIFACT) == \
        run["default_existed"]
    stat = REFERENCE.stat()
    assert (stat.st_mtime_ns, stat.st_size) == (run["ref_stat"].st_mtime_ns,
                                                run["ref_stat"].st_size)


def test_default_artifact_is_the_ports_own_and_ignored_by_git():
    path = Path(servebench.DEFAULT_ARTIFACT)
    assert path.name != REFERENCE.name
    assert path.parent == REPO / "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_latency_row_on_the_ports_runtime(monkeypatch):
    """The reference's latency row, from a Serve deployment of
    `LLMDeployment` under the load generator (1 s of load here): its keys,
    nothing hung, nothing failed; the runner started the port's runtime
    for the row and stopped it after."""
    import ray_tpu_torch

    assert not ray_tpu_torch.is_initialized()
    monkeypatch.setattr(servebench, "measure_latency_under_load",
                        functools.partial(
                            servebench.measure_latency_under_load,
                            duration_s=1.0))
    art = servebench.run_servebench(quick=True, slot_sweep=(8,),
                                    device="cpu")
    assert not ray_tpu_torch.is_initialized()
    lat = art["latency_under_load"]
    ref = json.loads(REFERENCE.read_text())["latency_under_load"]
    assert set(lat) == set(ref)
    assert lat["hung"] == 0 and lat["errors"] == 0, lat
    assert lat["submitted"] == (lat["accepted"] + lat["shed"]
                                + lat["timeout"] + lat["errors"]), lat
    assert lat["accepted"] > 0 and 0 < lat["p50_ms"] <= lat["p99_ms"]
    assert (lat["offered_rps"], lat["max_new_tokens"]) == (6.0, 16)


def test_deploy_spans_on_the_real_deploy_path():
    """A deploy of `LLMDeployment` on `tiny` on the CPU leaves its spans in
    `timeline()`: the driver pickles and submits the definition and waits;
    the controller gets it as an argument and checkpoints it; the replica
    gets it, unpickles it and builds the engine. chip_smoke phase 18 reads
    the same spans from its deploy at 8B width."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import ModelConfig, init_params
    from ray_tpu_torch.models.serving import LLMDeployment
    from ray_tpu_torch.models.transformer import tree_leaves

    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0, device="cpu")
    driver = ["serve::pickle_definition", "serve::submit_deploy",
              "serve::await_deploy"]
    controller = ["serve::checkpoint_pickle", "serve::checkpoint_kv_put",
                  "serve::put_definition"]
    replica = ["serve::replica_unpickle", "serve::replica_construct"]
    ray_tpu_torch.init(num_cpus=2)
    try:
        since = time.time() * 1e6  # this process may hold earlier spans
        handle = serve.run(serve.deployment(LLMDeployment(
            params, cfg, num_slots=2, max_len=64, device="cpu")).bind())
        assert ray_tpu_torch.get(handle.remote(
            {"prompt": [1, 2, 3], "max_new_tokens": 2}), timeout=60)[:3] \
            == [1, 2, 3]
        deadline = time.monotonic() + 30
        while True:
            events = [e for e in ray_tpu_torch.timeline()
                      if e.get("ph") == "X" and e["ts"] >= since]
            names = {e["name"] for e in events}
            if set(driver + controller + replica) <= names or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    pids = {n: {e["pid"] for e in events if e["name"] == n}
            for n in driver + controller + replica}
    assert all(pids.values()), pids
    assert set().union(*(pids[n] for n in driver)) == {os.getpid()}
    c_pid = set().union(*(pids[n] for n in controller))
    r_pid = set().union(*(pids[n] for n in replica))
    assert len(c_pid) == len(r_pid) == 1 and c_pid != r_pid
    assert c_pid | r_pid | {os.getpid()} == set().union(*pids.values())
    # the definition crosses each process boundary as an object in the store
    got = {e["pid"] for e in events if e["name"] == "task::get_arg"}
    assert c_pid | r_pid <= got
    blob = [e["args"]["bytes"] for e in events
            if e["name"] == "serve::submit_deploy"]
    unpickled = [e["args"]["bytes"] for e in events
                 if e["name"] == "serve::replica_unpickle"]
    assert len(blob) == 1 and unpickled == blob
    assert blob[0] > sum(t.numel() * t.element_size()
                         for t in tree_leaves(params))
