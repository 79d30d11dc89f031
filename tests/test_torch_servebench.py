"""models/servebench's runner on the CPU, quick profile: the artifact has
the JAX package's keys (its committed SERVEBENCH_r16.json), latency aside;
asking for the latency row raises (its Serve runtime is not ported); and
`main` writes only the path it is given, never the JAX package's artifact."""

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


def test_latency_row_raises_until_serve_is_ported(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        servebench.run_servebench(quick=True, device="cpu")
    _on_the_cpu(monkeypatch)
    with pytest.raises(NotImplementedError, match="--no-latency"):
        servebench.main(["--json", str(tmp_path / "x.json")])
    assert not list(tmp_path.iterdir())

