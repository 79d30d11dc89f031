"""The port's Tune searchers, schedulers and loggers against ray_tpu's, on
the same inputs.

Each scenario of the reference's test_tune_loggers and test_tune_searchers
runs through both packages, one runtime of each alive side by side in this
process: the reference's assertions hold on each, and what its calls
return (each sweep's results, every searcher suggestion, PBT's explored
configs, the schedulers' decisions) is recorded and compared between the
two, where the scenario fixes it. ASHA's stops, PBT's exploits, the median
rule's and HyperBand's decisions, and the loggers' files are also compared
on streams that fix their order. Also test_tune's two slowest scenarios (a
driver killed mid-sweep and restored, a timeout); its others and the slice
as a whole are in tests/test_torch_tune_parity.py.
"""

import csv
import json
import struct

import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, normalize, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_killed

FILES = ("test_tune_loggers.py", "test_tune_searchers.py")
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
# scenarios whose recorded values depend on timing: trials running at once
# report in arrival order. The reference's own assertions still hold on
# both packages.
UNCOMPARED = {"test_bohb_with_hyperband_scheduler_end_to_end",
              "test_tuner_with_search_alg_end_to_end",
              "test_callback_hook_order",
              "test_raising_callback_is_isolated",
              "test_tuner_experiment_resume_after_driver_kill",
              "test_timeout_stopper_stops_experiment"}
# scenarios that start and stop a runtime of their own
OWN_RUNTIME = {"test_tuner_experiment_resume_after_driver_kill"}


def _grid(grid):
    """A ResultGrid as its trials' configs, metrics and errors, sorted."""
    rows = [(normalize(r.config), normalize({k: v for k, v in
                                             r.metrics.items()
                                             if k != "config"}),
             r.error is not None) for r in grid]
    return sorted(rows, key=repr)


def _targets(pkg):
    import importlib

    name = PKGS[pkg].__name__
    tuner = importlib.import_module(f"{name}.tune.tuner")
    se = importlib.import_module(f"{name}.tune.searchers")
    sc = importlib.import_module(f"{name}.tune.schedulers")
    return [(tuner.Tuner, "fit", _grid),
            (se.RandomSearcher, "suggest"), (se.ConcurrencyLimiter, "suggest"),
            (se._HistorySearcher, "suggest"),
            (sc.PopulationBasedTraining, "_explore"), (sc.PB2, "_explore"),
            (sc.ASHAScheduler, "on_trial_result"),
            (sc.MedianStoppingRule, "on_trial_result"),
            (sc.HyperBandScheduler, "on_trial_result"),
            (sc.PopulationBasedTraining, "on_trial_result")]


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=2):
        yield


CASES = [(f, name) for f in FILES for name in reference_tests(f)] + [
    ("test_tune.py", name) for name in sorted(OWN_RUNTIME | {
        "test_timeout_stopper_stops_experiment"})]


@pytest.mark.parametrize("filename,name", CASES,
                         ids=[f"{f[5:-3]}::{n}" for f, n in CASES])
def test_reference_scenario_matches(both, filename, name, tmp_path, request,
                                    monkeypatch):
    got = {}
    for pkg, module in PKGS.items():
        ns = load(filename, pkg)
        if name in OWN_RUNTIME:  # the runtime this test holds serves it
            monkeypatch.setattr(module, "init", lambda *a, **k: None)
            monkeypatch.setattr(module, "shutdown", lambda *a, **k: None)

        def scenario():
            with recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        got[pkg] = [repr(c).replace(str(tmp_path / pkg), "<tmp>")
                    for c in rerun_if_killed(scenario)]
    if name not in UNCOMPARED:
        assert got["port"] == got["ref"]


# ------------------------------------------- decisions on a fixed stream


def _stream_decisions(pkg, scheduler_name, **kw):
    """A scheduler fed one fixed interleaving of four trials' results (the
    order a runner would see); returns its decisions and PBT's exploits."""
    import importlib

    name = PKGS[pkg].__name__
    sc = importlib.import_module(f"{name}.tune.schedulers")
    tuner = importlib.import_module(f"{name}.tune.tuner")
    sched = getattr(sc, scheduler_name)(**kw)
    trials = [tuner.Trial(trial_id=f"t{i}", config={"q": q, "lr": 0.1 * q})
              for i, q in enumerate((1.0, 2.0, 3.0, 4.0))]
    exploits = []

    class Runner:
        def __init__(self):
            self.trials = trials

        def exploit(self, trial, donor, new_config):
            exploits.append((trial.trial_id, donor.trial_id,
                             normalize(new_config)))
            trial.config = new_config

    runner, decisions = Runner(), []
    for step in range(1, 13):
        for t in trials:
            if t.state == "TERMINATED":
                continue
            result = {"score": t.config["q"] * step + 0.01 * step * step,
                      "training_iteration": step}
            t.last_result = result
            d = sched.on_trial_result(runner, t, result)
            decisions.append((t.trial_id, step, d))
            if d == "STOP":
                t.state = "TERMINATED"
    return decisions, exploits


@pytest.mark.parametrize("scheduler,kw", [
    ("ASHAScheduler", dict(metric="score", mode="max", max_t=12,
                           grace_period=2, reduction_factor=2)),
    ("PopulationBasedTraining", dict(
        metric="score", mode="max", perturbation_interval=3,
        quantile_fraction=0.5, hyperparam_mutations={"lr": [0.5, 1.0, 2.0]},
        seed=3)),
    ("MedianStoppingRule", dict(metric="score", mode="max",
                                grace_period=2, min_samples_required=2)),
    ("HyperBandScheduler", dict(metric="score", mode="max", max_t=12)),
])
def test_scheduler_decisions_match_on_a_fixed_stream(scheduler, kw):
    ref = _stream_decisions("ref", scheduler, **kw)
    port = _stream_decisions("port", scheduler, **kw)
    assert port == ref
    if scheduler == "ASHAScheduler":
        assert any(d == "STOP" for _, s, d in ref[0] if s < 12)
    if scheduler == "PopulationBasedTraining":
        assert ref[1]  # the weak trials exploited the strong ones


# --------------------------------------------------------------- loggers


def _logger_files(pkg, tmp_path):
    """One trial at a time (a fixed order), the default loggers: every
    trial directory's params, results, CSV and TensorBoard scalars (each
    event without its wall time)."""
    import importlib

    tune = importlib.import_module(f"{PKGS[pkg].__name__}.tune")
    air = importlib.import_module(f"{PKGS[pkg].__name__}.air")

    def train_fn(config):
        for i in range(3):
            tune.report({"score": config["a"] * (i + 1), "epoch": i,
                         "ratio": config["a"] / (i + 1)})

    root = tmp_path / pkg
    tune.Tuner(train_fn, param_space={"a": tune.grid_search([1.0, 2.0])},
               tune_config=tune.TuneConfig(metric="score", mode="max",
                                           max_concurrent_trials=1),
               run_config=air.RunConfig(name="exp",
                                        storage_path=str(root))).fit()
    out = {}
    exp = root / "exp"
    for td in sorted(p for p in exp.iterdir() if p.name.startswith("trial_")):
        files = {"params": json.loads((td / "params.json").read_text()),
                 "result": [json.loads(x) for x in
                            (td / "result.json").read_text().splitlines()],
                 "csv": list(csv.reader(open(td / "progress.csv")))}
        (event,) = [p for p in td.iterdir() if p.name.startswith("events.out")]
        raw, off, records = event.read_bytes(), 0, []
        while off < len(raw):
            (length,) = struct.unpack_from("<Q", raw, off)
            records.append(raw[off + 12 + 9:off + 12 + length])
            off += 12 + length + 4
        files["events"] = records
        files["event_suffix"] = event.name.rsplit(".", 1)[1]
        out[td.name] = files
    return out


def test_logger_files_match(both, tmp_path):
    ref = rerun_if_killed(_logger_files, "ref", tmp_path)
    port = rerun_if_killed(_logger_files, "port", tmp_path)
    assert [f.pop("event_suffix") for f in ref.values()] == ["raytpu"] * 2
    assert [f.pop("event_suffix") for f in port.values()] == [
        "raytputorch"] * 2
    assert port == ref
    assert len(ref["trial_00000"]["result"]) == 3
