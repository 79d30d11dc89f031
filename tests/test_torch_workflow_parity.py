"""The port's workflows against ray_tpu's, on the same inputs.

Each workflow scenario of the reference's test_dag_workflow_autoscaler runs
through both packages, one runtime of each alive side by side in this
process: the reference's assertions hold on each, and what its calls
return (outputs, statuses, the workflows listed, each step's persisted
result) is recorded and compared between the two. Also: the storage root
is the port's own, and a step's result persists under it as the
reference's does (the steps take no resources: no device path).
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_killed

FILE = "test_dag_workflow_autoscaler.py"
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
REPO = Path(__file__).resolve().parents[1]
# the meta's wall-clock times
_TIMES = ("start_time", "end_time")


def _listed(wfs):
    return [{k: v for k, v in w.items() if k not in _TIMES} for w in wfs]


def _targets(pkg):
    wf = importlib.import_module(f"{PKGS[pkg].__name__}.workflow")
    return [(wf, "run"), (wf, "resume"), (wf, "get_output"),
            (wf, "get_status"), (wf, "list_all", _listed)]


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=8):
        yield


CASES = [n for n in reference_tests(FILE) if "workflow" in n]


@pytest.mark.parametrize("name", CASES)
def test_reference_workflow_scenario_matches(both, name, tmp_path, request):
    got = {}
    for pkg in PKGS:
        ns = load(FILE, pkg)

        def scenario():
            with recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        got[pkg] = [repr(c).replace(str(tmp_path / pkg), "<tmp>")
                    for c in rerun_if_killed(scenario)]
    assert got["port"] == got["ref"]
    assert got["ref"]


def _persisted(pkg, root):
    """A two-step workflow's output and the file tree it leaves."""
    wf = importlib.import_module(f"{PKGS[pkg].__name__}.workflow")

    @wf.step
    def add(a, b):
        return a + b

    out = wf.run(add.step(add.step(1, 2), 3), workflow_id="w", storage=root)
    files = sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                   if p.is_file())
    steps = {p.name: wf.get_output("w", storage=root)
             for p in (Path(root) / "w" / "steps").iterdir()}
    return out, files, len(steps)


def test_persisted_layout_matches(both, tmp_path):
    ref = rerun_if_killed(_persisted, "ref", str(tmp_path / "ref"))
    port = rerun_if_killed(_persisted, "port", str(tmp_path / "port"))
    assert port == ref
    assert ref[0] == 6 and ref[2] == 2


def test_storage_root_is_the_ports_own(tmp_path):
    """`RAY_TPU_TORCH_WORKFLOW_STORAGE`, else ~/.ray_tpu_torch/workflows;
    the reference's variable does not move it."""
    code = ("from ray_tpu_torch.workflow import api; "
            "print(api._DEFAULT_STORAGE)")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU")}
    env.update(PYTHONPATH=str(REPO), HOME=str(tmp_path),
               RAY_TPU_WORKFLOW_STORAGE=str(tmp_path / "ref"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path / ".ray_tpu_torch/workflows")
    env["RAY_TPU_TORCH_WORKFLOW_STORAGE"] = str(tmp_path / "port")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path / "port")
