"""The port's streaming Data execution against ray_tpu's, on the same inputs.

Each scenario of the reference's test_data_streaming runs through both
packages, each on the reference's own fixture (an in-process cluster whose
object store holds a third of the pipeline's output), one package after
the other: the reference's assertions hold on each, and the values its
calls return (counts, rows, the rows a limit takes) are recorded and
compared between the two. (The scenarios need a cluster of their own, so
they live apart from tests/test_torch_data_parity.py's shared runtimes.)
"""

import contextlib
import importlib

import pytest

from torch_libs import PKG_NAME, load, recording, reference_tests, run
from torch_runtime import rerun_if_killed

FILE = "test_data_streaming.py"


def _targets(pkg):
    ds = importlib.import_module(f"{PKG_NAME[pkg]}.data.datastream")
    return [(ds.Datastream, n) for n in ("count", "take", "take_all",
                                         "num_blocks")]


@pytest.mark.parametrize("name", reference_tests(FILE))
def test_streaming_scenario_matches(name, tmp_path, request):
    got = {}
    for pkg in PKG_NAME:
        ns = load(FILE, pkg)
        fixture = ns["small_store_cluster"].__wrapped__

        def scenario():
            with contextlib.contextmanager(fixture)() as cluster, \
                    recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request,
                    extra={"small_store_cluster": cluster})
            return calls

        got[pkg] = rerun_if_killed(scenario)
    assert got["port"] == got["ref"]
