"""The port's Data library against ray_tpu's, on the same inputs.

Each scenario of the reference's own Data tests (test_data, test_data_plan,
test_data_pushdown, test_data_shuffle, test_datasources, test_data_io)
runs through both packages, one runtime of each alive side by side in this
process: the reference's assertions hold on each, and the values its calls
return (rows, counts, aggregates, schemas, plans, batches, seeded shuffles
and splits) are recorded and compared between the two. Also: the port's
`TokenLoader` against the reference's, batch for batch, and
`iter_torch_batches` on the card by default.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_libs import load, recording, reference_tests, run
from torch_runtime import both_runtimes, rerun_if_killed

FILES = ("test_data.py", "test_data_plan.py", "test_data_pushdown.py",
         "test_data_shuffle.py", "test_datasources.py", "test_data_io.py")
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}
# scenarios whose recorded values depend on more than the inputs: process
# ids, unseeded shuffles; the reference's own assertions still hold on
# both packages
UNCOMPARED = {"test_actor_pool_min_size", "test_unseeded_shuffles_differ"}
# scenarios whose rows come back in completion order: compared as sorted
UNORDERED = {"test_per_operator_memory_budget_throttles"}


def _targets(pkg):
    import importlib

    ds = importlib.import_module(f"{PKGS[pkg].__name__}.data.datastream")
    names = ("explain", "count", "sum", "min", "max", "mean", "std",
             "unique", "take", "take_all", "schema", "num_blocks",
             "take_batch", "size_bytes", "input_files")
    return [(ds.Datastream, n) for n in names if n in ds.Datastream.__dict__]


@pytest.fixture(scope="module")
def both():
    with both_runtimes(num_cpus=4, accelerators=8):
        yield


CASES = [(f, name) for f in FILES for name in reference_tests(f)]


@pytest.mark.parametrize("filename,name", CASES,
                         ids=[f"{f[5:-3]}::{n}" for f, n in CASES])
def test_reference_scenario_matches(both, filename, name, tmp_path, request):
    got = {}
    for pkg in PKGS:
        ns = load(filename, pkg)

        def scenario():
            with recording(pkg, _targets(pkg)) as calls:
                run(ns, name, pkg, tmp_path, request)
            return calls

        # file paths name each package's own directory
        got[pkg] = [repr(c).replace(str(tmp_path / pkg), "<tmp>")
                    for c in rerun_if_killed(scenario)]
    if name in UNCOMPARED:
        return
    if name in UNORDERED:
        got = {k: sorted(v) for k, v in got.items()}
    assert got["port"] == got["ref"]


def _token_file(path, n):
    np.random.default_rng(5).integers(0, 128256, n, dtype=np.int32).tofile(
        path)


@pytest.mark.parametrize("mode", ["sequential", "random"])
def test_token_loader_matches_reference_batch_for_batch(tmp_path, mode):
    """The port's copy of the native loader against the reference's build
    on one file, seed and mode (one prefetch thread: the order several
    threads give depends on their timing)."""
    from ray_tpu.data.token_loader import TokenLoader as RefLoader
    from ray_tpu_torch.data import token_loader
    from ray_tpu_torch.data.token_loader import TokenLoader

    path = str(tmp_path / "tokens.bin")
    _token_file(path, 40 * 65 + 17)
    kw = dict(batch=4, seq_len=64, n_threads=1, seed=3, mode=mode)
    with RefLoader(path, **kw) as ref, TokenLoader(path, **kw) as port:
        assert token_loader.native()
        assert port.num_tokens == ref.num_tokens
        assert port.batches_per_epoch == ref.batches_per_epoch
        for _ in range(25):  # past an epoch's 10 batches
            np.testing.assert_array_equal(port.next(), ref.next())


def test_token_loader_builds_into_the_ports_own_directory():
    from ray_tpu_torch.data import token_loader

    assert token_loader.native()
    lib = token_loader._lib._name
    assert "/build/torch_loader/libtt_loader-" in lib
    assert token_loader._SRC.endswith("ray_tpu_torch/data/csrc/token_loader.cpp")


def test_token_loader_fallback_is_reported(tmp_path, monkeypatch):
    """Without the native library the loader falls back to numpy, as the
    reference's does, and says so."""
    from ray_tpu_torch.data import token_loader

    path = str(tmp_path / "tokens.bin")
    _token_file(path, 8 * 33)
    monkeypatch.setattr(token_loader, "_lib", None)
    monkeypatch.setattr(token_loader, "_lib_failed", True)
    assert not token_loader.native()
    loader = token_loader.TokenLoader(path, batch=2, seq_len=32,
                                      mode="sequential")
    assert loader._handle is None and loader.next().shape == (2, 33)


def test_iter_torch_batches_defaults_to_the_card(both):
    """The port's iter_torch_batches puts batches on the card unless the
    caller asks for the CPU; without a card the default raises."""
    import torch

    from ray_tpu_torch import data

    ds = data.from_numpy({"x": np.arange(6.0)})
    cpu = list(ds.iter_torch_batches(batch_size=4, device="cpu"))
    assert [b["x"].tolist() for b in cpu] == [[0.0, 1.0, 2.0, 3.0],
                                             [4.0, 5.0]]
    (it,) = ds.streaming_split(1)
    if torch.cuda.is_available():
        got = next(iter(ds.iter_torch_batches(batch_size=4)))
        assert got["x"].device.type == "cuda"
        return
    for batches in (ds.iter_torch_batches(batch_size=4),
                    it.iter_torch_batches(batch_size=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(iter(batches))
