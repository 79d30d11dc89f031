"""The port's scheduler against the reference's: the native (C++) select and
place decisions of ray_tpu_torch/core/csrc/cluster_scheduler.cpp equal
those of ray_tpu's src/scheduler/cluster_scheduler.cpp on node tables and
demands drawn from a numpy seed, with ray_tpu's `tpu_slice` label and
"TPU" resource mapped to the port's `nvlink_domain` label and "GPU"; and
the port's pure-Python spec (core/scheduler.py) takes its own C++'s
decisions on the same tables."""

import os

import numpy as np
import pytest

from ray_tpu.core import native_scheduler as ref_native
from ray_tpu.core.scheduler import NodeView as RefNodeView
from ray_tpu_torch.core import native_scheduler as port_native
from ray_tpu_torch.core import scheduler as port_scheduler
from ray_tpu_torch.core.scheduler import NodeView, SchedulingPolicy
from ray_tpu_torch.core.task_spec import SchedulingStrategy

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="g++ toolchain unavailable")

N_TABLES = 250  # node tables, each with its select and place demands
CHUNKS = 5
STRATEGIES = ("STRICT_PACK", "PACK", "SPREAD", "STRICT_SPREAD")


def _table(seed: int):
    """One node table and its demands, in the port's names: "GPU" and the
    `nvlink_domain` label. Quantities on a 0.25 grid, as tasks ask."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(1, 9))):
        total, avail = {}, {}
        for res, choices in (("CPU", (1, 2, 4, 8, 16)), ("GPU", (0, 1, 2, 4, 8)),
                             ("mem", (0, 0, 4))):
            t = float(rng.choice(choices))
            if t:
                total[res] = t
                avail[res] = float(np.floor(t * rng.uniform(0, 1.0001) * 4) / 4)
        labels = {}
        dom = rng.choice(["", "d0", "d0", "d1", "d2"])
        if dom:
            labels["nvlink_domain"] = str(dom)
        nodes.append((bytes([i + 1]) * 8, total, avail, labels))
    demands = []
    for _ in range(6):
        d = {"CPU": float(rng.choice([0.0, 0.5, 1.0, 2.0, 4.0]))}
        g = float(rng.choice([0.0, 0.0, 0.25, 0.5, 1.0, 2.0, 4.0]))
        if g:
            d["GPU"] = g
        if rng.random() < 0.2:
            d["mem"] = 2.0
        d = {k: v for k, v in d.items() if v} or {"CPU": 1.0}
        prefer = (nodes[int(rng.integers(len(nodes)))][0]
                  if rng.random() < 0.5 else None)
        demands.append((d, str(rng.choice(["HYBRID", "SPREAD"])), prefer))
    groups = []
    for _ in range(4):
        bundles = []
        for _ in range(int(rng.integers(1, 5))):
            b = {"CPU": float(rng.choice([0.5, 1.0, 2.0]))}
            if rng.random() < 0.6:
                b["GPU"] = float(rng.choice([0.5, 1.0, 2.0]))
            bundles.append(b)
        groups.append((bundles, STRATEGIES[int(rng.integers(4))]))
    return nodes, demands, groups


def _to_ref(res):
    return {("TPU" if k == "GPU" else k): v for k, v in res.items()}


def _ref_labels(labels):
    return {("tpu_slice" if k == "nvlink_domain" else k): v
            for k, v in labels.items()}


def _decisions(native, nodes, demands, groups, rename):
    """Every select and place decision of one scheduler on one table."""
    tr = _to_ref if rename else dict
    for node_id, total, avail, labels in nodes:
        native.upsert_node(node_id, tr(total), tr(avail),
                           labels=_ref_labels(labels) if rename else labels)
    out = [native.select(tr(d), strat, prefer)
           for d, strat, prefer in demands]
    out += [native.place_bundles([tr(b) for b in bundles], strat)
            for bundles, strat in groups]
    return out


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_native_decisions_equal_the_reference_native(chunk):
    per = N_TABLES // CHUNKS
    placed = 0
    for seed in range(chunk * per, (chunk + 1) * per):
        nodes, demands, groups = _table(seed)
        want = _decisions(ref_native.NativeScheduler(0.5), nodes, demands,
                          groups, rename=True)
        got = _decisions(port_native.NativeScheduler(0.5), nodes, demands,
                         groups, rename=False)
        assert got == want, seed
        placed += sum(p is not None for p in want[len(demands):])
    assert placed > per // 2  # the tables exercise feasible placements too


def _python_policy() -> SchedulingPolicy:
    os.environ["RAY_TPU_TORCH_NATIVE_SCHEDULER"] = "0"
    try:
        policy = SchedulingPolicy()
    finally:
        del os.environ["RAY_TPU_TORCH_NATIVE_SCHEDULER"]
    assert policy._native is None
    return policy


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_python_spec_equals_its_native_scheduler(chunk):
    spec, native = _python_policy(), SchedulingPolicy()
    assert native._native is not None
    per = N_TABLES // CHUNKS
    for seed in range(chunk * per, (chunk + 1) * per):
        nodes, demands, groups = _table(seed)
        views = [NodeView(i, t, a, dict(lab)) for i, t, a, lab in nodes]
        for d, strat, prefer in demands:
            s = SchedulingStrategy(name=strat)
            assert (native.select_node(views, d, s, prefer)
                    == spec.select_node(views, d, s, prefer)), seed
        for bundles, strat in groups:
            assert (native.place_bundles(views, bundles, strat)
                    == spec.place_bundles(views, bundles, strat)), seed


def test_strict_pack_prefers_one_nvlink_domain():
    """Two GPU bundles no single host fits land on the hosts of one NVLink
    domain, as two TPU bundles land on one tpu_slice in the reference."""
    nodes = [(b"\x01" * 8, {"CPU": 8, "GPU": 8}, {"CPU": 8, "GPU": 8},
              {"nvlink_domain": "d1"}),
             (b"\x02" * 8, {"CPU": 8, "GPU": 8}, {"CPU": 8, "GPU": 8},
              {"nvlink_domain": "d0"}),
             (b"\x03" * 8, {"CPU": 8, "GPU": 8}, {"CPU": 8, "GPU": 8},
              {"nvlink_domain": "d0"})]
    bundles = [{"GPU": 8.0}, {"GPU": 8.0}]
    want = [b"\x02" * 8, b"\x03" * 8]
    for policy in (_python_policy(), SchedulingPolicy()):
        views = [NodeView(i, t, a, lab) for i, t, a, lab in nodes]
        assert policy.place_bundles(views, bundles, "STRICT_PACK") == want
    ref = ref_native.NativeScheduler(0.5)
    for i, t, a, lab in nodes:
        ref.upsert_node(i, _to_ref(t), _to_ref(a), labels=_ref_labels(lab))
    assert ref.place_bundles([_to_ref(b) for b in bundles],
                             "STRICT_PACK") == want
    # the reference's label means nothing to the port
    views = [NodeView(i, t, a, _ref_labels(lab)) for i, t, a, lab in nodes]
    assert SchedulingPolicy().place_bundles(views, bundles,
                                            "STRICT_PACK") is None
    assert RefNodeView is not NodeView


def test_port_libraries_are_its_own():
    """The port builds its own copies of both sources into build/
    torch_runtime/ under names ray_tpu's build/ never uses."""
    from ray_tpu.core import arena as ref_arena
    from ray_tpu_torch.core import arena as port_arena

    for port, ref in ((port_native, ref_native), (port_arena, ref_arena)):
        lib = port._load_lib()
        assert lib is not None
        assert os.path.basename(lib._name).startswith("libtt_")
        assert os.path.dirname(lib._name).endswith(
            os.path.join("build", "torch_runtime"))
        assert lib._name != ref._load_lib()._name
        assert os.path.dirname(port._SRC).endswith(
            os.path.join("ray_tpu_torch", "core", "csrc"))


def test_python_scheduler_when_the_native_one_fails(monkeypatch):
    """Without a toolchain the policy falls back to the Python spec, as the
    reference's does."""
    monkeypatch.setattr(port_native, "_load_lib", lambda: None)
    policy = SchedulingPolicy()
    assert policy._native is None
    views = [NodeView(b"\x01" * 8, {"CPU": 4, "GPU": 2},
                      {"CPU": 4, "GPU": 2})]
    assert policy.select_node(views, {"GPU": 1}) == b"\x01" * 8
    assert port_scheduler.NVLINK_DOMAIN_LABEL == "nvlink_domain"
