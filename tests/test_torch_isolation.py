"""The port stands alone: ray_tpu_torch and chip_smoke.py import neither jax
nor ray_tpu, and every entry point of the device path refuses to run on a
missing GPU. The runtime, Serve and the runtime's harness CLIs (burst,
jobstorm, memstorm, envelope, microbenchmark), which do no device work, run
on any host; no default artifact of theirs names a file of the JAX
package. The operator surface (`python -m ray_tpu_torch`, the launcher,
job submission, the dashboard, Grafana, rpdb) keeps its own state root, KV
namespaces, job ids and dashboard files, and its CLI starts without a
GPU. The ML libraries (air, tune, data, workflow) are scanned and
imported with the rest; their own names are held in their parity tests."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "ray_tpu_torch"


def _port_modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "ray_tpu")


def test_port_imports_neither_jax_nor_ray_tpu():
    modules = list(_port_modules())
    for name in ("ray_tpu_torch.models.serving", "ray_tpu_torch.train.step",
                 "ray_tpu_torch.bench",
                 "ray_tpu_torch.ops.kernels.adamw",
                 "ray_tpu_torch.ops.kernels.flash_attention",
                 "ray_tpu_torch.ops.kernels.fused_ffn",
                 "ray_tpu_torch.ops.kernels.fused_attn",
                 "ray_tpu_torch.ops.kernels.rmsnorm",
                 "ray_tpu_torch.ops.kernels.xent",
                 "ray_tpu_torch.models.convert",
                 "ray_tpu_torch.models.planning",
                 "ray_tpu_torch.train.checkpointing",
                 "ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.parallel.distributed",
                 "ray_tpu_torch.parallel.fsdp",
                 "ray_tpu_torch.parallel.expert",
                 "ray_tpu_torch.parallel.pipeline",
                 "ray_tpu_torch.ops.moe",
                 "ray_tpu_torch.multichip",
                 "ray_tpu_torch._version",
                 "ray_tpu_torch.runtime_env",
                 "ray_tpu_torch.core.api",
                 "ray_tpu_torch.core.worker",
                 "ray_tpu_torch.core.worker_main",
                 "ray_tpu_torch.core.worker_pool",
                 "ray_tpu_torch.core.raylet",
                 "ray_tpu_torch.core.gcs",
                 "ray_tpu_torch.core.node_main",
                 "ray_tpu_torch.core.cluster",
                 "ray_tpu_torch.core.serialization",
                 "ray_tpu_torch.core.object_store",
                 "ray_tpu_torch.core.arena",
                 "ray_tpu_torch.core.native_scheduler",
                 "ray_tpu_torch.core.placement_group",
                 "ray_tpu_torch.client.client",
                 "ray_tpu_torch.client.server",
                 "ray_tpu_torch.util",
                 "ray_tpu_torch.util.collective",
                 "ray_tpu_torch.util.profiler",
                 "ray_tpu_torch.util.flight_recorder",
                 "ray_tpu_torch.autoscaler",
                 "ray_tpu_torch.autoscaler.autoscaler",
                 "ray_tpu_torch.autoscaler.node_provider",
                 "ray_tpu_torch.core.burst",
                 "ray_tpu_torch.core.jobstorm",
                 "ray_tpu_torch.core.memstorm",
                 "ray_tpu_torch.envelope",
                 "ray_tpu_torch.microbenchmark",
                 "ray_tpu_torch.serve.storm",
                 "ray_tpu_torch.__main__",
                 "ray_tpu_torch.dag",
                 "ray_tpu_torch.dashboard",
                 "ray_tpu_torch.dashboard_ui",
                 "ray_tpu_torch.grafana",
                 "ray_tpu_torch.job_submission",
                 "ray_tpu_torch.autoscaler.launcher",
                 "ray_tpu_torch.util.otel",
                 "ray_tpu_torch.util.joblib",
                 "ray_tpu_torch.util.rpdb",
                 "ray_tpu_torch.air",
                 "ray_tpu_torch.air.checkpoint",
                 "ray_tpu_torch.air.config",
                 "ray_tpu_torch.air.integrations",
                 "ray_tpu_torch.air.result",
                 "ray_tpu_torch.air.session",
                 "ray_tpu_torch.tune",
                 "ray_tpu_torch.tune.callback",
                 "ray_tpu_torch.tune.logger",
                 "ray_tpu_torch.tune.schedulers",
                 "ray_tpu_torch.tune.search",
                 "ray_tpu_torch.tune.searchers",
                 "ray_tpu_torch.tune.session",
                 "ray_tpu_torch.tune.stopper",
                 "ray_tpu_torch.tune.tuner",
                 "ray_tpu_torch.data",
                 "ray_tpu_torch.data.datasources",
                 "ray_tpu_torch.data.datastream",
                 "ray_tpu_torch.data.expressions",
                 "ray_tpu_torch.data.plan",
                 "ray_tpu_torch.data.preprocessors",
                 "ray_tpu_torch.data.shuffle",
                 "ray_tpu_torch.data.tfrecord",
                 "ray_tpu_torch.data.token_loader",
                 "ray_tpu_torch.workflow",
                 "ray_tpu_torch.workflow.api"):
        assert name in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    assert "ray_tpu_torch.ops.kernels.quant" in loaded


def test_chip_smoke_imports_neither_jax_nor_ray_tpu():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "ray_tpu_torch.models" in names
    assert not [n for n in names if _forbidden(n)], names


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """Copied out of the checkout (or on a box without CUDA) the script
    exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("entry", ["init_params", "params_from_jax",
                                   "engine", "require_cuda",
                                   "make_train_step", "make_init_fn",
                                   "fused_adamw_optimizer", "bench",
                                   "params_from_hf_state_dict",
                                   "servebench", "make_mesh",
                                   "initialize_group", "multichip",
                                   "LLMDeployment"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig, init_params
    from ray_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                              LLMDeployment)
    from ray_tpu_torch.ops.kernels._util import require_cuda
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_init_fn,
                                     make_train_step)
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import servebench
    from ray_tpu_torch.models.convert import params_from_hf_state_dict
    from ray_tpu_torch import multichip
    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh)

    cfg = ModelConfig.tiny()
    calls = {
        "init_params": lambda: init_params(cfg, seed=0),
        "params_from_jax": lambda: params_from_jax(
            {"embed": np.zeros((cfg.vocab_size, cfg.d_model), np.float32)},
            cfg),
        "engine": lambda: ContinuousBatchingEngine(
            init_params(cfg, seed=0, device="cpu"), cfg),
        "require_cuda": lambda: require_cuda("cuda"),
        "make_train_step": lambda: make_train_step(cfg),
        "make_init_fn": lambda: make_init_fn(cfg, default_optimizer())(0),
        "fused_adamw_optimizer": lambda: make_init_fn(
            cfg, fused_adamw_optimizer())(0),
        "bench": lambda: bench.main([]),
        "params_from_hf_state_dict": lambda: params_from_hf_state_dict(
            {}, cfg),
        "servebench": lambda: servebench.run_servebench(with_latency=False),
        "make_mesh": lambda: make_mesh(MeshConfig()),
        "initialize_group": lambda: initialize_group(0, 1),
        "multichip": lambda: multichip.main(["--chips", "4"]),
        "LLMDeployment": lambda: LLMDeployment(
            init_params(cfg, seed=0, device="cpu"), cfg),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_default_artifacts_are_the_ports_own():
    """Every CLI default of the harnesses writes under the ignored build/
    with a `_torch` name, never over a file the JAX package committed."""
    from ray_tpu_torch import envelope, microbenchmark
    from ray_tpu_torch.core import burst, jobstorm, memstorm
    from ray_tpu_torch.models import servebench
    from ray_tpu_torch.serve import storm

    paths = [envelope.DEFAULT_ARTIFACT, microbenchmark.OBJPLANE_ARTIFACT,
             jobstorm.DEFAULT_ARTIFACT, memstorm.DEFAULT_ARTIFACT,
             storm.DEFAULT_ARTIFACT, storm.HEADFAIL_ARTIFACT,
             servebench.DEFAULT_ARTIFACT, *burst.DEFAULT_ARTIFACTS.values()]
    committed = {p.name for p in REPO.glob("*.json")}
    assert len(set(paths)) == len(paths)
    for path in map(Path, paths):
        assert path.parent == REPO / "build", path
        assert path.stem.endswith("_torch"), path
        assert path.name not in committed, path
    assert {"ENVELOPE_r10.json", "HEADFAIL_r11.json", "JOBSTORM_r20.json",
            "STORESTORM_r18.json", "PARTITION_r13.json",
            "OBJPLANE_r14.json"} <= committed
    # the operator surface: Grafana's default directory, the launcher's
    # state root, the KV namespaces of jobs and breakpoints, the job ids
    from ray_tpu import job_submission as ref_jobs
    from ray_tpu.autoscaler import launcher as ref_launcher
    from ray_tpu.util import rpdb as ref_rpdb
    from ray_tpu_torch import grafana, job_submission
    from ray_tpu_torch.autoscaler import launcher
    from ray_tpu_torch.util import rpdb

    out_dir = Path(grafana.DEFAULT_OUT_DIR)
    assert out_dir.parent == REPO / "build"
    assert out_dir.name.endswith("_torch")
    if "RAY_TPU_TORCH_CLUSTERS_DIR" not in os.environ:
        assert launcher._STATE_ROOT == os.path.expanduser(
            "~/.ray_tpu_torch/clusters")
    assert launcher._STATE_ROOT != ref_launcher._STATE_ROOT
    assert job_submission._KV_NS == "ray_tpu_torch_job_submission"
    assert rpdb._KV_NS == "ray_tpu_torch_rpdb"
    assert job_submission._KV_NS != ref_jobs._KV_NS
    assert rpdb._KV_NS != ref_rpdb._KV_NS
    assert job_submission.JOB_ID_PREFIX == "rtt-job-"


@pytest.mark.parametrize("module", ["ray_tpu_torch.core.burst",
                                    "ray_tpu_torch.core.jobstorm",
                                    "ray_tpu_torch.core.memstorm",
                                    "ray_tpu_torch.envelope",
                                    "ray_tpu_torch.microbenchmark",
                                    "ray_tpu_torch",
                                    "ray_tpu_torch metrics export-dashboards",
                                    "ray_tpu_torch rllib train --algo ppo"])
def test_harness_clis_start_without_a_gpu(module, tmp_path):
    """The harness CLIs and the operator CLI do no device work: they parse
    and start on a host without a card (here the help text, which names
    the default path; the dashboards' export). `rllib` trains on the card
    by default: without one it exits 2 with one line naming the missing
    card, and with `--device cpu` it trains an iteration and exits 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    module, *args = module.split()
    if args[:2] == ["metrics", "export-dashboards"]:
        args += ["--out-dir", str(tmp_path)]
    out = subprocess.run([sys.executable, "-m", module, *(args or ["--help"])],
                         capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    if args[:1] == ["rllib"]:
        assert out.returncode == 2 and out.stdout == ""
        assert len(out.stderr.strip().splitlines()) == 1, out.stderr
        assert "no CUDA card" in out.stderr and "--device cpu" in out.stderr
        cpu = subprocess.run(
            [sys.executable, "-m", module, *args, "--stop-iters", "1",
             "--num-workers", "1", "--device", "cpu"],
            capture_output=True, text=True, env=env, cwd=str(tmp_path),
            timeout=120)
        assert cpu.returncode == 0, cpu.stderr
        assert cpu.stdout.startswith("iter 1: reward=")
        return
    assert out.returncode == 0, out.stderr
    if args:
        assert sorted(os.listdir(tmp_path)) == [
            f"ray_tpu_torch_{n}.json" for n in ("core", "serve", "train")]
        return
    assert "usage" in out.stdout

