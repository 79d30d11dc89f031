"""The port stands alone: ray_tpu_torch and chip_smoke.py import neither jax
nor ray_tpu, and every entry point refuses to run on a missing GPU."""

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
                 "ray_tpu_torch.train.checkpointing"):
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
                                   "servebench"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig, init_params
    from ray_tpu_torch.models.serving import ContinuousBatchingEngine
    from ray_tpu_torch.ops.kernels._util import require_cuda
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_init_fn,
                                     make_train_step)
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import servebench
    from ray_tpu_torch.models.convert import params_from_hf_state_dict

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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
