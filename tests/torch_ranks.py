"""Ranks of the port's multi-process CPU tests: each runs as its own process
under gloo and imports torch, numpy and the port only (never jax), so the
JAX side of a parity test stays in the pytest process.

    python tests/torch_ranks.py TASK OUTDIR RANK WORLD PORT [ARGS...]

Tasks (rank 0 writes OUTDIR/out.npz and OUTDIR/out.json):
  steps DP FSDP MASKED  3 steps of `default_optimizer(1e-3, warmup_steps=1)`
                        on `tiny` (float32) from OUTDIR/in.npz (the JAX
                        params, "p/<path>", and the global batch), each rank
                        on its rows; losses, grad norms, final params whole.
  ckpt                  a tiny state at dp 2 x fsdp 2, one step, saved;
                        restored onto fsdp 4; every leaf compared whole;
                        the next step's loss on both meshes.
  budget FSDP           a tiny state at fsdp FSDP, one step: the bytes of
                        this rank's params, optimizer moments and grads.

`run_ranks` launches WORLD such processes and waits for them (the test's
join timeout besides the group's own).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ray_tpu_torch.parallel.fsdp import tree_paths

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60.0


def run_ranks(task, world, outdir, *args, timeout=120.0):
    """Run `world` ranks of `task`; raise with their output if one fails or
    they outlast `timeout` seconds. Returns rank 0's out.json."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(outdir), str(rank), str(world),
         str(port), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO)) for rank in range(world)]
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{task}: ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise AssertionError(f"{task}: ranks {failed} failed:\n"
                             + "\n".join(o[-3000:] for o in outputs))
    return json.loads((Path(outdir) / "out.json").read_text())


# ---------------------------------------------------------------- ranks


def _setup(rank, world, port):
    from ray_tpu_torch.parallel import initialize_group

    initialize_group(rank, world, device="cpu", timeout=GROUP_TIMEOUT_S,
                     init_method=f"tcp://127.0.0.1:{port}")


def _tree(flat, prefix):
    """{"a/b": x} entries under `prefix` as a nested dict."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _tensors(state):
    return {"params": state.params, "mu": state.opt_state.mu,
            "nu": state.opt_state.nu}


def _whole(tree, prefix, out):
    """Each leaf of a tree of DTensors gathered whole (a collective) into
    out[prefix + path] as numpy."""
    for path, t in tree_paths(tree):
        out[prefix + path] = t.full_tensor().numpy().copy()


def _write(outdir, rank, arrays, result):
    if rank == 0:
        np.savez(Path(outdir) / "out.npz", **arrays)
        (Path(outdir) / "out.json").write_text(json.dumps(result))


def steps(outdir, rank, world, dp, fsdp, masked):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.train import (TrainState, batch_sharding,
                                     default_optimizer, make_train_step,
                                     shard_batch, shard_state,
                                     state_shardings)

    cfg = ModelConfig.tiny()
    mesh = make_virtual_mesh(world, MeshConfig(dp=int(dp), fsdp=int(fsdp)))
    data = dict(np.load(Path(outdir) / "in.npz"))
    optimizer = default_optimizer(1e-3, warmup_steps=1)
    params = params_from_jax(_tree(data, "p/"), cfg, device="cpu")
    state = shard_state(TrainState(params, optimizer.init(params), 0),
                        state_shardings(cfg, mesh, optimizer))
    tokens = torch.from_numpy(data["tokens"])
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if int(masked):
        batch["loss_mask"] = torch.from_numpy(data["mask"])
    local = shard_batch(batch, mesh)
    # the rows are DTensor's own split of the batch (dp-major)
    s = batch_sharding(mesh)["inputs"]
    rows_as_dtensor = all(torch.equal(
        local[k], distribute_tensor(v, mesh, s.placements).to_local())
        for k, v in batch.items())
    step_fn, _ = make_train_step(cfg, optimizer, "cpu", mesh=mesh)
    losses, norms = [], []
    for _ in range(3):
        state, metrics = step_fn(state, local)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    arrays = {}
    _whole(state.params, "p/", arrays)
    _write(outdir, rank, arrays, {
        "losses": losses, "norms": norms, "rows_as_dtensor": rows_as_dtensor,
        "local_rows": int(local["inputs"].shape[0]),
        "count": state.opt_state.count, "step": state.step})


def ckpt(outdir, rank, world):
    import torch

    from ray_tpu_torch.bench import make_batch
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.train import (abstract_like, default_optimizer,
                                     latest_checkpoint, load_checkpoint,
                                     make_train_step, save_checkpoint,
                                     shard_batch, state_shardings)

    cfg = ModelConfig.tiny()
    optimizer = default_optimizer(1e-3, warmup_steps=1)
    src = make_virtual_mesh(world, MeshConfig(dp=2, fsdp=2))
    dst = make_virtual_mesh(world, MeshConfig(fsdp=4))
    batch = make_batch(cfg, 4, 32, 1, "cpu")
    step_src, init_src = make_train_step(cfg, optimizer, "cpu", mesh=src)
    step_dst, _ = make_train_step(cfg, optimizer, "cpu", mesh=dst)
    state, _ = step_src(init_src(0), shard_batch(batch, src))
    root = Path(outdir) / "ckpt"
    save_checkpoint(state, str(root), step=1, meta={"mesh": "dp2xfsdp2"})
    target = abstract_like(state, state_shardings(cfg, dst, optimizer))
    restored, meta = load_checkpoint(latest_checkpoint(str(root)), target)
    whole_src, whole_dst = {}, {}
    _whole(_tensors(state), "", whole_src)
    _whole(_tensors(restored), "", whole_dst)
    equal = sorted(k for k in whole_src
                   if np.array_equal(whole_src[k], whole_dst[k]))
    on_dst = all(t.device_mesh is dst
                 for _, t in tree_paths(_tensors(restored)))
    local_rows = shard_batch(batch, dst)
    assert torch.equal(local_rows["inputs"],
                       shard_batch(batch, src)["inputs"])
    _, m_src = step_src(state, shard_batch(batch, src))
    _, m_dst = step_dst(restored, local_rows)
    _write(outdir, rank, whole_src, {
        "leaves": sorted(whole_src), "equal": equal, "on_target_mesh": on_dst,
        "meta": meta, "step": restored.step,
        "count": restored.opt_state.count,
        "next_loss": [float(m_src["loss"]), float(m_dst["loss"])]})


def budget(outdir, rank, world, fsdp):
    from ray_tpu_torch.bench import make_batch
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.models.planning import _tree_bytes
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                     shard_batch, to_local)

    cfg = ModelConfig.tiny()
    mesh = make_virtual_mesh(world, MeshConfig(fsdp=int(fsdp)))
    optimizer = default_optimizer(1e-3, warmup_steps=1)
    seen = {}

    class GradBytes:
        init = staticmethod(optimizer.init)

        @staticmethod
        def apply(grads, state, params, grad_norm):
            seen["grads"] = _tree_bytes(grads)
            return optimizer.apply(grads, state, params, grad_norm)

    step_fn, init_fn = make_train_step(cfg, GradBytes, "cpu", mesh=mesh)
    state = init_fn(0)
    state, _ = step_fn(state, shard_batch(make_batch(cfg, 4, 32, 1, "cpu"),
                                          mesh))
    _write(outdir, rank, {}, {
        "params": _tree_bytes(to_local(state.params)),
        "optimizer": _tree_bytes(to_local(state.opt_state)),
        "grads": seen["grads"]})


if __name__ == "__main__":
    task, outdir, rank, world, port, *rest = sys.argv[1:]
    rank, world = int(rank), int(world)
    _setup(rank, world, port)
    try:
        {"steps": steps, "ckpt": ckpt, "budget": budget}[task](
            outdir, rank, world, *rest)
    finally:
        from ray_tpu_torch.parallel import shutdown_group

        shutdown_group()
