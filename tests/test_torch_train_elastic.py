"""The elastic recovery of the port's trainer on nodes that declare GPUs:
the twin of tests/test_elastic_recovery.py (slow, as the reference's). The
loop's mesh size is the worker's GPU grant; this CPU host runs its step
at world 1, as the reference's virtual mesh stands in for the chips."""

import os

import pytest


def _elastic_loop_factory():
    """The port's twin of test_elastic_recovery's loop: the mesh size is
    the worker's GPU grant (recorded; the CPU host runs the step at world
    1), a DCP save every step, a restore on start."""
    import os  # noqa: F401

    def _loop(config):
        import os
        import time

        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch.air import session
        from ray_tpu_torch.air.checkpoint import Checkpoint
        from ray_tpu_torch.models import ModelConfig
        from ray_tpu_torch.train import default_optimizer, make_train_step
        from ray_tpu_torch.train.checkpointing import (restore_sharded,
                                                       save_sharded)

        ckpt_root = config["ckpt_root"]
        granted = len(rt.get_gpu_ids())
        cfg = ModelConfig.tiny()
        step_fn, init_fn = make_train_step(cfg, default_optimizer(1e-3),
                                           device="cpu")
        state = init_fn(0)
        start_step = 0
        prev = session.get_checkpoint()
        if prev is not None:
            meta = prev.to_dict()
            start_step = meta["step"]
            state = restore_sharded(meta["dcp_path"], state)
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (4, 65), generator=g)
        batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
        for step in range(start_step, config["total_steps"]):
            state, metrics = step_fn(state, batch)
            path = save_sharded(state, os.path.join(ckpt_root,
                                                    f"step_{step + 1}"))
            session.report(
                {"loss": float(metrics["loss"]), "step": step + 1,
                 "mesh_devices": granted},
                checkpoint=Checkpoint.from_dict({"dcp_path": path,
                                                 "step": step + 1}))
            time.sleep(0.15)

    return _loop


@pytest.mark.slow
def test_elastic_recovery_node_loss_on_gpu_nodes(tmp_path):
    """Twin of test_elastic_recovery_node_loss_mesh_reshape on nodes that
    declare GPUs: the node holding the 8-GPU worker dies after 3
    checkpoints, the trainer shrinks the grant to the survivor's 2 and
    resumes from the last checkpoint."""
    import threading
    import time

    from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.train import MeshTrainer

    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"GPU": 2})
    doomed = cluster.add_node(num_cpus=2, resources={"GPU": 8})
    cluster.connect()
    try:
        ckpt_root = str(tmp_path / "ckpts")
        os.makedirs(ckpt_root, exist_ok=True)

        def chaos():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if len([d for d in os.listdir(ckpt_root)
                        if d.startswith("step_")]) >= 3:
                    cluster.remove_node(doomed)
                    return
                time.sleep(0.1)

        killer = threading.Thread(target=chaos, daemon=True)
        killer.start()
        result = MeshTrainer(
            _elastic_loop_factory(),
            train_loop_config={"ckpt_root": ckpt_root, "total_steps": 12},
            scaling_config=ScalingConfig(
                num_workers=1, resources_per_worker={"GPU": 8},
                elastic=True),
            run_config=RunConfig(failure_config=FailureConfig(
                max_failures=4))).fit()
        killer.join(timeout=5)
        assert result.error is None, result.error
        hist = result.metrics_history
        meshes = [m["mesh_devices"] for m in hist]
        assert 8 in meshes and 2 in meshes, meshes
        reshaped = [m for m in hist if m["mesh_devices"] == 2]
        assert reshaped[0]["step"] >= 3, reshaped[0]
        assert hist[-1]["step"] == 12, hist[-1]
        pre_kill = [m for m in hist if m["mesh_devices"] == 8][-1]["loss"]
        assert reshaped[0]["loss"] <= pre_kill + 0.5
    finally:
        cluster.shutdown()
