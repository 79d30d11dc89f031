"""Training throughput of the flagship transformer (twin of the training
half of bench.py:19-75).

    python -m ray_tpu_torch.bench          # one GPU: Llama-3-8B width, 8 layers
    python -m ray_tpu_torch.bench --cpu    # smoke path: `tiny` on the CPU
    torchrun --nproc-per-node 4 -m ray_tpu_torch.bench --fsdp 4 --n-layers 32

Runs over the world, as the reference's bench does (`bench.py:32`): the
process group from torchrun's environment (a world of 1 when launched
alone), a `MeshConfig(dp=-1, fsdp=--fsdp)` mesh over it, 2 rows a card of
the global batch, and the sharded step. Rank 0 prints ONE JSON line with
the reference's keys: tokens/s a chip, MFU, step time, loss, n_params and
n_chips (the world size). FLOPs per token are counted as the reference counts them
(`bench.py:72-74`): 6·n_params plus 6·L·d·seq for causal attention. MFU is
measured against the H100 SXM's dense bf16 rate (989 TFLOP/s) on the card;
the CPU smoke path divides by a nominal 1 TFLOP/s, as the reference's CI
path does, and its numbers are no device measurement.

`profile_train` runs a few steps under torch.profiler: device time per step,
the device-idle share of the window and the kernels that take the time (the
collectives also by NCCL operation).
The transfer half (`_bench_transfer`, the reference's `bench.py:161-200`)
moves one object between two raylets of an in-process `ray_tpu_torch.core`
cluster through the pipelined chunk pull, 512 MiB on the card's host and
24 MiB under `--cpu`, beside a single-stream loopback TCP baseline of the
same host; rank 0 adds its keys (`transfer_mib`, `transfer_gbps`,
`loopback_tcp_1stream_gbps`) to the JSON line, or `transfer_error`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import ModelConfig, count_params
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.parallel import (MeshConfig, initialize_group, make_mesh,
                                    shutdown_group)
from ray_tpu_torch.train.step import (default_optimizer, make_train_step,
                                      shard_batch)

PEAK_BF16_FLOPS_H100 = 989e12   # H100 SXM data sheet, dense
NOMINAL_CPU_FLOPS = 1e12        # the reference's CI smoke-path divisor


def train_config_8b(n_layers: int = 8) -> ModelConfig:
    """Llama-3-8B at full width with its depth cut to fit one 80 GB card,
    run as the reference's bench runs its step (fused FFN and attention
    blocks; remat is then unused)."""
    return dataclasses.replace(ModelConfig.llama3_8b(), n_layers=n_layers,
                               fused_ffn=True, fused_attn=True, remat="dots")


def flops_per_token(cfg: ModelConfig, n_params: int, seq: int) -> int:
    attn_flops = 6 * cfg.n_layers * cfg.d_model * seq  # 12·L·d·s · 0.5 causal
    return 6 * n_params + attn_flops


def throughput(cfg: ModelConfig, n_params: int, batch_size: int, seq: int,
               step_s: float, peak_flops: float) -> Dict[str, float]:
    tokens_per_sec = batch_size * seq / step_s
    return {"tokens_per_sec": tokens_per_sec,
            "mfu": tokens_per_sec * flops_per_token(cfg, n_params, seq)
            / peak_flops}


def make_batch(cfg: ModelConfig, batch_size: int, seq: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """{"inputs", "targets"} from one [b, seq + 1] draw of random tokens."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                           generator=gen, device=dev)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_config(cfg: ModelConfig, batch_size: int, seq: int,
                 peak_flops: float, iters: int, device="cuda",
                 seed: int = 0, mesh=None) -> Dict[str, Any]:
    """One config's train step: the first step (kernel build and load
    included), one warm step, then `iters` timed steps ending in a sync.
    With `mesh`, the sharded step on this rank's rows of the global batch
    of `batch_size` rows; tokens/s and MFU are a chip's."""
    dev = require_cuda(device)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(), dev,
                                       mesh=mesh)
    state = init_fn(seed)
    n_params = count_params(state.params)
    batch = make_batch(cfg, batch_size, seq, seed + 1, dev)
    n_chips = 1
    if mesh is not None:
        batch, n_chips = shard_batch(batch, mesh), mesh.size()

    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    float(metrics["loss"])
    first_step_s = time.perf_counter() - t0
    state, metrics = step_fn(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    return {**throughput(cfg, n_params, batch_size // n_chips, seq, dt,
                         peak_flops),
            "step_time_s": dt, "first_step_s": first_step_s, "loss": loss,
            "n_params": n_params, "n_chips": n_chips}


_PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel", "dw_gateup_kernel", "dw_down_kernel",
                 "dgateup_kernel", "adamw_kernel", "quant_rows",
                 "dequant_rows")


# NCCL's device kernels by the collective in their names (a kernel whose
# name names none is kept under its own name)
_NCCL_OPS = ("AllGather", "ReduceScatter", "AllReduce", "SendRecv",
             "Broadcast")


def _kernel_kind(name: str) -> str:
    """A device kernel's group for the time breakdown, from its name."""
    if any(k in name for k in _PORT_KERNELS):
        return "port kernels"
    low = name.lower()
    if "nccl" in low:
        return "collectives"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cuBLAS matmuls"
    if any(k in low for k in ("memcpy", "memset", "copy")):
        return "copies and casts"
    if any(k in low for k in ("elementwise", "reduce", "softmax", "cat",
                              "index", "scatter", "gather")):
        return "elementwise and reductions"
    return "other"


def profile_train(step_fn, state, batch, *, steps: int = 3, top: int = 8
                  ) -> Tuple[Any, Dict[str, Any]]:
    """torch.profiler over `steps` training steps: device (kernel and copy)
    time per step, split by kind of kernel and the collectives by NCCL
    operation (and the expert-parallel ones by their `ep/` range), the
    kernels that take most of it, and the device-idle share of the
    window's own host-clock time (synchronized at both ends, profiler
    overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = next(iter(batch.values())).device
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, batch)
        _sync(dev)
        window_ms = 1e3 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in averages if e.device_type == DeviceType.CUDA]
    # the expert-parallel collectives' ranges (parallel/expert.py): the
    # device time of the kernels each launched
    by_range = {e.key: e.device_time_total / 1e3 / steps for e in averages
                if e.device_type == DeviceType.CPU
                and e.key.startswith("ep/")}
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    by_kind: Dict[str, float] = {}
    by_collective: Dict[str, float] = {}
    for key, us, _ in rows:
        kind = _kernel_kind(key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
        if kind == "collectives":
            op = next((o for o in _NCCL_OPS if o in key), key[:60])
            by_collective[op] = by_collective.get(op, 0.0) + us / 1e3 / steps
    return state, {
        "steps": steps,
        "ms_per_step": window_ms / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1 - device_us / 1e3 / window_ms,
        "launches_per_step": sum(r[2] for r in rows) / steps,
        "ms_per_step_by_kind": by_kind,
        "collective_ms_per_step_by_op": by_collective,
        "ep_collective_ms_per_step": by_range,
        "top": [{"name": k[:90], "ms_per_step": us / 1e3 / steps,
                 "share": us / device_us, "calls_per_step": n / steps}
                for k, us, n in rows[:top]] if device_us else [],
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="smoke path: ModelConfig.tiny on the CPU")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="fsdp axis of the mesh (dp takes the rest)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="layers (default: 8 on the card, tiny's on the CPU)")
    args = ap.parse_args(argv)
    if args.cpu:
        cfg, rows, seq = ModelConfig.tiny(), 4, 128
        device, peak, platform = "cpu", NOMINAL_CPU_FLOPS, "cpu"
        kind, iters = "cpu", 3
    else:
        require_cuda("cuda")
        cfg, rows, seq = train_config_8b(), 2, 2048
        device, peak, platform = "cuda", PEAK_BF16_FLOPS_H100, "gpu"
        kind, iters = torch.cuda.get_device_name(0), 10
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    import torch.distributed as dist

    own_group = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    initialize_group(int(os.environ.get("RANK", "0")), world, device=device)
    try:
        mesh = make_mesh(MeshConfig(dp=-1, fsdp=args.fsdp), device=device)
        r = bench_config(cfg, rows * mesh.size(), seq, peak, iters,
                         device=device, mesh=mesh)
    finally:
        if own_group:
            shutdown_group()
    result = {
        "metric": "train_tokens_per_sec_per_chip",
        "value": r["tokens_per_sec"],
        "unit": "tokens/s/chip",
        "vs_baseline": r["mfu"] / 0.40,
        "mfu": r["mfu"],
        "n_params": r["n_params"],
        "n_chips": r["n_chips"],
        "platform": platform,
        "device": kind,
        "batch": rows * r["n_chips"],
        "seq": seq,
        "step_time_s": r["step_time_s"],
        "first_step_s": r["first_step_s"],
        "loss": r["loss"],
    }
    if int(os.environ.get("RANK", "0")) == 0:
        try:
            # larger than the 16 MiB chunk at both sizes, so the measured
            # path is the pipelined chunk pull, not the single-shot one
            result.update(_bench_transfer(24 if args.cpu else 512))
        except Exception as e:  # never lose the primary line to the add-on
            result["transfer_error"] = f"{type(e).__name__}: {e}"[:200]
        print(json.dumps(result), flush=True)
    return result


def _bench_transfer(size_mib: int = 512) -> dict:
    """Cross-raylet chunked object transfer throughput (reference
    release/benchmarks object-transfer envelope): an in-process 2-raylet
    cluster moves a size_mib object through the pipelined chunk pull path.
    Host memory only: no device work."""
    import numpy as np

    import ray_tpu_torch.core.rpc as rpc
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.ids import ObjectID

    cluster = Cluster()
    a = cluster.add_node(num_cpus=1, object_store_memory=2 * (size_mib << 20))
    b = cluster.add_node(num_cpus=1, object_store_memory=2 * (size_mib << 20))
    try:
        oid = ObjectID.from_random()
        a.store.put_bytes(oid, np.ones(size_mib << 20, dtype=np.uint8).data)
        cli = rpc.connect_with_retry(b.address, timeout=10)
        try:
            t0 = time.perf_counter()
            cli.call("pull_object", {"object_id": oid, "source": a.address},
                     timeout=300)
            dt = time.perf_counter() - t0
        finally:
            cli.close()
        return {"transfer_mib": size_mib,
                "transfer_gbps": round(size_mib / 1024 / dt * 8, 2),
                **_transfer_ceiling(size_mib)}
    finally:
        cluster.shutdown()


def _transfer_ceiling(size_mib: int) -> dict:
    """Measured SINGLE-STREAM loopback TCP baseline on THIS host, reported
    next to the transfer number so it reads against the right bar: the
    kernel loopback path is the limiter, not a NIC (both raylets share the
    host). The data plane's striped multi-stream + copy_file_range pull can
    legitimately exceed this single-stream figure."""
    import socket
    import threading

    payload = bytearray(4 << 20)
    n_chunks = (size_mib << 20) // len(payload)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def sink():
        conn, _ = srv.accept()
        with conn:
            left = n_chunks * len(payload)
            buf = memoryview(bytearray(1 << 20))
            while left:
                n = conn.recv_into(buf)
                if not n:
                    break
                left -= n

    t = threading.Thread(target=sink, daemon=True)
    t.start()
    cli = socket.create_connection(srv.getsockname())
    try:
        t0 = time.perf_counter()
        with cli:
            for _ in range(n_chunks):
                cli.sendall(payload)
        t.join(timeout=60)
        dt = time.perf_counter() - t0
        moved_mib = n_chunks * len(payload) >> 20
        return {"loopback_tcp_1stream_gbps":
                round(moved_mib / 1024 / dt * 8, 2)}
    finally:
        srv.close()


if __name__ == "__main__":
    main()
