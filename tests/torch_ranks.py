"""Ranks of the port's multi-process CPU tests: each runs as its own process
under gloo and imports torch, numpy and the port only (never jax), so the
JAX side of a parity test stays in the pytest process.

    python tests/torch_ranks.py TASK OUTDIR RANK WORLD PORT [ARGS...]

Tasks (rank 0 writes OUTDIR/out.npz and OUTDIR/out.json):
  steps DP FSDP MASKED [TP SP SCHEME FUSED MOE PP KV]
                        3 steps of `default_optimizer(1e-3, warmup_steps=1)`
                        on `tiny` (`tiny_moe` if MOE; KV KV heads if not 0;
                        float32;
                        `seq_parallel=SCHEME`, "-" for none; the fused
                        blocks if FUSED) from OUTDIR/in.npz (the JAX params,
                        "p/<path>", and the global batch), each rank on its
                        block; losses, grad norms, moe_aux, final params
                        whole, and whether every pp rank's blocks are the
                        same bits.
  pp DP PP FSDP TP N_MICRO
                        the pipeline (`make_pp_train_step`) on OUTDIR/in.npz
                        (the JAX params of `tiny` at its "n_layers", the
                        global batch and its mask): `pp_forward`'s logits
                        of the first row block on the last stage, vocab
                        whole (OUTDIR/logits.npz), then 3 steps of
                        `default_optimizer(1e-3, warmup_steps=1)`: losses,
                        grad norms, step 1's gradients and the final params
                        whole.
  ckpt_pp               a tiny state at fsdp 2, one step, saved; restored
                        onto pp 2 (the pipeline's rules); every leaf
                        compared whole; the next pipeline step's loss
                        (n_micro 2) and the unsharded step's on the same
                        state.
  sp_ops                ring and Ulysses attention over sp = WORLD, each
                        case of OUTDIR/in.npz ("<case>/q", k, v, the
                        cotangent "dy", "causal"): outputs and dq, dk, dv
                        whole.
  tp_blocks             the fused attention and FFN blocks at tp = WORLD
                        on OUTDIR/in.npz: outputs and gradients whole.
  vocab CHUNK           vocab_embed and vocab_nll (dense, and chunked by
                        CHUNK) at tp = WORLD on OUTDIR/in.npz with its loss
                        mask: the rows, the losses, their gradients whole.
  reshard_tp [MOE]      a tiny (`tiny_moe` if MOE) state at fsdp 4, one
                        step, saved; restored onto fsdp 2 x tp 2 and saved
                        again; restored onto fsdp 4: every leaf compared
                        whole both ways; the next step's loss on each mesh.
  moe_units             on 2 ranks: `local_gating` of OUTDIR/in.npz's router
                        logits at sp 2 and at fsdp 2 (each rank's dispatch,
                        combine and aux into OUTDIR/<mesh>_<rank>.npz); and
                        one `tiny_moe` MoE layer (`_layer`) at tp 2 on
                        in.npz's x, params and cotangent: its output, aux
                        and gradients whole (rank 0's out.npz).
  ckpt                  a tiny state at dp 2 x fsdp 2, one step, saved;
                        restored onto fsdp 4; every leaf compared whole;
                        the next step's loss on both meshes.
  budget FSDP           a tiny state at fsdp FSDP, one step: the bytes of
                        this rank's params, optimizer moments and grads.

  rl_mesh               rllib's learners on a dp = WORLD mesh (every rank the
                        same batch, `ppo_batch`/`traj_batch`/`dqn_batch`)
                        beside the same learners without one, each on the
                        CPU: PPO (one update), DQN (update, sync_target,
                        update; td gathered), IMPALA and APPO (one
                        update), the mesh LearnerGroup (update, weights
                        round trip); losses, aux and params of both.

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


def steps(outdir, rank, world, dp, fsdp, masked, tp=1, sp=1, scheme="-",
          fused=0, moe=0, pp=1, kv=0):
    import dataclasses

    import torch
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.train import (TrainState, batch_sharding,
                                     default_optimizer, make_train_step,
                                     shard_batch, shard_state,
                                     state_shardings)

    cfg = dataclasses.replace(
        ModelConfig.tiny_moe() if int(moe) else ModelConfig.tiny(),
        seq_parallel="" if scheme == "-" else scheme,
        fused_ffn=bool(int(fused)), fused_attn=bool(int(fused)))
    if int(kv):
        cfg = dataclasses.replace(cfg, n_kv_heads=int(kv))
    mesh = make_virtual_mesh(world, MeshConfig(
        dp=int(dp), fsdp=int(fsdp), tp=int(tp), sp=int(sp), pp=int(pp)))
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
    losses, norms, aux = [], [], []
    for _ in range(3):
        state, metrics = step_fn(state, local)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        aux.append(float(metrics["moe_aux"]))
    arrays = {}
    _whole(state.params, "p/", arrays)
    pp_group = mesh.get_group("pp")
    pp_same = all(all(torch.equal(parts[0], x) for x in parts) for parts in (
        _blocks(t.to_local(), pp_group) for _, t in tree_paths(state.params)))
    _write(outdir, rank, arrays, {
        "losses": losses, "norms": norms, "moe_aux": aux,
        "pp_replicas_equal": pp_same,
        "rows_as_dtensor": rows_as_dtensor,
        "local_rows": int(local["inputs"].shape[0]),
        "local_seq": int(local["inputs"].shape[1]),
        "count": state.opt_state.count, "step": state.step})


def _blocks(t, group=None):
    """`t` from every rank of `group`, in rank order (a collective)."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _whole_along(t, dim, group=None):
    """The blocks of `t` along `dim` from every rank of `group`, in rank
    order (a collective)."""
    import torch

    return torch.cat(_blocks(t, group), dim)


class _FirstGrads:
    """An optimizer that keeps the gradients (this rank's blocks) of the
    first step it applies."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def init(self, params):
        return self.optimizer.init(params)

    def apply(self, grads, state, params, grad_norm=None):
        if self.grads is None:
            self.grads = grads
        return self.optimizer.apply(grads, state, params, grad_norm)


def _whole_blocks(tree, shardings, prefix, out):
    """Each local block of `tree` (a tree of tensors laid out as the
    NamedShardings of `shardings`) gathered whole (a collective) into
    out[prefix + path] as numpy."""
    node = dict(tree_paths(shardings))
    for path, t in tree_paths(tree):
        out[prefix + path] = node[path].from_local(
            t).full_tensor().numpy().copy()


def pp(outdir, rank, world, dp, pp_, fsdp, tp, n_micro):
    import dataclasses

    import torch

    from ray_tpu_torch.bridge import params_from_jax
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.models.transformer import param_logical_axes
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.parallel.fsdp import FSDP
    from ray_tpu_torch.parallel.pipeline import (Stages, make_pp_train_step,
                                                 pp_forward)
    from ray_tpu_torch.parallel.tensor import Parallel
    from ray_tpu_torch.train import (TrainState, default_optimizer,
                                     shard_batch, shard_state, to_local)

    data = dict(np.load(Path(outdir) / "in.npz"))
    cfg = dataclasses.replace(ModelConfig.tiny(),
                              n_layers=int(data["n_layers"]))
    n_micro = int(n_micro)
    mesh = make_virtual_mesh(world, MeshConfig(
        dp=int(dp), pp=int(pp_), fsdp=int(fsdp), tp=int(tp)))
    optimizer = _FirstGrads(default_optimizer(1e-3, warmup_steps=1))
    step_fn, _, sh = make_pp_train_step(cfg, mesh, optimizer, n_micro,
                                        device="cpu")
    params = params_from_jax(_tree(data, "p/"), cfg, device="cpu")
    state = shard_state(TrainState(params, optimizer.init(params), 0), sh)
    tokens = torch.from_numpy(data["tokens"])
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
             "loss_mask": torch.from_numpy(data["mask"])}
    local = shard_batch(batch, mesh)

    fsdp_ = FSDP(mesh, sh.params, param_logical_axes(cfg))
    par = Parallel.from_mesh(mesh, fsdp_.gather)
    stages = Stages.from_mesh(mesh)
    logits = pp_forward(to_local(state.params), local["inputs"], cfg, stages,
                        n_micro, par)
    if stages.last:
        if par.tp_group is not None:
            logits = _whole_along(logits, -1, par.tp_group)
        dp_i, _, fsdp_i, tp_i, _ = mesh.get_coordinate()
        if dp_i == fsdp_i == tp_i == 0:
            np.savez(Path(outdir) / "logits.npz", logits=logits.numpy())

    losses, norms = [], []
    for _ in range(3):
        state, metrics = step_fn(state, local)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    arrays = {}
    _whole_blocks(optimizer.grads, sh.params, "g/", arrays)
    _whole(state.params, "p/", arrays)
    _write(outdir, rank, arrays, {
        "losses": losses, "norms": norms, "step": state.step,
        "count": state.opt_state.count,
        "local_rows": int(local["inputs"].shape[0])})


def ckpt_pp(outdir, rank, world):
    import dataclasses

    from ray_tpu_torch.bench import make_batch
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train import (TrainState, abstract_like,
                                     default_optimizer, latest_checkpoint,
                                     load_checkpoint, make_train_step,
                                     save_checkpoint, shard_batch)

    cfg = ModelConfig.tiny()
    optimizer = default_optimizer(1e-3, warmup_steps=1)
    src = make_virtual_mesh(world, MeshConfig(fsdp=2))
    dst = make_virtual_mesh(world, MeshConfig(pp=2))
    batch = make_batch(cfg, 4, 32, 1, "cpu")
    step_src, init_src = make_train_step(cfg, optimizer, "cpu", mesh=src)
    step_pp, _, sh = make_pp_train_step(cfg, dst, optimizer, 2, "cpu")
    state, _ = step_src(init_src(0), shard_batch(batch, src))
    root = Path(outdir) / "ckpt"
    save_checkpoint(state, str(root), step=1)
    restored, _ = load_checkpoint(latest_checkpoint(str(root)),
                                  abstract_like(state, sh))
    whole_src, whole_dst = {}, {}
    _whole(_tensors(state), "", whole_src)
    _whole(_tensors(restored), "", whole_dst)
    equal = sorted(k for k in whole_src
                   if np.array_equal(whole_src[k], whole_dst[k]))
    on_dst = all(t.device_mesh is dst
                 for _, t in tree_paths(_tensors(restored)))
    # the unsharded step on the whole state, then the pipeline's
    whole = TrainState(_full(state.params), dataclasses.replace(
        state.opt_state, mu=_full(state.opt_state.mu),
        nu=_full(state.opt_state.nu)), state.step)
    _, m_one = make_train_step(cfg, optimizer, "cpu")[0](whole, batch)
    _, m_pp = step_pp(restored, shard_batch(batch, dst))
    _write(outdir, rank, {}, {
        "leaves": sorted(whole_src), "equal": equal,
        "on_target_mesh": on_dst, "step": restored.step,
        "count": restored.opt_state.count,
        "next_loss": [float(m_one["loss"]), float(m_pp["loss"])]})


def _full(tree):
    """A tree of DTensors gathered whole (a collective), as tensors."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor()


def sp_ops(outdir, rank, world):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    data = dict(np.load(Path(outdir) / "in.npz"))
    group = dist.group.WORLD
    arrays = {}
    for case in sorted({k.split("/")[0] for k in data}):
        s = data[case + "/q"].shape[2] // world  # this rank's positions
        local = [torch.from_numpy(data[f"{case}/{n}"][:, :, rank * s:
                                                      (rank + 1) * s])
                 .requires_grad_(True) for n in ("q", "k", "v")]
        dy = torch.from_numpy(data[case + "/dy"][:, :, rank * s:
                                                 (rank + 1) * s])
        fn = ring_attention if case.startswith("ring") else ulysses_attention
        lq, lk, lv = local
        if case.startswith("ring") and lk.shape[1] != lq.shape[1]:
            rep = lq.shape[1] // lk.shape[1]  # the caller repeats K/V
            lk, lv = (t.repeat_interleave(rep, dim=1) for t in (lk, lv))
        out = fn(lq, lk, lv, group, causal=bool(data[case + "/causal"]))
        grads = torch.autograd.grad(out, local, dy)
        for name, t in (("out", out), *zip(("dq", "dk", "dv"), grads)):
            arrays[f"{case}/{name}"] = _whole_along(t.detach(), 2).numpy()
    _write(outdir, rank, arrays, {"cases": sorted(
        {k.split("/")[0] for k in data})})


def tp_blocks(outdir, rank, world):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops.kernels.fused_attn import attn_block
    from ray_tpu_torch.ops.kernels.fused_ffn import ffn_block

    data = dict(np.load(Path(outdir) / "in.npz"))
    group = dist.group.WORLD
    # the split dim of each weight (its tp block); None replicated
    splits = {"attn": (None, None, 1, 1, 1, 0, None, None),
              "ffn": (None, None, 1, 1, 0)}
    names = {"attn": ("x", "nw", "wq", "wk", "wv", "wo", "cos", "sin"),
             "ffn": ("x", "nw", "wg", "wu", "wd")}
    arrays = {}
    for block, fn in (("attn", attn_block), ("ffn", ffn_block)):
        leaves = []
        for name, dim in zip(names[block], splits[block]):
            t = torch.from_numpy(data[f"{block}/{name}"])
            if dim is not None:
                t = t.chunk(world, dim)[rank]
            leaves.append(t.clone().requires_grad_(True))
        kw = ({"n_heads": int(data["attn/heads"][0]) // world,
               "n_kv_heads": int(data["attn/heads"][1]) // world}
              if block == "attn" else {})
        y = fn(*leaves, **kw, tp_group=group)
        grads = torch.autograd.grad(y, leaves,
                                    torch.from_numpy(data[f"{block}/dy"]))
        arrays[f"{block}/y"] = y.detach().numpy()
        for name, dim, g in zip(names[block], splits[block], grads):
            arrays[f"{block}/d{name}"] = (
                g if dim is None else _whole_along(g, dim)).numpy()
    _write(outdir, rank, arrays, {})


def vocab(outdir, rank, world, chunk):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.transformer import chunked_token_nll, token_nll
    from ray_tpu_torch.parallel.tensor import (Parallel, copy_to_tp,
                                               vocab_embed)

    data = dict(np.load(Path(outdir) / "in.npz"))
    group = dist.group.WORLD
    par = Parallel(tp_group=group, tp=world, tp_rank=rank)
    emb, x, head = (torch.from_numpy(data[k]) for k in ("emb", "x", "head"))
    tokens, targets = (torch.from_numpy(data[k]) for k in ("tokens",
                                                           "targets"))
    mask = torch.from_numpy(data["mask"])
    emb_r = emb.chunk(world, 0)[rank].clone().requires_grad_(True)
    rows = vocab_embed(emb_r, tokens, torch.float32, group, rank)
    (d_emb,) = torch.autograd.grad(rows, [emb_r],
                                   torch.from_numpy(data["rows_dy"]))
    arrays = {"rows": rows.detach().numpy(),
              "d_emb": _whole_along(d_emb, 0).numpy()}
    for name in ("dense", "chunked"):
        xl = x.clone().requires_grad_(True)
        hl = head.chunk(world, 1)[rank].clone().requires_grad_(True)
        if name == "dense":
            logits = (copy_to_tp(xl, group) @ hl).float()
            loss = token_nll(logits, targets, mask, par)
        else:
            loss = chunked_token_nll(xl, hl, targets, mask, int(chunk), par)
        dx, dh = torch.autograd.grad(loss, [xl, hl])
        arrays[f"{name}/loss"] = loss.detach().numpy()
        arrays[f"{name}/dx"] = dx.numpy()
        arrays[f"{name}/dhead"] = _whole_along(dh, 1).numpy()
    _write(outdir, rank, arrays, {})


def reshard_tp(outdir, rank, world, moe=0):
    from ray_tpu_torch.bench import make_batch
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.train import (abstract_like, default_optimizer,
                                     latest_checkpoint, load_checkpoint,
                                     make_train_step, save_checkpoint,
                                     shard_batch, state_shardings)

    cfg = ModelConfig.tiny_moe() if int(moe) else ModelConfig.tiny()
    optimizer = default_optimizer(1e-3, warmup_steps=1)
    meshes = {"fsdp4": make_virtual_mesh(world, MeshConfig(fsdp=4)),
              "fsdp2xtp2": make_virtual_mesh(world, MeshConfig(fsdp=2,
                                                               tp=2))}
    steps = {k: make_train_step(cfg, optimizer, "cpu", mesh=m)
             for k, m in meshes.items()}
    batch = make_batch(cfg, 4, 32, 1, "cpu")
    state, _ = steps["fsdp4"][0](steps["fsdp4"][1](0),
                                 shard_batch(batch, meshes["fsdp4"]))
    result, states = {}, {"fsdp4": state}
    for i, (src, dst) in enumerate((("fsdp4", "fsdp2xtp2"),
                                    ("fsdp2xtp2", "fsdp4"))):
        root = Path(outdir) / f"ckpt_{i}"
        save_checkpoint(states[src], str(root), step=1)
        target = abstract_like(states[src], state_shardings(
            cfg, meshes[dst], optimizer))
        restored, _ = load_checkpoint(latest_checkpoint(str(root)), target)
        whole_src, whole_dst = {}, {}
        _whole(_tensors(states[src]), "", whole_src)
        _whole(_tensors(restored), "", whole_dst)
        result[f"{src}->{dst}"] = {
            "leaves": len(whole_src),
            "equal": sum(np.array_equal(whole_src[k], whole_dst[k])
                         for k in whole_src),
            "on_target_mesh": all(t.device_mesh is meshes[dst] for _, t in
                                  tree_paths(_tensors(restored)))}
        if i == 0:
            states[dst] = restored
        else:
            states["back"] = restored
    losses = {}
    for name, mesh in (("fsdp4", "fsdp4"), ("fsdp2xtp2", "fsdp2xtp2"),
                       ("back", "fsdp4")):
        _, m = steps[mesh][0](states[name], shard_batch(batch,
                                                        meshes[mesh]))
        losses[name] = float(m["loss"])
    result["next_loss"] = losses
    _write(outdir, rank, {}, result)


def moe_units(outdir, rank, world):
    import torch

    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.models.transformer import _layer
    from ray_tpu_torch.ops.layers import rotary_embedding
    from ray_tpu_torch.ops.moe import local_gating
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.parallel.expert import token_block
    from ray_tpu_torch.parallel.tensor import Parallel

    data = dict(np.load(Path(outdir) / "in.npz"))
    logits = torch.from_numpy(data["logits"])
    B, S, _ = logits.shape
    for name, config in (("sp2", MeshConfig(sp=2)),
                         ("fsdp2", MeshConfig(fsdp=2))):
        par = Parallel.from_mesh(make_virtual_mesh(world, config))
        b, s = B // par.fsdp, S // par.sp
        b0, s0 = token_block(par, b, s)
        dispatch, combine, aux = local_gating(
            logits[b0:b0 + b, s0:s0 + s].contiguous(),
            int(data["capacity"]), par)
        np.savez(Path(outdir) / f"{name}_{rank}.npz", dispatch=dispatch,
                 combine=combine, aux=aux, block=np.array([b0, b, s0, s]))

    # one MoE layer at tp 2: the split leaves' tp blocks, the rest whole
    cfg = ModelConfig.tiny_moe()
    par = Parallel.from_mesh(make_virtual_mesh(world, MeshConfig(tp=2)))
    split = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 2, "w_up": 2,
             "w_down": 1}
    leaves = {}
    for key in data:
        if key.startswith("p/"):
            t = torch.from_numpy(data[key])
            name = key[2:]
            if name in split:
                t = t.chunk(world, split[name])[par.tp_rank]
            leaves[name] = t.clone().requires_grad_(True)
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    cos, sin = rotary_embedding(torch.arange(x.shape[1]), cfg.head_dim,
                                cfg.rope_theta)
    out, aux = _layer(cfg, par, x, leaves, cos[None], sin[None])
    loss = (out * torch.from_numpy(data["dy"])).sum() + aux
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [x] + [leaves[n] for n in names])
    arrays = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
              "d/x": grads[0].numpy()}
    for name, g in zip(names, grads[1:]):
        arrays["d/" + name] = (_whole_along(g, split[name], par.tp_group)
                               if name in split else g).numpy()
    _write(outdir, rank, arrays, {})


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


def ppo_batch(n, obs_dim=4, num_actions=2, seed=0):
    """tests/test_learner_group.py's `_ppo_batch`."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n),
        "logp": rng.normal(size=n).astype(np.float32) * 0.1 - 0.7,
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }


def traj_batch(n_envs=8, t=16, obs_dim=4, num_actions=2, seed=3):
    """tests/test_learner_group.py's `_traj_batch`."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(t, n_envs, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, (t, n_envs)).astype(np.int32),
        "logp": (rng.normal(size=(t, n_envs)) * 0.1 - 0.7).astype(np.float32),
        "rewards": rng.normal(size=(t, n_envs)).astype(np.float32),
        "dones": (rng.random((t, n_envs)) < 0.05).astype(np.float32),
        "last_value": rng.normal(size=n_envs).astype(np.float32),
    }


def dqn_batch(n=32):
    """tests/test_learner_group.py's DQN batch."""
    rng = np.random.default_rng(0)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "dones": rng.integers(0, 2, n).astype(np.float32),
    }


def rl_mesh(outdir, rank, world):
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.rllib.appo import APPOLearner
    from ray_tpu_torch.rllib.dqn import DQNLearner
    from ray_tpu_torch.rllib.impala import ImpalaLearner
    from ray_tpu_torch.rllib.learner import LearnerGroup
    from ray_tpu_torch.rllib.ppo import PPOLearner

    mesh = make_virtual_mesh(world, MeshConfig(dp=world, fsdp=1, tp=1,
                                               sp=1))
    arrays, out = {}, {}

    def keep(name, learner):
        for k, v in learner.get_weights().items():
            arrays[f"{name}/{k}"] = v

    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        ppo = PPOLearner(4, 2, lr=1e-3, seed=7, device="cpu", **kw)
        out[f"ppo_{name}"] = float(ppo.update(ppo_batch(64))["total_loss"])
        keep(f"ppo_{name}", ppo)
        dqn = DQNLearner(4, 2, lr=1e-3, gamma=0.99, device="cpu", **kw)
        loss1, td = dqn.update_batch(dqn_batch())
        dqn.sync_target()
        loss2, _ = dqn.update_batch(dqn_batch())
        out[f"dqn_{name}"] = [loss1, loss2]
        arrays[f"dqn_{name}_td"] = td
        keep(f"dqn_{name}", dqn)
        for cls in (ImpalaLearner, APPOLearner):
            args = (4, 2, 1e-3, 0.99) + ((0.2,) if cls is APPOLearner
                                         else ()) + (0.5, 0.01)
            vt = cls(*args, seed=5, device="cpu", **kw)
            tag = f"{cls.__name__}_{name}"
            out[tag] = vt.update_batch(traj_batch())["total_loss"]
            keep(tag, vt)
    group = LearnerGroup(PPOLearner, {"obs_dim": 4, "num_actions": 2,
                                      "lr": 1e-3, "device": "cpu"},
                         backend="mesh", mesh=mesh)
    out["group"] = group.update(ppo_batch(64))["total_loss"]
    w = group.get_weights()
    group.set_weights(w)
    out["group_roundtrip"] = all(
        np.array_equal(w[k], v) for k, v in group.get_weights().items())
    _write(outdir, rank, arrays, out)


def continuous_batch(seed, n=32):
    """tests/test_learner_group.py's DDPG (seed 1) and SAC (seed 0)
    batches: Pendulum-shaped transitions."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "dones": np.zeros(n, np.float32),
    }


# tests/test_learner_group.py's DDPG learner (its mesh case) and SAC's
DDPG_KW = dict(actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.05,
               twin_q=True, smooth_target_policy=False, target_noise=0.0,
               target_noise_clip=0.0, seed=2, policy_delay=2)
SAC_KW = dict(lr=3e-4, gamma=0.99, tau=0.05, target_entropy=-1.0, seed=4)
CONTINUOUS_UPDATES = 3   # crosses the delayed actor's boundary (delay 2)


def rl_mesh_continuous(outdir, rank, world):
    """DDPG's and SAC's learners with and without a dp mesh: DDPG as the
    reference's mesh case; SAC given the reference's standard normals
    (`noise.npz`: next_eps/eps of each update) and drawing its own; TD3
    (target smoothing) drawing its own. 3 updates each."""
    from ray_tpu_torch.parallel import MeshConfig, make_virtual_mesh
    from ray_tpu_torch.rllib.ddpg import DDPGLearner
    from ray_tpu_torch.rllib.sac import SACLearner

    mesh = make_virtual_mesh(world, MeshConfig(dp=world, fsdp=1, tp=1,
                                               sp=1))
    noise = dict(np.load(Path(outdir) / "noise.npz"))
    arrays, out = {}, {}

    def keep(tag, learner):
        for path, v in _flat(learner.get_weights()).items():
            arrays[f"{tag}/{path}"] = v
        for path, v in _flat(learner.extra).items():
            arrays[f"{tag}/target/{path}"] = v

    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        ddpg = DDPGLearner(3, 1, 1.0, **DDPG_KW, device="cpu", **kw)
        td3 = DDPGLearner(3, 1, 1.0, **{**DDPG_KW,
                                        "smooth_target_policy": True,
                                        "target_noise": 0.2,
                                        "target_noise_clip": 0.5},
                          device="cpu", **kw)
        sac = SACLearner(3, 1, 1.0, **SAC_KW, device="cpu", **kw)
        sac_own = SACLearner(3, 1, 1.0, **SAC_KW, device="cpu", **kw)
        for tag in ("ddpg", "td3", "sac", "sac_own"):
            out[f"{tag}_{name}"] = []
        for u in range(CONTINUOUS_UPDATES):
            for tag, learner, batch in (
                    ("ddpg", ddpg, continuous_batch(1)),
                    ("td3", td3, continuous_batch(1)),
                    ("sac", sac, {**continuous_batch(0),
                                  "next_eps": noise[f"next_eps{u}"],
                                  "eps": noise[f"eps{u}"]}),
                    ("sac_own", sac_own, continuous_batch(0))):
                out[f"{tag}_{name}"].append(learner.update_batch(batch))
        for tag, learner in (("ddpg", ddpg), ("td3", td3), ("sac", sac),
                             ("sac_own", sac_own)):
            keep(f"{tag}_{name}", learner)
    _write(outdir, rank, arrays, out)


def _flat(tree, prefix=""):
    """Nested dicts and lists as {"a/0/b": array}, tensors as numpy."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if hasattr(
                v, "detach") else v)
    return out


if __name__ == "__main__":
    task, outdir, rank, world, port, *rest = sys.argv[1:]
    rank, world = int(rank), int(world)
    _setup(rank, world, port)
    try:
        {"steps": steps, "ckpt": ckpt, "budget": budget, "sp_ops": sp_ops,
         "tp_blocks": tp_blocks, "vocab": vocab, "reshard_tp": reshard_tp,
         "moe_units": moe_units, "pp": pp,
         "ckpt_pp": ckpt_pp, "rl_mesh": rl_mesh,
         "rl_mesh_continuous": rl_mesh_continuous}[task](outdir, rank,
                                                         world, *rest)
    finally:
        from ray_tpu_torch.parallel import shutdown_group

        shutdown_group()
