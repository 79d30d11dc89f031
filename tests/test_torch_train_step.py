"""models/transformer (training half), train/step and bench: the port
against the JAX package on the CPU, `ModelConfig.tiny` (float32), with the
JAX parameters and optimizer state carried across by the numpy bridge.

Tolerances: the loss within 1e-5 relative (the same float32 forward, sums
in another order); every gradient leaf within 1e-4; after optimizer steps
the parameters within 1e-4, the loss and gradient norm within 1e-5 (Adam
divides each gradient by its own running magnitude, which scales their
float32 differences up to ~1e-5 of the learning rate).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.models import loss_fn as jloss
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.ops.pallas import fused_ffn as jffn
from ray_tpu.train import make_train_step as jmake_train_step
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu.train.step import fused_adamw_optimizer as jfused_adamw
from ray_tpu_torch import bench
from ray_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                  train_state_from_jax, train_state_to_numpy)
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
from ray_tpu_torch.ops.kernels import fused_ffn as tffn
from ray_tpu_torch.train import (default_optimizer, fused_adamw_optimizer,
                                 make_train_step,
                                 warmup_cosine_decay_schedule)

FUSED = dict(fused_ffn=True, fused_attn=True)
BATCH, SEQ = 2, 32


def _cfgs(fused):
    kw = FUSED if fused else {}
    return (dataclasses.replace(JConfig.tiny(), **kw),
            dataclasses.replace(ModelConfig.tiny(), **kw))


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, 512, (BATCH, SEQ + 1)).astype(np.int32)


def _mask():
    m = np.ones((BATCH, SEQ + 1), np.float32)
    m[0, 20:] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.device_get(jinit(jax.random.PRNGKey(0), JConfig.tiny()))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(fused, masked):
    jcfg, _ = _cfgs(fused)
    batch = {"tokens": jnp.asarray(_tokens())}
    if masked:
        batch["loss_mask"] = jnp.asarray(_mask())
    fn = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, jcfg)[0]))
    loss, grads = fn(_jax_params())
    return float(loss), jax.device_get(grads)


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}" if isinstance(tree[k], dict) else k: vv
                for k in sorted(tree)
                for kk, vv in (_flat(tree[k]).items()
                               if isinstance(tree[k], dict)
                               else [(k, tree[k])])}
    return tree


# the loss mask is loss-side code that both layer paths share: one masked
# case keeps the file's JAX compilations few
@pytest.mark.parametrize("fused,masked", [(False, False), (True, False),
                                          (False, True)])
def test_loss_and_grads_match_jax(fused, masked):
    _, cfg = _cfgs(fused)
    params = params_from_jax(_jax_params(), cfg, device="cpu")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(_tokens())}
    if masked:
        batch["loss_mask"] = torch.from_numpy(_mask())
    loss, aux = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads = _jax_loss_and_grads(fused, masked)
    assert aux["ntokens"] == BATCH * SEQ
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = params_to_numpy(dict(zip(range(len(grads)), grads)))
    want = [np.asarray(g) for g in tree_leaves(want_grads)]
    assert len(got) == len(want) == 12
    names = sorted(_flat(want_grads))
    for i, name in enumerate(names):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_remat_full_and_chunked_loss_match_the_plain_forward():
    """remat="full" (torch.utils.checkpoint) and loss_chunk give the same
    loss and gradients as the plain forward, within float32 rounding."""
    _, base = _cfgs(False)
    batch = {"inputs": torch.from_numpy(_tokens()[:, :-1]),
             "targets": torch.from_numpy(_tokens()[:, 1:])}
    results = []
    for cfg in (base, dataclasses.replace(base, remat="full"),
                dataclasses.replace(base, loss_chunk=8)):
        params = params_from_jax(_jax_params(), cfg, device="cpu")
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(params, batch, cfg)
        results.append((float(loss.detach()),
                        torch.autograd.grad(loss, leaves)))
    for loss, grads in results[1:]:
        np.testing.assert_allclose(loss, results[0][0], rtol=1e-6)
        for g, g0 in zip(grads, results[0][1]):
            np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_unported_modes_raise():
    _, cfg = _cfgs(False)
    params = params_from_jax(_jax_params(), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    for kw, err in ((dict(seq_parallel="ring"), NotImplementedError),
                    (dict(fused_attn=True), ValueError),
                    (dict(fused_ffn=True, n_experts=4), ValueError)):
        with pytest.raises(err):
            loss_fn(params, batch, dataclasses.replace(cfg, **kw))


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 10000), (3, 4)])
def test_schedule_matches_optax(warmup, total):
    ours = warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
    for step in (0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                 total - 1, total, total + 7):
        # optax computes in float32: 1 + cos(pi t / T) cancels near T
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * 3e-4, err_msg=f"step {step}")


ALL_KERNELS = (True, True, True)  # USE_K1, USE_K2, USE_K3


def _set_ffn_flags(module, flags):
    old = (module.USE_K1, module.USE_K2, module.USE_K3)
    module.USE_K1, module.USE_K2, module.USE_K3 = flags
    return old


@functools.lru_cache(maxsize=None)
def _jax_steps(fused, all_kernels=False, n_steps=3):
    """The JAX step on a 1-device CPU mesh: its initial state and, after
    each step, (loss, grad_norm, params). `all_kernels`: the fused AdamW
    optimizer and every fused-FFN kernel flag on (the Pallas kernels run in
    interpret mode)."""
    jcfg, _ = _cfgs(fused)
    mesh = make_mesh(MeshConfig(dp=1), jax.devices()[:1])
    make_opt = jfused_adamw if all_kernels else jdefault_optimizer
    step_fn, init_fn, _ = jmake_train_step(
        jcfg, mesh, make_opt(1e-3, warmup_steps=1), donate=False)
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    tokens = _tokens(5)
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:])}
    out = []
    old = _set_ffn_flags(jffn, ALL_KERNELS if all_kernels else
                         (jffn.USE_K1, jffn.USE_K2, jffn.USE_K3))
    try:  # the flags are read while the step is traced, at its first call
        for _ in range(n_steps):
            state, metrics = step_fn(state, batch)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                        jax.device_get(state.params)))
    finally:
        _set_ffn_flags(jffn, old)
    return init, tokens, out


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_jax(fused):
    init, tokens, want = _jax_steps(fused)
    _, cfg = _cfgs(fused)
    state = train_state_from_jax(init, cfg, device="cpu")
    assert state.opt_state.count == 0 and state.step == 0
    step_fn, _ = make_train_step(cfg, default_optimizer(1e-3,
                                                        warmup_steps=1),
                                 device="cpu")
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]),
             "targets": torch.from_numpy(tokens[:, 1:])}
    _check_steps(step_fn, state, batch, want)


def test_three_all_kernel_train_steps_match_jax():
    """The all-kernel step: fused blocks, USE_K1/K2/K3 on and
    fused_adamw_optimizer (mu and nu float32) on both sides."""
    init, tokens, want = _jax_steps(True, all_kernels=True)
    _, cfg = _cfgs(True)
    state = train_state_from_jax(init, cfg, device="cpu")
    assert state.opt_state.nu["embed"].dtype == torch.float32
    step_fn, _ = make_train_step(cfg, fused_adamw_optimizer(
        1e-3, warmup_steps=1), device="cpu")
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]),
             "targets": torch.from_numpy(tokens[:, 1:])}
    old = _set_ffn_flags(tffn, ALL_KERNELS)
    try:
        _check_steps(step_fn, state, batch, want)
    finally:
        _set_ffn_flags(tffn, old)


def _check_steps(step_fn, state, batch, want):
    for i, (loss, gnorm, params) in enumerate(want):
        state, metrics = step_fn(state, batch)
        assert metrics["step"] == i
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm,
                                   rtol=1e-5)
        got = train_state_to_numpy(state)
        assert got["count"] == got["step"] == i + 1
        for name, g, w in zip(sorted(_flat(params)),
                              tree_leaves(got["params"]),
                              tree_leaves(params)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {name}")
    assert want[-1][0] < want[0][0]  # the loss falls


def test_bfloat16_moments_keep_optax_dtypes():
    """On bfloat16 leaves optax keeps mu in float32 (mu_dtype) and nu in
    the parameter dtype; the port does the same. Two steps, the first
    clipped (global norm ~6 > 1), the second not. optax takes the norm in
    bfloat16 and the port in float32, so the clipped gradients differ by up
    to 2**-8 relative before a few bfloat16 roundings: values agree within
    2**-6 relative plus 2**-7 of the leaf's largest value (elements that
    nearly cancel), and a new parameter, p + lr·u rounded to bfloat16,
    within lr·2**-6 more."""
    rng = np.random.default_rng(4)
    shapes = {"b": (48,), "w": (64, 48)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.1, 0.001)]

    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    opt = jdefault_optimizer(1e-2, warmup_steps=1)
    jstate = opt.init(jp)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    topt = default_optimizer(1e-2, warmup_steps=1)
    tstate = topt.init(tp)
    for g in grads:
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        updates, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = topt.apply({k: torch.from_numpy(v).to(torch.bfloat16)
                             for k, v in g.items()}, tstate, tp)
    adam = jstate[1][0]
    for k in shapes:
        assert adam.mu[k].dtype == jnp.float32 and tstate.mu[k].dtype == \
            torch.float32
        assert adam.nu[k].dtype == jnp.bfloat16 and tstate.nu[k].dtype == \
            torch.bfloat16
        assert tp[k].dtype == torch.bfloat16
        for got, want, name in ((tstate.mu[k], adam.mu[k], "mu"),
                                (tstate.nu[k], adam.nu[k], "nu"),
                                (tp[k], jp[k], "params")):
            want = np.asarray(want, np.float32)
            atol = 2 ** -7 * np.abs(want).max() + (
                1e-2 * 2 ** -6 if name == "params" else 0.0)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -6, atol=atol,
                                       err_msg=f"{name} {k}")
    assert tstate.count == int(adam.count) == 2


def test_bench_cpu_smoke_path_prints_its_keys(capsys):
    result = bench.main(["--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert {"metric", "value", "unit", "vs_baseline", "mfu", "n_params",
            "n_chips", "platform", "batch", "seq", "step_time_s",
            "first_step_s", "loss"} <= set(line)
    assert line["platform"] == "cpu" and line["n_chips"] == 1
    assert line["value"] > 0 and np.isfinite(line["loss"])


def test_step_frees_its_gradients_without_garbage_collection():
    """A step's gradients die with the step, by reference counting alone:
    at Llama-3-8B width a reference cycle holding them kept 5.6 GB per
    step alive on the card until the collector ran."""
    import gc
    import weakref

    _, cfg = _cfgs(True)
    opt = default_optimizer(1e-3, warmup_steps=1)
    seen = []

    def apply(grads, *args):
        seen.append(weakref.ref(grads["embed"]))
        return opt.apply(grads, *args)

    step_fn, init_fn = make_train_step(cfg, opt._replace(apply=apply),
                                       device="cpu")
    state = init_fn(0)
    batch = {"tokens": torch.from_numpy(_tokens())}
    gc.disable()
    try:
        state, _ = step_fn(state, batch)
        assert seen[0]() is None
    finally:
        gc.enable()
