"""models/planning: the 8B plan for H100s. `_budget` counts the state's
bytes from the meta device, and they equal a real TrainState's and the
JAX package's (its `jax.eval_shape` of optax's state); at the reference's
v5e constants and efficiencies the port's plan is the reference's
`eightb_plan`, number for number; the sharding checks raise; the default
4-card plan fits 80 GB a card; the step reports the phases that
`measure_phase_eff` times. Nothing here writes into the repository (the
JAX package's plan test writes its artifact there)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.models import planning as ref
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu.train.step import fused_adamw_optimizer as jfused_adamw
from ray_tpu_torch.bench import make_batch
from ray_tpu_torch.models import ModelConfig, init_params, planning
from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
from ray_tpu_torch.models.planning import (H100_HBM_BYTES, GIB, PHASE_EFF,
                                           _budget, _tree_bytes,
                                           eightb_plan, measure_phase_eff)
from ray_tpu_torch.train import (default_optimizer, fused_adamw_optimizer,
                                 make_train_step)
from ray_tpu_torch.train.step import _tree_map

OPTIMIZERS = {"default": (default_optimizer, jdefault_optimizer),
              "fused": (fused_adamw_optimizer, jfused_adamw)}
JAX_DTYPES = {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16}


@functools.lru_cache(maxsize=None)
def _jax_state_bytes(preset, dtype, opt, **overrides):
    """(params, optimizer state without its scalars, the scalars) bytes of
    the JAX package's state for the same config, from `jax.eval_shape` as
    its planning module takes them. The scalars are optax's int32 update
    counts, which the port keeps as Python ints."""
    jcfg = dataclasses.replace(getattr(JConfig, preset)(),
                               dtype=JAX_DTYPES[dtype], **overrides)
    p = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    o = jax.eval_shape(OPTIMIZERS[opt][1]().init, p)
    scalars = sum(x.dtype.itemsize for x in jax.tree_util.tree_leaves(o)
                  if not x.shape)
    return ref._tree_bytes(p), ref._tree_bytes(o) - scalars, scalars


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_budget_state_bytes_equal_a_real_train_state(preset, opt, dtype):
    """params, the optimizer's moments and (from one real step's gradients)
    the grads, byte for byte, against the port's real state and the JAX
    package's (optax's moment dtypes); the efficiencies are the ones
    measured under the same optimizer."""
    cfg = dataclasses.replace(getattr(ModelConfig, preset)(), dtype=dtype)
    optimizer = OPTIMIZERS[opt][0]()
    b = _budget(cfg, optimizer, 1, 1, 1, tokens=64, seq=32)
    state = make_train_step(cfg, optimizer, "cpu")[1](0)
    assert b["param_bytes"] == _tree_bytes(state.params)
    assert b["optimizer_bytes"] == _tree_bytes(state.opt_state)
    assert b["n_params"] == sum(t.numel()
                                for t in tree_leaves(state.params))
    params = _tree_map(lambda t: t.detach().requires_grad_(True),
                       state.params)
    loss, _ = loss_fn(params, make_batch(cfg, 2, 16, 1, "cpu"), cfg)
    grads = torch.autograd.grad(loss, list(tree_leaves(params)))
    assert b["grad_bytes"] == sum(g.numel() * g.element_size()
                                  for g in grads)
    jparams, jopt, jscalars = _jax_state_bytes(preset, dtype, opt)
    assert (b["param_bytes"], b["optimizer_bytes"]) == (jparams, jopt)
    assert 0 < jscalars <= 16
    assert b["optimizer"] == opt and b["phase_eff"] == PHASE_EFF[opt]
    assert b["nvlink_bytes_per_step"] == 0  # one card, no collectives


def test_budget_is_the_reference_plan_at_its_constants(monkeypatch):
    """The reference's plan (64 v5e chips, fsdp 16 x tp 4, 4096 tokens of
    4096) against `_budget` on the same config: the state's bytes exactly
    (optax's scalar counts aside), the per-card GiB the plan reports; then,
    with the port's card figures and efficiencies set to the reference's
    v5e figures and B1_EFF, the whole plan, step time and MFU included."""
    want = ref.eightb_plan()
    assert want["mesh"] == {"fsdp": 16, "tp": 4}
    cfg = dataclasses.replace(ModelConfig.llama3_8b(), max_seq_len=4096,
                              remat="dots")
    b = _budget(cfg, default_optimizer(), 64, 16, 4, 4096, 4096)
    jparams, jopt, _ = _jax_state_bytes("llama3_8b", torch.bfloat16,
                                        "default", max_seq_len=4096,
                                        remat="dots")
    assert b["n_params"] == want["n_params"]
    assert (b["param_bytes"], b["grad_bytes"], b["optimizer_bytes"]) == (
        jparams, jparams, jopt)
    per = b["per_chip_bytes"]
    for k in ("params", "grads", "optimizer", "activations", "logits"):
        assert round(per[k] / GIB, 3) == want["per_chip"][f"{k}_gib"], k

    for name, value in (("H100_PEAK_FLOPS", ref.V5E_PEAK_FLOPS),
                        ("H100_HBM_BYTES", ref.V5E_HBM_BYTES),
                        ("H100_HBM_BW", ref.V5E_HBM_BW),
                        ("H100_NVLINK_BW", ref.V5E_ICI_BW)):
        monkeypatch.setattr(planning, name, value)
    monkeypatch.setattr(planning, "PHASE_EFF",
                        {k: dict(ref.B1_EFF) for k in PHASE_EFF})
    got = eightb_plan(n_chips=64, fsdp=16, tp=4)
    assert got["n_params"] == want["n_params"]
    assert got["per_chip"] == want["per_chip"]
    for k in ("mesh", "batch_per_chip_tokens", "seq"):
        assert got[k] == want[k], k
    gp, wp = got["projection"], want["projection"]
    assert gp["phase_eff"] == wp["phase_eff"]
    assert (gp["nvlink_param_traffic_gib_per_step"]
            == wp["ici_param_traffic_gib_per_step"])
    for k in ("step_s", "tokens_per_sec_per_chip", "projected_mfu",
              "conservative_mfu", "north_star_mfu", "meets_north_star"):
        assert gp[k] == wp[k], k
    # the reference returns no FLOP count: it is its MFU's numerator
    b = _budget(cfg, default_optimizer(), 64, 16, 4, 4096, 4096)
    assert b["flops_per_token"] == pytest.approx(
        b["mfu"] * ref.V5E_PEAK_FLOPS / b["tokens_per_sec_per_chip"],
        rel=1e-12)
    assert b["flops_per_token"] == pytest.approx(
        wp["projected_mfu"] * ref.V5E_PEAK_FLOPS
        / wp["tokens_per_sec_per_chip"], rel=1e-3)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "llama3_8b"])
def test_meta_init_has_the_real_shapes_and_dtypes(preset):
    """init_params on the meta device (the counterpart of jax.eval_shape)
    draws nothing and gives the CPU init's shapes and dtypes (for
    llama3_8b, 16 GB, the CPU init's at one layer and a small vocabulary,
    widened back to the config's)."""
    cfg = getattr(ModelConfig, preset)()
    small = (dataclasses.replace(cfg, n_layers=1, vocab_size=256)
             if preset == "llama3_8b" else cfg)
    meta = _flat(init_params(cfg, device="meta"))
    want = _flat(init_params(small, device="cpu"))
    assert meta.keys() == want.keys()
    V, d = cfg.vocab_size, cfg.d_model
    for name, t in meta.items():
        w = want[name]
        shape = {"embed": (V, d), "lm_head": (d, V)}.get(
            name, (cfg.n_layers, *w.shape[1:]) if name.startswith("layers/")
            else tuple(w.shape))
        assert t.device.type == "meta", name
        assert tuple(t.shape) == shape and t.dtype == w.dtype, name


def test_sharding_that_does_not_divide_raises():
    cfg = ModelConfig.llama3_8b()
    with pytest.raises(ValueError, match="is not n_chips"):
        _budget(cfg, default_optimizer(), 4, 2, 1, 4096, 4096)
    with pytest.raises(ValueError, match="tp=3 does not divide n_heads"):
        eightb_plan(n_chips=3, fsdp=1, tp=3)
    with pytest.raises(ValueError, match="tp=16 does not divide n_kv_heads"):
        eightb_plan(n_chips=16, fsdp=1, tp=16)
    with pytest.raises(ValueError, match="does not divide"):
        _budget(dataclasses.replace(cfg, d_ff=14337), default_optimizer(),
                2, 1, 2, 4096, 4096)


def test_default_four_card_plan_fits_80gb():
    plan = eightb_plan()
    assert plan["mesh"] == {"fsdp": 4, "tp": 1}
    jparams, jopt, _ = _jax_state_bytes("llama3_8b", torch.bfloat16,
                                        "default", max_seq_len=4096,
                                        remat="dots")
    assert plan["n_params"] == ref.eightb_plan()["n_params"]
    per = plan["per_chip"]
    # bf16 params and grads, and optax's float32 mu and bf16 nu (10 B a
    # parameter, 80.3 GB), over 4 cards
    state_gib = per["params_gib"] + per["grads_gib"] + per["optimizer_gib"]
    assert state_gib == pytest.approx((2 * jparams + jopt) / 4 / GIB,
                                      abs=2e-3)
    total = state_gib + per["activations_gib"] + per["logits_gib"]
    assert total < H100_HBM_BYTES / GIB
    assert per["headroom_gib"] > 1.0, per
    proj = plan["projection"]
    assert proj["optimizer"] == "default_optimizer"
    assert proj["phase_eff"] == PHASE_EFF["default"]
    assert 0 < proj["projected_mfu"] and proj["step_s"] > 0
    assert proj["nvlink_param_traffic_gib_per_step"] > 0


def test_one_card_cannot_hold_full_depth():
    """Why full depth needs four cards: 80.3 GB of state alone."""
    b = _budget(ModelConfig.llama3_8b(), default_optimizer(), 1, 1, 1,
                4096, 4096)
    assert b["per_chip_bytes"]["headroom"] < 0


def test_phase_measurement_needs_the_card():
    cfg = ModelConfig.tiny()
    with pytest.raises(ValueError, match="CUDA device"):
        measure_phase_eff(cfg, default_optimizer(), {}, device="cpu")


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_step_reports_the_phases_it_launches(opt):
    """The real step calls `on_phase` at each phase measure_phase_eff
    times, in order, once a step, and computes what it computes without."""
    cfg = ModelConfig.tiny()
    batch = make_batch(cfg, 2, 16, 1, "cpu")
    seen = []
    runs = {}
    for hook in (None, seen.append):
        step_fn, init_fn = make_train_step(cfg, OPTIMIZERS[opt][0](), "cpu",
                                           on_phase=hook)
        state = init_fn(0)
        for _ in range(2):
            state, metrics = step_fn(state, batch)
        runs[hook is None] = (metrics["loss"], state.params)
    assert seen == ["forward", "backward", "optimizer", "end"] * 2
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])):
        assert torch.equal(a, b)
