"""ops/moe and the MoE model paths: the port against ray_tpu/ops/moe.py and
the JAX package's MoE model on the CPU, at `ModelConfig.tiny_moe()`
(float32, 4 experts, top-2), with the JAX parameters and optimizer state
carried across by the numpy bridge.

Routing is an argmax over float32 probabilities, and the two packages sum
the router product in different orders, so a near tie could send a token
to another expert in one package only. Every test on model inputs records
the router logits the port saw (`_Router`) and asserts that the top two
probabilities of every row, and the second and third, lie more than
`MARGIN` = 1e-4 apart, far above the float32 differences (~1e-6): the
routing is then the same in both packages, and the tolerances below need
no room for a flip.

Tolerances: `top2_gating` on identical logits sends every token to the
same slots (dispatch exact) and its weights and aux loss agree within
4 float32 ulps (XLA's and torch's float32 exp differ by one ulp on about
a tenth of inputs on the CPU, which the softmax and the pair's
renormalisation carry through); `moe_ffn` in float32 within 1e-5 of the
output's largest magnitude (another summation order), in bfloat16 within
1e-2 (bf16 output rounding, ~4e-3); the model's loss and aux within 1e-5
relative, gradients within 1e-4; after optimizer steps the parameters
within 1e-4 and loss and gradient norm within 1e-5; prefill and decode
logits within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models import inference as jinf
from ray_tpu.models import init_params as jinit
from ray_tpu.models import loss_fn as jloss
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.train import make_train_step as jmake_train_step
from ray_tpu.train.step import default_optimizer as jdefault_optimizer
from ray_tpu_torch.bridge import (params_from_jax, train_state_from_jax,
                                  train_state_to_numpy)
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.train import default_optimizer, make_train_step

JCFG, CFG = JConfig.tiny_moe(), ModelConfig.tiny_moe()
MARGIN = 1e-4
BATCH, SEQ = 2, 32
# the batch of the optimizer steps: its routing keeps MARGIN over 3 steps
STEP_SEED = 9


def margins(logits) -> float:
    """The smallest gap between the first and second, and the second and
    third, largest router probability of any row."""
    p = np.sort(torch.softmax(torch.as_tensor(logits).double(), -1).numpy(),
                axis=-1)[:, ::-1]
    return float(min((p[:, 0] - p[:, 1]).min(), (p[:, 1] - p[:, 2]).min()))


class _Router:
    """Records the router logits [T, E] of every routing the port makes
    while active (`_route`, which the gating looks up at call time)."""

    def __init__(self, monkeypatch):
        self.logits = []
        real = tmoe._route

        def recording(router_logits, capacity):
            self.logits.append(router_logits.detach().clone())
            return real(router_logits, capacity)

        monkeypatch.setattr(tmoe, "_route", recording)

    def check(self, calls=None):
        assert self.logits, "no routing was recorded"
        if calls is not None:
            assert len(self.logits) == calls
        for lg in self.logits:
            assert margins(lg) > MARGIN, "a near tie in the router"


# ------------------------------------------------------------ top2_gating


@pytest.mark.parametrize("T,E,cf", [(64, 4, 1.25), (64, 4, 4.0),
                                    (37, 8, 1.25), (37, 8, 8.0),
                                    (8, 8, 1.25)])
def test_top2_gating_matches_jax_on_identical_logits(T, E, cf):
    """cf 1.25 overflows some experts' capacity (tokens dropped); cf = E
    gives every expert room for every token (none dropped)."""
    logits = (2 * np.random.default_rng(T * E).standard_normal(
        (T, E))).astype(np.float32)
    capacity = max(1, int(cf * T / E))
    jd, jc, ja = jmoe.top2_gating(jnp.asarray(logits), capacity)
    td, tc, ta = tmoe.top2_gating(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ulp = np.finfo(np.float32).eps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=4 * ulp,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=4 * ulp)
    kept = int(td.sum())
    if cf == E:
        assert kept == 2 * T
    else:
        assert kept < 2 * T  # the overflow case does drop tokens
    # each slot holds at most one token, each token at most two slots
    assert td.sum(dim=0).max() <= 1 and td.sum(dim=(1, 2)).max() <= 2


def test_top2_gating_ties_go_to_the_first_index():
    logits = np.zeros((3, 4), np.float32)
    logits[1] = [0.0, 1.0, 1.0, 0.0]
    jd, jc, _ = jmoe.top2_gating(jnp.asarray(logits), 8)
    td, tc, _ = tmoe.top2_gating(torch.from_numpy(logits), 8)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert td[0, :2].sum() == 2 and td[1, 1:3].sum() == 2


# ---------------------------------------------------------------- moe_ffn


def _moe_inputs(seed, B=2, S=24, d=32, E=4, ff=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, d)).astype(np.float32),
            (0.3 * rng.standard_normal((d, E))).astype(np.float32),
            *((rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
              for s in ((E, d, ff), (E, d, ff), (E, ff, d))))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_ffn_matches_jax(monkeypatch, dtype, tol, cf):
    arrays = _moe_inputs(3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout, jaux = jmoe.moe_ffn(*(jnp.asarray(a, jdt) for a in arrays),
                              capacity_factor=cf)
    router = _Router(monkeypatch)
    tout, taux = tmoe.moe_ffn(*(torch.from_numpy(a).to(dtype)
                                for a in arrays), capacity_factor=cf)
    router.check(calls=1)
    assert tout.dtype == dtype and tout.shape == arrays[0].shape
    want = np.asarray(jout, np.float32)
    err = np.abs(tout.float().numpy() - want).max() / np.abs(want).max()
    assert err < tol
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ------------------------------------------------------------ the model


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.device_get(jinit(jax.random.PRNGKey(0), JCFG))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    batch = {"tokens": jnp.asarray(_tokens())}
    fn = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, JCFG),
                                    has_aux=True))
    (loss, aux), grads = fn(_jax_params())
    return float(loss), float(aux["moe_aux"]), jax.device_get(grads)


def test_tiny_moe_loss_aux_and_grads_match_jax(monkeypatch):
    params = params_from_jax(_jax_params(), CFG, device="cpu")
    assert params["layers"]["router"].shape == (2, 128, 4)
    assert params["layers"]["w_down"].shape == (2, 4, 256, 128)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    router = _Router(monkeypatch)
    loss, aux = loss_fn(params, {"tokens": torch.from_numpy(_tokens())}, CFG)
    grads = torch.autograd.grad(loss, leaves)
    router.check(calls=CFG.n_layers)
    want_loss, want_aux, want_grads = _jax_loss_and_grads()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(aux["moe_aux"].detach()), want_aux,
                               rtol=1e-5)
    # the aux term is in the loss, weighted as the reference weighs it
    assert float(aux["moe_aux"].detach()) > 1.0
    want = [np.asarray(g) for g in tree_leaves(want_grads)]
    assert len(grads) == len(want) == 13
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(want_grads["layers"]["router"])).max() > 0


@functools.lru_cache(maxsize=None)
def _jax_steps(n_steps=3):
    mesh = make_mesh(MeshConfig(dp=1), jax.devices()[:1])
    step_fn, init_fn, _ = jmake_train_step(
        JCFG, mesh, jdefault_optimizer(1e-3, warmup_steps=1), donate=False)
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    tokens = _tokens(STEP_SEED)
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:])}
    out = []
    for _ in range(n_steps):
        state, metrics = step_fn(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    jax.device_get(state.params)))
    return init, tokens, out


def test_three_tiny_moe_train_steps_match_jax(monkeypatch):
    init, tokens, want = _jax_steps()
    state = train_state_from_jax(init, CFG, device="cpu")
    step_fn, _ = make_train_step(CFG, default_optimizer(1e-3,
                                                        warmup_steps=1),
                                 device="cpu")
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]),
             "targets": torch.from_numpy(tokens[:, 1:])}
    router = _Router(monkeypatch)
    for i, (loss, gnorm, params) in enumerate(want):
        state, metrics = step_fn(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm,
                                   rtol=1e-5)
        assert float(metrics["moe_aux"]) > 1.0
        got = train_state_to_numpy(state)
        for g, w in zip(tree_leaves(got["params"]), tree_leaves(params)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i}")
    router.check(calls=3 * CFG.n_layers)
    assert want[-1][0] < want[0][0]


def test_step_metrics_carry_the_aux_of_the_loss(monkeypatch):
    """moe_aux in the step's metrics is the JAX loss_fn's aux (the reference
    step computes it with the loss) and 0 on a dense model."""
    params = _jax_params()
    tokens = _tokens(STEP_SEED)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    _, jaux = jloss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    JCFG)
    step_fn, init_fn = make_train_step(CFG, default_optimizer(1e-3),
                                       device="cpu")
    state = init_fn(0)
    state.params = params_from_jax(params, CFG, device="cpu")
    router = _Router(monkeypatch)
    _, metrics = step_fn(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    router.check(calls=CFG.n_layers)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)
    dense = dataclasses.replace(CFG, n_experts=0)
    step_fn, init_fn = make_train_step(dense, default_optimizer(1e-3),
                                       device="cpu")
    _, metrics = step_fn(init_fn(0), {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert float(metrics["moe_aux"]) == 0.0


def test_fused_ffn_refuses_moe():
    params = params_from_jax(_jax_params(), CFG, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    with pytest.raises(ValueError, match="dense"):
        loss_fn(params, batch, dataclasses.replace(CFG, fused_ffn=True))


# ------------------------------------------------------------ inference

MAX_LEN = 32
jax_prefill = jax.jit(jinf.prefill, static_argnums=(2, 3))
jax_decode_step = jax.jit(jinf.decode_step, static_argnums=3)


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_tiny_moe_prefill_and_decode_match_jax(monkeypatch, cf):
    """Prefill of 3 prompts (one right-padded) and 4 decode steps; at cf
    1.25 the decode steps' 3 rows overflow an expert's capacity of 1."""
    jcfg = dataclasses.replace(JCFG, capacity_factor=cf)
    cfg = dataclasses.replace(CFG, capacity_factor=cf)
    jp = _jax_params()
    tp = params_from_jax(jp, cfg, device="cpu")
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (3, 11)).astype(np.int32)
    index = np.array([10, 4, 7], np.int32)
    router = _Router(monkeypatch)
    jl, jc = jax_prefill(jp, jnp.asarray(tokens), jcfg, MAX_LEN,
                         jnp.asarray(index))
    tl, tc = tinf.prefill(tp, torch.from_numpy(tokens), cfg, MAX_LEN,
                          torch.from_numpy(index))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=1e-5)
    token = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        jl, jc = jax_decode_step(jp, jc, jnp.asarray(token), jcfg)
        tl, tc = tinf.decode_step(tp, tc, torch.from_numpy(token), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
    router.check(calls=5 * cfg.n_layers)


def test_w8a16_moe_tree_matches_the_reference():
    """quantize_model_params quantizes the 4-D expert leaves row by row as
    the reference does and leaves the router in the model dtype;
    `_layer_slice` and `_unstack` hand out [E, ...] int8/scale views."""
    from ray_tpu.models.serving import quantize_model_params as jquantize
    from ray_tpu_torch.models.serving import quantize_model_params
    from ray_tpu_torch.models.transformer import _layer_slice, _unstack

    jp = _jax_params()
    tq = quantize_model_params(params_from_jax(jp, CFG, device="cpu"), CFG)
    jq = jax.device_get(jquantize(jp, JCFG))
    layers = tq["layers"]
    assert isinstance(layers["router"], torch.Tensor)
    np.testing.assert_array_equal(layers["router"].numpy(),
                                  np.asarray(jq["layers"]["router"]))
    for name in ("w_gate", "w_up", "w_down"):
        for part in ("int8", "scale"):
            np.testing.assert_array_equal(
                layers[name][part].numpy(),
                np.asarray(jq["layers"][name][part]), err_msg=name)
    assert layers["w_down"]["scale"].shape == (2, 4, 256, 1)
    for lp in (_layer_slice(layers, 1), _unstack(layers)[1]):
        assert lp["w_gate"]["int8"].shape == (4, 128, 256)
        assert lp["w_gate"]["scale"].shape == (4, 128, 1)
        assert lp["w_gate"]["int8"].data_ptr() == \
            layers["w_gate"]["int8"][1].data_ptr()  # a view, not a copy
        assert lp["router"].shape == (128, 4)
