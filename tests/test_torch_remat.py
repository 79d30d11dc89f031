"""Selective remat (models/transformer.py `maybe_remat`, ops/remat.py): the
port's remat modes against the JAX package's on the CPU.

Each mode of each config gives the loss and gradients of the JAX package's
same mode: the loss within 1e-5 relative and every gradient within 1e-4
(float32, sums in another order; the recompute changes no value). The
configs are `tiny`, `tiny_moe` (its routing margins asserted as in
test_torch_moe.py), `ModelConfig(remat=..., fused_ffn=True)` (the fused FFN
block behind a rematerialized attention half) and `fused_proj`.

The values each mode keeps for the backward are those the reference's
policy keeps: `jax.ad_checkpoint.print_saved_residuals` on the reference's
layer (and attention half) lists them beside the arguments, and the port's
policy, recorded as it decides, keeps values of the same shapes.
"""

import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu.models import loss_fn as jloss
from ray_tpu.models import transformer as jtf
from ray_tpu.ops.layers import rotary_embedding as jrotary
from ray_tpu_torch.bridge import params_from_jax
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.ops import remat
from ray_tpu_torch.ops.layers import rotary_embedding

MODES = ("none", "full", "dots", "dots_sans_qkv", "dots_plus_attn")
SELECTIVE = MODES[2:]
CONFIGS = {
    "tiny": {},
    "tiny_moe": {},
    "fused_ffn": dict(fused_ffn=True),
    "fused_proj": dict(fused_proj=True),
}
BATCH, SEQ = 2, 32


def _cfgs(name, mode):
    base = "tiny_moe" if name == "tiny_moe" else "tiny"
    kw = dict(CONFIGS[name], remat=mode)
    return (dataclasses.replace(getattr(JConfig, base)(), **kw),
            dataclasses.replace(getattr(ModelConfig, base)(), **kw))


def _tokens():
    return np.random.default_rng(1).integers(0, 512, (BATCH, SEQ + 1)
                                             ).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params(moe):
    cfg = JConfig.tiny_moe() if moe else JConfig.tiny()
    return jax.device_get(jinit(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name, mode):
    jcfg, _ = _cfgs(name, mode)
    batch = {"tokens": jnp.asarray(_tokens())}
    fn = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, jcfg)[0]))
    loss, grads = fn(_jax_params(name == "tiny_moe"))
    return float(loss), [np.asarray(g) for g in tree_leaves(
        jax.device_get(grads))]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_mode_matches_jax(monkeypatch, name, mode):
    _, cfg = _cfgs(name, mode)
    params = params_from_jax(_jax_params(name == "tiny_moe"), cfg,
                             device="cpu")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    logits = []
    real = tmoe._route
    monkeypatch.setattr(tmoe, "_route", lambda lg, c: (
        logits.append(lg.detach().clone()), real(lg, c))[1])
    loss, _ = loss_fn(params, {"tokens": torch.from_numpy(_tokens())}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads = _jax_loss_and_grads(name, mode)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    if name == "tiny_moe":
        # the forward, and the recompute where the router product is not
        # kept, route each layer: margins as test_torch_moe.py asserts them
        from test_torch_moe import MARGIN, margins

        assert len(logits) >= cfg.n_layers
        assert all(margins(lg) > MARGIN for lg in logits)


def test_every_mode_gives_the_same_loss_and_grads_on_the_port():
    """The modes recompute the same values: equal within float32 rounding
    of the one summation that differs (none) and bit for bit otherwise."""
    results = {}
    for mode in MODES:
        _, cfg = _cfgs("tiny_moe", mode)
        params = params_from_jax(_jax_params(True), cfg, device="cpu")
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(params, {"tokens": torch.from_numpy(_tokens())},
                          cfg)
        results[mode] = (loss.detach(), torch.autograd.grad(loss, leaves))
    base_loss, base_grads = results["none"]
    for mode in MODES[1:]:
        loss, grads = results[mode]
        assert torch.equal(loss, base_loss), mode
        for g, g0 in zip(grads, base_grads):
            assert torch.equal(g, g0), mode


def test_unknown_mode_raises():
    _, cfg = _cfgs("tiny", "dots_and_more")
    params = params_from_jax(_jax_params(False), cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown remat mode"):
        loss_fn(params, {"tokens": torch.from_numpy(_tokens())}, cfg)


# ------------------------------------------------- what each mode keeps

_SHAPE = re.compile(r"^(\w+)\[([\d,]*)\] (.*)$")


def _jax_saved(name, mode, region):
    """Shapes (sorted) of the values the reference keeps for the backward
    of its layer ("layer") or attention half ("attn") under `mode`, the
    arguments left out."""
    jcfg, _ = _cfgs(name, mode)
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                _jax_params(name == "tiny_moe")["layers"])
    x = jnp.ones((2, 16, jcfg.d_model), jnp.float32)
    cos, sin = jrotary(jnp.arange(16), jcfg.head_dim, jcfg.rope_theta)
    if region == "attn":
        fn = jtf.maybe_remat(functools.partial(jtf._attn_half, jcfg, None),
                             jcfg)

        def f(x, lp, cos, sin):
            return fn(x, lp, cos, sin).sum()
    else:
        fn = jtf.maybe_remat(functools.partial(jtf._layer, jcfg, None), jcfg)

        def f(x, lp, cos, sin):
            y, aux = fn(x, lp, cos, sin)
            return y.sum() + aux

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(f, x, lp, cos[None],
                                                sin[None])
    shapes = []
    for line in out.getvalue().splitlines():
        m = _SHAPE.match(line.strip())
        assert m, line
        if "from the argument" not in m.group(3):
            shapes.append(tuple(int(n) for n in m.group(2).split(",") if n))
    return sorted(shapes)


def _port_saved(monkeypatch, name, mode, region):
    """Shapes (sorted) of the values the port's policy keeps when it runs
    the same layer (or attention half) forward and backward."""
    _, cfg = _cfgs(name, mode)
    params = params_from_jax(_jax_params(name == "tiny_moe"), cfg,
                             device="cpu")
    lp = {k: v[0].requires_grad_(True) for k, v in params["layers"].items()}
    x = torch.ones((2, 16, cfg.d_model), requires_grad=True)
    cos, sin = rotary_embedding(torch.arange(16), cfg.head_dim,
                                cfg.rope_theta)
    saved = []
    real = remat.selective_policy

    def recording(names):
        policy = real(names)

        def record(ctx, func, *args, **kwargs):
            out = policy(ctx, func, *args, **kwargs)
            if out == remat.CheckpointPolicy.MUST_SAVE \
                    and not ctx.is_recompute:
                a = args[0]
                shape = (a.shape if func is remat.NAMED_OPS[1]
                         else (*a.shape[:-1], args[1].shape[-1]))
                saved.append(tuple(shape))
            return out

        return record

    monkeypatch.setattr(remat, "selective_policy", recording)
    body = ttf._attn_half if region == "attn" else ttf._layer
    fn = ttf.maybe_remat(functools.partial(body, cfg, ttf.SINGLE), cfg,
                         region)
    out = fn(x, lp, cos[None], sin[None])
    loss = out.sum() if region == "attn" else out[0].sum() + out[1]
    loss.backward()
    return sorted(saved)


@pytest.mark.parametrize("mode", SELECTIVE + ("full",))
@pytest.mark.parametrize("name,region", [("tiny", "layer"),
                                         ("tiny_moe", "layer"),
                                         ("fused_ffn", "attn")])
def test_policy_keeps_what_the_reference_keeps(monkeypatch, name, region,
                                               mode):
    want = _jax_saved(name, mode, region)
    got = _port_saved(monkeypatch, name, mode, region)
    assert got == want
    if mode == "dots" and region == "layer":
        assert want  # the mode keeps something
