"""ops/kernels/xent: the port's plain cross-entropy against the reference's
Pallas kernels (`ray_tpu/ops/pallas/xent.py`), run in interpret mode on the
CPU as tests/test_pallas_kernels.py runs them, and the port's autograd
Function against `jax.grad` of `softmax_cross_entropy_pallas`.

Inputs come from a seeded numpy generator and go to both sides. loss and
lse within 1e-5 (the port sums each row at once, the reference over
2048-column blocks); gradients within rtol 1e-4, atol 1e-5, the reference's
own tolerance for its kernel (tests/test_pallas_kernels.py:81). bfloat16
logits are exact in float32, so they keep the float32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import xent as jxent
from ray_tpu_torch.ops.kernels import xent as txent

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# (N, V): a vocabulary of two whole 2048-column blocks, a ragged one (3000),
# and rows ragged against the 256-row blocks as well (300 x 2100)
SHAPES = [(32, 4096), (8, 3000), (300, 2100)]


def _inputs(n, v, seed, ignore_every=0):
    """logits ~ 2·N(0, 1), labels in [0, V); every `ignore_every`-th label
    set to -1."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((n, v))).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    if ignore_every:
        labels[::ignore_every] = -1
    weights = rng.standard_normal(n).astype(np.float32)
    return logits, labels, weights


@jax.jit
def _ref_fwd(logits, labels):
    loss, lse = jxent._run_fwd(logits, labels.reshape(-1, 1))
    return loss[:, 0], lse[:, 0]


@jax.jit
def _ref_grad(logits, labels, weights):
    """d/dlogits of sum(loss · weights): a cotangent that differs by row."""
    return jax.grad(lambda l: jnp.sum(
        jxent.softmax_cross_entropy_pallas(l, labels) * weights))(logits)


def _launches():
    return [k.launches for k in txent.KERNELS]


@pytest.mark.parametrize("n,v", SHAPES)
def test_plain_forward_matches_pallas_kernel(n, v):
    logits, labels, _ = _inputs(n, v, v)
    want_loss, want_lse = _ref_fwd(logits, labels)
    before = _launches()
    loss, lse = txent.xent_fwd(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert _launches() == before  # the CPU launches nothing
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (n,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("n,v", SHAPES)
def test_gradient_matches_jax_grad_of_the_pallas_entry(n, v):
    logits, labels, weights = _inputs(n, v, v + 1)
    want = _ref_grad(logits, labels, weights)
    tl = torch.from_numpy(logits).requires_grad_(True)
    before = _launches()
    loss = txent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    (dx,) = torch.autograd.grad((loss * torch.from_numpy(weights)).sum(), tl)
    assert _launches() == before
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), **GRAD_TOL)


def test_bfloat16_logits():
    n, v = SHAPES[2]
    logits, labels, weights = _inputs(n, v, 3)
    jl = jnp.asarray(logits, jnp.bfloat16)
    want_loss, want_lse = _ref_fwd(jl, labels)
    want_dx = _ref_grad(jl, labels, weights)
    tl = torch.from_numpy(logits).bfloat16().requires_grad_(True)
    loss = txent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    (dx,) = torch.autograd.grad((loss * torch.from_numpy(weights)).sum(), tl)
    assert loss.dtype == torch.float32 and dx.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               **TOL)
    _, lse = txent.xent_fwd(tl.detach(), torch.from_numpy(labels))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    # both round the same float32 gradient once to bfloat16: one ulp apart
    # at most
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_dx), 1e-30))) - 7)
    assert (np.abs(dx.float().numpy() - want_dx) <= ulp).all()


def test_negative_labels_take_no_correct_logit():
    """A label of -1 (an ignore index): loss = lse, and no one-hot in the
    gradient; the same in both packages."""
    n, v = SHAPES[1]
    logits, labels, weights = _inputs(n, v, 4, ignore_every=3)
    want_loss, want_lse = _ref_fwd(logits, labels)
    want_dx = _ref_grad(logits, labels, weights)
    tl = torch.from_numpy(logits).requires_grad_(True)
    loss = txent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    (dx,) = torch.autograd.grad((loss * torch.from_numpy(weights)).sum(), tl)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD_TOL)
    ignored = labels < 0
    _, lse = txent.xent_fwd(tl.detach(), torch.from_numpy(labels))
    assert torch.equal(loss.detach()[ignored], lse[ignored])
    assert (dx[ignored] > 0).all()  # softmax only: every entry positive


def test_label_past_the_vocabulary_is_treated_as_negative():
    """The port's choice where the reference is not defined (a label >= V
    picks up -1e30 inside the reference's padded block)."""
    logits, _, _ = _inputs(3, 50, 6)
    tl = torch.from_numpy(logits)
    past = txent.xent_fwd(tl, torch.tensor([50, 77, -1]))
    neg = txent.xent_fwd(tl, torch.tensor([-1, -1, -1]))
    assert torch.equal(past[0], neg[0]) and torch.equal(past[1], neg[1])
    g = torch.ones(3)
    assert torch.equal(txent.xent_bwd(tl, torch.tensor([50, 77, -1]),
                                      past[1], g),
                       txent.xent_bwd(tl, torch.tensor([-1, -1, -1]),
                                      neg[1], g))


def test_int64_labels_are_accepted():
    n, v = SHAPES[0]
    logits, labels, _ = _inputs(n, v, 7)
    tl = torch.from_numpy(logits)
    got = txent.softmax_cross_entropy(tl, torch.from_numpy(labels).long())
    want = txent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    assert torch.equal(got, want)


def test_bad_shapes_and_dtypes_raise():
    logits = torch.zeros((4, 10))
    labels = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="labels \\[N\\]"):
        txent.softmax_cross_entropy(logits, labels[:3])
    with pytest.raises(ValueError, match="labels \\[N\\]"):
        txent.xent_fwd(torch.zeros(10), labels)
    with pytest.raises(TypeError, match="integers"):
        txent.softmax_cross_entropy(logits, labels.float())
    with pytest.raises(TypeError, match="logits must be"):
        txent.xent_fwd(logits.half(), labels)
    lse = torch.zeros(4)
    with pytest.raises(ValueError, match="do not match"):
        txent.xent_bwd(logits, labels, lse[:2], lse)
    with pytest.raises(TypeError, match="float32 lse and g"):
        txent.xent_bwd(logits, labels, lse, lse.bfloat16())
