"""Port parity: the streaming softmax cross-entropy
(mxnet_tpu_torch.ops.softmax_xent) and the loss built on it
(mxnet_tpu_torch.gluon.loss) against the JAX package.

The same numpy logits and labels go through both packages: the JAX Pallas
kernels in interpret mode (enabled per test with ``monkeypatch``) and its
``_reference`` (log_softmax + take), against the port's CPU dispatch (the
plain versions of the CUDA kernels).  Tolerance: atol/rtol 1e-5 in f32
(summation order); bf16 logits at 2e-2 (the cotangent is rounded to
bf16 on both sides, at different points).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops.pallas import softmax_xent as jsx

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import softmax_xent as tsx

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _inputs(seed, lead, V):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*lead, V)).astype(np.float32)
    lab = rng.randint(0, V, lead).astype(np.int32)
    g = rng.rand(*lead).astype(np.float32)
    return x, lab, g


def _jax(x, lab, g, fn):
    loss, vjp = jax.vjp(lambda xx: fn(xx, jnp.asarray(lab)), jnp.asarray(x))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(g))[0])


def _torch(x, lab, g):
    xt = torch.tensor(x, requires_grad=True)
    loss = tsx.softmax_cross_entropy(xt, torch.from_numpy(lab))
    loss.backward(torch.from_numpy(g))
    return loss.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("lead,V", [((12,), 1000), ((3, 5), 1000),
                                    ((2, 2, 3), 257), ((8,), 128)])
def test_matches_jax_kernel(interpret, lead, V):
    x, lab, g = _inputs(0, lead, V)
    want = _jax(x, lab, g, lambda a, b: jsx.softmax_cross_entropy(
        a, b, block_n=8, block_v=256))
    got = _torch(x, lab, g)
    for name, a, b in zip(("loss", "dx"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("lead,V", [((12,), 1000), ((3, 5), 30522)])
def test_matches_jax_reference(lead, V):
    x, lab, g = _inputs(1, lead, V)
    want = _jax(x, lab, g, lambda a, b: jsx._reference(
        a.reshape(-1, a.shape[-1]), b.reshape(-1)).reshape(b.shape))
    got = _torch(x, lab, g)
    for name, a, b in zip(("loss", "dx"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_bf16_logits(interpret):
    x, lab, g = _inputs(2, (16,), 1000)
    xb = jnp.asarray(x, jnp.bfloat16)
    loss, vjp = jax.vjp(lambda a: jsx.softmax_cross_entropy(
        a, jnp.asarray(lab), block_n=8, block_v=256), xb)
    dx = vjp(jnp.asarray(g))[0]
    assert dx.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    lt = tsx.softmax_cross_entropy(xt, torch.from_numpy(lab))
    lt.backward(torch.from_numpy(g))
    assert lt.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(loss),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dx.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("V", [1000, 600])
def test_masked_vocabulary_matches_jax_reference(V):
    """-inf logits (a masked column; a row masked over its first 512
    entries) contribute nothing and give finite losses and gradients."""
    x, lab, g = _inputs(6, (8,), V)
    x[:, 7] = -np.inf
    x[1, :512] = -np.inf
    lab[lab == 7] = 8
    lab[1] = 550
    want = _jax(x, lab, g, jsx._reference)
    got = _torch(x, lab, g)
    for name, a, b in zip(("loss", "dx"), got, want):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_reference_entry_equals_the_dispatch():
    """`softmax_cross_entropy_reference` (the oracle on the card) is the
    CPU dispatch's plain path under the same autograd."""
    x, lab, g = _inputs(7, (3, 4), 300)
    res = []
    for fn in (tsx.softmax_cross_entropy, tsx.softmax_cross_entropy_reference):
        xt = torch.tensor(x, requires_grad=True)
        loss = fn(xt, torch.from_numpy(lab))
        loss.backward(torch.from_numpy(g))
        res.append((loss.detach(), xt.grad))
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_labels_are_not_clamped(interpret):
    """A label outside [0, V) hits no column: loss = lse, no one-hot."""
    x, lab, g = _inputs(3, (8,), 128)
    lab[[1, 5]] = [-1, 128]
    want = _jax(x, lab, g, lambda a, b: jsx.softmax_cross_entropy(
        a, b, block_n=8, block_v=128))
    got = _torch(x, lab, g)
    for name, a, b in zip(("loss", "dx"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    lse = torch.logsumexp(torch.from_numpy(x), -1).numpy()
    np.testing.assert_allclose(got[0][[1, 5]], lse[[1, 5]], **TOL)


@pytest.mark.parametrize("route", ["sparse_last", "sparse_axis0",
                                   "dense", "from_logits"])
def test_softmax_ce_loss_matches_gluon(interpret, route):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6, 10).astype(np.float32)
    kw, lab = {}, rng.randint(0, 10, (4, 6)).astype(np.int32)
    if route == "sparse_axis0":
        x = rng.randn(10, 6).astype(np.float32)
        kw, lab = dict(axis=0), rng.randint(0, 10, (6,)).astype(np.int32)
    elif route == "dense":
        kw = dict(sparse_label=False)
        lab = rng.dirichlet(np.ones(10), (4, 6)).astype(np.float32)
    elif route == "from_logits":
        kw = dict(from_logits=True)
        x = np.log(rng.dirichlet(np.ones(10), (4, 6))).astype(np.float32)
    want = JLoss(**kw)(mx.np.array(x), mx.np.array(lab)).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(torch.from_numpy(x),
                                        torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_npx_softmax_cross_entropy_sum():
    x, lab, _ = _inputs(5, (6,), 50)
    got = tnn.softmax_cross_entropy(torch.from_numpy(x),
                                    torch.from_numpy(lab), reduction="sum")
    assert got.shape == (1,)
    want = tsx.xent_fwd_reference(torch.from_numpy(x),
                                  torch.from_numpy(lab))[0].sum()
    np.testing.assert_allclose(got.numpy()[0], want.numpy(), **TOL)


def test_dispatch_refuses_other_devices():
    with pytest.raises(MXNetError, match="cuda or cpu"):
        tsx.softmax_cross_entropy(torch.zeros(2, 5, device="meta"),
                                  torch.zeros(2, dtype=torch.int32))
