"""Port parity: the streaming softmax cross-entropy
(mxnet_tpu_torch.ops.softmax_xent) and the loss built on it
(mxnet_tpu_torch.gluon.loss) against the JAX package.

The same numpy logits and labels go through both packages: the JAX Pallas
kernels in interpret mode (enabled per test with ``monkeypatch``) and its
``_reference`` (log_softmax + take), against the port's CPU dispatch (the
plain versions of the CUDA kernels).  Tolerance: atol/rtol 1e-5 in f32
(summation order); bf16 logits at 2e-2 (the cotangent is rounded to
bf16 on both sides, at different points); f16 logits' dx within one f16
step.
"""
import os
import re

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


@pytest.mark.parametrize("N,V", [(8, 30522), (16, 1001)])
def test_f16_logits_match_jax_kernel(interpret, N, V):
    """f16 logits (fp16 AMP's MLM head) through JAX's kernel and the port's
    plain versions: the loss is f32 from the same f16 values on both
    sides (1e-5), dx is written in f16 (within one f16 step, 2**-10 of
    its value, of JAX's)."""
    x, lab, g = _inputs(3, (N,), V)
    xh = jnp.asarray(x, jnp.float16)
    loss, vjp = jax.vjp(lambda a: jsx.softmax_cross_entropy(
        a, jnp.asarray(lab), block_n=8, block_v=512), xh)
    dx = vjp(jnp.asarray(g))[0]
    assert dx.dtype == jnp.float16
    xt = torch.from_numpy(np.array(xh.astype(jnp.float32))).to(
        torch.float16).requires_grad_()
    lt = tnn.softmax_cross_entropy(xt, torch.from_numpy(lab))
    lt.backward(torch.from_numpy(g))
    assert lt.dtype == torch.float32 and xt.grad.dtype == torch.float16
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(loss),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(dx.astype(jnp.float32))
    np.testing.assert_allclose(xt.grad.float().numpy(), want,
                               rtol=2 ** -10, atol=1e-7)


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


# ---------------------------------------------------------------------------
# the CUDA forward's launch plan (`_fwd_plan`, `_row_split`) in plain Python
# ---------------------------------------------------------------------------

_CU = open(os.path.join(os.path.dirname(tsx.__file__), os.pardir, "csrc",
                        "softmax_xent.cu")).read()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def test_forward_plan_constants_are_the_kernels():
    assert _cu_const("FWD_THREADS") == tsx.FWD_THREADS
    assert _cu_const("FWD_MIN_BLOCKS") == tsx.FWD_MIN_BLOCKS
    assert _cu_const("FWD_UNROLL") == tsx.FWD_UNROLL
    assert "__launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)" in _CU


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("V", [1, 7, 8, 9, 30522, 32000, 50257])
def test_row_split_covers_the_row_once_at_every_phase(V, itemsize):
    """At every 16-byte phase of the row's start: the head ends on a
    16-byte boundary (or at V), the body is whole vectors, and the
    kernel's reads -- threads 0..E-1 the head, E..2E-1 the tail, thread
    tid the body's vectors (b * unroll + k) * threads + tid -- take every
    element once."""
    per, T, U = 16 // itemsize, tsx.FWD_THREADS, tsx.FWD_UNROLL
    for phase in range(0, 16, itemsize):
        head, nvec, tail = tsx._row_split(V, itemsize, phase)
        assert head + nvec * per + tail == V
        assert 0 <= head < per and 0 <= tail < per
        if nvec:
            assert (phase + head * itemsize) % 16 == 0
        seen = np.zeros(V, np.int64)
        tail0 = head + nvec * per
        for tid in range(T):
            c = tid if tid < per else tail0 + tid - per
            if (tid < per and tid < head) or \
                    (per <= tid < 2 * per and c < V):
                seen[c] += 1
        nb = -(-nvec // (U * T))
        vec = ((np.arange(nb)[:, None, None] * U +
                np.arange(U)[None, :, None]) * T +
               np.arange(T)[None, None, :]).ravel()
        vec = vec[vec < nvec]
        assert len(np.unique(vec)) == len(vec) == nvec
        body = head + vec[:, None] * per + np.arange(per)[None, :]
        np.add.at(seen, body.ravel(), 1)
        assert (seen == 1).all(), (phase, head, nvec, tail)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("N", [1, 7, 64, 1280, 3072, 8192, 100000])
def test_forward_plan_takes_every_row_once_in_one_wave(N, sms):
    """Persistent blocks: at most one resident wave, block b takes rows b,
    b + grid, ..., each row once, and no block takes more than one row
    beyond another."""
    plan = tsx._fwd_plan(N, sms)
    assert 1 <= plan.grid <= min(N, sms * tsx.FWD_MIN_BLOCKS)
    per_block = [len(range(b, N, plan.grid)) for b in range(plan.grid)]
    assert sum(per_block) == N
    assert max(per_block) == plan.rounds
    assert max(per_block) - min(per_block) <= 1
    assert plan.rounds == -(-N // (sms * tsx.FWD_MIN_BLOCKS))
