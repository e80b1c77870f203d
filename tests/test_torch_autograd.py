"""Port parity: `mxnet_tpu_torch.autograd` against the JAX package's
``mxnet_tpu/autograd.py``.

- the scopes (`record`, `pause`, `train_mode`, `predict_mode`) set the
  recording and training flags as JAX's do, nested and restored;
- their effect on Gluon's `Dropout` and `BatchNorm` (identity, batch or
  running statistics) is JAX's, and a plain ``torch.nn.Module`` inside a
  Gluon block follows the training flag;
- `backward` (scalar and non-scalar heads, head gradients), `grad` (first
  and second order) and a custom `Function` give JAX's gradients on the
  same seeded inputs, within 1e-6 relative (f32; the same products in
  another order);
- ``grad_req`` "write" overwrites and "add" sums across backward passes,
  as JAX's do; "null" takes no gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tm
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock, nn as tnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)


def _x(seed=0, shape=(4, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flags(ag):
    return ag.is_recording(), ag.is_training()


@pytest.mark.parametrize("outer", ["none", "record", "pause", "train_mode",
                                   "predict_mode"])
@pytest.mark.parametrize("inner", ["record", "pause", "train_mode",
                                   "predict_mode", "record_predict",
                                   "pause_train"])
def test_scopes_set_the_flags_as_jax(outer, inner):
    def scope(ag, name):
        return {"record": lambda: ag.record(),
                "pause": lambda: ag.pause(),
                "train_mode": lambda: ag.train_mode(),
                "predict_mode": lambda: ag.predict_mode(),
                "record_predict": lambda: ag.record(train_mode=False),
                "pause_train": lambda: ag.pause(train_mode=True),
                }[name]()

    seen = {}
    for ag, key in ((jag, "jax"), (tag, "port")):
        trail = [_flags(ag)]
        if outer == "none":
            with scope(ag, inner):
                trail.append(_flags(ag))
            trail.append(_flags(ag))
        else:
            with scope(ag, outer):
                trail.append(_flags(ag))
                with scope(ag, inner):
                    trail.append(_flags(ag))
                trail.append(_flags(ag))
        trail.append(_flags(ag))
        seen[key] = trail
    assert seen["port"] == seen["jax"]
    assert torch.is_grad_enabled()       # torch's own mode is put back


def test_record_turns_torch_grad_mode_on_and_pause_off():
    with torch.no_grad():
        with tag.record():
            assert torch.is_grad_enabled()
            with tag.pause():
                assert not torch.is_grad_enabled()
            assert torch.is_grad_enabled()
        assert not torch.is_grad_enabled()
    prev = tag.set_recording(True)
    assert tag.is_recording() and prev is False
    tag.set_recording(False)
    torch.set_grad_enabled(True)
    assert tag.set_training(True) is False
    assert tag.set_training(False) is True


def test_dropout_follows_the_scopes_as_jax():
    x = _x(1, (64, 32)) + 3.0
    jd, td = jnn.Dropout(0.5), tnn.Dropout(0.5)
    jd.initialize()
    xt = torch.from_numpy(x)
    cases = {"outside": lambda ag: _null(), "record": lambda ag: ag.record(),
             "record_predict": lambda ag: ag.record(train_mode=False),
             "train_mode": lambda ag: ag.train_mode(),
             "predict_mode": lambda ag: ag.predict_mode()}
    for name, sc in cases.items():
        with sc(jag):
            jout = jd(mx.np.array(x)).asnumpy()
        with sc(tag):
            tout = td(xt).numpy()
        j_id, t_id = np.array_equal(jout, x), np.array_equal(tout, x)
        assert j_id == t_id, name
        if not t_id:       # inverted dropout: zeros, and kept * 2
            kept = tout != 0
            assert 0.3 < kept.mean() < 0.7
            np.testing.assert_allclose(tout[kept], 2 * x[kept], rtol=1e-6)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_plain_module_children_follow_the_training_flag():
    class Net(HybridBlock):
        def __init__(self):
            super().__init__()
            self.drop = torch.nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(x)

    net = Net()
    x = torch.ones(256, 8)
    assert torch.equal(net(x), x) and not net.drop.training
    with tag.record():
        y = net(x)
    assert net.drop.training and not torch.equal(y, x)
    with tag.predict_mode():
        assert torch.equal(net(x), x)


@pytest.mark.parametrize("scope", ["record", "predict"])
def test_batch_norm_follows_the_scopes_as_jax(scope):
    x = _x(2, (8, 5, 3))
    jb, tb = jnn.BatchNorm(in_channels=5), tnn.BatchNorm(in_channels=5)
    jb.initialize(mx.init.Normal(0.5))
    with tm.cpu():
        tb.initialize()
    tb.load_dict({k: torch.from_numpy(v.data().asnumpy())
                  for k, v in jb.collect_params().items()})
    with (jag.record() if scope == "record" else jag.predict_mode()):
        jout = jb(mx.np.array(x)).asnumpy()
    with (tag.record() if scope == "record" else tag.predict_mode()):
        tout = tb(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    for n in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            getattr(tb, n).data().numpy(),
            getattr(jb, n).data().asnumpy(), rtol=1e-6, atol=1e-7)


def _pair(seed):
    x, w = _x(seed), _x(seed + 1)
    jx, jw = mx.np.array(x), mx.np.array(w)
    jx.attach_grad()
    jw.attach_grad()
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    return (jx, jw), (tx, tw)


def test_backward_scalar_and_non_scalar_heads_match_jax():
    (jx, jw), (tx, tw) = _pair(3)
    g = _x(5)
    with jag.record():
        jy = mx.np.sin(jx) * jw + jx * jx
    jag.backward(jy, mx.np.array(g))
    with tag.record():
        ty = torch.sin(tx) * tw + tx * tx
    tag.backward(ty, torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.asnumpy(), **TOL)
    # a non-scalar head with no head gradient takes ones
    (jx, jw), (tx, tw) = _pair(4)
    with jag.record():
        jy = jx * jw
    jy.backward()
    with tag.record():
        ty = tx * tw
    tag.backward(ty)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)


def test_grad_first_and_second_order_match_jax():
    (jx, jw), (tx, tw) = _pair(6)
    with jag.record():
        jy = (jx * jx * jx * jw).sum()
        jg = jag.grad(jy, [jx, jw], create_graph=True)
        jz = jg[0].sum()
    jz.backward()
    with tag.record():
        ty = (tx * tx * tx * tw).sum()
        tg = tag.grad(ty, [tx, tw], create_graph=True)
        assert tx.grad is None      # grad() does not touch .grad
        tz = tg[0].sum()
    tag.backward(tz)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.detach().numpy(), b.asnumpy(), **TOL)
    # the second-order gradient, through the recorded first one
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)
    single = tag.grad((tx * 2).sum(), tx)
    assert torch.equal(single, torch.full_like(tx, 2.0))
    with pytest.raises(MXNetError, match="grad"):
        tag.grad((tx * 2).sum(), [tw])


class _JSigmoid(jag.Function):
    def forward(self, x):
        y = 1 / (1 + mx.np.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


class _TSigmoid(tag.Function):
    def forward(self, x):
        y = 1 / (1 + torch.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


def test_custom_function_matches_jax():
    (jx, _), (tx, _) = _pair(7)
    with jag.record():
        jy = _JSigmoid()(jx)
    jy.backward()
    with tag.record():
        ty = _TSigmoid()(tx)
    tag.backward(ty)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_and_add_sums_as_jax(req):
    x = _x(8)
    jx = mx.np.array(x)
    jx.attach_grad(req)
    tx = torch.from_numpy(x.copy())
    tag.mark_variables(tx, torch.zeros_like(tx), req)
    for k in (1.0, 3.0):
        with jag.record():
            jy = (jx * jx * k).sum()
        jy.backward()
        with tag.record():
            ty = (tx * tx * k).sum()
        tag.backward(ty)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), **TOL)


def test_grad_req_null_takes_no_gradient():
    t = torch.ones(3)
    tag.mark_variables(t, torch.zeros(3), "null")
    assert not t.requires_grad and t.grad is None
    with pytest.raises(MXNetError, match="grad_req"):
        tag.set_grad_req(t, "sum")
