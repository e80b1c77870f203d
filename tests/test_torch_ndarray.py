"""Port parity: the ``ndarray`` of `mxnet_tpu_torch` (a handle over a torch
tensor) against the JAX package's ``ndarray``, on the CPU.

Properties and conversions, dtypes (JAX's x64-off rule), indexing and
assignment, the operators with Python and NumPy scalars on either side and
their in-place forms, copies and devices, DLPack, ``attach_grad`` under
"write" and "add", ``backward`` of a non-scalar head, ``detach``, the
recording rule, and the boundary: a Block, a loss, a metric, ``generate``,
``split_and_load`` and ``TrainStep`` take arrays and return arrays while
their insides see plain tensors.  Where MXNet's semantics and the JAX
package's part (views, in-place writes under ``record()``), the port
follows MXNet and the case is held against NumPy.
"""
import functools
import operator

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError
from torch_np_common import jax_results, want as _want

torch.set_num_threads(1)


def _np(seed, shape=(3, 4), lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _both(a, dtype=None):
    """The same host value as a JAX array and as a port array (CPU)."""
    with tm.cpu():
        return mx.np.array(a, dtype=dtype), tm.np.array(a, dtype=dtype)


def _close(t, j, rtol=1e-6, atol=1e-6):
    tv, jv = np.asarray(t.asnumpy()), np.asarray(j.asnumpy())
    assert tv.shape == jv.shape
    assert str(t.dtype) == str(j.dtype), (t.dtype, j.dtype)
    np.testing.assert_allclose(tv, jv.astype(tv.dtype), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# properties, conversion, dtypes
# ---------------------------------------------------------------------------

def test_properties_match_jax():
    j, t = _both(_np(0, (2, 3, 4)))
    assert t.shape == j.shape == (2, 3, 4)
    assert t.size == j.size == 24 and t.ndim == j.ndim == 3
    assert t.dtype == np.float32 and str(t.dtype) == str(j.dtype)
    assert t.T.shape == j.T.shape == (4, 3, 2)
    assert t.device == tm.cpu() and t.ctx == t.context == tm.cpu()
    assert t.itemsize == 4 and t.nbytes == 96
    assert isinstance(t, tm.nd.NDArray) and tm.NDArray is tm.np.ndarray
    assert hash(t) == id(t) and t.stype == "default"
    assert len(t) == 2 and [r.shape for r in t] == [(3, 4), (3, 4)]


def test_asnumpy_item_tolist_match_jax():
    j, t = _both(_np(1))
    a = t.asnumpy()
    a[0, 0] = 99.0             # a writable copy
    assert float(t[0, 0]) != 99.0
    np.testing.assert_array_equal(t.asnumpy(), np.asarray(j.asnumpy()))
    assert t.tolist() == np.asarray(j.asnumpy()).tolist()
    j1, t1 = _both(np.float32(2.5))
    assert t1.item() == j1.item() == t1.asscalar() == 2.5
    assert float(t1) == 2.5 and int(t1) == 2 and bool(t1)
    np.testing.assert_array_equal(np.asarray(t), t.asnumpy())
    assert t.shape == (3, 4) and np.asarray(t, dtype=np.float64).dtype \
        == np.float64


def test_dtype_rules_match_jax():
    # float64 input takes the default float, int64 input int32
    for host in (np.arange(4.0), [1.5, 2.5], 3.0):
        j, t = _both(host)
        assert str(t.dtype) == str(j.dtype) == "float32"
    j, t = _both(np.arange(4, dtype=np.int64))
    assert str(t.dtype) == str(j.dtype) == "int32"
    # an explicit float64 raises in both
    with pytest.raises(mx.MXNetError):
        mx.np.array([1.0], dtype="float64")
    with pytest.raises(MXNetError):
        tm.np.array([1.0], dtype="float64", device="cpu")
    # int / int true division is float32, index results int32
    j, t = _both(np.array([3, 4], np.int32))
    assert str((t / t).dtype) == str((j / j).dtype) == "float32"
    assert str(tm.np.argmax(t).dtype) == str(mx.np.argmax(j).dtype)
    assert str(tm.np.mean(t).dtype) == str(mx.np.mean(j).dtype)


def test_bfloat16_dtype_and_asnumpy_widening():
    bf = tm.np.bfloat16
    assert bf == "bfloat16" and bf == torch.bfloat16 and bf == bf
    assert bf == mx.np.bfloat16 and bf != "float32"
    x = _np(2)
    j, t = _both(x, dtype="bfloat16")
    assert t.dtype == "bfloat16" and t.dtype == bf
    got = t.asnumpy()
    assert got.dtype == np.float32                 # widened, exactly
    want = np.asarray(j.asnumpy()).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.all(got == torch.from_numpy(x).to(torch.bfloat16).float()
                  .numpy())


# ---------------------------------------------------------------------------
# indexing and assignment
# ---------------------------------------------------------------------------

KEYS = {
    "int": 1, "neg": -1, "slice": slice(1, None), "step": slice(None, None, 2),
    "pair": (1, 2), "mixed": (slice(None), 2), "ellipsis": (Ellipsis, 1),
    "newaxis": (None, slice(0, 2)), "list": [0, 2], "array": "idx",
    "mask": "mask", "row_mask": "row_mask",
}


def _index(k, x, idx):
    """KEYS' entry `k` as a host index into `x` (`idx` the integer
    array's values)."""
    if k == "idx":
        return np.array(idx, np.int32)
    if k == "mask":
        return x > 0
    if k == "row_mask":
        return np.array([True, False, True])
    return k


def _on(pkg, k):
    return pkg.np.array(k) if isinstance(k, np.ndarray) else k


def _getitem(pkg, key):
    x = _np(3, (3, 4))
    return pkg.np.array(x)[_on(pkg, _index(KEYS[key], x, [2, 0, 2]))]


def _setitem(pkg, key, value):
    x = _np(4, (3, 4))
    k = _index(KEYS[key], x, [2, 0])
    a = pkg.np.array(x)
    a[_on(pkg, k)] = 7.5 if value == "scalar" else pkg.np.array(
        _np(5, x[k].shape))
    return a


SET_KEYS = ["int", "slice", "pair", "mixed", "array", "mask"]


@pytest.fixture(scope="module")
def jax_want():
    """The JAX package's indexing and operator results, one compile for
    most."""
    fns = {("get", k): functools.partial(_getitem, mx, k)
           for k in KEYS if k != "list"}
    fns.update({("set", k, v): functools.partial(_setitem, mx, k, v)
                for k in SET_KEYS for v in ("scalar", "array")})
    fns.update({(op, other, side): functools.partial(_operator, mx, op,
                                                     other, side)
                for op in OPS for other, side in SIDES})
    fns.update({op: functools.partial(_int_operator, mx, op)
                for op in INT_OPS})
    return jax_results(fns)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_getitem_matches_jax(key, jax_want):
    with tm.cpu():
        got = _getitem(tm, key)
    if key == "list":        # JAX refuses a list index; NumPy takes it
        np.testing.assert_array_equal(got.asnumpy(),
                                      _np(3, (3, 4))[KEYS[key]])
        return
    _close(got, _want(jax_want, ("get", key)))


@pytest.mark.parametrize("key", SET_KEYS)
@pytest.mark.parametrize("value", ["scalar", "array"])
def test_setitem_matches_jax(key, value, jax_want):
    with tm.cpu():
        got = _setitem(tm, key, value)
    _close(got, _want(jax_want, ("set", key, value)))


def test_basic_slice_is_a_view_as_in_numpy():
    """MXNet's (and NumPy's) basic slicing gives a view: a write through
    it reaches the array.  The JAX package copies (ROADMAP.md §C)."""
    x = _np(6, (3, 4))
    with tm.cpu():
        t = tm.np.array(x)
    n = x.copy()
    tv, nv = t[1], n[1]
    tv[:] = 5.0
    nv[:] = 5.0
    np.testing.assert_array_equal(t.asnumpy(), n)
    assert tm.np.may_share_memory(t, tv) and np.may_share_memory(n, nv)
    tv += 1.0
    nv += 1.0
    np.testing.assert_array_equal(t.asnumpy(), n)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

OPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
       "truediv": operator.truediv, "floordiv": operator.floordiv,
       "mod": operator.mod, "pow": operator.pow, "eq": operator.eq,
       "ne": operator.ne, "lt": operator.lt, "le": operator.le,
       "gt": operator.gt, "ge": operator.ge}
OPERANDS = ["array", "int", "float", "np_float32", "np_int32"]


def _operand(kind, shape, seed):
    if kind == "array":
        return _both(_np(seed, shape, 0.5, 2.0))
    v = {"int": 2, "float": 1.5, "np_float32": np.float32(1.5),
         "np_int32": np.int32(3)}[kind]
    return v, v


SIDES = [(o, "right") for o in OPERANDS] + [("int", "left"),
                                            ("np_float32", "left")]
INT_OPS = ["add", "sub", "mul", "floordiv", "mod", "truediv", "lt"]


def _operator(pkg, op, other, side):
    fn = OPS[op]
    a = pkg.np.array(_np(7, (3, 4), 0.5, 2.0))
    o = _operand(other, (3, 4), 8)[pkg is tm]
    return fn(a, o) if side == "right" else fn(o, a)


def _int_operator(pkg, op):
    fn = OPS[op]
    a = pkg.np.array(np.array([[5, 7, 9], [2, 3, 11]], np.int32))
    b = pkg.np.array(np.array([[2, 3, 4], [1, 2, 5]], np.int32))
    return fn(a, b), fn(a, 3), fn(7, a)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("other,side", SIDES)
def test_operator_matches_jax(op, other, side, jax_want):
    jr = _want(jax_want, (op, other, side))
    with tm.cpu():
        tr = _operator(tm, op, other, side)
    assert isinstance(tr, tm.np.ndarray), type(tr)
    _close(tr, jr, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("op", INT_OPS)
def test_integer_operators_match_jax(op, jax_want):
    with tm.cpu():
        got = _int_operator(tm, op)
    for t, j in zip(got, _want(jax_want, op)):
        _close(t, j)


def test_unary_operators_and_matmul_match_jax():
    j, t = _both(_np(9, (3, 4)))
    j2, t2 = _both(_np(10, (4, 2)))
    _close(-t, -j)
    _close(abs(t), abs(j))
    _close(+t, +j)
    _close(t @ t2, j @ j2, rtol=1e-5, atol=1e-5)
    ji, ti = _both(np.array([1, 6], np.int32))
    _close(~ti, ~ji)
    _close(ti & 3, ji & 3)
    _close(ti | 8, ji | 8)
    _close(ti ^ 5, ji ^ 5)
    _close(ti << 1, ji << 1)
    _close(ti >> 1, ji >> 1)


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "itruediv",
                                "ipow"])
@pytest.mark.parametrize("other", ["array", "float"])
def test_inplace_operators_match_jax(op, other):
    fn = getattr(operator, op)
    j, t = _both(_np(11, (3, 4), 0.5, 2.0))
    jo, to = _operand(other, (3, 4), 12)
    jr, tr = fn(j, jo), fn(t, to)
    assert tr is t
    _close(tr, jr, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# copies, devices, DLPack
# ---------------------------------------------------------------------------

def test_astype_copy_copyto_as_in_ctx_match_jax():
    j, t = _both(_np(13))
    _close(t.astype("int32"), j.astype("int32"))
    _close(t.astype(np.float16), j.astype(np.float16))
    assert t.astype("float32", copy=False) is t
    c = t.copy()
    c[0, 0] = 100.0
    assert float(t[0, 0]) != 100.0
    jo, to = _both(np.zeros((3, 4), np.float32))
    j.copyto(jo)
    assert t.copyto(to) is to
    _close(to, jo)
    for moved in (t.as_in_ctx(tm.cpu()), t.to_device("cpu"),
                  t.copyto(tm.cpu()), t.as_in_context(tm.cpu(0))):
        assert moved.device == tm.cpu()
        _close(moved, j)


def test_dlpack_round_trip_shares_memory():
    with tm.cpu():
        t = tm.np.array(_np(14))
    back = tm.dlpack.from_dlpack(tm.dlpack.to_dlpack_for_write(t))
    back[0, 0] = -7.0                 # a write through it reaches t
    assert float(t[0, 0]) == -7.0
    via_np = np.from_dlpack(t)        # the protocol, for NumPy
    np.testing.assert_array_equal(via_np, t.asnumpy())
    r = tm.npx.from_dlpack(tm.dlpack.to_dlpack_for_read(t))
    np.testing.assert_array_equal(r.asnumpy(), t.asnumpy())
    j = mx.np.array(_np(14))
    np.testing.assert_array_equal(
        tm.np.from_dlpack(np.asarray(j.asnumpy())).asnumpy(),
        np.asarray(j.asnumpy()))


def test_ops_over_two_devices_raise():
    with tm.cpu():
        t = tm.np.ones((3,))
    other = tm.ndarray.from_torch(torch.empty(3, device="meta"))
    with pytest.raises(MXNetError, match="one op"):
        t + other
    with pytest.raises(MXNetError, match="one op"):
        tm.np.add(t, other)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _grad_run(pkg, x, req, passes):
    a = pkg.np.array(x) if pkg is mx else pkg.np.array(x, device="cpu")
    a.attach_grad(req)
    zero = a.grad.asnumpy().copy()
    for k in range(passes):
        with pkg.autograd.record():
            y = (a * a * (k + 1)).sum()
        y.backward()
    return zero, a.grad.asnumpy()


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_write_and_add_match_jax(req):
    x = _np(15)
    jz, jg = _grad_run(mx, x, req, 2)
    tz, tg = _grad_run(tm, x, req, 2)
    np.testing.assert_array_equal(tz, np.zeros_like(x))
    np.testing.assert_array_equal(tz, np.asarray(jz))
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-6)


def test_backward_of_a_non_scalar_head_and_out_grad_match_jax():
    x = _np(16)
    og = _np(17)
    grads = []
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            a = pkg.np.array(x)
            a.attach_grad()
            with pkg.autograd.record():
                y = pkg.np.tanh(a) * 3
            y.backward()
            g1 = a.grad.asnumpy().copy()
            with pkg.autograd.record():
                y = pkg.np.tanh(a) * 3
            y.backward(pkg.np.array(og))
            grads.append((g1, a.grad.asnumpy()))
    for (tg, jg) in zip(grads[1], grads[0]):
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-6, atol=1e-6)


def test_detach_and_drop_grad_match_jax():
    x = _np(18)
    out = []
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            a = pkg.np.array(x)
            a.attach_grad()
            with pkg.autograd.record():
                y = (a.detach() * a).sum()
            y.backward()
            out.append(a.grad.asnumpy())
            a.zero_grad()
            assert float(abs(a.grad).sum()) == 0.0
            a.drop_grad()
            assert a.grad is None
    np.testing.assert_allclose(out[1], np.asarray(out[0]), rtol=1e-6)


def test_recording_rule_matches_jax():
    """Outside ``record()`` nothing is recorded: ``backward`` of such an
    array changes no gradient, in both packages (MXNet proper raises)."""
    x = _np(19)
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            a = pkg.np.array(x)
            a.attach_grad()
            y = a * 2
            y.backward()
            np.testing.assert_array_equal(a.grad.asnumpy(),
                                          np.zeros_like(x))
            with pkg.autograd.record():
                with pkg.autograd.pause():
                    z = a * 3
                w = a * 4
            assert not pkg.autograd.is_recording()
            z.backward()
            np.testing.assert_array_equal(a.grad.asnumpy(),
                                          np.zeros_like(x))
            w.backward()
            np.testing.assert_array_equal(a.grad.asnumpy(),
                                          np.full_like(x, 4.0))
    with tm.cpu():
        a = tm.np.array(x)
        a.attach_grad()
        assert not (a * 2)._data.requires_grad     # no graph kept
        with tm.autograd.record():
            assert (a * 2)._data.requires_grad


def test_inplace_write_to_a_variable_inside_record_raises():
    """MXNet: "Inplace operations ... are not supported when recording";
    outside ``record()`` the write goes through (a hand-written SGD)."""
    with tm.cpu():
        a = tm.np.array(_np(20))
        a.attach_grad()
        with tm.autograd.record():
            with pytest.raises(MXNetError, match="Inplace"):
                a += 1
            with pytest.raises(MXNetError, match="Inplace"):
                a[0] = 1.0
        before = a.asnumpy()
        a[:] = a - 0.5 * a.grad
        a -= 1.0
        np.testing.assert_array_equal(a.asnumpy(), before - 1.0)
        assert a._data.requires_grad


def test_autograd_functions_take_arrays():
    x = _np(21)
    with tm.cpu():
        a = tm.np.array(x)
        g = tm.np.zeros_like(a)
        tm.autograd.mark_variables([a], [g])
        with tm.autograd.record():
            y = a * a
        tm.autograd.backward([y])
        np.testing.assert_allclose(a.grad.asnumpy(), 2 * x, rtol=1e-6)
        with tm.autograd.record():
            y = (a * 3).sum()
        (d,) = tm.autograd.grad(y, [a])
        assert isinstance(d, tm.np.ndarray)
        np.testing.assert_allclose(d.asnumpy(), np.full_like(x, 3.0))


def test_asarray_of_a_tensor_shares_storage_and_graph():
    """``Parameter.data()`` stays a tensor; ``mx.np.asarray`` wraps one
    with no copy, its storage and its graph shared."""
    t = torch.ones(3, requires_grad=True)
    y = t * 2
    a = tm.np.asarray(y)
    assert a._data is y
    with tm.autograd.record():
        (a * 3).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full(3, 6.0))
    with tm.cpu():
        net = tm.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        w = net.weight.data()
        assert type(w) is torch.nn.Parameter or torch.is_tensor(w)
        aw = tm.np.asarray(w)
        aw[0, 0] = 5.0                    # writes the parameter itself
        assert float(w[0, 0]) == 5.0


# ---------------------------------------------------------------------------
# the boundary: entry points take and return arrays
# ---------------------------------------------------------------------------

class _Seen(tm.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = tm.gluon.nn.Dense(3, in_units=4)
        self.seen = []

    def forward(self, x, extra=None):
        self.seen.append((type(x), type(extra)))
        out = self.dense(x)
        return out, {"twice": out * 2}


def test_block_unwraps_arrays_and_wraps_results():
    """The port's own blocks unwrap arrays (their forward sees tensors); a
    forward written outside the port sees the arrays it was given, as in
    MXNet; results come back as arrays."""
    with tm.cpu():
        net = _Seen()
        net.initialize()
        inner = []
        net.dense.register_forward_pre_hook(
            lambda block, args: inner.append(type(args[0])))
        x = tm.np.array(_np(22, (2, 4)))
        out, rest = net(x, extra=[x])
        assert net.seen[-1] == (tm.np.ndarray, list)
        assert inner[-1] is torch.Tensor
        assert isinstance(out, tm.np.ndarray)
        assert isinstance(rest["twice"], tm.np.ndarray)
        tout, trest = net(x._data)            # tensors in: tensors out
        assert type(tout) is torch.Tensor and net.seen[-1][0] is \
            torch.Tensor
        np.testing.assert_array_equal(out.asnumpy(), tout.detach().numpy())
        assert not out._data.requires_grad    # outside record: no graph
        with tm.autograd.record():
            out, _ = net(x)
        assert out._data.requires_grad


def test_loss_metric_split_and_load_and_generate_take_arrays():
    from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    with tm.cpu():
        logits = tm.np.array(_np(23, (4, 5)))
        labels = tm.np.array(np.array([0, 3, 1, 4], np.int32))
        loss = tm.gluon.loss.SoftmaxCrossEntropyLoss()(logits, labels)
        assert isinstance(loss, tm.np.ndarray) and loss.shape == (4,)
        acc = tm.gluon.metric.Accuracy()
        acc.update(labels, logits)
        pred = logits.asnumpy().argmax(1)
        assert acc.get()[1] == float((pred == labels.asnumpy()).mean())
        parts = tm.gluon.utils.split_and_load(logits, [tm.cpu(), tm.cpu()])
        assert all(isinstance(p, tm.np.ndarray) for p in parts)
        assert [p.shape for p in parts] == [(2, 5), (2, 5)]
        assert all(type(p) is torch.Tensor for p in
                   tm.gluon.utils.split_and_load(logits._data, [tm.cpu()]))
        halves = tm.gluon.utils.split_data(logits, 2)
        assert all(isinstance(p, tm.np.ndarray) for p in halves)
        g = tm.np.array(np.full((2, 2), 3.0, np.float32))
        norm = tm.gluon.utils.clip_global_norm([g], 1.0)
        assert abs(norm - 6.0) < 1e-5
        np.testing.assert_allclose(g.asnumpy(), 0.5, rtol=1e-5)
        model = GPTForCausalLM(GPTConfig(
            vocab_size=31, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position=32, dropout=0.0),
            device="cpu")
        ids = tm.np.array(np.array([[1, 2, 3]], np.int32))
        out = model.generate(ids, max_new_tokens=4)
        assert isinstance(out, tm.np.ndarray) and out.shape == (1, 7)
        raw = model.generate(ids._data, max_new_tokens=4)
        assert type(raw) is torch.Tensor
        assert out.tolist() == raw.tolist()


def test_train_step_takes_arrays_and_returns_an_array():
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep
    with tm.cpu():
        net = tm.gluon.nn.Dense(2, in_units=4)
        net.initialize(device="cpu")
        x = tm.np.array(_np(24, (8, 4)))
        y = tm.np.array(np.arange(8, dtype=np.int32) % 2)

        def loss_fn(out, xb, yb):
            assert type(out) is torch.Tensor and type(yb) is torch.Tensor
            return tm.ops.softmax_cross_entropy(out, yb).mean()

        step = TrainStep(net, Adam(learning_rate=1e-2), loss_fn,
                         num_model_args=1)
        loss = step(x, y)
        assert isinstance(loss, tm.np.ndarray) and loss.shape == ()
        assert isinstance(float(loss), float)
        raw = step(x._data, y._data)
        assert type(raw) is torch.Tensor
