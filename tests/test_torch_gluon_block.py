"""Port parity: the Gluon core (`gluon.Block` / `HybridBlock`,
`gluon.Parameter`, `gluon.nn`, `gluon.utils`) against the JAX package's
``mxnet_tpu/gluon/``.

- deferred shapes are inferred on the first call, as JAX's are;
- `collect_params` gives JAX's dotted names on the same net (and they
  equal torch's ``named_parameters()``), ``select`` keeps JAX's subset;
- a ``.npz`` written by either package loads into the other, f32 and bf16
  (the ``__bf16__`` tag), bit for bit;
- `load_dict`, `share_parameters`, the forward hooks, `cast`,
  ``grad_req`` "add" / "null", `functional_call`, and what raises by name;
- every `gluon.nn` layer and activation: output, input gradient and
  parameter gradients against JAX's on the same seeded weights and
  inputs, in train and predict mode, within 1e-5 relative (f32; the norms
  sum in another order);
- BatchNorm's running statistics after 3 steps equal JAX's (1e-6);
- `gluon.utils` (`split_data`, `split_and_load`, `clip_global_norm`);
- the new modules import neither JAX nor the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tm
from mxnet_tpu_torch import autograd as tag, gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import functional_call
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _copy_into(tnet, jnet):
    """JAX's values into the port's net, name for name."""
    tnet.load_dict({k: torch.from_numpy(np.asarray(v.data().asnumpy()))
                    for k, v in jnet.collect_params().items()})


def _concat(nn):
    c = nn.HybridConcatenate(axis=-1)
    c.add(nn.Dense(3, in_units=4), nn.Dense(2, in_units=4))
    return c


# name -> (factory over an ``nn`` module, input shape, modes); an int
# input is drawn in [0, 10)
LAYERS = {
    "dense": (lambda nn: nn.Dense(5, in_units=12), (3, 12), None),
    "dense_deferred_flatten_tanh": (
        lambda nn: nn.Dense(5, activation="tanh"), (3, 2, 6), None),
    "dense_no_flatten_no_bias": (
        lambda nn: nn.Dense(5, flatten=False, use_bias=False), (3, 2, 6),
        None),
    "dropout_predict": (lambda nn: nn.Dropout(0.5), (4, 6), ("predict",)),
    "embedding": (lambda nn: nn.Embedding(10, 4), "int", None),
    "batchnorm": (lambda nn: nn.BatchNorm(), (4, 3, 5), None),
    "batchnorm_last_axis": (lambda nn: nn.BatchNorm(axis=-1), (4, 5, 3),
                            None),
    "batchnorm_fixed": (lambda nn: nn.BatchNorm(scale=False, center=False,
                                                momentum=0.8), (4, 3, 5),
                        None),
    "batchnorm_relu": (lambda nn: nn.BatchNormReLU(), (4, 3, 5), None),
    "layernorm": (lambda nn: nn.LayerNorm(), (4, 6), None),
    "layernorm_axis1": (lambda nn: nn.LayerNorm(axis=1, epsilon=1e-3),
                        (4, 6, 3), None),
    "rmsnorm": (lambda nn: nn.RMSNorm(), (4, 6), None),
    "groupnorm": (lambda nn: nn.GroupNorm(num_groups=2), (4, 6, 5), None),
    "instancenorm": (lambda nn: nn.InstanceNorm(), (4, 3, 5), None),
    "flatten": (lambda nn: nn.Flatten(), (3, 2, 4), None),
    "lambda_tanh": (lambda nn: nn.Lambda("tanh"), (3, 4), None),
    "hybrid_lambda_tanh": (lambda nn: nn.HybridLambda("tanh"), (3, 4), None),
    "concatenate": (_concat, (3, 4), None),
    "identity": (lambda nn: nn.Identity(), (3, 4), None),
    "sequential": (lambda nn: nn.Sequential(nn.Dense(4, in_units=3),
                                            nn.Activation("relu")),
                   (5, 3), None),
    "leaky_relu": (lambda nn: nn.LeakyReLU(0.1), (4, 6), None),
    "prelu": (lambda nn: nn.PReLU(), (4, 6), None),
    "prelu_channels": (lambda nn: nn.PReLU(in_channels=3), (4, 3, 5), None),
    "elu": (lambda nn: nn.ELU(0.7), (4, 6), None),
    "selu": (lambda nn: nn.SELU(), (4, 6), None),
    "gelu": (lambda nn: nn.GELU(), (4, 6), None),
    "gelu_tanh": (lambda nn: nn.GELU("tanh"), (4, 6), None),
    "swish": (lambda nn: nn.Swish(1.5), (4, 6), None),
    "silu": (lambda nn: nn.SiLU(), (4, 6), None),
}
for _act in ("relu", "sigmoid", "log_sigmoid", "tanh", "softrelu",
             "softsign", "mish"):
    LAYERS[f"activation_{_act}"] = (
        lambda nn, a=_act: nn.Activation(a), (4, 6), None)


def _input(shape, seed):
    if shape == "int":
        x = np.random.RandomState(seed).randint(0, 10, (3, 5))
        return x.astype(np.int32), mx.np.array(x, dtype="int32"), \
            torch.from_numpy(x)
    x = _np(seed, shape)
    jx = mx.np.array(x)
    jx.attach_grad()
    return x, jx, torch.from_numpy(x.copy()).requires_grad_()


def _build(name, seed):
    factory, shape, _ = LAYERS[name]
    jl, tl = factory(jnn), factory(tnn)
    # the JAX layer's weights come from the case's own seed, not from
    # wherever the global key stands after the tests before it (they are
    # copied into the port's layer below, so the parity is unchanged)
    mx.random.seed(seed)
    jl.initialize(mx.init.Normal(0.5))
    with tm.cpu():
        tl.initialize()
    x, jx, _ = _input(shape, seed)
    with jag.predict_mode():
        jl(jx)                  # deferred shapes
    with tag.predict_mode():
        tl(torch.from_numpy(x))
    _copy_into(tl, jl)
    return jl, tl


# dropout's train-mode masks come from each package's own generator
# (test_torch_autograd holds its scopes), so it runs in predict mode only
CASES = [(name, mode) for name in sorted(LAYERS)
         for mode in (LAYERS[name][2] or ("train", "predict"))]


@pytest.mark.parametrize("name,mode", CASES)
def test_layer_matches_jax(name, mode):
    jl, tl = _build(name, 1)
    x, jx, tx = _input(LAYERS[name][1], 2)
    with jag.record(train_mode=mode == "train"):
        jy = jl(jx)
    g = _np(3, jy.shape)       # a seeded head gradient
    jy.backward(mx.np.array(g))
    with tag.record(train_mode=mode == "train"):
        ty = tl(tx)
    tag.backward(ty, torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
    if tx.dtype.is_floating_point:
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                   **TOL)
    jp, tp = jl.collect_params(), tl.collect_params()
    assert list(tp) == list(jp)
    for k, p in tp.items():
        assert p.grad_req == jp[k].grad_req, k
        if p.grad_req == "null":
            assert p.grad() is None
            np.testing.assert_allclose(p.data().detach().numpy(),
                                       jp[k].data().asnumpy(), **TOL)
            continue
        np.testing.assert_allclose(p.grad().numpy(),
                                   jp[k].grad().asnumpy(), **TOL,
                                   err_msg=k)


def test_batch_norm_running_stats_after_three_steps_match_jax():
    jl, tl = _build("batchnorm", 4)
    for step in range(3):
        x = _np(10 + step, (6, 3, 4), scale=1.0 + step) + step
        with jag.record():
            jl(mx.np.array(x))
        with tag.record():
            tl(torch.from_numpy(x))
    for n in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tl, n).data().numpy(),
                                   getattr(jl, n).data().asnumpy(),
                                   rtol=1e-6, atol=1e-7)


class _Head(jgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.scale = jgluon.Parameter("scale", shape=(1,),
                                      init=mx.init.One())
        self.out = jnn.Dense(3, in_units=8)

    def forward(self, x):
        return self.out(x) * self.scale.data()


class _THead(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.scale = tgluon.Parameter("scale", shape=(1,),
                                      init=tm.init.One())
        self.out = tnn.Dense(3, in_units=8)

    def forward(self, x):
        return self.out(x) * self.scale.data()


def _nets():
    def body(nn, head):
        net = nn.HybridSequential()
        inner = nn.HybridSequential()
        inner.add(nn.Dense(8), nn.BatchNorm(), nn.Activation("relu"))
        net.add(inner, nn.LayerNorm(), nn.Embedding(4, 2), head)
        return net
    return body(jnn, _Head()), body(tnn, _THead())


def test_deferred_shapes_are_inferred_on_the_first_call_as_jax():
    jd, td = jnn.Dense(4), tnn.Dense(4)
    jd.initialize()
    with tm.cpu():
        td.initialize()
    assert td.weight.shape == jd.weight.shape == (4, 0)
    with pytest.raises(DeferredInitializationError):
        td.weight.data()
    x = _np(5, (2, 3, 5))
    jd(mx.np.array(x))
    td(torch.from_numpy(x))
    assert td.weight.shape == jd.weight.shape == (4, 15)
    assert tuple(td.weight.data().shape) == (4, 15)
    assert [n for n, _ in td.named_parameters()] == ["weight", "bias"]
    with pytest.raises(MXNetError, match="shape"):
        tgluon.Parameter("w", shape=(0, 3)).initialize(device="cpu")


def test_collect_params_names_and_select_match_jax():
    jnet, tnet = _nets()
    jnet.initialize()
    with tm.cpu():
        tnet.initialize()
    x = _np(6, (2, 5))
    with jag.predict_mode():
        jnet[0](mx.np.array(x))
    tnet[0](torch.from_numpy(x))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    assert [n for n, _ in tnet.named_parameters()] == \
        [n for n, p in tp.items() if p._data is not None]
    for sel in ("weight", "^0\\.", "running_.*", "3\\.(scale|out)"):
        assert list(tnet.collect_params(sel)) == \
            list(jnet.collect_params(sel))
    assert tp["3.scale"].name == "3.scale"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_save_load_both_ways_bit_equal(tmp_path, dtype):
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(6, in_units=4), jnn.LayerNorm(in_channels=6))
    jnet.initialize(mx.init.Normal(0.3))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(6, in_units=4), tnn.LayerNorm(in_channels=6))
    with tm.cpu():
        tnet.initialize(tm.init.Normal(0.3))
    if dtype == "bfloat16":
        jnet.cast("bfloat16")
        tnet.cast("bfloat16")
    jf, tf = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jnet.save_parameters(jf)
    tnet.load_parameters(jf)
    for k, p in tnet.collect_params().items():
        want = jnet.collect_params()[k].data().asnumpy()
        assert str(p.data().dtype) == f"torch.{dtype}"
        assert np.array_equal(p.data().detach().float().numpy(),
                              np.asarray(want, np.float32)), k
    with tm.cpu():
        tnet.initialize(tm.init.Normal(0.3), force_reinit=True)
    tnet.save_parameters(tf)
    jnet.load_parameters(tf)
    for k, p in jnet.collect_params().items():
        got = np.asarray(p.data().asnumpy(), np.float32)
        assert np.array_equal(
            got, tnet.collect_params()[k].data().detach().float().numpy())
    with pytest.raises(MXNetError, match="A16"):
        tnet.save_parameters(tf, format="params")


def test_load_dict_share_parameters_hooks_and_cast():
    with tm.cpu():
        a, b = tnn.Dense(3, in_units=2), tnn.Dense(3, in_units=2)
        a.initialize()
        b.initialize()
    vals = {"weight": torch.arange(6.0).reshape(3, 2),
            "bias": torch.ones(3)}
    a.load_dict(vals)
    assert torch.equal(a.weight.data().detach(), vals["weight"])
    with pytest.raises(MXNetError, match="missing"):
        a.load_dict({"weight": vals["weight"]})
    with pytest.raises(MXNetError, match="dtype"):
        a.load_dict({k: v.double() for k, v in vals.items()})
    b.share_parameters(a.collect_params())
    assert b.weight is a.weight and b.bias is a.bias
    assert b._parameters["weight"] is a.weight.data()
    x = torch.ones(1, 2)
    assert torch.equal(a(x), b(x))
    seen = []
    h1 = a.register_forward_pre_hook(lambda blk, args: seen.append(
        ("pre", blk, args[0].shape)))
    h2 = a.register_forward_hook(lambda blk, args, out: seen.append(
        ("post", blk, out.shape)))
    a(x)
    assert seen == [("pre", a, (1, 2)), ("post", a, (1, 3))]
    h1.detach()
    h2.detach()
    a(x)
    assert len(seen) == 2
    a.cast("float16")
    assert a.weight.data().dtype == torch.float16
    assert a.weight.dtype == torch.float16


def test_grad_req_add_sums_and_null_skips():
    with tm.cpu():
        d = tnn.Dense(2, in_units=3)
        d.initialize()
    x = torch.ones(4, 3)
    for _ in range(2):
        with tag.record():
            y = d(x).sum()
        tag.backward(y)
    once = d.weight.grad().clone()        # "write": the last pass only
    d.setattr("grad_req", "add")
    d.zero_grad()
    for _ in range(2):
        with tag.record():
            y = d(x).sum()
        tag.backward(y)
    assert torch.allclose(d.weight.grad(), 2 * once)
    d.weight.grad_req = "null"
    assert d.weight.grad() is None and not d.weight.data().requires_grad
    with pytest.raises(MXNetError, match="grad_req"):
        d.weight.grad_req = "sum"


def test_functional_call_binds_values_and_returns_batch_norm_updates():
    with tm.cpu():
        net = tnn.HybridSequential()
        net.add(tnn.Dense(3, in_units=2), tnn.BatchNorm(in_channels=3))
        net.initialize()
    params = {k: p.data().detach().clone()
              for k, p in net.collect_params().items()}
    params["0.weight"] = params["0.weight"] * 2
    x = torch.randn(5, 2, generator=torch.Generator().manual_seed(0))
    out, aux = functional_call(net, params, x, training=True)
    assert set(aux) == {"1.running_mean", "1.running_var"}
    assert torch.equal(params["1.running_mean"], torch.zeros(3))
    # the block's own values are untouched, and came back
    assert not torch.equal(net[0].weight.data(), params["0.weight"])
    assert net._modules["0"]._parameters["weight"] is net[0].weight.data()
    with tag.train_mode():
        want = net[1](torch.nn.functional.linear(
            x, params["0.weight"], params["0.bias"]))
    assert torch.allclose(out, want, atol=1e-6)


def test_hybridize_changes_nothing_and_the_rest_raises_by_name():
    with tm.cpu():
        net = tnn.HybridSequential(tnn.Dense(3, in_units=2))
        net.initialize()
    x = torch.randn(4, 2)
    before = net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    assert torch.equal(net(x), before)
    for call, what in ((lambda: net.hybridize(backend="x"), "backend"),
                       (lambda: net.export("p"), "export"),
                       (lambda: net.optimize_for(x), "optimize_for"),
                       (lambda: tgluon.SymbolBlock(), "SymbolBlock"),
                       (lambda: tnn.SyncBatchNorm(), "A12"),
                       (lambda: tnn.Embedding(3, 2, sparse_grad=True),
                        "A16"),
                       (lambda: net[0].weight.row_sparse_data(None), "A16"),
                       (lambda: tgluon.utils.download("x"), "download")):
        with pytest.raises(MXNetError, match=what):
            call()
    net.summary()


@pytest.mark.parametrize("n,even", [(4, True), (3, False)])
def test_split_data_and_split_and_load_match_jax(n, even):
    x = _np(7, (12, 3)) if even else _np(7, (11, 3))
    js = jgluon.utils.split_data(mx.np.array(x), n, even_split=even)
    ts = tgluon.utils.split_data(torch.from_numpy(x), n, even_split=even)
    assert [t.shape for t in ts] == [j.shape for j in js]
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), b.asnumpy())
    if not even:
        with pytest.raises(ValueError):
            tgluon.utils.split_data(torch.from_numpy(x), n)
    parts = tgluon.utils.split_and_load(x, [tm.cpu(), "cpu"],
                                        even_split=even)
    assert len(parts) == 2 and parts[0].device.type == "cpu"


def test_clip_global_norm_matches_jax():
    arrays = [_np(8, (3, 4), 2.0), _np(9, (5,), 3.0)]
    ja = [mx.np.array(a) for a in arrays]
    ta = [torch.from_numpy(a.copy()) for a in arrays]
    jn = jgluon.utils.clip_global_norm(ja, 1.5)
    tn = tgluon.utils.clip_global_norm(ta, 1.5)
    assert abs(tn - jn) <= 1e-5 * jn
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), **TOL)
    with pytest.warns(UserWarning):
        tgluon.utils.clip_global_norm([torch.tensor([np.inf])], 1.0)


def test_gluon_modules_import_no_jax_and_no_jax_package():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.device, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.initializer, mxnet_tpu_torch.util, "
            "mxnet_tpu_torch.gluon.block, mxnet_tpu_torch.gluon.parameter, "
            "mxnet_tpu_torch.gluon.nn, mxnet_tpu_torch.gluon.nn.basic_layers,"
            " mxnet_tpu_torch.gluon.nn.activations, "
            "mxnet_tpu_torch.gluon.utils, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.gluon.metric, mxnet_tpu_torch.gluon.trainer, "
            "mxnet_tpu_torch.contrib.quantization\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_devices_wrap_torch_devices():
    assert tm.cpu().torch_device == torch.device("cpu")
    assert tm.gpu(1).torch_device == torch.device("cuda", 1)
    assert tm.Device("cuda:0") == tm.gpu(0) and tm.Context is tm.Device
    assert str(tm.gpu(2)) == "gpu(2)"
    with pytest.raises(MXNetError, match="tpu"):
        tm.tpu()
    with tm.cpu():
        assert tm.current_device() == tm.cpu()
        with tm.gpu(0):
            assert tm.current_device() == tm.gpu(0)
    assert tm.num_gpus() == torch.cuda.device_count()
    assert tm.resolve_device(tm.cpu()) == torch.device("cpu")


def test_deepcopy_and_pickle_keep_the_parameters_and_grad_req(tmp_path):
    import copy
    with tm.cpu():
        net = tnn.HybridSequential(tnn.Dense(3, in_units=2), tnn.Dense(2))
        net.initialize()
    x = torch.ones(4, 2)
    fresh = copy.deepcopy(net)          # the second layer still deferred
    net(x)
    torch.save(net, str(tmp_path / "net.pt"))
    for twin in (copy.deepcopy(net),
                 torch.load(str(tmp_path / "net.pt"), weights_only=False)):
        assert torch.equal(twin(x), net(x))
        w = twin[0].weight
        assert w.data() is twin[0]._parameters["weight"]
        assert w.data() is not net[0].weight.data()
        for _ in range(2):              # "write": the last pass only
            with tag.record():
                y = twin(x).sum()
            tag.backward(y)
        once = w.grad().clone()
        with tag.record():
            y = twin(x).sum()
        tag.backward(y)
        assert torch.equal(w.grad(), once)
    # a deferred parameter materialized in a copy lands in the copy's own
    # module, not the original's
    fresh(x)
    assert fresh[1]._parameters["weight"] is fresh[1].weight.data()
    assert net[1]._parameters["weight"] is net[1].weight.data()
    assert fresh[1].weight.data() is not net[1].weight.data()
