"""Port parity: `gluon.model_zoo` of `mxnet_tpu_torch` against the JAX
package's on the CPU.

- every `get_model` name (JAX's alias table) builds in the port with
  JAX's parameter names;
- resnet18_v1's and resnet50_v1's parameter names and shapes, after the
  first call, equal JAX's;
- resnet18_v1 (classes 10, 2 x 3 x 128 x 128, Xavier weights carried over
  by `load_jax_params`): the logits, the loss, every parameter after one
  NAG `Trainer` step (lr 0.05, momentum 0.9, wd 1e-4, as
  ``examples/gluon/image_classification.py`` trains) and BatchNorm's
  running statistics equal JAX's, on the reference route (the JAX
  optimizer is given the `Trainer`'s parameters, ``param_dict``, as
  MXNet's `Trainer` wires it).  Not at 32 x 32: there the last stage's
  BatchNorm normalises two values a channel, so a step's gradients are
  ill-conditioned, and a one-ulp change of the input moves the JAX
  package's own weights after the step far past any tolerance; at 128 x
  128 (32 values a channel) the step is well-conditioned;
- mobilenet0.25 at its own 224 x 224 (training mode: BatchNorm normalises
  with the batch; its quarter-width depthwise stages are ill-conditioned
  the same way at small sizes) and squeezenet1.1 (predict mode, Xavier
  magnitude 6 so that the logits are not vanishingly small) give JAX's
  logits;
- `model_store` loads weights placed under ``root`` (written by either
  package) and raises by name on a miss; nothing is downloaded.

The JAX side runs hybridized (one compile a net).  Tolerances: logits and
loss rtol 1e-4 / atol 1e-5; weights after the step and running
statistics rtol 1e-4 / atol 1e-5 (f32; convolutions sum in another
order).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = sorted(n for n in jvision._models if n != "get_resnet")


def _x(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(
        np.float32)


def _jax_net(name, shape, init=None, **kw):
    mx.random.seed(0)
    net = jvision.get_model(name, **kw)
    net.initialize(init or mx.init.Xavier())
    net.hybridize()
    net(mx.np.array(_x(shape)))
    return net


def _carry(jnet, name, **kw):
    tnet = tvision.get_model(name, **kw)
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet.collect_params().items()}, device="cpu")
    return tnet


def test_the_zoo_has_jax_names():
    assert sorted(tvision._models) == sorted(jvision._models)
    with pytest.raises(MXNetError, match="not in the zoo"):
        tvision.get_model("resnet19_v1")


@pytest.mark.parametrize("name", NAMES)
def test_every_name_builds_with_jax_parameter_names(name):
    got = list(tvision.get_model(name, classes=7).collect_params())
    assert got == list(jvision.get_model(name, classes=7).collect_params())


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_resnet_names_and_shapes_equal_jax(name):
    jnet = _jax_net(name, (1, 3, 32, 32), classes=10)
    tnet = tvision.get_model(name, classes=10)
    tnet.initialize(tm.init.Xavier(), device="cpu")
    tnet(torch.from_numpy(_x((1, 3, 32, 32))))
    want = {k: p.shape for k, p in jnet.collect_params().items()}
    got = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    assert list(got) == list(want) and got == want
    grad_req = {k: p.grad_req for k, p in tnet.collect_params().items()}
    assert grad_req == {k: p.grad_req for k, p in
                        jnet.collect_params().items()}


def test_resnet18_v1_nag_step_equals_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "reference")
    shape = (2, 3, 128, 128)
    jnet = _jax_net("resnet18_v1", shape, classes=10)
    tnet = _carry(jnet, "resnet18_v1", classes=10)
    x = _x(shape, seed=1)
    y = np.array([3, 7], np.float32)
    opts = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    jp = jnet.collect_params()
    jtr = jgluon.Trainer(jp, "nag", dict(opts))
    jtr.optimizer.param_dict = dict(jp)
    ttr = tm.gluon.Trainer(tnet.collect_params(), "nag", dict(opts))
    with mx.autograd.record():
        jout = jnet(mx.np.array(x))
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jout, mx.np.array(y))
    jl.backward()
    jtr.step(2)
    with tm.cpu():
        with tm.autograd.record():
            tout = tnet(tm.np.array(x))
            tl = tm.gluon.loss.SoftmaxCrossEntropyLoss()(tout,
                                                         tm.np.array(y))
        tl.backward()
        ttr.step(2)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), **TOL)
    stats = 0
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.data().detach().numpy(),
                                   jp[k].data().asnumpy(), err_msg=k, **TOL)
        stats += k.endswith(("running_mean", "running_var"))
    assert stats == 2 * 20                 # every BatchNorm's, moved
    rm = tnet.features[1].running_mean.data().numpy()
    assert not np.allclose(rm, 0.0)


@pytest.mark.parametrize("name,training", [("mobilenet0.25", True),
                                           ("squeezenet1.1", False)])
def test_small_nets_forward_as_jax(name, training):
    shape = (2, 3, 224, 224) if training else (1, 3, 64, 64)
    jnet = _jax_net(name, shape, None if training else
                    mx.init.Xavier(magnitude=6), classes=10)
    tnet = _carry(jnet, name, classes=10)
    x = _x(shape, seed=2)
    with mx.autograd.record(train_mode=training):
        want = jnet(mx.np.array(x)).asnumpy()
    with tm.cpu(), tm.autograd.record(train_mode=training):
        got = tnet(tm.np.array(x)).asnumpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


def test_model_store_loads_placed_weights_and_raises_on_a_miss(tmp_path):
    root = str(tmp_path)
    with pytest.raises(MXNetError, match="resnet18_v1-a0666292.params.*"
                                         "no network"):
        model_store.get_model_file("resnet18_v1", root=root)
    with pytest.raises(MXNetError, match="mynet.params"):
        model_store.get_model_file("mynet", root=root)
    jnet = _jax_net("resnet18_v1", (1, 3, 32, 32), classes=10)
    jnet.save_parameters(os.path.join(root, "resnet18_v1.params"))
    with tm.cpu():
        tnet = tvision.resnet18_v1(classes=10, pretrained=True, root=root)
    for k, p in tnet.collect_params().items():
        np.testing.assert_array_equal(p.data().detach().numpy(),
                                      jnet.collect_params()[k].data()
                                      .asnumpy(), err_msg=k)
    assert model_store.get_model_file("resnet18_v1", root=root) == \
        os.path.join(root, "resnet18_v1.params")
    model_store.purge(root)
    assert not os.listdir(root)
    stamped = os.path.join(root, "squeezenet1.1-0000.params")
    with tm.cpu():
        tvision.squeezenet1_1(classes=10).initialize(device="cpu")
        tnet.save_parameters(stamped)
    with pytest.warns(UserWarning, match="WITHOUT sha1"):
        assert model_store.get_model_file("squeezenet1.1",
                                          root=root) == stamped
