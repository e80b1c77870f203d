"""Port parity: MXNet's int8 workflow (`contrib.quantization`) against the
JAX package's ``mxnet_tpu/contrib/quantization.py``.

The same seeded numpy inputs go through both packages:

- `quantize_kv` / `dequantize_kv` (the int8 KV pool's writes) bit for bit,
  zero vectors and bf16 rows included;
- `quantize`, `dequantize`, `requantize` and both routes of
  `quantized_fully_connected` (per-channel and one ``w_amax``) within 1e-6
  of the output's scale;
- `calib_minmax`, `calib_entropy` and `LayerCalibrator` (naive and entropy,
  below ``max_samples`` so no subsample is drawn) equal;
- `QuantizedDense` / `quantize_net` over a Gluon ``Dense`` net: the
  thresholds equal and the int8 net's output within 1e-6 of its scale
  (their test keeps the name it had when both raised by name, before the
  port had ``gluon.nn``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq

torch.set_num_threads(1)


def _vectors(seed, shape=(6, 3, 24)):
    """Seeded vectors at mixed magnitudes, two of them all zero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x *= np.exp(rng.randn(*shape[:-1], 1)).astype(np.float32) * 3
    x[1, 2] = 0.0
    x[4, 0] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_quantize_kv_is_bit_equal_to_jax(dtype, axis):
    x = _vectors(0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jqv, js = jq.quantize_kv(jx, axis=axis)
    tqv, ts = tq.quantize_kv(tx, axis=axis)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jq.dequantize_kv(jqv, js, axis=axis)
    td = tq.dequantize_kv(tqv, ts, axis=axis)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if axis == -1:
        # a zero vector: zeros at scale 0, dequantized to exact zeros
        assert float(ts[1, 2]) == 0.0 and not tqv[1, 2].any()
        assert not td[4, 0].any()
    bf = tq.dequantize_kv(tqv, ts, axis=axis, dtype=torch.bfloat16)
    jbf = jq.dequantize_kv(jqv, js, axis=axis, dtype=jnp.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(),
                                  np.asarray(jbf).astype(np.float32))


def _close(got, want, tol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("ranged", [False, True])
def test_quantize_dequantize_match_jax(ranged):
    x = _vectors(1, (5, 16))
    kw = dict(min_range=-2.0, max_range=1.5) if ranged else {}
    jqv, jlo, jhi = jq.quantize(mx.np.array(x), **kw)
    tqv, tlo, thi = tq.quantize(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(tqv.numpy(), jqv.asnumpy())
    assert float(tlo) == float(jlo.asnumpy())
    assert float(thi) == float(jhi.asnumpy())
    jd = jq.dequantize(jqv, jlo, jhi).asnumpy()
    td = tq.dequantize(tqv, tlo, thi).numpy()
    _close(td, jd)
    with pytest.raises(MXNetError, match="int8"):
        tq.quantize(torch.from_numpy(x), out_type="uint8")


def test_requantize_matches_jax():
    rng = np.random.RandomState(2)
    acc = rng.randint(-60000, 60000, (7, 9)).astype(np.int32)
    args = (-3.0, 2.5, -1.25, 0.75)
    jout = jq.requantize(mx.np.array(acc), *(mx.np.array(np.float32(a))
                                             for a in args)).asnumpy()
    tout = tq.requantize(torch.from_numpy(acc), *args).numpy()
    assert tout.dtype == np.int8
    np.testing.assert_array_equal(tout, jout)


@pytest.mark.parametrize("w_amax", [None, 2.75])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fully_connected_matches_jax(w_amax, bias):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 40).astype(np.float32)
    w = (rng.randn(12, 40) * 0.5).astype(np.float32)
    b = rng.randn(12).astype(np.float32) if bias else None
    x_amax = 2.5
    jargs = (mx.np.array(x), mx.np.array(w),
             None if b is None else mx.np.array(b), x_amax)
    jout = jq.quantized_fully_connected(*jargs, w_amax=w_amax).asnumpy()
    tout = tq.quantized_fully_connected(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), x_amax, w_amax=w_amax)
    assert tout.shape == (2, 3, 12) and tout.dtype == torch.float32
    _close(tout.numpy(), jout)


def test_calibration_functions_match_jax():
    rng = np.random.RandomState(4)
    for samples in (rng.randn(5000).astype(np.float32),
                    np.concatenate([rng.randn(3000) * 0.1,
                                    rng.randn(20) * 8]).astype(np.float32),
                    np.zeros(100, np.float32),
                    rng.randn(300).astype(np.float32)):
        assert tq.calib_minmax(samples) == jq.calib_minmax(samples)
        assert tq.calib_entropy(samples) == jq.calib_entropy(samples)
        assert tq.calib_entropy(samples, num_bins=512) == \
            jq.calib_entropy(samples, num_bins=512)
    d = rng.rand(17)
    np.testing.assert_array_equal(tq._smooth_distribution(d),
                                  jq._smooth_distribution(d))


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_layer_calibrator_matches_jax(mode):
    rng = np.random.RandomState(5)
    jc = jq.LayerCalibrator(mode=mode, num_bins=1024, max_samples=1 << 16)
    tc = tq.LayerCalibrator(mode=mode, num_bins=1024, max_samples=1 << 16,
                            rng=0)
    for step in range(3):
        for name, scale in (("layers.0.wqkv", 1.0), ("layers.1.w2", 4.0)):
            a = (rng.randn(8, 64) * scale).astype(np.float32)
            jc.observe(name, mx.np.array(a))
            # the port takes a torch tensor or a numpy array
            tc.observe(name, torch.from_numpy(a) if step % 2 else a)
    assert tc.amax == jc.amax
    assert tc.thresholds() == jc.thresholds()
    with pytest.raises(MXNetError, match="calibration mode"):
        tq.LayerCalibrator(mode="percentile")


def test_layer_calibrator_subsample_is_seeded():
    """Past ``max_samples`` the entropy subsample comes from the
    calibrator's own generator: the same seed, the same threshold."""
    rng = np.random.RandomState(6)
    data = [(rng.randn(4096) * (1 + i)).astype(np.float32) for i in range(3)]

    def run(seed):
        c = tq.LayerCalibrator(mode="entropy", max_samples=5000, rng=seed)
        for a in data:
            c.observe("x", a)
        assert c._counts["x"] == 5000
        return c.thresholds()["x"]

    assert run(1) == run(1)


def test_quantized_dense_and_quantize_net_raise_by_name():
    """Once both raised by name; now they match the JAX package's."""
    from mxnet_tpu.gluon import nn as jnn
    import mxnet_tpu_torch as tm
    from mxnet_tpu_torch.gluon import nn as tnn
    rng = np.random.RandomState(8)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(12, in_units=10, activation="relu"),
             jnn.Dense(4, in_units=12))
    jnet.initialize(mx.init.Normal(0.5))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(12, in_units=10, activation="relu"),
             tnn.Dense(4, in_units=12))
    with tm.cpu():
        tnet.initialize()
    tnet.load_dict({k: torch.from_numpy(v.data().asnumpy())
                    for k, v in jnet.collect_params().items()})
    calib = [rng.randn(6, 10).astype(np.float32) for _ in range(2)]
    x = rng.randn(5, 10).astype(np.float32)
    jqn = jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib])
    tqn = tq.quantize_net(tnet, calib_data=[torch.from_numpy(c)
                                            for c in calib])
    for k in ("0", "1"):
        assert tqn._qmap[k].x_amax == pytest.approx(jqn._qmap[k].x_amax,
                                                    rel=1e-6)
    _close(tqn(torch.from_numpy(x)).numpy(),
           jqn(mx.np.array(x)).asnumpy())
    jd = jq.QuantizedDense(jnet[1], 2.0)
    td = tq.QuantizedDense(tnet[1], 2.0)
    h = rng.randn(5, 12).astype(np.float32)
    _close(td(torch.from_numpy(h)).numpy(), jd(mx.np.array(h)).asnumpy())
    np.testing.assert_array_equal(td.qt.scale.numpy(),
                                  np.asarray(jd.qt.scale))
