"""Port parity: `mxnet_tpu_torch.initializer` and `random` against the JAX
package's ``mxnet_tpu/initializer.py``.

- the deterministic initializers (`Zero`, `One`, `Constant`, `Bilinear`,
  `LSTMBias`, `Load`, `Mixed`, `RNNFused`'s bias) and the name rules
  (gamma, beta, running mean and variance, bias) give JAX's values
  exactly;
- the random ones cannot match JAX's keyed PRNG bit for bit, so they are
  held to the seed (the same `random.seed`, the same values; another
  seed, others) and to their formulas: `Uniform` and `Xavier` (every
  ``rnd_type`` / ``factor_type``) within their bounds, with the uniform's
  moments; `Normal`, gaussian `Xavier` and `MSRAPrelu` at the formula's
  standard deviation within 3% (sample sizes 2e4-2e5); `Orthogonal`'s
  rows orthonormal times its scale (1e-5);
- `create` by name, `InitDesc`, `dumps` and equality as JAX's.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as jinit

import mxnet_tpu_torch as tm
from mxnet_tpu_torch import initializer as tinit, random as trandom
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(1)


def _jax(init, name, shape):
    a = mx.np.zeros(shape)
    init(name, a)
    return np.asarray(a.asnumpy())


def _port(init, name, shape, dtype=torch.float32):
    t = torch.zeros(shape, dtype=dtype)
    init(name, t)
    return t


DETERMINISTIC = {
    "zero": (lambda m: m.Zero(), "w", (3, 4)),
    "one": (lambda m: m.One(), "w", (3, 4)),
    "constant_scalar": (lambda m: m.Constant(0.7), "w", (2, 5)),
    "constant_array": (lambda m: m.Constant(
        np.arange(5, dtype=np.float32)), "w", (2, 5)),
    "bilinear": (lambda m: m.Bilinear(), "w", (2, 3, 4, 6)),
    "lstm_bias": (lambda m: m.LSTMBias(2.0), "w", (12,)),
    "gamma_rule": (lambda m: m.Uniform(), "ln_gamma", (7,)),
    "beta_rule": (lambda m: m.Uniform(), "ln_beta", (7,)),
    "running_mean_rule": (lambda m: m.Uniform(), "bn_running_mean", (7,)),
    "running_var_rule": (lambda m: m.Uniform(), "bn_moving_var", (7,)),
    "bias_rule": (lambda m: m.Normal(), "dense_bias", (7,)),
    "rnn_fused_bias": (lambda m: m.RNNFused(forget_bias=1.5),
                       "l0_i2h_bias", (16,)),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializers_equal_jax(name):
    factory, pname, shape = DETERMINISTIC[name]
    want = _jax(factory(jinit), pname, shape)
    got = _port(factory(tinit), pname, shape)
    np.testing.assert_array_equal(got.numpy(), want)
    # 16-bit tensors take the same values, rounded
    got16 = _port(factory(tinit), pname, shape, torch.bfloat16)
    np.testing.assert_array_equal(
        got16.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())


def test_load_and_mixed_equal_jax(tmp_path):
    vals = {"arg:dense0_weight": np.arange(6, dtype=np.float32).reshape(2, 3),
            "aux:bn_running_var": np.full(4, 2.0, np.float32)}
    jl = jinit.Load({k: mx.np.array(v) for k, v in vals.items()},
                    default_init=jinit.One())
    tl = tinit.Load(vals, default_init=tinit.One())
    for name, shape in (("dense0_weight", (2, 3)),
                        ("bn_running_var", (4,)), ("other", (2,))):
        np.testing.assert_array_equal(_port(tl, name, shape).numpy(),
                                      _jax(jl, name, shape))
    with pytest.raises(MXNetError, match="shape"):
        _port(tl, "dense0_weight", (3, 2))
    with pytest.raises(MXNetError, match="no saved value"):
        _port(tinit.Load(vals), "missing", (2,))
    np.savez(str(tmp_path / "p.npz"), **vals)
    tf = tinit.Load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(_port(tf, "dense0_weight", (2, 3)).numpy(),
                                  vals["arg:dense0_weight"])
    jm = jinit.Mixed(["bias$", ".*"], [jinit.Constant(3.0), jinit.One()])
    tmx = tinit.Mixed(["bias$", ".*"], [tinit.Constant(3.0), tinit.One()])
    for name in ("fc_bias", "fc_weight"):
        np.testing.assert_array_equal(_port(tmx, name, (3,)).numpy(),
                                      _jax(jm, name, (3,)))
    with pytest.raises(MXNetError, match="matched no pattern"):
        _port(tinit.Mixed(["bias$"], [tinit.Zero()]), "w", (2,))


def _draw(init, shape, seed, name="w"):
    trandom.seed(seed)
    return _port(init, name, shape)


RANDOM = {
    "uniform": (lambda: tinit.Uniform(0.3), (200, 100)),
    "normal": (lambda: tinit.Normal(0.05), (200, 100)),
    "orthogonal_uniform": (lambda: tinit.Orthogonal(1.5), (20, 30)),
    "orthogonal_normal": (lambda: tinit.Orthogonal(0.5, "normal"), (30, 20)),
    "msra": (lambda: tinit.MSRAPrelu(slope=0.1), (200, 100)),
}
for _r in ("uniform", "gaussian"):
    for _f in ("avg", "in", "out"):
        RANDOM[f"xavier_{_r}_{_f}"] = (
            lambda r=_r, f=_f: tinit.Xavier(r, f, 2.5), (200, 60, 2))


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_initializers_follow_the_seed(name):
    factory, shape = RANDOM[name]
    a = _draw(factory(), shape, 3)
    b = _draw(factory(), shape, 3)
    c = _draw(factory(), shape, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def _xavier_scale(shape, factor_type, magnitude):
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    return math.sqrt(magnitude / factor)


@pytest.mark.parametrize("rnd", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor", ["avg", "in", "out"])
def test_xavier_follows_its_formula(rnd, factor):
    shape = (200, 60, 2)
    scale = _xavier_scale(shape, factor, 2.5)
    assert tinit.Xavier(rnd, factor, 2.5).scale_of(shape) == \
        pytest.approx(scale, rel=1e-12)
    t = _draw(tinit.Xavier(rnd, factor, 2.5), shape, 5).double()
    # JAX's draw obeys the same formula
    jv = _jax(jinit.Xavier(rnd, factor, 2.5), "w", shape).astype(np.float64)
    if rnd == "uniform":
        for v in (t.numpy(), jv):
            assert np.abs(v).max() <= scale
            assert abs(v.std() - scale / math.sqrt(3)) < 0.03 * scale
    else:
        for v in (t.numpy(), jv):
            assert abs(v.std() - scale) < 0.03 * scale
    assert abs(float(t.mean())) < 0.02 * scale


def test_uniform_normal_msra_follow_their_formulas():
    u = _draw(tinit.Uniform(0.3), (200, 100), 6).double()
    assert float(u.abs().max()) <= 0.3
    assert abs(float(u.std()) - 0.3 / math.sqrt(3)) < 0.03 * 0.3
    n = _draw(tinit.Normal(0.05), (200, 100), 7).double()
    assert abs(float(n.std()) - 0.05) < 0.03 * 0.05
    assert abs(float(n.mean())) < 0.02 * 0.05
    m = _draw(tinit.MSRAPrelu("in", slope=0.1), (200, 100), 8).double()
    want = math.sqrt(2.0 / (1 + 0.01) / 100)
    assert abs(float(m.std()) - want) < 0.03 * want
    j = _jax(jinit.MSRAPrelu("in", slope=0.1), "w", (200, 100))
    assert abs(float(j.std()) - want) < 0.03 * want


@pytest.mark.parametrize("shape", [(20, 30), (30, 20)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    q = _draw(tinit.Orthogonal(1.5), shape, 9).double()
    small = q @ q.T if shape[0] <= shape[1] else q.T @ q
    np.testing.assert_allclose(small.numpy(),
                               2.25 * np.eye(min(shape)), atol=1e-5)


def test_create_initdesc_dumps_and_equality_as_jax():
    for name in ("zeros", "ones", "uniform", "normal", "xavier",
                 "orthogonal", "msraprelu", "bilinear", "lstmbias"):
        assert type(tinit.create(name)).__name__ == \
            type(jinit.create(name)).__name__
    assert isinstance(tinit.create(None), tinit.Uniform)
    with pytest.raises(MXNetError, match="not registered"):
        tinit.create("nope")
    d = tinit.InitDesc("fc_weight", attrs={"lr_mult": "2"})
    assert d == "fc_weight" and d.attrs == {"lr_mult": "2"}
    assert tinit.Xavier(factor_type="in").dumps() == \
        jinit.Xavier(factor_type="in").dumps()
    assert tinit.Constant(np.ones(3)) == tinit.Constant(np.ones(3))
    assert tinit.Normal(0.1) != tinit.Normal(0.2)
    assert tm.init is tinit


def test_seeded_generators_are_per_device_and_scoped():
    trandom.seed(11)
    a = torch.rand(4, generator=trandom.generator("cpu"))
    trandom.seed(11)
    assert torch.equal(torch.rand(4, generator=trandom.generator(
        tm.cpu())), a)
    with trandom.generator_scope(11):
        assert torch.equal(torch.rand(4, generator=trandom.generator(
            torch.device("cpu"))), a)
    trandom.seed(5, ctx="cpu")
    b = torch.rand(3, generator=trandom.generator("cpu"))
    trandom.seed(5, ctx="cpu")
    assert torch.equal(torch.rand(3, generator=trandom.generator("cpu")), b)
