"""`mx.np.random` — NumPy's samplers over the port's generators
(counterpart of ``mxnet_tpu/numpy/random.py``).

Every sampler draws from `mxnet_tpu_torch.random.generator` of the device
it samples on (seeded by `seed`), through torch's own samplers that take a
generator (``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
``multinomial`` / ``poisson`` / ``binomial`` / ``_standard_gamma`` and the
in-place ``exponential_`` / ``geometric_`` / ``cauchy_``); the rest are
transforms of those.  The JAX package's keyed PRNG cannot be matched bit
for bit: a seed gives the same numbers within the port, and the
distributions are NumPy's.  Dtypes follow the JAX package's: float32 by
default (``binomial`` too), int32 for ``randint``, ``poisson``,
``negative_binomial`` and ``geometric``.
``hypergeometric``, ``zipf``, ``logseries``, ``wald`` and ``triangular``
raise by name (ROADMAP.md A16).
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from .. import random as _rng
from ..base import MXNetError, unported
from ..device import current_device, resolve_device
from ..ndarray.ndarray import _write_out, ndarray, to_torch_dtype, wrap

__all__ = [
    "seed", "uniform", "normal", "randn", "rand", "randint", "choice",
    "shuffle", "permutation", "gamma", "beta", "exponential", "poisson",
    "multinomial", "categorical", "bernoulli", "lognormal", "logistic",
    "gumbel", "laplace", "rayleigh", "weibull", "pareto", "power",
    "chisquare", "f", "multivariate_normal", "standard_normal",
    "standard_exponential", "standard_gamma", "standard_cauchy",
    "standard_t", "binomial", "negative_binomial", "geometric",
    "dirichlet", "vonmises", "normal_n", "uniform_n",
    "hypergeometric", "zipf", "logseries", "wald", "triangular",
]

#: the samplers of JAX's `mx.np.random` the port raises on
UNPORTED = ("hypergeometric", "logseries", "triangular", "wald", "zipf")
hypergeometric = unported("mx.np.random.hypergeometric", "A16")
zipf = unported("mx.np.random.zipf", "A16")
logseries = unported("mx.np.random.logseries", "A16")
wald = unported("mx.np.random.wald", "A16")
triangular = unported("mx.np.random.triangular", "A16")


def seed(seed, ctx="all"):
    """Reseed the port's generators (`mxnet_tpu_torch.random.seed`)."""
    _rng.seed(seed, ctx)


def _device(device, ctx, *params) -> torch.device:
    d = device if device is not None else ctx
    if d is None:
        for p in params:
            if isinstance(p, ndarray):
                return p._data.device
        d = current_device()
    return resolve_device(d)


def _size(size):
    if size is None:
        return None
    return (size,) if isinstance(size, int) else tuple(size)


def _fdt(dtype):
    return to_torch_dtype(dtype) or torch.float32


def _param(p, dev):
    """A parameter as an f32 tensor on `dev`."""
    if isinstance(p, ndarray):
        return p._data.to(dev, torch.float32)
    return torch.as_tensor(_onp.asarray(p, dtype=_onp.float32), device=dev)


def _shape(size, *params):
    s = _size(size)
    return s if s is not None else tuple(torch.broadcast_shapes(
        *(p.shape for p in params)))


def _check(name, p, positive=False):
    bad = (p <= 0) if positive else (p < 0)
    if bool(bad.any()):
        raise ValueError(f"{name} must be "
                         f"{'positive' if positive else 'non-negative'}")


def _finish(t, dt, out=None):
    return _write_out(wrap(t.to(dt)), out)


def _unit(shape, dev):
    """Uniform draws on (0, 1) (the open interval: the transforms take
    logs of both ends)."""
    u = torch.rand(shape, generator=_rng.generator(dev), device=dev)
    return u.clamp_min(torch.finfo(torch.float32).tiny)


def _std_normal(shape, dev):
    return torch.randn(shape, generator=_rng.generator(dev), device=dev)


def _std_gamma(alpha, shape, dev):
    a = alpha.broadcast_to(shape).contiguous()
    return torch._standard_gamma(a, generator=_rng.generator(dev))


# -- the basic samplers ------------------------------------------------------

def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None, ctx=None,
            out=None):
    dev = _device(device, ctx, low, high)
    lo, hi = _param(low, dev), _param(high, dev)
    shape = _shape(size, lo, hi)
    u = torch.rand(shape, generator=_rng.generator(dev), device=dev)
    return _finish(lo + (hi - lo) * u, _fdt(dtype), out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None,
           out=None):
    dev = _device(device, ctx, loc, scale)
    mu, sd = _param(loc, dev), _param(scale, dev)
    _check("scale", sd)
    shape = _shape(size, mu, sd)
    return _finish(mu + sd * _std_normal(shape, dev), _fdt(dtype), out)


def randn(*shape, dtype=None, device=None, ctx=None):
    return normal(0.0, 1.0, shape, dtype=dtype, device=device, ctx=ctx)


def rand(*shape, dtype=None, device=None, ctx=None):
    return uniform(0.0, 1.0, shape, dtype=dtype, device=device, ctx=ctx)


def standard_normal(size=None, dtype=None, device=None, ctx=None):
    return normal(0.0, 1.0, size, dtype=dtype, device=device, ctx=ctx)


def randint(low, high=None, size=None, dtype=None, device=None, ctx=None,
            out=None):
    if high is None:
        low, high = 0, low
    dev = _device(device, ctx)
    dt = to_torch_dtype(dtype) or torch.int32
    t = torch.randint(int(low), int(high), _size(size) or (),
                      generator=_rng.generator(dev), device=dev)
    return _finish(t, dt, out)


def choice(a, size=None, replace=True, p=None, device=None, ctx=None,
           out=None):
    dev = _device(device, ctx, a)
    pool = None
    if isinstance(a, int):
        n = a
    else:
        pool = a._data.to(dev) if isinstance(a, ndarray) else \
            torch.as_tensor(_onp.asarray(a), device=dev)
        n = pool.shape[0]
    shape = _size(size) or ()
    k = int(_onp.prod(shape)) if shape else 1
    g = _rng.generator(dev)
    if p is not None:
        w = _param(p, dev)
        idx = torch.multinomial(w, k, replacement=replace, generator=g)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=g, device=dev)
    else:
        if k > n:
            raise ValueError("Cannot take a larger sample than population "
                             "when replace=False")
        idx = torch.randperm(n, generator=g, device=dev)[:k]
    idx = idx.reshape(shape)
    r = idx if pool is None else pool[idx]
    return _write_out(wrap(r), out)


def permutation(x, device=None, ctx=None):
    if isinstance(x, int):
        dev = _device(device, ctx)
        return wrap(torch.randperm(x, generator=_rng.generator(dev),
                                   device=dev))
    t = x._data
    perm = torch.randperm(t.shape[0], generator=_rng.generator(t.device),
                          device=t.device)
    return wrap(t[perm])


def shuffle(x: ndarray):
    """Shuffle `x` along its first axis, in place."""
    t = x._data
    perm = torch.randperm(t.shape[0], generator=_rng.generator(t.device),
                          device=t.device)
    x._inplace(lambda d: d.copy_(d[perm]))


# -- continuous families ------------------------------------------------------

def gamma(shape, scale=1.0, size=None, dtype=None, device=None, ctx=None,
          out=None):
    dev = _device(device, ctx, shape, scale)
    k, th = _param(shape, dev), _param(scale, dev)
    _check("shape", k)
    _check("scale", th)
    sh = _shape(size, k, th)
    return _finish(_std_gamma(k, sh, dev) * th, _fdt(dtype), out)


def standard_gamma(shape, size=None, dtype=None, device=None, ctx=None):
    return gamma(shape, 1.0, size, dtype=dtype, device=device, ctx=ctx)


def beta(a, b, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, a, b)
    a, b = _param(a, dev), _param(b, dev)
    _check("a", a, True)
    _check("b", b, True)
    sh = _shape(size, a, b)
    x, y = _std_gamma(a, sh, dev), _std_gamma(b, sh, dev)
    return _finish(x / (x + y), _fdt(dtype))


def exponential(scale=1.0, size=None, dtype=None, device=None, ctx=None,
                out=None):
    dev = _device(device, ctx, scale)
    s = _param(scale, dev)
    _check("scale", s)
    sh = _shape(size, s)
    e = torch.empty(sh, device=dev).exponential_(
        1.0, generator=_rng.generator(dev))
    return _finish(e * s, _fdt(dtype), out)


def standard_exponential(size=None, dtype=None, device=None, ctx=None):
    return exponential(1.0, size, dtype=dtype, device=device, ctx=ctx)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, device=None,
              ctx=None):
    dev = _device(device, ctx, mean, sigma)
    mu, sd = _param(mean, dev), _param(sigma, dev)
    _check("sigma", sd)
    sh = _shape(size, mu, sd)
    return _finish(torch.exp(mu + sd * _std_normal(sh, dev)), _fdt(dtype))


def _loc_scale(name, transform):
    def sampler(loc=0.0, scale=1.0, size=None, dtype=None, device=None,
                ctx=None):
        dev = _device(device, ctx, loc, scale)
        mu, s = _param(loc, dev), _param(scale, dev)
        _check("scale", s)
        sh = _shape(size, mu, s)
        return _finish(mu + s * transform(_unit(sh, dev)), _fdt(dtype))
    sampler.__name__ = name
    return sampler


logistic = _loc_scale("logistic", lambda u: torch.log(u / (1 - u)))
gumbel = _loc_scale("gumbel", lambda u: -torch.log(-torch.log(u)))
laplace = _loc_scale("laplace", lambda u: torch.where(
    u < 0.5, torch.log(2 * u), -torch.log(2 * (1 - u))))


def rayleigh(scale=1.0, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, scale)
    s = _param(scale, dev)
    _check("scale", s)
    sh = _shape(size, s)
    return _finish(s * torch.sqrt(-2 * torch.log(_unit(sh, dev))),
                   _fdt(dtype))


def _shape_param(name, transform):
    def sampler(a, size=None, dtype=None, device=None, ctx=None):
        dev = _device(device, ctx, a)
        a = _param(a, dev)
        _check("a", a, True)
        sh = _shape(size, a)
        return _finish(transform(_unit(sh, dev), a), _fdt(dtype))
    sampler.__name__ = name
    return sampler


weibull = _shape_param("weibull", lambda u, a: (-torch.log(u)) ** (1 / a))
pareto = _shape_param("pareto", lambda u, a: u ** (-1 / a) - 1)
power = _shape_param("power", lambda u, a: u ** (1 / a))


def chisquare(df, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, df)
    k = _param(df, dev)
    _check("df", k, True)
    sh = _shape(size, k)
    return _finish(2 * _std_gamma(k / 2, sh, dev), _fdt(dtype))


def f(dfnum, dfden, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, dfnum, dfden)
    n, d = _param(dfnum, dev), _param(dfden, dev)
    _check("dfnum", n, True)
    _check("dfden", d, True)
    sh = _shape(size, n, d)
    x = 2 * _std_gamma(n / 2, sh, dev) / n
    y = 2 * _std_gamma(d / 2, sh, dev) / d
    return _finish(x / y, _fdt(dtype))


def standard_cauchy(size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx)
    c = torch.empty(_size(size) or (), device=dev).cauchy_(
        generator=_rng.generator(dev))
    return _finish(c, _fdt(dtype))


def standard_t(df, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, df)
    k = _param(df, dev)
    _check("df", k, True)
    sh = _shape(size, k)
    z = _std_normal(sh, dev)
    return _finish(z / torch.sqrt(2 * _std_gamma(k / 2, sh, dev) / k),
                   _fdt(dtype))


def multivariate_normal(mean, cov, size=None, check_valid="warn", tol=1e-8,
                        dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, mean, cov)
    mu, c = _param(mean, dev), _param(cov, dev)
    sh = (_size(size) or ()) + tuple(mu.shape)
    lo = torch.linalg.cholesky(c)
    z = _std_normal(sh, dev)
    return _finish(mu + z @ lo.T, _fdt(dtype))


def dirichlet(alpha, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, alpha)
    a = _param(alpha, dev)
    _check("alpha", a, True)
    sh = (_size(size) or ()) + tuple(a.shape)
    g = _std_gamma(a, sh, dev)
    return _finish(g / g.sum(-1, keepdim=True), _fdt(dtype))


def vonmises(mu, kappa, size=None, dtype=None, device=None, ctx=None):
    """Best and Fisher's rejection sampler, every element retried until
    accepted (all from the device's generator)."""
    dev = _device(device, ctx, mu, kappa)
    m, k = _param(mu, dev), _param(kappa, dev)
    _check("kappa", k)
    sh = _shape(size, m, k)
    m, k = m.broadcast_to(sh), k.broadcast_to(sh).clamp_min(1e-8)
    tau = 1 + torch.sqrt(1 + 4 * k * k)
    rho = (tau - torch.sqrt(2 * tau)) / (2 * k)
    r = (1 + rho * rho) / (2 * rho)
    out = torch.zeros(sh, device=dev)
    todo = torch.ones(sh, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        u1, u2, u3 = (_unit(sh, dev) for _ in range(3))
        z = torch.cos(math.pi * u1)
        w = (1 + r * z) / (r + z)
        c = k * (r - w)
        ok = (c * (2 - c) - u2 > 0) | (torch.log(c / u2) + 1 - c >= 0)
        theta = torch.sign(u3 - 0.5) * torch.acos(w.clamp(-1, 1))
        take = todo & ok
        out = torch.where(take, theta, out)
        todo = todo & ~ok
    out = torch.remainder(out + m + math.pi, 2 * math.pi) - math.pi
    return _finish(out, _fdt(dtype))


# -- discrete families --------------------------------------------------------

def poisson(lam=1.0, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, lam)
    rate = _param(lam, dev)
    _check("lam", rate)
    sh = _shape(size, rate)
    t = torch.poisson(rate.broadcast_to(sh).contiguous(),
                      generator=_rng.generator(dev))
    return _finish(t, to_torch_dtype(dtype) or torch.int32)


def binomial(n, p, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, n, p)
    nn, pp = _param(n, dev), _param(p, dev)
    sh = _shape(size, nn, pp)
    t = torch.binomial(nn.broadcast_to(sh).contiguous(),
                       pp.broadcast_to(sh).contiguous(),
                       generator=_rng.generator(dev))
    return _finish(t, to_torch_dtype(dtype) or torch.float32)


def negative_binomial(n, p, size=None, dtype=None, device=None, ctx=None):
    """A Poisson draw at a Gamma(n, (1 - p) / p) rate (NumPy's
    construction)."""
    dev = _device(device, ctx, n, p)
    nn, pp = _param(n, dev), _param(p, dev)
    sh = _shape(size, nn, pp)
    rate = _std_gamma(nn, sh, dev) * (1 - pp) / pp
    t = torch.poisson(rate, generator=_rng.generator(dev))
    return _finish(t, to_torch_dtype(dtype) or torch.int32)


def geometric(p, size=None, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx, p)
    pp = _param(p, dev)
    sh = _shape(size, pp)
    u = _unit(sh, dev)
    t = torch.ceil(torch.log(u) / torch.log1p(-pp.broadcast_to(sh)))
    return _finish(t.clamp_min(1), to_torch_dtype(dtype) or torch.int32)


def bernoulli(prob=None, logit=None, size=None, dtype=None, device=None,
              ctx=None):
    if (prob is None) == (logit is None):
        raise MXNetError("bernoulli: give exactly one of prob and logit")
    dev = _device(device, ctx, prob, logit)
    pr = _param(prob, dev) if logit is None else \
        torch.sigmoid(_param(logit, dev))
    sh = _shape(size, pr)
    t = torch.bernoulli(pr.broadcast_to(sh).contiguous(),
                        generator=_rng.generator(dev))
    return _finish(t, _fdt(dtype))


def multinomial(n, pvals, size=None, shape=None):
    """Counts of `n` draws over the categories `pvals` (NumPy's
    multinomial): shape ``size + (len(pvals),)``, int32."""
    dev = _device(None, None, pvals)
    p = _param(pvals, dev)
    sh = _size(size if size is not None else shape) or ()
    k = int(_onp.prod(sh)) if sh else 1
    draws = torch.multinomial(p.expand(k, -1), int(n), replacement=True,
                              generator=_rng.generator(dev))
    counts = torch.zeros(k, p.shape[-1], dtype=torch.int32, device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return wrap(counts.reshape(tuple(sh) + (p.shape[-1],)))


def categorical(prob, shape=None, size=None, dtype=None, device=None,
                ctx=None):
    """Category indices drawn from `prob` (..., K) (``npx.random.
    categorical``): `shape` extra draws a row."""
    dev = _device(device, ctx, prob)
    p = _param(prob, dev)
    extra = _size(size if size is not None else shape) or ()
    k = int(_onp.prod(extra)) if extra else 1
    rows = p.reshape(-1, p.shape[-1])
    idx = torch.multinomial(rows, k, replacement=True,
                            generator=_rng.generator(dev))
    out = idx.reshape(tuple(p.shape[:-1]) + tuple(extra))
    return _finish(out, to_torch_dtype(dtype) or torch.int32)


# -- batched forms (npx.random.*_n) ------------------------------------------

def _n_size(batch_shape, *params):
    b = _size(batch_shape) or ()
    shapes = [_onp.shape(p.asnumpy() if isinstance(p, ndarray) else p)
              for p in params]
    return b + tuple(_onp.broadcast_shapes(*shapes))


def normal_n(loc=0.0, scale=1.0, batch_shape=None, dtype=None, device=None,
             ctx=None):
    return normal(loc, scale, _n_size(batch_shape, loc, scale), dtype=dtype,
                  device=device, ctx=ctx)


def uniform_n(low=0.0, high=1.0, batch_shape=None, dtype=None, device=None,
              ctx=None):
    return uniform(low, high, _n_size(batch_shape, low, high), dtype=dtype,
                   device=device, ctx=ctx)
