"""Port parity: the rest of the optimizer family (NAG, Signum, SGLD, DCASGD,
LARS, AdaBelief, Adamax, Nadam, AdaDelta, FTML, AdaGrad, GroupAdaGrad,
RMSProp, Ftrl, LANS and ``Test``) and the learning-rate schedulers,
against the JAX package's ``optimizer/``.

Each rule runs on both packages from the same numpy inputs (a seeded zoo of
a (40, 25) matrix, a 37-vector and a (2, 4) matrix; random state, kept
non-negative where the rule takes its root), at update count t = 3, with
rescale_grad 0.5 and wd 0.01:

- through the fused routes' reference update
  (``ops.fused_optimizer.apply_updates(use_kernel=False)``, f32 device
  hyperparameters) for every fused-safe rule, and through the per-parameter
  ``Optimizer.update`` (Python-number hyperparameters) for every rule;
- in f32: weights and state within atol 2e-6 (each value within 2e-6, or
  2e-6 of its size past 1: FTML's d and the accumulators reach ~10, where
  one f32 step is 1e-6);
- with bf16 weights, gradients and state: within one bf16 step (rtol
  2**-7), as ``tests/test_torch_fused_optimizer.py`` holds Adam.

The six rules the chunk kernel adds (NAG, Signum with and without
momentum, AdaBelief, Adamax, AdaDelta, FTML): the port's kernel route on
the CPU (the kernel's plain version, in place) against JAX's Pallas chunk
kernel in the interpreter (f32 state, f32 and mixed bf16/f32 weight
groups), and bit for bit against JAX's reference route with bf16 state
(JAX's interpreted kernel rounds a bf16 leaf apart from both routes,
ROADMAP §C); skip is bit-identical; FTML fills its third slot.

SGLD's noise comes from each package's own generator, so parity hands both
the same numpy noise; the real draws are checked for their mean and
variance and for seed determinism.  The schedulers equal JAX's exactly over
200 update counts.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import from_jax
from mxnet_tpu.optimizer import lr_scheduler as jsched
from mxnet_tpu.ops.pallas import fused_optimizer as jfo

from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_optimizer as tfo
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

torch.set_num_threads(1)

# name: (class, kwargs, state slots kept non-negative)
RULES = {
    "nag": ("NAG", dict(learning_rate=0.01, momentum=0.9), ()),
    "signum": ("Signum", dict(learning_rate=0.01, momentum=0.0,
                              wd_lh=0.01), ()),
    "signum_momentum": ("Signum", dict(learning_rate=0.01, momentum=0.9,
                                       wd_lh=0.01), ()),
    "sgld": ("SGLD", dict(learning_rate=0.01), ()),
    "dcasgd": ("DCASGD", dict(learning_rate=0.01), ()),
    "dcasgd_momentum": ("DCASGD", dict(learning_rate=0.01, momentum=0.9),
                        ()),
    "lars": ("LARS", dict(learning_rate=0.1), ()),
    "lars_momentum": ("LARS", dict(learning_rate=0.1, momentum=0.9), ()),
    "adabelief": ("AdaBelief", dict(learning_rate=0.01), (1,)),
    "adamax": ("Adamax", dict(learning_rate=0.01), (1,)),
    "nadam": ("Nadam", dict(learning_rate=0.01), (1,)),
    "adadelta": ("AdaDelta", dict(learning_rate=1.0), (0, 1)),
    "ftml": ("FTML", dict(learning_rate=0.01), (0, 1)),
    "adagrad": ("AdaGrad", dict(learning_rate=0.01), (0,)),
    "groupadagrad": ("GroupAdaGrad", dict(learning_rate=0.01), (0,)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01), (0,)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, centered=True,
                                         clip_weights=1.5), (0,)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1), (1,)),
    "lans": ("LANS", dict(learning_rate=0.01), (1,)),
    "lans_bounds": ("LANS", dict(learning_rate=0.01, lower_bound=5.0,
                                 upper_bound=20.0), (1,)),
    "test": ("Test", dict(learning_rate=0.01), ()),
}
FUSED_SAFE = sorted(n for n in RULES if n not in ("sgld", "nadam"))
KERNEL_RULES = ("nag", "signum", "signum_momentum", "adabelief", "adamax",
                "adadelta", "ftml")
SHAPES = (("w", (40, 25)), ("b", (37,)), ("s", (2, 4)))
T_BEFORE = 2          # update counts before the step: the step runs at t 3
HP = dict(lr=0.01, wd=0.01, rescale_grad=0.5, clip_gradient=None, t=3.0)


def _make(name):
    cls, kw, _ = RULES[name]
    return getattr(jopt, cls)(**kw), getattr(topt, cls)(**kw)


def _zoo(name, seed=0):
    """numpy f32 params, grads and states of the zoo for rule `name`."""
    _, to = _make(name)
    pos = RULES[name][2]
    rng = np.random.RandomState(seed)
    params, grads, states = {}, {}, {}
    for n, shape in SHAPES:
        params[n] = rng.randn(*shape).astype(np.float32)
        grads[n] = (3.0 * rng.randn(*shape)).astype(np.float32)
        slots = to.create_state(torch.zeros(shape))
        states[n] = tuple(
            np.asarray(rng.rand(*s.shape) + 0.5 if k in pos
                       else 0.1 * rng.randn(*s.shape), np.float32)
            for k, s in enumerate(slots))
    return params, grads, states


def _bf16(zoo):
    """The zoo with every value rounded to bf16 (kept as f32 numpy)."""
    def r(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
            .float().numpy()
    params, grads, states = zoo
    return ({n: r(a) for n, a in params.items()},
            {n: r(a) for n, a in grads.items()},
            {n: tuple(r(s) for s in st) for n, st in states.items()})


def _jax_arrays(zoo, dt):
    params, grads, states = zoo
    j = getattr(jnp, dt)
    return ({n: jnp.asarray(a, j) for n, a in params.items()},
            {n: jnp.asarray(a, j) for n, a in grads.items()},
            {n: tuple(jnp.asarray(s, j) for s in st)
             for n, st in states.items()})


def _torch_tensors(zoo, dt):
    params, grads, states = zoo
    d = getattr(torch, dt)
    return ({n: torch.from_numpy(a.copy()).to(d) for n, a in params.items()},
            {n: torch.from_numpy(a.copy()).to(d) for n, a in grads.items()},
            {n: tuple(torch.from_numpy(np.array(s)).to(d) for s in st)
             for n, st in states.items()})


def _jax_hp():
    return {k: None if v is None else jnp.float32(v) for k, v in HP.items()}


def _torch_hp():
    return {k: None if v is None else torch.tensor(v, dtype=torch.float32)
            for k, v in HP.items()}


def _close(got, want, what, bf16):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    d = np.abs(got - want)
    if bf16:
        lim = 2.0 ** -7 * np.abs(want) + 2e-6
    else:
        lim = 2e-6 * np.maximum(1.0, np.abs(want))
    ok = (d <= lim) | (np.isnan(got) & np.isnan(want))
    assert ok.all(), (what, float(np.nanmax(d - lim)))


def _check(tp, ts, jp, js, bf16):
    for n in tp:
        _close(tp[n].float().numpy(), jp[n], n, bf16)
        assert len(ts[n]) == len(js[n]), n
        for k, (a, b) in enumerate(zip(ts[n], js[n])):
            _close(a.float().numpy(), b, f"{n} state {k}", bf16)


def _jax_update(jo, zoo, dt):
    """JAX's per-parameter ``Optimizer.update`` over the zoo, in name
    order; returns new params and states as numpy."""
    jp, jg, js = _jax_arrays(zoo, dt)
    jo.rescale_grad, jo.wd = HP["rescale_grad"], HP["wd"]
    jo.lr = HP["lr"]
    out_p, out_s = {}, {}
    for n in sorted(jp):
        jo._index_update_count[n] = T_BEFORE
        w, g = from_jax(jp[n]), from_jax(jg[n])
        st = tuple(from_jax(s) for s in js[n])
        jo.update(n, w, g, st)
        out_p[n] = np.asarray(w._data.astype(jnp.float32))
        out_s[n] = tuple(np.asarray(s._data.astype(jnp.float32))
                         for s in st)
    return out_p, out_s


def _torch_update(to, zoo, dt):
    tp, tg, ts = _torch_tensors(zoo, dt)
    to.rescale_grad, to.wd = HP["rescale_grad"], HP["wd"]
    to.lr = HP["lr"]
    out_s = {}
    for n in sorted(tp):
        to._index_update_count[n] = T_BEFORE
        out_s[n] = to.update(n, tp[n], tg[n], ts[n])
        assert all(s.dtype == tp[n].dtype for s in out_s[n]), n
    return tp, out_s


@pytest.fixture
def same_noise(monkeypatch):
    """SGLD's noise from one numpy draw for both packages, by shape."""
    rng = np.random.RandomState(11)
    noise = {shape: rng.randn(*shape).astype(np.float32)
             for _, shape in SHAPES}

    def jax_normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(noise[tuple(shape)], dtype)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(topt.SGLD, "_normal", lambda self, w: torch.from_numpy(
        noise[tuple(w.shape)]).to(w.dtype))


# ---------------------------------------------------------------------------
# the rules against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(RULES))
def test_update_matches_jax(same_noise, name, dt):
    """Per-parameter ``Optimizer.update``, Python-number hyperparameters,
    the stored dtypes throughout (JAX's ``Trainer`` per-parameter route)."""
    jo, to = _make(name)
    zoo = _zoo(name)
    if dt == "bfloat16":
        zoo = _bf16(zoo)
    jp, js = _jax_update(jo, zoo, dt)
    tp, ts = _torch_update(to, zoo, dt)
    _check(tp, ts, jp, js, dt == "bfloat16")
    assert to.num_update == jo.num_update == T_BEFORE + 1
    if name == "nadam":
        # the host-side product advanced once per parameter, as in JAX
        assert to.m_schedule == pytest.approx(float(jo.m_schedule),
                                              rel=1e-12)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FUSED_SAFE)
def test_reference_route_matches_jax(name, dt):
    """``apply_updates(use_kernel=False)`` with f32 device hyperparameters
    (the routes of `TrainStep` and the `Trainer`'s whole-tree update)."""
    jo, to = _make(name)
    zoo = _zoo(name, seed=1)
    if dt == "bfloat16":
        zoo = _bf16(zoo)
    jp, js = jfo.apply_updates(jo, *_jax_arrays(zoo, dt), _jax_hp(),
                               use_kernel=False)
    tp, ts = tfo.apply_updates(to, *_torch_tensors(zoo, dt), _torch_hp(),
                               use_kernel=False)
    for n in tp:
        assert str(tp[n].dtype)[6:] == str(jp[n].dtype), n
        for a, b in zip(ts[n], js[n]):
            assert str(a.dtype)[6:] == str(b.dtype), n
            assert tuple(a.shape) == tuple(b.shape), n
    _check(tp, ts, {n: np.asarray(v, np.float32) for n, v in jp.items()},
           {n: tuple(np.asarray(s, np.float32) for s in st)
            for n, st in js.items()}, dt == "bfloat16")


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", KERNEL_RULES)
def test_kernel_route_matches_jax_kernel(monkeypatch, name, clip):
    """The port's kernel route (the chunk kernel's plain version, in place)
    against JAX's Pallas chunk kernel in the interpreter, f32."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jo, to = _make(name)
    assert tfo.kernel_supported(to) and jfo.kernel_supported(jo)
    assert tfo._chunk_rule(to) >= 0
    zoo = _zoo(name, seed=2)
    hp = dict(HP, clip_gradient=clip)
    jp, js = jfo.apply_updates(
        jo, *_jax_arrays(zoo, "float32"),
        {k: None if v is None else jnp.float32(v) for k, v in hp.items()},
        use_kernel=True)
    params, grads, states = _torch_tensors(zoo, "float32")
    tp, ts = tfo.apply_updates(
        to, params, grads, states,
        {k: None if v is None else torch.tensor(v, dtype=torch.float32)
         for k, v in hp.items()}, use_kernel=True)
    assert all(tp[n] is params[n] for n in params)
    assert all(a is b for n in states for a, b in zip(ts[n], states[n]))
    _check(tp, ts, jp, js, False)


@pytest.mark.parametrize("name", KERNEL_RULES)
def test_mixed_dtype_groups_keep_their_dtypes(monkeypatch, name):
    """bf16 weights with f32 state (`TrainStep`'s bf16 model) beside f32
    leaves: two dtype groups, each output in its stored dtype, against
    JAX's interpreted kernel."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jo, to = _make(name)
    params, grads, states = _zoo(name, seed=3)
    bf = ("w", "s")
    for part in (params, grads):
        for n in bf:
            part[n] = torch.from_numpy(part[n]).bfloat16().float().numpy()
    jd = {n: jnp.bfloat16 if n in bf else jnp.float32 for n in params}
    td = {n: torch.bfloat16 if n in bf else torch.float32 for n in params}
    jp, js = jfo.apply_updates(
        jo, {n: jnp.asarray(a, jd[n]) for n, a in params.items()},
        {n: jnp.asarray(a, jd[n]) for n, a in grads.items()},
        {n: tuple(jnp.asarray(s) for s in st) for n, st in states.items()},
        _jax_hp(), use_kernel=True)
    tp, ts = tfo.apply_updates(
        to, {n: torch.from_numpy(a.copy()).to(td[n])
             for n, a in params.items()},
        {n: torch.from_numpy(a.copy()).to(td[n]) for n, a in grads.items()},
        {n: tuple(torch.from_numpy(s.copy()) for s in st)
         for n, st in states.items()}, _torch_hp(), use_kernel=True)
    for n in tp:
        assert tp[n].dtype == td[n], n
        assert all(s.dtype == torch.float32 for s in ts[n]), n
        _close(tp[n].float().numpy(), np.asarray(jp[n], np.float32), n,
               n in bf)
        for a, b in zip(ts[n], js[n]):
            _close(a.numpy(), b, n, False)


@pytest.mark.parametrize("name", KERNEL_RULES)
def test_16bit_state_matches_jax_reference_bit_for_bit(name):
    """bf16 weights and bf16 state (the `Trainer`'s state for a bf16
    model), every rounding point of the rule: the kernel route's plain
    version and the reference route both equal JAX's reference route bit
    for bit, weights and state."""
    jo, to = _make(name)
    zoo = _bf16(_zoo(name, seed=4))
    jp, js = jfo.apply_updates(jo, *_jax_arrays(zoo, "bfloat16"), _jax_hp(),
                               use_kernel=False)
    for use_kernel in (True, False):
        tp, ts = tfo.apply_updates(to, *_torch_tensors(zoo, "bfloat16"),
                                   _torch_hp(), use_kernel=use_kernel)
        for n in tp:
            np.testing.assert_array_equal(tp[n].float().numpy(),
                                          np.asarray(jp[n], np.float32),
                                          err_msg=n)
            for a, b in zip(ts[n], js[n]):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32),
                                              err_msg=n)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", KERNEL_RULES)
def test_skip_is_bit_identical(name, use_kernel):
    _, to = _make(name)
    zoo = _zoo(name, seed=5)
    for skip, same in ((True, True), (False, False)):
        params, grads, states = _torch_tensors(zoo, "float32")
        grads["b"][3] = float("nan")
        before = ({n: p.clone() for n, p in params.items()},
                  {n: tuple(s.clone() for s in st)
                   for n, st in states.items()})
        tp, ts = tfo.apply_updates(to, params, grads, states, _torch_hp(),
                                   skip=torch.tensor(skip),
                                   use_kernel=use_kernel)
        for n in params:
            assert torch.equal(tp[n], before[0][n]) == same, n
            for a, b in zip(ts[n], before[1][n]):
                assert torch.equal(a, b) == same, n


def test_ftml_fills_its_third_slot(monkeypatch):
    """FTML's (d, v, z): the kernel route writes all three in place, each
    equal to JAX's interpreted kernel, and z is the slot the weight is read
    back from (w = -z / d)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    jo, to = _make("ftml")
    zoo = _zoo("ftml", seed=6)
    params, grads, states = _torch_tensors(zoo, "float32")
    before = {n: tuple(s.clone() for s in st) for n, st in states.items()}
    tp, ts = tfo.apply_updates(to, params, grads, states, _torch_hp(),
                               use_kernel=True)
    jp, js = jfo.apply_updates(jo, *_jax_arrays(zoo, "float32"), _jax_hp(),
                               use_kernel=True)
    for n in tp:
        d, v, z = ts[n]
        assert z is states[n][2] and not torch.equal(z, before[n][2])
        np.testing.assert_allclose(z.numpy(), np.asarray(js[n][2]),
                                   rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(tp[n].numpy(), (-z / d).numpy(),
                                   rtol=1e-6)
    assert tfo._SLOTS[tfo._chunk_rule(to)] == 3


def test_chunk_rules_and_the_per_leaf_rest():
    """Every ``fused_elementwise`` rule of JAX's is a chunk rule of the
    port's (by its exact class); the others, and subclasses, are not."""
    for name, (cls, kw, _) in RULES.items():
        jo, to = getattr(jopt, cls)(**kw), getattr(topt, cls)(**kw)
        assert tfo.kernel_supported(to) == jfo.kernel_supported(jo), name
        assert tfo.supported(to) == jfo.supported(jo), name
        assert (tfo._chunk_rule(to) >= 0) == (name in KERNEL_RULES), name
    codes = {tfo._chunk_rule(topt.create(c, **kw))
             for c, kw in (("adam", {}), ("adamw", {}), ("sgd", {}),
                           ("sgd", {"momentum": 0.9}), ("nag", {}),
                           ("signum", {"momentum": 0.0}), ("signum", {}),
                           ("adabelief", {}), ("adamax", {}),
                           ("adadelta", {}), ("ftml", {}))}
    assert codes == set(range(11))

    class Slower(topt.NAG):
        """A subclass may change the rule: not the kernel's."""
    assert not tfo.kernel_supported(Slower())


def test_nag_without_momentum_is_refused_as_jax():
    """NAG keeps SGD's state, none at momentum 0, which its rule (as
    JAX's) cannot take; the kernel route names the mismatch."""
    jo, to = jopt.NAG(momentum=0.0), topt.NAG(momentum=0.0)
    assert to.create_state(torch.ones(3)) == () == jo.create_state_jax(
        jnp.ones(3))
    with pytest.raises(ValueError):
        to._rule(torch.ones(3), torch.ones(3), (), _torch_hp())
    with pytest.raises(MXNetError, match="keeps 1 state"):
        tfo._chunk_cuda(to, tfo._chunk_rule(to), ["w"],
                        {"w": torch.ones(3)}, {"w": torch.ones(3)},
                        {"w": ()}, None, torch.device("cpu"), 8)


# ---------------------------------------------------------------------------
# SGLD's noise
# ---------------------------------------------------------------------------

def test_sgld_noise_distribution_and_seed():
    """The real draws: N(0, lr) in the weight's dtype.  With a zero
    gradient and no decay the update is the noise alone; over 200 000
    elements its mean is within 5 standard errors of 0 and its variance
    within 2% of lr.  The same seed gives the same bits, another seed
    other bits, and the generator advances between calls."""
    n, lr = 200_000, 0.04

    def step(seed, calls=1):
        o = topt.SGLD(learning_rate=lr, seed=seed)
        w, g = torch.zeros(n), torch.zeros(n)
        for _ in range(calls):
            o.update(0, w, g, ())
        return w.clone()
    x = step(0).double()
    assert abs(float(x.mean())) < 5 * math.sqrt(lr / n)
    assert float(x.var()) == pytest.approx(lr, rel=0.02)
    assert torch.equal(step(0), step(0))
    assert not torch.equal(step(0), step(1))
    assert not torch.equal(step(0, calls=2), 2 * step(0))
    # the optimizer's own generator, seeded with `seed`, is drawn from
    o = topt.SGLD(learning_rate=lr, seed=5)
    w = torch.zeros(8)
    o.update(0, w, torch.zeros(8), ())
    want = torch.randn(8, generator=torch.Generator().manual_seed(5)) * \
        torch.sqrt(torch.tensor(lr))
    assert torch.equal(w, want)
    b = torch.zeros(64, dtype=torch.bfloat16)
    topt.SGLD(learning_rate=lr).update(0, b, torch.zeros_like(b), ())
    assert b.dtype == torch.bfloat16 and bool((b != 0).any())


def test_sgld_pickles_with_its_generator_state():
    """`Updater`'s dump pickles the optimizer: the generator's state goes
    with it, so a reloaded SGLD draws what the original would next."""
    import pickle
    o = topt.SGLD(learning_rate=0.01, seed=3)
    w = torch.zeros(16)
    o.update(0, w, torch.zeros(16), ())
    o2 = pickle.loads(pickle.dumps(o))
    a, b = torch.zeros(16), torch.zeros(16)
    o.update(0, a, torch.zeros(16), ())
    o2.update(0, b, torch.zeros(16), ())
    assert torch.equal(a, b) and not torch.equal(a, w)


# ---------------------------------------------------------------------------
# state shapes the rules change, and the registry
# ---------------------------------------------------------------------------

def test_dcasgd_momentum_becomes_the_weights_shape_as_jax():
    jo, to = jopt.DCASGD(learning_rate=0.1), topt.DCASGD(learning_rate=0.1)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    g = np.ones((2, 3), np.float32)
    jw = from_jax(jnp.asarray(w))
    jst = jo.create_state(0, jw)
    assert jst[0].shape == ()
    jo.update(0, jw, from_jax(jnp.asarray(g)), jst)
    tw = torch.from_numpy(w.copy())
    tst = to.create_state(tw)
    assert tst[0].shape == () and tst[1].data_ptr() != tw.data_ptr()
    tst = to.update(0, tw, torch.from_numpy(g), tst)
    assert tuple(tst[0].shape) == tuple(jst[0].shape) == (2, 3)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw._data), atol=2e-6)
    np.testing.assert_allclose(tst[1].numpy(), w)


def test_groupadagrad_keeps_one_accumulator_a_row():
    to = topt.GroupAdaGrad()
    assert to.create_state(torch.zeros(5, 3, 2))[0].shape == (5, 1, 1)
    assert to.create_state(torch.zeros(7))[0].shape == (7,)


def test_every_jax_optimizer_is_registered():
    names = {n.lower() for n in jopt.__all__
             if isinstance(getattr(jopt, n), type)
             and issubclass(getattr(jopt, n), jopt.Optimizer)
             and n != "Optimizer"}
    assert names <= set(topt.optimizer._registry)
    for n in names:
        assert type(topt.create(n)).__name__.lower() == n


# ---------------------------------------------------------------------------
# learning-rate schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1,
                                       stop_factor_lr=1e-4)),
    "factor_warmup": ("FactorScheduler", dict(
        step=10, factor=0.9, base_lr=0.1, warmup_steps=20,
        warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(
        step=[150, 30, 90], factor=0.3, base_lr=0.2)),
    "multifactor_constant_warmup": ("MultiFactorScheduler", dict(
        step=[50, 120], factor=0.5, base_lr=0.2, warmup_steps=25,
        warmup_begin_lr=0.02, warmup_mode="constant")),
    "poly": ("PolyScheduler", dict(max_update=150, base_lr=0.1, pwr=2,
                                   final_lr=1e-3)),
    "poly_warmup": ("PolyScheduler", dict(
        max_update=180, base_lr=0.1, pwr=3, warmup_steps=30,
        warmup_begin_lr=0.001)),
    "cosine": ("CosineScheduler", dict(max_update=170, base_lr=0.1,
                                       final_lr=0.005)),
    "cosine_warmup": ("CosineScheduler", dict(
        max_update=160, base_lr=0.05, warmup_steps=40,
        warmup_begin_lr=0.0)),
    "cosine_constant_warmup": ("CosineScheduler", dict(
        max_update=120, base_lr=0.05, warmup_steps=15,
        warmup_begin_lr=0.004, warmup_mode="constant")),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedulers_equal_jax_exactly(name):
    cls, kw = SCHEDULERS[name]
    js = getattr(jsched, cls)(**kw)
    ts = getattr(tsched, cls)(**kw)
    got = [ts(n) for n in range(200)]
    assert got == [js(n) for n in range(200)]
    assert len(set(got)) > 2


@pytest.mark.parametrize("name", ["cosine_warmup", "poly"])
def test_optimizer_hands_its_rate_to_the_scheduler(name):
    """Given both, the optimizer's ``learning_rate`` becomes the
    scheduler's ``base_lr`` (and the warmup's target stays the one the
    scheduler was built with, as in JAX); the rate is the scheduler's at
    ``num_update``."""
    cls, kw = SCHEDULERS[name]
    jo = jopt.Adam(learning_rate=0.3, lr_scheduler=getattr(jsched, cls)(**kw))
    to = topt.Adam(learning_rate=0.3, lr_scheduler=getattr(tsched, cls)(**kw))
    assert to.lr_scheduler.base_lr == jo.lr_scheduler.base_lr == 0.3
    assert to.lr_scheduler.warmup_final_lr == jo.lr_scheduler.warmup_final_lr
    for k in (0, 1, 17, 41, 199):
        jo.num_update = to.num_update = k
        assert to.learning_rate == jo.learning_rate
    assert topt.CosineScheduler is tsched.CosineScheduler
