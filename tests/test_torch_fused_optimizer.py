"""Port parity: the multi-tensor optimizer update
(mxnet_tpu_torch.ops.fused_optimizer.apply_updates) against the JAX
package's ``ops/pallas/fused_optimizer.py``.

The port's kernel route on the CPU (the CUDA kernels' plain version,
updating in place) is held against JAX's kernel route run in the Pallas
interpreter (the chunk kernel for Adam, AdamW and SGD; LAMB phases A and
B) over the JAX test's leaf zoo (sizes 1000, 37 and 8), with random
moments: atol 2e-6 on f32 weights and state (the JAX kernel test's own
bound; summation order of LAMB's norms).  bf16 weights may land one bf16
step apart where the two f32 results straddle a rounding boundary, so they
are held to rtol 2**-7 (one bf16 step at most).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops.pallas import fused_optimizer as jfo

from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import fused_optimizer as tfo
from mxnet_tpu_torch.ops import policy

torch.set_num_threads(1)

OPTS = {
    "adam": ("Adam", dict(learning_rate=0.01, epsilon=1e-6)),
    "adamw": ("AdamW", dict(learning_rate=0.01, epsilon=1e-6)),
    "adamw_nocorrect": ("AdamW", dict(learning_rate=0.01, epsilon=1e-6,
                                      correct_bias=False)),
    "sgd": ("SGD", dict(learning_rate=0.01)),
    "sgd_momentum": ("SGD", dict(learning_rate=0.01, momentum=0.9)),
    "lamb": ("LAMB", dict(learning_rate=0.01)),
    "lamb_no_bias_correction": ("LAMB", dict(learning_rate=0.01,
                                             bias_correction=False)),
    "lamb_bounds": ("LAMB", dict(learning_rate=0.01, lower_bound=5.0,
                                 upper_bound=20.0)),
}
SIZES = (("w", 1000), ("b", 37), ("s", 8))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _make(name):
    cls, kw = OPTS[name]
    return getattr(jopt, cls)(**kw), getattr(topt, cls)(**kw)


def _hp(clip):
    return dict(lr=0.01, wd=0.01, rescale_grad=0.5, clip_gradient=clip,
                t=3.0)


def _zoo(topt_, seed=0):
    """numpy f32 params, grads and states (random moments) of the zoo."""
    rng = np.random.RandomState(seed)
    params, grads, states = {}, {}, {}
    for n, size in SIZES:
        params[n] = rng.randn(size).astype(np.float32)
        grads[n] = (3.0 * rng.randn(size)).astype(np.float32)
        k = len(topt_.create_state(torch.zeros(size)))
        st = [0.1 * rng.randn(size), rng.rand(size)][:k]
        states[n] = tuple(a.astype(np.float32) for a in st)
    return params, grads, states


def _jax_update(jo, zoo, dtypes, hp, skip=None):
    params, grads, states = zoo
    jd = {n: getattr(jnp, dtypes.get(n, "float32")) for n in params}
    return jfo.apply_updates(
        jo, {n: jnp.asarray(a, jd[n]) for n, a in params.items()},
        {n: jnp.asarray(a, jd[n]) for n, a in grads.items()},
        {n: tuple(jnp.asarray(s) for s in st) for n, st in states.items()},
        {k: None if v is None else jnp.float32(v) for k, v in hp.items()},
        skip=skip, use_kernel=True)


def _torch_tensors(zoo, dtypes):
    params, grads, states = zoo
    td = {n: getattr(torch, dtypes.get(n, "float32")) for n in params}
    return ({n: torch.from_numpy(a.copy()).to(td[n])
             for n, a in params.items()},
            {n: torch.from_numpy(a.copy()).to(td[n])
             for n, a in grads.items()},
            {n: tuple(torch.from_numpy(s.copy()) for s in st)
             for n, st in states.items()})


def _torch_hp(hp):
    return {k: None if v is None else torch.tensor(v, dtype=torch.float32)
            for k, v in hp.items()}


def _assert_matches(tp, ts, jp, js):
    for n in tp:
        assert str(tp[n].dtype).split(".")[1] == str(jp[n].dtype), n
        want = np.asarray(jp[n], np.float32)
        if tp[n].dtype == torch.bfloat16:
            np.testing.assert_allclose(tp[n].float().numpy(), want,
                                       rtol=2 ** -7, atol=2e-6, err_msg=n)
        else:
            np.testing.assert_allclose(tp[n].numpy(), want, rtol=0,
                                       atol=2e-6, err_msg=n)
        for a, b in zip(ts[n], js[n]):
            assert str(a.dtype).split(".")[1] == str(b.dtype), n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-6, err_msg=n)


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("clip", [None, 1.0])
def test_kernel_route_matches_jax_kernel(interpret, name, clip):
    jo, to = _make(name)
    assert tfo.kernel_supported(to) and jfo.kernel_supported(jo)
    zoo = _zoo(to)
    hp = _hp(clip)
    jp, js = _jax_update(jo, zoo, {}, hp)
    params, grads, states = _torch_tensors(zoo, {})
    tp, ts = tfo.apply_updates(to, params, grads, states, _torch_hp(hp),
                               use_kernel=True)
    # the kernel route updates in place and returns the same tensors
    assert all(tp[n] is params[n] for n in params)
    assert all(a is b for n in states for a, b in zip(ts[n], states[n]))
    _assert_matches(tp, ts, jp, js)


@pytest.mark.parametrize("name", ["adam", "sgd_momentum", "lamb"])
def test_mixed_dtype_groups_keep_their_dtypes(interpret, name):
    """bf16 weights with f32 state form their own group; every output
    keeps the dtype it was stored in."""
    jo, to = _make(name)
    dtypes = {"w": "bfloat16", "s": "bfloat16"}
    zoo = _zoo(to, seed=2)
    # bf16 weights and gradients start from bf16 values on both sides
    for part in zoo[:2]:
        for n in dtypes:
            part[n] = torch.from_numpy(part[n]).bfloat16().float().numpy()
    jp, js = _jax_update(jo, zoo, dtypes, _hp(None))
    params, grads, states = _torch_tensors(zoo, dtypes)
    tp, ts = tfo.apply_updates(to, params, grads, states,
                               _torch_hp(_hp(None)), use_kernel=True)
    assert tp["w"].dtype == tp["s"].dtype == torch.bfloat16
    assert tp["b"].dtype == torch.float32
    _assert_matches(tp, ts, jp, js)


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_skip_is_bit_identical(name, use_kernel):
    _, to = _make(name)
    zoo = _zoo(to, seed=1)
    for skip, same in ((True, True), (False, False)):
        params, grads, states = _torch_tensors(zoo, {})
        grads["b"][3] = float("nan")       # what a skip guards against
        before = ({n: p.clone() for n, p in params.items()},
                  {n: tuple(s.clone() for s in st)
                   for n, st in states.items()})
        tp, ts = tfo.apply_updates(to, params, grads, states,
                                   _torch_hp(_hp(None)),
                                   skip=torch.tensor(skip),
                                   use_kernel=use_kernel)
        for n in params:
            assert torch.equal(tp[n], before[0][n]) == same, n
            for a, b in zip(ts[n], before[1][n]):
                assert torch.equal(a, b) or not same, n


def test_other_rules_take_the_reference_route():
    class Scaled(topt.SGD):
        """An elementwise rule the chunk kernel does not write out."""

    assert not tfo.kernel_supported(Scaled())
    o = topt.SGD()
    o.fused_safe = False
    assert not tfo.kernel_supported(o) and not tfo.supported(o)
    w, g = torch.ones(4), torch.ones(4)
    out, _ = tfo.apply_updates(Scaled(learning_rate=0.5), {"w": w},
                               {"w": g}, {"w": ()}, _torch_hp(_hp(None)),
                               use_kernel=True)
    assert out["w"] is not w and torch.equal(w, torch.ones(4))


def test_policy_spellings_and_kernel_route(monkeypatch):
    for raw, want in (("off", "off"), ("0", "off"), ("REF", "reference"),
                      ("reference", "reference"), ("kernel", "kernel"),
                      ("pallas", "kernel"), ("auto", "auto"),
                      ("bogus", "auto")):
        monkeypatch.setenv("MXTPU_PALLAS", raw)
        assert policy.pallas_mode() == want
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    adam = topt.Adam()
    for mode, on_cpu, on_cuda in (("kernel", True, True),
                                  ("auto", False, True),
                                  ("reference", False, False),
                                  ("off", False, False)):
        monkeypatch.setenv("MXTPU_PALLAS", mode)
        assert policy.kernel_active(cpu) == on_cpu
        assert policy.kernel_active(cuda) == on_cuda
        assert tfo.kernel_route(adam, cpu) == on_cpu
        assert tfo.kernel_route(topt.LAMB(), cuda) == on_cuda
    monkeypatch.delenv("MXTPU_PALLAS")
    assert policy.pallas_mode() == "auto"
    assert not policy.kernel_active(torch.zeros(1))
