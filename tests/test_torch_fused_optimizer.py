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
are held to rtol 2**-7 (one bf16 step at most).  f16 leaves (f32 or f16
state) are held to JAX's reference route bit for bit, but for LAMB's
kernel route (its f32 trust ratio: one f16 step plus 2**-10 of the
update).
"""
import pathlib
import re

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


@pytest.mark.parametrize("name", ["lamb", "lamb_bounds"])
def test_bf16_lamb_reference_route_rounds_the_ratio_as_jax(name):
    """LAMB over bf16 weights with f32 state on the reference route, against
    JAX's ``apply_updates(use_kernel=False)``: JAX's rule rounds the trust
    ratio to the weight's bf16 (``ratio.astype(w.dtype)``), which moves
    the update by up to 2**-9 of itself.  With lr 1 the update is as large
    as the weight, so where the two nearly cancel that is many bf16 steps
    of the result; the port must land within one bf16 step (2**-8 of the
    value, rounding of two f32 results) of JAX's on every element, and its
    f32 state within 2e-6.  The kernel route keeps the ratio in f32, as
    JAX's kernel does (held above)."""
    jo, to = _make(name)
    jo.lr = to.lr = 1.0
    rng = np.random.RandomState(5)
    n = 4096
    w = rng.randn(n).astype(np.float32)
    w = torch.from_numpy(w).bfloat16().float().numpy()
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).bfloat16()
    g = g.float().numpy()
    m = (0.1 * rng.randn(n)).astype(np.float32)
    v = rng.rand(n).astype(np.float32)
    hp = dict(lr=1.0, wd=0.01, rescale_grad=1.0, clip_gradient=None, t=1.0)
    jp, js = jfo.apply_updates(
        jo, {"w": jnp.asarray(w, jnp.bfloat16)},
        {"w": jnp.asarray(g, jnp.bfloat16)},
        {"w": (jnp.asarray(m), jnp.asarray(v))},
        {k: None if x is None else jnp.float32(x) for k, x in hp.items()},
        use_kernel=False)
    tp, ts = tfo.apply_updates(
        to, {"w": torch.from_numpy(w).bfloat16()},
        {"w": torch.from_numpy(g).bfloat16()},
        {"w": (torch.from_numpy(m), torch.from_numpy(v))}, _torch_hp(hp),
        use_kernel=False)
    assert tp["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"], np.float32)
    got = tp["w"].float().numpy()
    step = 2.0 ** -8 * np.maximum(np.abs(want), np.abs(got))
    assert np.all(np.abs(got - want) <= step), \
        float(np.max(np.abs(got - want) / np.maximum(step, 1e-30)))
    for a, b in zip(ts["w"], js["w"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd_momentum", "lamb"])
def test_16bit_state_rounds_the_decay_as_jax(name):
    """bf16 weights with bf16 state (the `Trainer`'s state for a bf16
    model): JAX's rules multiply the stored state by a Python float, a
    bf16 product with the scalar rounded to bf16 first (``beta1 * m``),
    then add the f32 gradient term.  The
    port's kernel route (the plain version the CUDA kernels are held to)
    and its reference route both equal JAX's reference route bit for bit,
    weights and state, but for LAMB's weights on the kernel route, whose
    trust ratio stays f32 (one bf16 step, plus 2**-8 of the update)."""
    jo, to = _make(name)
    zoo = _zoo(to, seed=4)
    bf = {n: "bfloat16" for n, _ in SIZES}
    for part in zoo[:2]:
        for n in bf:
            part[n] = torch.from_numpy(part[n]).bfloat16().float().numpy()
    for n in bf:
        zoo[2][n] = tuple(torch.from_numpy(s).bfloat16().float().numpy()
                          for s in zoo[2][n])
    hp = _hp(None)
    jp, js = jfo.apply_updates(
        jo, {n: jnp.asarray(a, jnp.bfloat16) for n, a in zoo[0].items()},
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in zoo[1].items()},
        {n: tuple(jnp.asarray(s, jnp.bfloat16) for s in st)
         for n, st in zoo[2].items()},
        {k: None if v is None else jnp.float32(v) for k, v in hp.items()},
        use_kernel=False)
    for use_kernel in (True, False):
        params, grads, _ = _torch_tensors(zoo, bf)
        states = {n: tuple(torch.from_numpy(s.copy()).bfloat16() for s in st)
                  for n, st in zoo[2].items()}
        tp, ts = tfo.apply_updates(to, params, grads, states, _torch_hp(hp),
                                   use_kernel=use_kernel)
        for n in tp:
            want = np.asarray(jp[n], np.float32)
            got = tp[n].float().numpy()
            if name == "lamb" and use_kernel:
                # the kernels' f32 trust ratio against JAX's bf16 one: the
                # update moves by up to 2**-9 of itself, then one bf16 step
                # (at most 2**-7 of the value)
                upd = np.abs(want - zoo[0][n])
                assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
                              + 2.0 ** -8 * upd), n
            else:
                np.testing.assert_array_equal(got, want, err_msg=n)
            for a, b in zip(ts[n], js[n]):
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# float16 leaves: the nine chunk rules and LAMB
# ---------------------------------------------------------------------------

# the chunk kernel's nine rules (JAX's ``fused_elementwise`` optimizers,
# SGD and Signum each with and without momentum) and the state slots drawn
# positive (the rules take their roots)
CHUNK_RULES = {
    "adam": ("Adam", dict(learning_rate=0.01, epsilon=1e-6), (1,)),
    "adamw": ("AdamW", dict(learning_rate=0.01, epsilon=1e-6), (1,)),
    "sgd": ("SGD", dict(learning_rate=0.01), ()),
    "sgd_momentum": ("SGD", dict(learning_rate=0.01, momentum=0.9), ()),
    "nag": ("NAG", dict(learning_rate=0.01, momentum=0.9), ()),
    "signum": ("Signum", dict(learning_rate=0.01, momentum=0.0,
                              wd_lh=0.01), ()),
    "signum_momentum": ("Signum", dict(learning_rate=0.01, momentum=0.9,
                                       wd_lh=0.01), ()),
    "adabelief": ("AdaBelief", dict(learning_rate=0.01), (1,)),
    "adamax": ("Adamax", dict(learning_rate=0.01), (1,)),
    "adadelta": ("AdaDelta", dict(learning_rate=1.0), (0, 1)),
    "ftml": ("FTML", dict(learning_rate=0.01), (0, 1)),
    "lamb": ("LAMB", dict(learning_rate=0.01), (1,)),
}


def _f16_update(name, sdt, seed=4):
    """JAX's reference route and the port's two routes over the zoo in f16
    weights and gradients with state in `sdt` (every value an f16 value on
    both sides): (jax params, jax states, [(use_kernel, port params, port
    states)], the zoo's weights)."""
    cls, kw, pos = CHUNK_RULES[name]
    jo, to = getattr(jopt, cls)(**kw), getattr(topt, cls)(**kw)
    rng = np.random.RandomState(seed)
    zoo = {}
    for n, size in SIZES:
        w = rng.randn(size).astype(np.float16)
        g = (3.0 * rng.randn(size)).astype(np.float16)
        st = tuple(np.asarray(rng.rand(size) + 0.5 if k in pos
                              else 0.1 * rng.randn(size), np.float16)
                   for k, _ in enumerate(to.create_state(torch.zeros(size))))
        zoo[n] = (w, g, st)
    hp = _hp(None)
    jp, js = jfo.apply_updates(
        jo, {n: jnp.asarray(z[0]) for n, z in zoo.items()},
        {n: jnp.asarray(z[1]) for n, z in zoo.items()},
        {n: tuple(jnp.asarray(x, sdt) for x in z[2])
         for n, z in zoo.items()},
        {k: None if v is None else jnp.float32(v) for k, v in hp.items()},
        use_kernel=False)
    runs = []
    for use_kernel in (True, False):
        tp, ts = tfo.apply_updates(
            to, {n: torch.from_numpy(z[0].copy()) for n, z in zoo.items()},
            {n: torch.from_numpy(z[1].copy()) for n, z in zoo.items()},
            {n: tuple(torch.from_numpy(x.copy()).to(getattr(torch, sdt))
                      for x in z[2]) for n, z in zoo.items()},
            _torch_hp(hp), use_kernel=use_kernel)
        runs.append((use_kernel, tp, ts))
    return jp, js, runs, {n: z[0] for n, z in zoo.items()}


@pytest.mark.parametrize("sdt", ["float32", "float16"])
@pytest.mark.parametrize("name", sorted(set(CHUNK_RULES) - {"lamb"}))
def test_f16_chunk_rules_match_jax_reference_bit_for_bit(name, sdt):
    """f16 weights with f32 state (`TrainStep`'s ``_master_dtype``) and
    with f16 state (the `Trainer`'s, JAX's ``multi_precision=False``),
    every chunk rule: the kernel route's plain version -- what the CUDA
    chunk kernel is held to on the card -- and the reference route both
    equal JAX's reference route (``apply_updates(use_kernel=False)``) bit
    for bit, weights and state, each in its stored dtype.  The decay of an
    f16 state rounds the scalar and the product to f16, as JAX's weak
    scalars do; JAX's interpreted chunk kernel is not the reference here
    (ROADMAP.md C: its interpreter is not bit-faithful in 16 bits)."""
    jp, js, runs, _ = _f16_update(name, sdt)
    for use_kernel, tp, ts in runs:
        for n in tp:
            assert tp[n].dtype == torch.float16, (use_kernel, n)
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]),
                                          err_msg=f"{use_kernel} {n}")
            assert len(ts[n]) == len(js[n])
            for a, b in zip(ts[n], js[n]):
                assert str(a.dtype) == "torch." + str(b.dtype) == \
                    "torch." + sdt
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{use_kernel} {n}")


@pytest.mark.parametrize("sdt", ["float32", "float16"])
def test_f16_lamb_matches_jax_reference(sdt):
    """LAMB over f16 leaves: the reference route equals JAX's bit for bit
    (both round the trust ratio to the weight's f16); the kernel route,
    whose ratio stays f32 as JAX's kernel keeps it, lands within one f16
    step of the value (2**-10 of it) plus 2**-10 of the update, and its
    state bit for bit."""
    jp, js, runs, w0 = _f16_update("lamb", sdt, seed=5)
    for use_kernel, tp, ts in runs:
        for n in tp:
            want = np.asarray(jp[n], np.float32)
            got = tp[n].float().numpy()
            assert tp[n].dtype == torch.float16
            if use_kernel:
                upd = np.abs(want - w0[n].astype(np.float32))
                assert np.all(np.abs(got - want) <= 2.0 ** -10 * np.abs(want)
                              + 2.0 ** -10 * upd + 2.0 ** -24), n
            else:
                np.testing.assert_array_equal(got, want, err_msg=n)
            for a, b in zip(ts[n], js[n]):
                assert str(a.dtype) == "torch." + sdt
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_the_kernels_take_f16_and_raise_on_f64_by_name():
    """The CUDA wrappers' leaf check (what a card launch runs first): f32,
    bf16 and f16 leaves pass; a float64 or an integer leaf, or a gradient
    in another dtype than its weight, raises `MXNetError` naming the
    dtypes the kernels take (the card never gets such a leaf)."""
    from mxnet_tpu_torch.base import MXNetError
    cpu = torch.device("cpu")
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        w = torch.zeros(8, dtype=dt)
        tfo._check_leaf("w", w, w.clone(), (torch.zeros(8),), cpu)
        assert tfo._DTYPES[dt] == {torch.float32: 0, torch.bfloat16: 1,
                                   torch.float16: 2}[dt]
    for w, g in ((torch.zeros(8, dtype=torch.float64),) * 2,
                 (torch.zeros(8, dtype=torch.int32),) * 2,
                 (torch.zeros(8, dtype=torch.float16), torch.zeros(8))):
        with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
            tfo._check_leaf("w", w, g, (), cpu)


# ---------------------------------------------------------------------------
# LAMB phase A's leaf table (no card needed)
# ---------------------------------------------------------------------------

def _bert_base_leaves(dtype):
    """(shape, dtype name) of every parameter of `BertForPretraining(
    bert_base(dtype))`, in its order, from the configuration alone: the
    LayerNorm parameters stay f32."""
    from mxnet_tpu_torch.models import bert_base
    c = bert_base()
    H, I, V = c.hidden_size, c.intermediate_size, c.vocab_size
    norm = [((H,), "float32")] * 2
    out = [((V, H), dtype), ((c.type_vocab_size, H), dtype),
           ((c.max_position, H), dtype)] + norm
    for _ in range(c.num_layers):
        out += [((3 * H, H), dtype), ((3 * H,), dtype), ((H, H), dtype),
                ((H,), dtype)] + norm + [((I, H), dtype), ((I,), dtype),
                                         ((H, I), dtype), ((H,), dtype)] \
            + norm
    out += [((H, H), dtype), ((H,), dtype), ((H, H), dtype), ((H,), dtype)] \
        + norm + [((V, H), dtype), ((V,), dtype), ((2, H), dtype),
                  ((2,), dtype)]
    return out


@pytest.mark.parametrize("dtype,n_groups", [("float32", 1), ("bfloat16", 2),
                                            ("float16", 2)])
def test_lamb_table_covers_every_element_of_bert_base_once(dtype, n_groups):
    """`_lamb_layout` over the groups of BERT-base's real leaves: every
    element of every leaf in exactly one block entry, the r offsets
    disjoint and 16-byte aligned, each leaf's partial slots contiguous and
    in chunk order; one phase-A launch per (weight, state) dtype group."""
    leaves = _bert_base_leaves(dtype)
    assert len(leaves) == 159
    assert sum(int(np.prod(s)) for s, _ in leaves) == 133_547_324
    groups = {}
    for i, (s, d) in enumerate(leaves):
        groups.setdefault((d, "float32", "float32"), []).append(i)
    assert len(groups) == n_groups
    chunk = tfo.LAMB_CHUNK
    for members in groups.values():
        numels = [int(np.prod(leaves[i][0])) for i in members]
        lay = tfo._lamb_layout(numels)
        leaf = (lay.codes >> 32).astype(np.int64)
        ck = lay.codes & 0xffffffff
        assert lay.codes.dtype == np.int64
        for j, n in enumerate(numels):
            mine = np.sort(ck[leaf == j])
            # each chunk of the leaf once: elements [c * chunk, ...) cover
            # [0, n) exactly
            assert (mine == np.arange(-(-n // chunk))).all()
            assert lay.chunks[j] == mine.size
            assert lay.r_off[j] % 8 == 0
            assert lay.r_off[j] + n <= (lay.r_off[j + 1] if j + 1 <
                                        len(numels) else lay.r_total)
            # slots p_off .. p_off + chunks - 1, chunk c at p_off + c
            assert lay.p_off[j] == sum(lay.chunks[:j])
        assert lay.slots == sum(lay.chunks) == lay.codes.size
        assert lay.r_total >= sum(numels)
        # one launch's block map: every code of the group, in leaf order
        assert (np.diff(leaf) >= 0).all()


def test_lamb_layout_edges():
    lay = tfo._lamb_layout([1, 768, 0, tfo.LAMB_CHUNK + 1],
                           chunk=tfo.LAMB_CHUNK)
    assert lay.chunks == [1, 1, 0, 2]
    assert lay.r_off == [0, 8, 776, 776]
    assert lay.p_off == [0, 1, 2, 2]
    assert list(lay.codes) == [0, 1 << 32, 3 << 32, (3 << 32) | 1]
    empty = tfo._lamb_layout([])
    assert empty.codes.size == 0 and empty.r_total == 0


# ---------------------------------------------------------------------------
# LAMB phase B's walk of phase A's table (no card needed)
# ---------------------------------------------------------------------------

# `lamb_b_kernel`'s threads a block and 8-element steps a thread keeps in
# flight, read from the kernel's source, so the walk below cannot drift
# from them; the walk mirrors the kernel's indexing (its stepping is held on
# the card by `tests/test_torch_cuda.py`'s phase-B tests)
_CU = (pathlib.Path(tfo.__file__).resolve().parents[1] / "csrc"
       / "fused_optimizer.cu").read_text()


def _cu_const(name):
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", _CU)
    return int(v)


THREADS, LAMB_U = _cu_const("THREADS"), _cu_const("LAMB_U")


def test_lamb_phase_b_walk_reads_the_kernel_constants():
    assert THREADS % 32 == 0 and LAMB_U >= 1
    # a chunk is a whole number of 8-element steps (the entry requires it)
    assert tfo.LAMB_CHUNK % 8 == 0


def _chunk_pattern(length, aligned):
    """Offsets from a chunk's start that `lamb_b_kernel` writes, in the
    order its threads take them: 16-byte steps of 8 elements over the
    chunk's whole eighths when w is aligned (thread t at 8 t, then strides
    of 8 THREADS, LAMB_U steps an iteration), then one element a thread
    (from t, stride THREADS) over the rest."""
    vend = length // 8 * 8 if aligned else 0
    idx = []
    for t in range(THREADS):
        for i0 in range(8 * t, vend, 8 * THREADS * LAMB_U):
            for u in range(LAMB_U):
                i = i0 + 8 * THREADS * u
                if i < vend:
                    idx.extend(range(i, i + 8))
    for t in range(THREADS):
        idx.extend(range(vend + t, length, THREADS))
    return np.asarray(idx, np.int64)


def _walk_phase_b(numels, aligned, grid, chunk):
    """Simulate one phase-B launch: `grid` blocks stride over the codes in
    phase A's order, each chunk's threads taking `_chunk_pattern`'s
    offsets.  Returns the layout, each leaf's written element ranges
    [start, end) and the r ranges read for them, and how often each code
    was visited."""
    lay = tfo._lamb_layout(numels, chunk)
    n_codes = lay.codes.size
    writes = [[] for _ in numels]
    r_reads = []
    visited = np.zeros(n_codes, np.int64)
    checked = set()
    for b in range(grid):
        for k in range(b, n_codes, grid):
            visited[k] += 1
            leaf, ck = int(lay.codes[k] >> 32), int(lay.codes[k] & 0xffffffff)
            start = ck * chunk
            end = min(numels[leaf], start + chunk)
            key = (end - start, aligned[leaf])
            if key not in checked:
                # the chunk's threads take each of its offsets once
                got = np.sort(_chunk_pattern(*key))
                assert np.array_equal(got, np.arange(key[0])), key
                checked.add(key)
            writes[leaf].append((start, end))
            r0 = lay.r_off[leaf]
            r_reads.append((r0 + start, r0 + end))   # r read at r_off + i
    return lay, writes, r_reads, visited


def _tiles(ranges, lo, hi):
    """Do the [start, end) `ranges` cover [lo, hi) exactly once?"""
    at = lo
    for start, end in sorted(ranges):
        if start != at:
            return False
        at = end
    return at == hi


def _check_walk(numels, aligned, per_sm=8, sms=132, chunk=tfo.LAMB_CHUNK):
    lay = tfo._lamb_layout(numels, chunk)
    # the entry's grid (`persistent_grid`): as many blocks as fit, at most
    # one a code
    grid = min(per_sm * sms, int(lay.codes.size))
    lay, writes, r_reads, visited = _walk_phase_b(numels, aligned, grid,
                                                  chunk)
    assert (visited == 1).all()
    for j, n in enumerate(numels):
        assert _tiles(writes[j], 0, n), j    # each element written once
    # element i of leaf j reads r at r_off[j] + i, and nothing else
    assert sorted(r_reads) == sorted(
        (lay.r_off[j] + s, lay.r_off[j] + e)
        for j in range(len(numels)) for s, e in writes[j])


@pytest.mark.parametrize("grid", [(8, 132), (5, 132), (1, 7)])
@pytest.mark.parametrize("dtype,n_groups", [("float32", 1), ("bfloat16", 2),
                                            ("float16", 2)])
def test_lamb_phase_b_walk_writes_bert_base_once(dtype, n_groups, grid):
    """Phase B's grid-stride walk of each BERT-base group's codes (at the
    H100's 132 SMs with 8 or 5 blocks each, and at 7 blocks): every element
    of every leaf written exactly once, from r at its leaf's offset plus
    its index."""
    leaves = _bert_base_leaves(dtype)
    groups = {}
    for s, d in leaves:
        groups.setdefault(d, []).append(int(np.prod(s)))
    assert len(groups) == n_groups
    for numels in groups.values():
        _check_walk(numels, [True] * len(numels), *grid)


@pytest.mark.parametrize("aligned", [(True,) * 4, (False,) * 4,
                                     (True, False, True, False)])
@pytest.mark.parametrize("grid", [(8, 132), (4, 132), (1, 1), (1, 3),
                                  (2, 2), (16, 1)])
def test_lamb_phase_b_walk_edges(aligned, grid):
    """The edge layout (1, 768, an empty leaf, LAMB_CHUNK + 1), on the
    16-byte and the one-element paths, with one block up to a full
    card."""
    _check_walk([1, 768, 0, tfo.LAMB_CHUNK + 1], list(aligned), *grid)
