"""Port parity: ``mx.npx`` of `mxnet_tpu_torch` against the JAX package's,
on the CPU.

The kernel-routed ops (``layer_norm`` and its residual form, ``rms_norm``
and its residual form, ``softmax_cross_entropy``, ``multi_head_attention``)
take JAX's CPU route, the jnp reference under ``MXTPU_PALLAS=auto`` as its
own tests run it, and the port's plain versions, at the 1e-5 of
``tests/test_torch_fused_norm.py``, ``test_torch_softmax_xent.py`` and
``test_torch_flash_attention.py``; every other op at 1e-6 (elementwise)
or 1e-5.  Values and, for the differentiable ops, the gradients of
``sum(out ** 2)`` are compared.  The ops the port raises on are listed
(ROADMAP.md A11 and A16), and every name of JAX's ``npx.__all__`` is held
to be either ported with a case here or raising by name.
"""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as jnpx
import mxnet_tpu_torch as tm
from mxnet_tpu_torch.base import MXNetError
from torch_np_common import jax_results, want as _want

torch.set_num_threads(1)

_R = np.random.RandomState(77)


def _u(shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, shape).astype(np.float32)


INPUTS = {
    "x": _u((3, 4)), "y": _u((3, 4)), "xp": _u((3, 4), 0.1, 0.9),
    "t3": _u((2, 3, 4)), "r3": _u((2, 3, 4)), "g4": _u(4, 0.5, 1.5),
    "b4": _u(4), "nchw": _u((2, 4, 3, 3)), "g_c": _u(4, 0.5, 1.5),
    "b_c": _u(4), "rm": _u(4, -0.5, 0.5), "rv": _u(4, 0.5, 1.5),
    "w": _u((5, 4)), "bias": _u(5), "len": np.array([2, 4, 1], np.int32),
    "mask": _R.rand(3, 4) > 0.3, "lab": np.array([1, 3, 0], np.int32),
    "ids": np.array([[1, 4], [6, 2]], np.int32), "emb": _u((7, 3)),
    "q": _u((2, 5, 8)), "k": _u((2, 5, 8)), "v": _u((2, 5, 8)),
    "kg": _u((2, 5, 4)), "vg": _u((2, 5, 4)),
    "amask": (_R.rand(2, 5, 5) > 0.2).astype(np.float32),
    "qkv": _u((5, 2, 3 * 8)), "qe": _u((4, 2, 8)), "kve": _u((6, 2, 16)),
    "att_s": _u((4, 5, 5), 0.0, 1.0), "att_e": _u((4, 4, 6), 0.0, 1.0),
    "sq": _u((4, 6, 2)), "sk": _u((4, 6, 2)), "sw": _u((4, 6, 3)),
    "svl": np.array([6, 4], np.int32),
    "gidx": np.array([[0, 2], [1, 3]], np.int32),
    "gdat": _u(2), "ctc": _u((6, 2, 5)),
    "ctl": np.array([[1, 2, -1], [3, 3, 4]], np.int32),
    "ia": np.array([1, 0], np.int32), "iv": _u((2, 4)),
    "seq": _u((4, 3, 2)), "slen": np.array([2, 4, 3], np.int32),
    "bl": _u((2, 3, 4)), "br": _u((2, 4, 5)), "pg": _u(4, 0.1, 0.3),
    "i": np.array([[0, 2], [1, 1]], np.int32),
}

EW, RED, KERN = 1e-6, 1e-5, 1e-5

# name[:variant] -> (args, kwargs, tol, gradient checked)
CASES = {}


def _case(key, *args, tol=RED, grad=False, **kwargs):
    CASES[key] = (args, kwargs, tol, grad)


for _n in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
           "mish", "silu", "erf", "selu"):
    _case(_n, "x", tol=EW)
for _n in ("gamma", "gammaln"):
    _case(_n, "xp")
_case("erfinv", "xp", tol=EW)
_case("hard_sigmoid", "x", tol=EW)
_case("gelu", "x", grad=True)
_case("gelu:tanh", "x", approximation="tanh")
_case("elu", "x", alpha=0.7, tol=EW)
_case("prelu", "nchw", "g_c")
for _act in ("leaky", "elu", "rrelu"):
    _case(f"leaky_relu:{_act}", "x", act_type=_act, slope=0.2)
for _act in ("softrelu", "mish"):
    _case(f"activation:{_act}", "x", act_type=_act, tol=EW)
_case("softmax", "x", grad=True)
_case("softmax:temperature", "x", axis=0, temperature=2.0, grad=True)
_case("softmax:length", "x", length="len", use_length=True)
_case("log_softmax", "x", grad=True)
_case("masked_softmax", "x", "mask")
_case("masked_log_softmax", "x", "mask")
_case("fully_connected", "t3", "w", "bias", flatten=False, grad=True)
_case("fully_connected:flatten", "t3", "w3f", None, no_bias=True)
_case("batch_norm:predict", "nchw", "g_c", "b_c", "rm", "rv")
_case("layer_norm", "t3", "g4", "b4", tol=KERN, grad=True)
_case("layer_norm:axis", "x", "g3", "b3", axis=0, tol=KERN)
_case("layer_norm_residual", "t3", "r3", "g4", "b4", tol=KERN, grad=True)
_case("rms_norm", "t3", "g4", tol=KERN, grad=True)
_case("rms_norm_residual", "t3", "r3", "g4", tol=KERN, grad=True)
_case("group_norm", "nchw", "g_c", "b_c", num_groups=2)
_case("instance_norm", "nchw", "g_c", "b_c")
_case("l2_normalization", "nchw", mode="channel")
_case("embedding", "ids", "emb", grad=True)
_case("one_hot", "lab", 5)
_case("pick", "x", "lab", grad=True)
_case("topk", "x", k=2)
_case("topk:both", "x", k=2, ret_typ="both", axis=0)
_case("slice", "t3", (0, 1), (2, 3))
_case("reshape:codes", "t3", (-2, -1))
_case("reshape:merge", "t3", (-5, -2))
_case("reshape:split", "t3", (-6, 1, 2, -2, -2))
_case("reshape:reverse", "t3", (-1, 4), reverse=True)
_case("index_add", "iv", "ia", "iv")
_case("index_update", "iv", "ia", "iv")
_case("sequence_mask", "seq", "slen", use_sequence_length=True, value=-1.0)
_case("arange_like", "x")
_case("arange_like:axis", "x", start=1.0, step=0.5, axis=1)
_case("reshape_like", "x", "t3f")
_case("broadcast_like", "b4", "x")
_case("smooth_l1", "x", scalar=1.5)
_case("gather_nd", "x", "i")
_case("scatter_nd", "gdat", "i", (3, 4))
_case("interleaved_matmul_selfatt_qk", "qkv", heads=2)
_case("interleaved_matmul_selfatt_valatt", "qkv", "att_s2", heads=2)
_case("interleaved_matmul_encdec_qk", "qe", "kve", heads=2)
_case("interleaved_matmul_encdec_valatt", "kve", "att_e", heads=2)
_case("sldwin_atten_score", "sq", "sk", 1, w=1)
_case("sldwin_atten_context", "sw", "sk", 1, w=1)
_case("sldwin_atten_mask_like", "sw", 1, "svl", num_heads=2)
_case("multi_head_attention", "q", "k", "v", 2, tol=KERN, grad=True)
_case("multi_head_attention:mask", "q", "k", "v", 2, mask="amask",
      tol=KERN, grad=True)
_case("multi_head_attention:gqa", "q", "kg", "vg", 2, num_kv_heads=1,
      causal=True, window=2, tol=KERN, grad=True)
_case("multi_head_attention:rope", "q", "k", "v", 2, rope_theta=10000.0,
      tol=KERN, grad=True)
_case("softmax_cross_entropy", "x", "lab", tol=KERN, grad=True)
_case("ctc_loss", "ctc", "ctl", tol=1e-4)
_case("batch_dot", "bl", "br", grad=True)
_case("batch_dot:transposed", "br", "bl", transpose_a=True,
      transpose_b=True)
_case("cast", "x", "int32")
_case("amp_cast", "x", "float16")
_case("shape_array", "t3")
INPUTS["w3f"] = _u((5, 12))
INPUTS["g3"], INPUTS["b3"] = _u(3, 0.5, 1.5), _u(3)
INPUTS["t3f"] = _u((4, 3))
INPUTS["att_s2"] = _u((4, 5, 5), 0.0, 1.0)


def _arg(a, pkg):
    if isinstance(a, str) and a in INPUTS:
        return pkg.np.array(INPUTS[a])
    return a


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _compare(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gv, wv = g.asnumpy(), np.asarray(w.asnumpy())
        assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
        assert gv.shape == wv.shape, (gv.shape, wv.shape)
        np.testing.assert_allclose(gv, wv.astype(gv.dtype), rtol=tol,
                                   atol=tol)


def _run(pkg, name, args, kwargs, grad):
    a = [_arg(v, pkg) for v in args]
    kw = {k: _arg(v, pkg) for k, v in kwargs.items()}
    leaves = [v for v in a + list(kw.values())
              if hasattr(v, "attach_grad") and str(v.dtype) == "float32"]
    if not grad:
        return getattr(pkg.npx, name)(*a, **kw), []
    for v in leaves:
        v.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.npx, name)(*a, **kw)
        head = sum((o * o).sum() for o in _flat(out))
    head.backward()
    return out, [v.grad for v in leaves]


def _case_run(pkg, key):
    name = key.split(":")[0]
    args, kwargs, _, grad = CASES[key]
    return _run(pkg, name, args, kwargs, grad)


@pytest.fixture(scope="module")
def jax_want():
    """The JAX package's result of every case, one compile for most, on
    its CPU route (``MXTPU_PALLAS=auto``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_PALLAS", "auto")
        return jax_results({k: functools.partial(_case_run, mx, k)
                            for k in CASES})


@pytest.mark.parametrize("key", sorted(CASES))
def test_npx_matches_jax(key, jax_want):
    name = key.split(":")[0]
    args, kwargs, tol, grad = CASES[key]
    want, wgrads = _want(jax_want, key)
    with tm.cpu():
        got, ggrads = _run(tm, name, args, kwargs, grad)
    _compare(got, want, tol)
    _compare(ggrads, wgrads, max(tol, RED))


def test_batch_norm_training_moves_running_stats_as_jax():
    outs = []
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            x, g, b, rm, rv = (pkg.np.array(INPUTS[k]) for k in
                               ("nchw", "g_c", "b_c", "rm", "rv"))
            with pkg.autograd.record():
                y, m, v = pkg.npx.batch_norm(x, g, b, rm, rv, momentum=0.8,
                                             output_mean_var=True)
            outs.append([t.asnumpy() for t in (y, m, v, rm, rv)])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RED, atol=RED)


def test_dropout_modes():
    with tm.cpu():
        x = tm.np.ones((200, 50))
        assert tm.npx.dropout(x, p=0.5) is x          # predict mode
        with tm.autograd.record():
            y = tm.npx.dropout(x, p=0.5)
        kept = y.asnumpy() != 0
        assert 0.4 < kept.mean() < 0.6
        np.testing.assert_allclose(y.asnumpy()[kept], 2.0)
        z = tm.npx.dropout(x, p=0.25, mode="always", axes=(0,))
        col = z.asnumpy()[0] != 0
        assert (z.asnumpy() != 0).sum(axis=0).tolist() == \
            (col * 200).tolist()
        with tm.autograd.record():
            assert tm.npx.dropout(x, p=0.0) is x


def test_control_flow_matches_jax():
    outs = []
    for pkg in (mx, tm):
        with (tm.cpu() if pkg is tm else mx.cpu()):
            data = pkg.np.array(INPUTS["seq"])
            s0 = pkg.np.zeros((3, 2))

            def body(xt, st):
                ns = st * 0.5 + xt
                return ns * 2, ns
            out, final = pkg.npx.foreach(body, data, s0)
            i0 = pkg.np.array(np.float32(0.0))
            acc = pkg.np.array(np.float32(1.0))
            loop = pkg.npx.while_loop(lambda v: v[0] < 4,
                                      lambda v: [v[0] + 1, v[1] * 1.5],
                                      [i0, acc], max_iterations=10)
            c1 = pkg.npx.cond(pkg.np.array(np.float32(1.0)),
                              lambda a: a * 2, lambda a: a - 1,
                              [pkg.np.array(INPUTS["x"])])
            c0 = pkg.npx.cond(pkg.np.array(np.float32(0.0)),
                              lambda a: a * 2, lambda a: a - 1,
                              [pkg.np.array(INPUTS["x"])])
            outs.append([out, final] + list(loop) + [c1, c0])
    _compare(outs[1], outs[0], RED)


def test_save_load_savez_cross_packages(tmp_path):
    f1, f2, f3 = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    with tm.cpu():
        x, lab = tm.np.array(INPUTS["x"]), tm.np.array(INPUTS["lab"])
        tm.npx.save(f1, {"x": x, "lab": lab})
        tm.npx.savez(f2, x, lab=lab)
        tm.nd.save(f3, [x, lab])
        got = mx.npx.load(f1)
        np.testing.assert_array_equal(np.asarray(got["x"].asnumpy()),
                                      INPUTS["x"])
        np.testing.assert_array_equal(np.asarray(mx.npx.load(f2)["lab"]
                                                 .asnumpy()), INPUTS["lab"])
        lst = mx.nd.load(f3)
        np.testing.assert_array_equal(np.asarray(lst[1].asnumpy()),
                                      INPUTS["lab"])
        mx.npx.save(f1, {"w": mx.np.array(INPUTS["y"])})
        back = tm.npx.load(f1)
        assert back["w"].device == tm.cpu()
        np.testing.assert_array_equal(back["w"].asnumpy(), INPUTS["y"])
        assert [a.shape for a in tm.nd.load(f3)] == [(3, 4), (3,)]


def test_session_utilities():
    with tm.cpu():
        tm.npx.waitall()
        tm.nd.waitall()
        assert tm.npx.is_np_array() and tm.is_np_array()
        # NumPy shape semantics are always on; turning them off raises
        assert tm.util.set_np_shape(True) and tm.util.is_np_shape()
        tm.npx.set_np()
        with tm.util.np_shape(True):
            assert tm.util.is_np_shape()
        for off in (tm.npx.reset_np, lambda: tm.util.set_np_shape(False),
                    lambda: tm.util.np_shape(False)):
            with pytest.raises(MXNetError, match="A16"):
                off()
        assert tm.util.is_np_shape()
        assert tm.engine.set_bulk_size(4) == 0
        with tm.engine.bulk(8):
            tm.engine.waitall()
        assert tm.engine.engine_type() == tm.utils.config.flags.engine_type
        tm.npx.seed(3)
        a = tm.np.random.uniform(size=(4,))
        tm.npx.seed(3)
        assert tm.np.random.uniform(size=(4,)).tolist() == a.tolist()
        assert tm.npx.random is tm.np.random
        assert tm.npx.cpu() == tm.cpu() and tm.npx.gpu(1) == tm.gpu(1)
        assert tm.npx.num_tpus() == 0 and tm.npx.num_gpus() == \
            torch.cuda.device_count()
        with pytest.raises(MXNetError):
            tm.npx.tpu()
        h = np.arange(6, dtype=np.int64).reshape(2, 3)
        f = tm.npx.from_numpy(h)
        jf = mx.npx.from_numpy(h)
        assert str(f.dtype) == str(jf.dtype) == "int32"
        assert str(tm.npx.from_numpy(np.ones(2)).dtype) == "float32"
        d = tm.npx.from_dlpack(tm.npx.to_dlpack_for_read(f))
        assert d.tolist() == h.tolist()
        assert tm.npx.bernoulli(prob=0.5, size=(3,)).shape == (3,)
        assert tm.npx.normal_n(0.0, 1.0, batch_shape=(2,)).shape == (2,)
        assert tm.npx.uniform_n(0.0, 1.0, batch_shape=(2,)).shape == (2,)
        assert tm.npx.constraint_check(tm.np.ones(3) > 0).item()
        with pytest.raises(ValueError, match="bad"):
            tm.npx.constraint_check(tm.np.zeros(3) > 0, "bad")
        assert tm.npx.resolve_remat_policy("full", env_override=False) \
            == (True, None)
        x = tm.np.array(INPUTS["x"])
        x.attach_grad()
        with tm.autograd.record():
            y = tm.npx.remat_call(lambda t: tm.np.tanh(t) * 2, x).sum()
        y.backward()
        np.testing.assert_allclose(
            x.grad.asnumpy(), 2 * (1 - np.tanh(INPUTS["x"]) ** 2),
            rtol=1e-5, atol=1e-6)
        a, b = tm.npx.amp_multicast(tm.np.ones(2, dtype="float16"),
                                    tm.np.ones(2))
        assert str(a.dtype) == str(b.dtype) == "float32"
        a, b = tm.npx.amp_multicast(tm.np.ones(2, dtype="float16"),
                                    tm.np.ones(2), cast_narrow=True)
        assert str(a.dtype) == str(b.dtype) == "float16"


#: the npx names the port raises on, with their ROADMAP.md items
UNPORTED = {"convolution": "A11", "deconvolution": "A11", "pooling": "A11",
            "grid_generator": "A11", "bilinear_sampler": "A11",
            "spatial_transformer": "A11", "correlation": "A11",
            "im2col": "A11", "col2im": "A11",
            "deformable_convolution": "A11", "rnn": "A16",
            "custom": "A16", "intgemm_fully_connected": "A16"}


def test_every_jax_npx_name_is_ported_with_a_case_or_raises_by_name():
    assert tm.npx.UNPORTED == UNPORTED
    tested = {k.split(":")[0] for k in CASES} | {
        "batch_norm", "dropout", "foreach", "while_loop", "cond", "save",
        "load", "savez", "waitall", "set_np", "reset_np", "is_np_array",
        "seed", "random", "cpu", "gpu", "tpu", "num_gpus", "num_tpus",
        "from_numpy", "from_dlpack", "to_dlpack_for_read",
        "to_dlpack_for_write", "bernoulli", "normal_n", "uniform_n",
        "constraint_check", "remat_call", "resolve_remat_policy",
        "amp_multicast"}
    names = set(jnpx.__all__) - {"image"}
    missing = sorted(names - set(UNPORTED) - tested)
    assert not missing, f"ported without a parity case: {missing}"
    assert set(tm.npx.__all__) >= set(jnpx.__all__)
    for name, item in UNPORTED.items():
        with pytest.raises(MXNetError, match=item):
            getattr(tm.npx, name)(None)
    with pytest.raises(MXNetError, match="A11"):
        tm.npx.image.resize


def test_nd_names_are_ported_or_raise_by_name():
    """Every name of JAX's ``legacy_ops.__all__`` is in ``mx.nd``: the
    1.x creation functions ported, the rest raising naming A16 (none gives
    NumPy's semantics quietly); ``nd.sparse`` raises too."""
    from mxnet_tpu.ndarray import legacy_ops
    assert set(tm.nd.LEGACY_NAMES) == set(legacy_ops.__all__)
    for name in legacy_ops.__all__:
        fn = getattr(tm.nd, name)
        if name in tm.nd.LEGACY_PORTED:
            continue
        with pytest.raises(MXNetError, match="A16"):
            fn(None)
    with pytest.raises(MXNetError, match="A16"):
        tm.nd.sparse.csr_matrix
    with tm.cpu():
        for name, args in (("zeros", ((2, 3),)), ("ones", ((2,),)),
                           ("empty", ((2,),)), ("full", ((2, 2), 3.0))):
            got = getattr(tm.nd, name)(*args)
            want = getattr(mx.nd, name)(*args)
            _compare(got, want, EW)
        # mx.np's names reach mx.nd where 1.x does not override them
        assert tm.nd.array([1, 2]).tolist() == [1, 2]
        assert tm.nd.NDArray is tm.np.ndarray
