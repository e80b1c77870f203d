"""Port parity: ragged paged attention (mxnet_tpu_torch.ops.paged_attention)
against the JAX package's reference and its Pallas kernel in interpret mode.

The same numpy inputs (from a seed) go through both packages.  Tolerance:
atol/rtol 1e-5 in float32 — both sides compute the same f32 arithmetic and
differ only in summation order.  Only valid rows (chunk rows below a slot's
token count) are compared: padded rows are garbage by contract.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops.pallas import paged_attention as jpa

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, H, Hkv, C, D, ps, npages, maxp, start, nt):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, C, D).astype(np.float32)
    kp = rng.randn(npages, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(npages, ps, Hkv, D).astype(np.float32)
    # distinct physical pages per slot, shuffled (non-contiguous layout)
    pt = (rng.permutation(npages - 1)[:B * maxp] + 1).reshape(B, maxp)
    start = np.asarray(start, np.int32)
    nt = np.asarray(nt, np.int32)
    ctx = (start + nt).astype(np.int32)
    return q, kp, vp, pt.astype(np.int32), ctx, start, nt


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _assert_valid_rows(out, ref, nt):
    out, ref = np.asarray(out), np.asarray(ref)
    for b, n in enumerate(nt):
        np.testing.assert_allclose(out[b, :, :n], ref[b, :, :n], **TOL)


# slot 0 prefills from 0, slot 1 sits mid-context at a non-page-aligned
# length, slot 2 decodes deep in, slot 3 is empty (ctx = 0)
CASES = [pytest.param(C, H, Hkv, window, id=f"C{C}-H{H}kv{Hkv}-w{window}")
         for C in (1, 8) for (H, Hkv) in ((4, 4), (4, 2), (4, 1))
         for window in (None, 3)]


@pytest.mark.parametrize("C,H,Hkv,window", CASES)
def test_reference_matches_jax_reference(C, H, Hkv, window):
    B, D, ps, npages, maxp = 4, 16, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(0, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    ref = jpa.paged_attention_reference(*_jax(q, kp, vp, pt, ctx, st),
                                        window=window)
    out = tpa.paged_attention_reference(*_torch(q, kp, vp, pt, ctx, st),
                                        window=window)
    _assert_valid_rows(out, ref, nt)


@pytest.mark.parametrize("C,H,Hkv,window", CASES)
def test_dispatcher_matches_pallas_kernel_interpret(C, H, Hkv, window,
                                                    monkeypatch):
    """The port's CPU dispatch against the exact Pallas kernel code (run in
    interpret mode, page size 8 as the JAX serve tests run it)."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    B, D, ps, npages, maxp = 4, 16, 8, 24, 5
    start = [0, 13, 29, 0]
    nt = [C, max(1, C - 3), 1, 0]
    q, kp, vp, pt, ctx, st, nt = _inputs(1, B, H, Hkv, C, D, ps, npages,
                                         maxp, start, nt)
    ref = jpa.ragged_paged_attention(*_jax(q, kp, vp, pt, ctx, st),
                                     window=window, use_kernel=True)
    kernels.reset_launch_counts()
    out = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st),
                                     window=window)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert kernels.launch_counts()["ragged_paged_attention"] == 0
    _assert_valid_rows(out, ref, nt)


@pytest.mark.parametrize("C,window", [(1, None), (4, None), (4, 2)])
def test_dense_attend_matches_jax(C, window):
    """The dense-cache attention `generate` uses (no ctx_len)."""
    rng = np.random.RandomState(2)
    B, H, Hkv, T, D = 2, 4, 2, 12, 16
    q = rng.randn(B, H, C, D).astype(np.float32)
    kc = rng.randn(B, Hkv, T, D).astype(np.float32)
    vc = rng.randn(B, Hkv, T, D).astype(np.float32)
    pos = (np.array([[5], [9]]) + np.arange(C)[None]).astype(np.int32)
    ref = jpa._dense_attend(*_jax(q, kc, vc, pos), window=window)
    out = tpa._dense_attend(*_torch(q, kc, vc, pos), window=window)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **TOL)


def test_gather_pages_matches_jax():
    rng = np.random.RandomState(3)
    pool = rng.randn(9, 4, 2, 8).astype(np.float32)
    pt = rng.randint(0, 9, (3, 2)).astype(np.int32)
    ref = jpa.gather_pages(jnp.asarray(pool), jnp.asarray(pt))
    out = tpa.gather_pages(*_torch(pool, pt))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_empty_slot_and_padded_context_are_exact():
    """A ctx=0 slot's valid rows do not exist; a context padded with
    extra (unread) pages gives the bit-identical result."""
    B, H, Hkv, C, D, ps = 2, 4, 2, 1, 16, 8
    q, kp, vp, pt, ctx, st, nt = _inputs(4, B, H, Hkv, C, D, ps, 12, 3,
                                         [10, 0], [1, 1])
    a = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st))
    pt_long = np.concatenate([pt, pt[:, :1]], axis=1)
    b = tpa.ragged_paged_attention(*_torch(q, kp, vp, pt_long, ctx, st))
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()


def test_head_mismatch_raises():
    from mxnet_tpu_torch.base import MXNetError
    q, kp, vp, pt, ctx, st, _ = _inputs(5, 1, 3, 2, 1, 8, 8, 4, 1, [0], [1])
    with pytest.raises(MXNetError, match="multiple of pool kv heads"):
        tpa.ragged_paged_attention(*_torch(q, kp, vp, pt, ctx, st))
