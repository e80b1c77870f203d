"""The port's CUDA kernels against their plain versions, on the card:
ragged paged attention, the dequant-matmul, flash attention (forward and
backward, with padding or per-row bias, causal, dropout, ragged L and
D up to 128), the streaming cross-entropy (any V, unclamped labels), the
fused LayerNorm/RMSNorm (any h, with and without residual and beta) and
the optimizer kernels (the multi-tensor chunk for Adam, AdamW and SGD,
LAMB phases A and B; f32 and bf16 weights; the skip flag).

Marked ``cuda``: each test skips (with its reason) where no card is
visible, as on the CPU test machine.  Run them on a machine with an H100
(which needs no JAX): ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``.  Tolerances: f32 max-abs
<= 1e-4 of the output scale (summation order), bf16 <= 2e-2; the optimizer
kernels at atol 2e-6 on f32 (the JAX kernel test's bound), bf16 weights at
rtol 2**-7 (one bf16 step at most).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import quantized_matmul as qm

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C,Hkv,ps,window", [(1, 4, 16, None),
                                             (8, 2, 8, None),
                                             (8, 1, 24, 5)])
def test_paged_attention_kernel_matches_plain(card, dtype, tol, C, Hkv, ps,
                                              window):
    g = torch.Generator().manual_seed(0)
    B, H, D, maxp = 3, 4, 64, 6
    q = torch.randn(B, H, C, D, generator=g).to(card, dtype)
    kp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    vp = torch.randn(B * maxp + 1, ps, Hkv, D, generator=g).to(card, dtype)
    pt = (torch.randperm(B * maxp, generator=g) + 1).reshape(B, maxp)
    start = torch.tensor([0, 2 * ps + 3, 0])
    nt = torch.tensor([C, C, 0])
    args = [t.to(card, torch.int32) for t in (pt, start + nt, start)]
    kernels.reset_launch_counts()
    out = pa.ragged_paged_attention(q, kp, vp, *args, window=window)
    ref = pa.paged_attention_reference(q, kp, vp, *args, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ragged_paged_attention"] == 1
    for b in range(2):                  # slot 2 is empty (ctx = 0)
        n = int(nt[b])
        err = (out[b, :, :n].float() - ref[b, :, :n].float()).abs().max()
        assert float(err) <= tol * float(ref[b, :, :n].float().abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,N,K", [(8, 96, 64), (37, 70, 33)])
def test_quantized_matmul_kernel_matches_plain(card, dtype, tol, bits, M, N,
                                               K):
    g = torch.Generator().manual_seed(1)
    qt = qm.quantize_weight(torch.randn(N, K, generator=g), bits).to(card)
    x = torch.randn(M, K, generator=g).to(card, dtype)
    out = qm.quantized_matmul(x, qt)
    ref = qm.quantized_matmul_reference(x, qt)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max()
    assert float(err) <= tol * float(ref.float().abs().max())


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 1, 8, device=card, dtype=torch.float16)
    pool = torch.zeros(2, 8, 2, 8, device=card, dtype=torch.float16)
    i32 = torch.zeros(1, 1, dtype=torch.int32, device=card)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        pa.ragged_paged_attention(q, pool, pool, i32, i32[0], i32[0])
    qt = qm.quantize_weight(torch.randn(4, 8), 8).to(card)
    with pytest.raises(MXNetError, match="contiguous"):
        qm._qmm_cuda(torch.randn(8, 2, device=card).T, qt)


def _flash_case(card, dtype, B, H, Lq, Lk, D, bias_kind, causal, rate):
    """The dispatcher's output and gradients (kernels, through autograd)
    and those of the plain versions called by name on the same inputs."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(*s, generator=g).to(card, dtype)
                   for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D),
                             (B, H, Lq, D)))
    bias = None
    if bias_kind == "pad":
        vl = torch.randint(1, Lk + 1, (B,), generator=g)
        bias = torch.where(torch.arange(Lk)[None] < vl[:, None], 0.0,
                           fa.MASK_VALUE).to(card)
    elif bias_kind == "row":
        bias = torch.randn(B, Lq, Lk, generator=g).to(card)
        bias[0, :3] = fa.MASK_VALUE                 # fully masked rows
    seed = torch.tensor([12345], dtype=torch.int32, device=card)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qq, kk, vv, causal=causal, bias=bias,
                           dropout_rate=rate, dropout_seed=seed)
    o.backward(do)
    got = [o.detach()] + [t.grad for t in (qq, kk, vv)]
    bias3, per_head, per_row = (None, False, False) if bias is None \
        else fa.normalize_bias(bias, B, H, Lq, Lk)
    tail = (D ** -0.5, causal, rate, per_head, per_row)
    o_ref, lse = fa.flash_fwd_reference(q, k, v, bias3, seed, *tail)
    want = [o_ref] + list(fa.flash_bwd_reference(q, k, v, bias3, seed,
                                                 o_ref, lse, do, *tail))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Lq,Lk,D,bias_kind,causal,rate", [
    (128, 128, 64, "pad", False, 0.1), (77, 77, 64, "none", True, 0.0),
    (40, 100, 32, "row", False, 0.0), (130, 65, 128, "pad", False, 0.2)])
def test_flash_attention_kernels_match_plain(card, dtype, tol, Lq, Lk, D,
                                             bias_kind, causal, rate):
    kernels.reset_launch_counts()
    got, want = _flash_case(card, dtype, 2, 3, Lq, Lk, D, bias_kind, causal,
                            rate)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd"] == 1
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), name


def test_flash_attention_kernel_raises_on_what_it_does_not_take(card):
    from mxnet_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 4, 8, 16, device=card)
    kv = torch.zeros(1, 2, 8, 16, device=card)
    with pytest.raises(MXNetError, match="ROADMAP.md"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(MXNetError, match="ROADMAP.md"):
        fa.flash_attention(q, q, q, window=2)
    with pytest.raises(MXNetError, match="head_dim"):
        big = torch.zeros(1, 1, 8, 256, device=card)
        fa.flash_attention(big, big, big)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,V", [(64, 30522), (37, 1001)])
def test_softmax_xent_kernels_match_plain(card, dtype, tol, N, V):
    from mxnet_tpu_torch.ops import softmax_xent as sx
    g = torch.Generator().manual_seed(3)
    x = 3 * torch.randn(N, V, generator=g)
    lab = torch.randint(0, V, (N,), generator=g)
    lab[0] = -1                                   # not clamped
    # a masked vocabulary: a -inf column, and a row whose first 512 entries
    # (every thread's first read) are -inf
    x[:, 7] = float("-inf")
    x[1, :512] = float("-inf")
    lab[lab == 7] = 8
    lab[1] = 600
    x, lab = x.to(card, dtype), lab.to(card, torch.int32)
    gr = torch.rand(N, generator=g).to(card)
    kernels.reset_launch_counts()
    xx = x.clone().requires_grad_()
    loss = sx.softmax_cross_entropy(xx, lab)
    loss.backward(gr)
    loss_ref, lse = sx.xent_fwd_reference(x, lab)
    dx_ref = sx.xent_bwd_reference(x, lab, lse, gr)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["softmax_xent_fwd"] == 1
    assert kernels.launch_counts()["softmax_xent_bwd"] == 1
    assert bool(torch.isfinite(loss).all())
    for a, b in ((loss.detach(), loss_ref), (xx.grad, dx_ref)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,h", [(37, 200), (64, 768), (3, 4099)])
@pytest.mark.parametrize("rms,residual", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_fused_norm_kernel_matches_plain(card, dtype, tol, rows, h, rms,
                                         residual):
    from mxnet_tpu_torch.ops import fused_norm as fn
    g = torch.Generator().manual_seed(5)
    x = torch.randn(rows, h, generator=g).to(card, dtype)
    r = torch.randn(rows, h, generator=g).to(card, dtype) if residual \
        else None
    gamma = (torch.rand(h, generator=g) + 0.5).to(card)
    beta = None if rms else torch.randn(h, generator=g).to(card)
    kernels.reset_launch_counts()
    got = fn._norm_cuda(x, r, gamma, beta, 1e-5, rms)
    want = fn.norm_plain(x, r, gamma, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == 1
    got = got if residual else (got,)
    want = want if residual else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max())


def test_fused_norm_dispatch_launches_and_differentiates(card):
    from mxnet_tpu_torch.ops import nn as tnn
    x = torch.randn(4, 16, 768, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    gamma = torch.ones(768, device=card, requires_grad=True)
    beta = torch.zeros(768, device=card, requires_grad=True)
    kernels.reset_launch_counts()
    y = tnn.layer_norm(x, gamma, beta)          # MXTPU_PALLAS=auto
    y.float().sum().backward()
    assert kernels.launch_counts()["fused_norm"] == 1
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    assert gamma.grad.dtype == torch.float32


OPT_CASES = {"adam": ("Adam", {}), "adamw": ("AdamW", {}),
             "sgd": ("SGD", {}), "sgd_momentum": ("SGD", {"momentum": 0.9}),
             "lamb": ("LAMB", {}),
             "lamb_bounds": ("LAMB", {"lower_bound": 5.0,
                                      "upper_bound": 20.0,
                                      "bias_correction": False})}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_optimizer_kernels_match_plain(card, name, wdtype):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    cls, kw = OPT_CASES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    g = torch.Generator().manual_seed(6)
    sizes = {"a": 70001, "b": 1000, "c": 37, "d": 8}
    params = {n: torch.randn(k, generator=g).to(card, wdtype)
              for n, k in sizes.items()}
    params["d"] = params["d"].float()                  # a second group
    grads = {n: (3 * torch.randn(p.shape, generator=g)).to(card, p.dtype)
             for n, p in params.items()}
    states = {n: tuple(torch.rand(p.shape, generator=g).to(card)
                       for _ in opt.create_state(p))
              for n, p in params.items()}
    hp = {"lr": 0.01, "wd": 0.01, "rescale_grad": 0.5,
          "clip_gradient": 1.0, "t": 3.0}
    hp = {k: torch.tensor(v, device=card) for k, v in hp.items()}
    want = {n: fo._reference_leaf(opt, params[n], grads[n], states[n], hp,
                                  None) for n in params}
    kernels.reset_launch_counts()
    fo.apply_updates(opt, params, grads, states, hp, use_kernel=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if cls == "LAMB":
        assert counts["lamb_phase_a"] == counts["lamb_phase_b"] == 4
    else:
        groups = 2 if wdtype == torch.bfloat16 else 1
        assert counts["fused_optimizer_chunk"] == groups
    for n in params:
        w_want, s_want = want[n]
        if params[n].dtype == torch.bfloat16:
            torch.testing.assert_close(params[n].float(), w_want.float(),
                                       rtol=2 ** -7, atol=2e-6)
        else:
            torch.testing.assert_close(params[n], w_want, rtol=0, atol=2e-6)
        for a, b in zip(states[n], s_want):
            torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["adam", "sgd_momentum", "lamb"])
def test_optimizer_kernels_skip_is_bit_identical(card, name):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    cls, kw = OPT_CASES[name]
    opt = getattr(topt, cls)(learning_rate=0.01, **kw)
    for skip, same in ((True, True), (False, False)):
        params = {"w": torch.randn(5000, device=card)}
        grads = {"w": torch.randn(5000, device=card)}
        grads["w"][7] = float("nan")
        states = {"w": tuple(torch.rand(5000, device=card)
                             for _ in opt.create_state(params["w"]))}
        before = params["w"].clone(), [s.clone() for s in states["w"]]
        hp = {"lr": 0.1, "wd": 0.0, "rescale_grad": 1.0,
              "clip_gradient": None, "t": 1.0}
        fo.apply_updates(opt, params, grads, states, hp,
                         skip=torch.tensor(skip, device=card),
                         use_kernel=True)
        torch.cuda.synchronize()
        assert torch.equal(params["w"], before[0]) == same
        assert all(torch.equal(a, b) == same
                   for a, b in zip(states["w"], before[1]))
