"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no card is
visible, as on the CPU test machine.  Run them on a machine with an H100:
``python -m pytest tests/test_torch_cuda.py -q``.  Tolerances: f32 max-abs
<= 1e-4 of the output scale (summation order), bf16 <= 2e-2.
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
