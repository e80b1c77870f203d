"""Switch-style top-1 Mixture-of-Experts (counterpart of
``mxnet_tpu/parallel/moe.py``), on one card.

`switch_moe` routes each token to its argmax expert over static capacity
buffers (``capacity_factor`` bounds the tokens an expert takes; overflow
tokens are dropped and give zero rows, empty slots are zero), runs the
experts' FFN as batched products over the expert axis, and combines the
outputs weighted by the gate.  Three routes, as in JAX, chosen by
``MXTPU_PALLAS`` (`ops.policy`):

- ``off``: the dense (T, E, C) one-hot einsums, the oracle of the overflow
  semantics;
- otherwise `ops.moe_dispatch.moe_dispatch` / `moe_combine`, which take the
  CUDA row gather on the kernel route (the default on the card) and the
  plain scatter and gather on the reference route.

The routing arithmetic follows JAX's: f32 router logits whatever x's
dtype, the first maximum on ties, slot positions from an f32 cumulative
sum of the one-hot (exact below 2**24 tokens), ``capacity = max(1,
int(cf * T / E))``; the activation is GELU's tanh form (``jax.nn.gelu``'s
default), not `ops.nn.gelu`'s erf.  The load-balance loss (Switch eq. 4)
reaches the router only through the mean routing probabilities.

Expert parallelism over several cards (JAX's 'ep' mesh axis) waits for the
multi-card slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..device import resolve_device
from ..ops import moe_dispatch as _moed
from ..ops.policy import pallas_mode

__all__ = ["MoEFeedForward", "switch_moe", "route"]


def route(xt, router_w, capacity_factor=1.25, router_noise=0.0,
          generator=None):
    """Top-1 routing of tokens xt (T, H) by router_w (E, H): returns
    ``(expert (T,), gate (T,) f32, pos (T,) int32, kept (T,) bool,
    capacity, aux_loss)``.  With ``router_noise > 0`` and a
    `generator`, Gaussian noise of that scale is added to the logits."""
    tokens = xt.shape[0]
    e = router_w.shape[0]
    logits = xt.float() @ router_w.float().t()                   # (T, E)
    if router_noise > 0.0 and generator is not None:
        logits = logits + router_noise * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                          # (T,)
    gate = probs.gather(1, expert[:, None])[:, 0]

    # load-balance aux loss: E * sum_e f_e * p_e
    onehot = F.one_hot(expert, e).float()                         # (T, E)
    aux_loss = e * torch.sum(onehot.mean(0) * probs.mean(0))

    capacity = max(1, int(capacity_factor * tokens / e))
    # position of each token within its expert's buffer: the running count
    # of the one-hot over tokens, scanned along the inner axis of its
    # transpose (a scan over the outer axis of the (T, E) one-hot runs E
    # lanes wide on the card); counts below 2**24 are exact in f32 in any
    # order, so the bits are those of JAX's cumsum over axis 0
    pos = (torch.cumsum(onehot.t().contiguous(), dim=1).t() - 1.0) * onehot
    in_cap = (pos < capacity) & (onehot > 0)
    pos = torch.sum(pos * in_cap, dim=-1).to(torch.int32)
    kept = torch.any(in_cap, dim=-1)
    return expert, gate, pos, kept, capacity, aux_loss


def switch_moe(x, router_w, w_up, w_down, capacity_factor=1.25,
               activation="gelu", router_noise=0.0, generator=None):
    """Top-1 MoE: x (B, L, H); router_w (E, H); w_up (E, I, H); w_down
    (E, H, I).  Returns (out (B, L, H), aux_loss f32 scalar).  With
    ``router_noise > 0`` and a `generator`, Gaussian noise of that scale is
    added to the router logits."""
    b, l, h = x.shape
    e = router_w.shape[0]
    xt = x.reshape(b * l, h)
    expert, gate, pos, kept, capacity, aux_loss = route(
        xt, router_w, capacity_factor, router_noise, generator)

    dense = pallas_mode() == "off"
    if dense:
        onehot = F.one_hot(expert, e).float()
        disp = (onehot * kept[:, None])[:, :, None] * F.one_hot(
            pos.long(), capacity).to(x.dtype)[:, None, :]
        disp = disp.to(x.dtype)
        buf = torch.einsum("tec,th->ech", disp, xt)               # (E, C, H)
    else:
        buf = _moed.moe_dispatch(xt, expert, pos, kept, e, capacity)

    up = torch.einsum("ech,eih->eci", buf, w_up.to(buf.dtype))
    up = F.gelu(up, approximate="tanh") if activation == "gelu" \
        else F.relu(up)
    down = torch.einsum("eci,ehi->ech", up, w_down.to(up.dtype))

    if dense:
        out = torch.einsum("tec,ech->th",
                           disp * gate[:, None, None].to(x.dtype), down)
    else:
        out = _moed.moe_combine(down, expert, pos, kept, gate)
    return out.reshape(b, l, h), aux_loss


class MoEFeedForward(nn.Module):
    """Routed FFN layer: parameters ``router`` (E, H), ``expert_up``
    (E, I, H) and ``expert_down`` (E, H, I), named as the JAX layer's
    ``collect_params()`` so `load_jax_params` carries them across.
    `forward` returns ``(out, aux_loss)``; add the aux loss to the training
    loss scaled by e.g. 0.01 (Switch Transformer's alpha).

    Built on `device` (the card unless ``device="cpu"``) with weights drawn
    as JAX's ``initialize()`` draws them — uniform in [-0.07, 0.07] — from a
    CPU generator seeded with `seed`, so a seed gives the same weights on
    every device."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, capacity_factor: float = 1.25,
                 activation: str = "gelu", dtype="float32", device=None,
                 seed: int = 0):
        super().__init__()
        if num_experts < 2:
            raise MXNetError("MoEFeedForward needs num_experts >= 2")
        dev = resolve_device(device)
        dt = getattr(torch, str(dtype).replace("torch.", ""))
        self._cf = capacity_factor
        self._act = activation
        e, h, i = num_experts, hidden_size, intermediate_size
        self.router = nn.Parameter(torch.empty((e, h), dtype=dt))
        self.expert_up = nn.Parameter(torch.empty((e, i, h), dtype=dt))
        self.expert_down = nn.Parameter(torch.empty((e, h, i), dtype=dt))
        self.reset_parameters(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.router.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0, scale: float = 0.07) -> None:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        for p in (self.router, self.expert_up, self.expert_down):
            u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
            p.copy_((2.0 * u - 1.0) * scale)

    def forward(self, x):
        return switch_moe(x, self.router, self.expert_up, self.expert_down,
                          capacity_factor=self._cf, activation=self._act)
