"""The SGD family (counterpart of ``mxnet_tpu/optimizer/sgd.py``): SGD,
NAG, Signum, SGLD, DCASGD and LARS, the same rules with the same order of
operations.

Every Python number beside a tensor goes through `weak`, so that next to a
16-bit tensor it is rounded to 16 bits first, as JAX's weakly typed
scalars are; a hyperparameter that is already a tensor (an f32 device
scalar of the fused routes) passes as it is.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register, sign, sqrt, weak


@register
class SGD(Optimizer):
    """SGD with weight decay added to the gradient (``grad += wd * w``, as
    the reference) and optional momentum: state ``()`` without momentum,
    ``(mom,)`` with it."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, weight, dtype=None):
        if self.momentum != 0.0:
            return (torch.zeros_like(weight, dtype=dtype),)
        return ()

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + hp["wd"] * w
        if self.momentum != 0.0:
            (mom,) = s
            mom = weak(self.momentum, mom) * mom - hp["lr"] * g
            return w + mom, (mom,)
        return w - hp["lr"] * g, ()


@register
class NAG(SGD):
    """Nesterov accelerated gradient: ``mom = mu * mom - lr * g``, then
    ``w + mu * mom - lr * g`` with the new momentum.  State ``(mom,)``
    (SGD's: a momentum of 0 leaves no state, which the rule, as JAX's,
    does not take)."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kwargs)

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        (mom,) = s
        mom = weak(self.momentum, mom) * mom - weak(hp["lr"], g) * g
        return (w + weak(self.momentum, mom) * mom
                - weak(hp["lr"], g) * g), (mom,)


@register
class Signum(Optimizer):
    """signSGD with momentum: ``mom = mu * mom - (1 - mu) * (g + wd * w)``,
    ``w = (1 - lr * wd_lh) * w + lr * sign(mom)``; without momentum (state
    ``()``) ``w = (1 - lr * (wd_lh + wd)) * w - lr * sign(g)``.  ``sign``
    is 0 at 0 and NaN at NaN, as ``jnp.sign``."""
    fused_elementwise = True

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, weight, dtype=None):
        if self.momentum != 0.0:
            return (torch.zeros_like(weight, dtype=dtype),)
        return ()

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        lr = hp["lr"]
        if self.momentum != 0.0:
            (mom,) = s
            gw = g + weak(hp["wd"], w) * w
            mom = weak(self.momentum, mom) * mom - \
                weak(1 - self.momentum, gw) * gw
            w = weak(1 - lr * self.wd_lh, w) * w + \
                weak(lr, mom) * sign(mom)
            return w, (mom,)
        w = weak(1 - lr * (self.wd_lh + hp["wd"]), w) * w - \
            weak(lr, g) * sign(g)
        return w, ()


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr / 2 * g + noise``,
    the noise N(0, lr) in the weight's dtype.  Draws from the optimizer's
    own ``torch.Generator`` on the weight's device, seeded with `seed` at
    first use there.  Host-side random draws at every call, so not
    fused-safe: the `Trainer` runs it per parameter and
    `parallel.TrainStep` refuses it, as JAX's jitted step cannot draw its
    keys.  JAX's keyed PRNG gives other numbers from the same seed; the
    rule beside the noise is the same."""
    fused_safe = False

    def __init__(self, learning_rate=0.01, seed=0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.seed = seed
        self._generators = {}

    def _generator(self, device):
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(
                device=device).manual_seed(self.seed)
        return gen

    def _normal(self, w):
        """Standard normal noise shaped like `w`, in its dtype."""
        return torch.randn(w.shape, generator=self._generator(w.device),
                           dtype=w.dtype, device=w.device)

    def __getstate__(self):
        # generators do not pickle: keep their states (`Updater`'s dump)
        st = dict(self.__dict__)
        st["_generators"] = {str(d): g.get_state()
                             for d, g in self._generators.items()}
        return st

    def __setstate__(self, st):
        states = st.pop("_generators")
        self.__dict__.update(st)
        self._generators = {}
        for d, s in states.items():
            self._generator(torch.device(d)).set_state(s)

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        lr = hp["lr"]
        root = sqrt(lr) if torch.is_tensor(lr) else \
            sqrt(torch.tensor(lr, dtype=torch.float32))
        noise = self._normal(w) * root.to(w.device, w.dtype)
        return w - weak(0.5 * lr, g) * g + noise, ()


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient compensated by
    ``lamda * g * g * (w - prev_w)``.  State ``(mom, prev_w)``: the
    momentum is 0-d without momentum (the rule then makes it the weight's
    shape, as JAX does), ``prev_w`` a copy of the weight (the port updates
    weights in place, so the state never shares the weight's memory)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, weight, dtype=None):
        dt = dtype or weight.dtype
        mom = torch.zeros_like(weight, dtype=dt) if self.momentum != 0.0 \
            else torch.zeros((), dtype=dt, device=weight.device)
        return (mom, weight.detach().to(dt, copy=True))

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp) + weak(hp["wd"], w) * w
        mom, prev_w = s
        # w - prev_w in the weight's stored dtype (JAX's rule subtracts the
        # stored arrays; the reference route hands f32 views)
        delay = w.to(hp.get("stored_dtype", w.dtype)) - prev_w
        comp = g + weak(self.lamda, g) * g * g * delay
        lr = hp["lr"]
        if self.momentum != 0.0:
            mom = weak(self.momentum, mom) * mom - weak(lr, comp) * comp
        else:
            mom = weak(-lr, comp) * comp
        return w + mom, (mom, w.clone())


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the trust ratio ``eta * ||w|| /
    (||g|| + wd * ||w|| + eps)`` (1 where a norm is 0), norms per tensor
    in f32, rounded to the weight's stored dtype (``hp["stored_dtype"]``
    on the reference route, where the rule sees f32 views)."""

    def __init__(self, learning_rate=0.1, momentum=0.0, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, weight, dtype=None):
        if self.momentum != 0.0:
            return (torch.zeros_like(weight, dtype=dtype),)
        return ()

    def _rule(self, w, g, s, hp):
        g = self._preprocess_grad(g, hp)
        w_norm = torch.linalg.vector_norm(w.float())
        g_norm = torch.linalg.vector_norm(g.float())
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + hp["wd"] * w_norm + self.epsilon),
            1.0).to(hp.get("stored_dtype", w.dtype))
        g = g + weak(hp["wd"], w) * w
        step = trust * weak(hp["lr"], trust)
        if self.momentum != 0.0:
            (mom,) = s
            mom = weak(self.momentum, mom) * mom + step * g
            return w - mom, (mom,)
        return w - step * g, ()
