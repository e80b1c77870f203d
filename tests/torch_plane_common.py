"""Shared pieces of the operations-plane parity tests
(``tests/test_torch_{resilience,telemetry,tracing,health,recovery,
checkpoint,elastic,profiler}.py``): a fixture that leaves both packages'
process-wide state as it found it, and the tiny BERT pretraining step
(2 layers, hidden 64, dropout 0, f32) built in both packages from the same
weights, fed the same seeded batches, with a NaN planted in the loss at a
chosen step through a flag the loss multiplies in."""
import atexit
import faulthandler
import signal
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.elastic as jelastic
import mxnet_tpu.health as jhealth
import mxnet_tpu.recovery as jrecovery
import mxnet_tpu.resilience as jres
import mxnet_tpu.telemetry as jtele
import mxnet_tpu.tracing as jtrace

import mxnet_tpu_torch.elastic as telastic
import mxnet_tpu_torch.health as thealth
import mxnet_tpu_torch.recovery as trecovery
import mxnet_tpu_torch.resilience as tres
import mxnet_tpu_torch.telemetry as ttele
import mxnet_tpu_torch.tracing as ttrace

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=32, dropout=0.0)
ENV = ("MXTPU_FAULT_SPEC", "MXTPU_TELEMETRY", "MXTPU_HEALTH",
       "MXTPU_RECOVERY", "MXTPU_TRACE", "MXTPU_TRACE_DIR",
       "MXTPU_STALL_TIMEOUT", "MXTPU_STALL_ACTION", "MXTPU_CRASH_DIR",
       "MXTPU_SKIP_BUDGET", "MXTPU_ROLLBACK_BUDGET", "MXTPU_PREEMPT_GRACE",
       "MXTPU_PEAK_TFLOPS", "MXTPU_MFU_DEVICE_KIND", "MXTPU_METRICS_PORT",
       "MXTPU_MEMMON_INTERVAL",
       # JAX's Pallas interpreter (other test files set it process-wide):
       # the parity cases hold the port to JAX's reference route
       "MXTPU_PALLAS_INTERPRET")


def _reset_all():
    for rec, hl, tele, trace in ((jrecovery, jhealth, jtele, jtrace),
                                 (trecovery, thealth, ttele, ttrace)):
        rec.disable()
        rec._tracker.reset()
        rec._tracker.count = 0        # disable() keeps the running count
        hl.disable()
        tele.disable()
        tele.registry().reset()
        trace.disable()
        trace.reset()
        trace.account().clear()
        hl._beats.clear()
        # the exit hooks `enable` registered: a test's state must not
        # flush or export at the worker's exit
        for mod, hook in ((hl, "_atexit_flush"), (tele, "_atexit_shutdown"),
                          (trace, "_atexit_export")):
            atexit.unregister(getattr(mod, hook))
            mod._atexit_registered = False
    jres._active = None
    tres._active = None


@pytest.fixture(autouse=True)
def clean_plane(monkeypatch, tmp_path):
    """Both packages' health, recovery, telemetry and tracing off, their
    registries, beats, fault registries and the plane's environment
    variables cleared (crash bundles into `tmp_path`); afterwards the same,
    and the process's excepthook, SIGTERM handler and faulthandler state as
    they were, the exit hooks unregistered and the plane's watchdog
    threads ended."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXTPU_CRASH_DIR", str(tmp_path / "crash"))
    hook = sys.excepthook
    sigterm = signal.getsignal(signal.SIGTERM)
    fh = faulthandler.is_enabled()
    threads = set(threading.enumerate())
    _reset_all()
    yield
    _reset_all()
    sys.excepthook = hook
    signal.signal(signal.SIGTERM, sigterm)
    if fh != faulthandler.is_enabled():
        (faulthandler.enable if fh else faulthandler.disable)()
    for t in set(threading.enumerate()) - threads:
        if "watchdog" in t.name:
            t.join(timeout=2.0)
            assert not t.is_alive(), t.name


def enable_plane(recover=True):
    """Health (and recovery) on in both packages, crash bundles into
    ``MXTPU_CRASH_DIR``."""
    jhealth.enable()
    thealth.enable()
    if recover:
        jrecovery.enable()
        trecovery.enable()


# ---------------------------------------------------------------------------
# the tiny BERT pretraining step in both packages
# ---------------------------------------------------------------------------

def batches(n=12, nan_at=None, B=4, L=16, M=5):
    """`n` seeded batches (ids, valid_length, masked_positions, labels,
    flag); the flag is NaN at the 1-based step `nan_at`."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        ids = rng.randint(0, 128, (B, L)).astype(np.int32)
        vl = rng.randint(L // 2, L + 1, (B,)).astype(np.int32)
        mp = np.sort(rng.rand(B, L).argsort(1)[:, :M], 1).astype(np.int32)
        lab = rng.randint(0, 128, (B, M)).astype(np.int32)
        flag = np.array([np.nan if nan_at == i + 1 else 1.0], np.float32)
        out.append((ids, vl, mp, lab, flag))
    return out


def jax_bench():
    from mxnet_tpu.gluon.block import HybridBlock
    from mxnet_tpu.models import bert as jbert

    class JaxBench(HybridBlock):
        def __init__(self, cfg):
            super().__init__()
            self.model = jbert.BertForPretraining(cfg)

        def forward(self, ids, vl, mp):
            return self.model(ids, valid_length=vl, masked_positions=mp)

    mx.random.seed(0)
    jm = JaxBench(jbert.BertConfig(**SMALL))
    jm.initialize(mx.init.Normal(0.2))
    ids, vl, mp, _, _ = batches(1)[0]
    jm(mx.np.array(ids), mx.np.array(vl), mx.np.array(mp))
    return jm


class TorchBench(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        from mxnet_tpu_torch.models import bert as tbert
        self.model = tbert.BertForPretraining(tbert.BertConfig(**SMALL),
                                              **kw)

    def forward(self, ids, vl, mp):
        return self.model(ids, valid_length=vl, masked_positions=mp)


EPS = 1e-4


def torch_step(weights, lr=1e-4):
    """The port's step over `weights` (Adam, epsilon `EPS`: the key third
    of the QKV bias has an exactly zero gradient up to round-off, which a
    small epsilon grows into steps of random sign — at 1e-6 they part the
    packages by 1e-3 of that tensor in 12 steps at lr 1e-3; lr is
    `bench.py`'s 1e-4)."""
    from mxnet_tpu_torch import load_jax_params
    from mxnet_tpu_torch.ops import softmax_cross_entropy
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep

    tm = TorchBench(device="cpu", seed=0)
    if weights is not None:       # else the port's own seeded init
        load_jax_params(tm, weights, device="cpu")

    def loss_fn(out, ids, vl, mp, lab, flag):
        return softmax_cross_entropy(out[0], lab).mean() * flag[0]

    return TrainStep(tm, Adam(learning_rate=lr, epsilon=EPS), loss_fn,
                     num_model_args=3)


def jax_step(lr=1e-4):
    """JAX's step on a one-device CPU mesh, from `jax_bench`'s weights, and
    those weights by name (numpy), taken before any step."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.ops.pallas.softmax_xent import softmax_cross_entropy
    from mxnet_tpu.parallel import make_mesh, make_sharded_train_step

    jm = jax_bench()

    def loss_fn(out, ids, vl, mp, lab, flag):
        return jnp.mean(softmax_cross_entropy(
            out[0], lab.astype(jnp.int32))) * flag[0]

    weights = {k: p.data().asnumpy() for k, p in jm.collect_params().items()}
    mesh = make_mesh({"dp": 1}, jax.devices("cpu")[:1])
    return make_sharded_train_step(
        jm, jopt.Adam(learning_rate=lr, epsilon=EPS), loss_fn, mesh,
        num_model_args=3), weights


def jax_batch(b):
    return tuple(mx.np.array(a) for a in b)


def jax_params(step):
    import jax
    return {n: np.asarray(jax.device_get(v)) for n, v in step.pvals.items()}


def torch_params(step):
    return {n: step.params[n].detach().numpy().copy()
            for n in step.param_names}


def assert_rel(got, want, tol=1e-5):
    """Every tensor's L2 departure relative to its L2 norm within `tol`."""
    assert set(got) == set(want)
    for n in want:
        d = np.linalg.norm((got[n] - want[n]).ravel())
        ref = max(np.linalg.norm(want[n].ravel()), 1e-30)
        assert d / ref <= tol, (n, d / ref)


class GuardLog:
    """Patches a package's `elastic.PreemptionGuard` so a test can reach
    the loop's guard and call `request_stop()` (no real signal: the test
    workers share their process group)."""

    def __init__(self, monkeypatch, module):
        self.guards = []
        log = self.guards

        class Logged(module.PreemptionGuard):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                log.append(self)

        monkeypatch.setattr(module, "PreemptionGuard", Logged)

    def stop(self):
        self.guards[-1].request_stop()
