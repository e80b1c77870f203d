"""Port parity: `mxnet_tpu_torch.utils.CheckpointManager` and `TrainStep`'s
checkpoints against ``mxnet_tpu`` on the CPU (scenarios from
``tests/unittest/test_elastic.py`` and ``test_recovery.py``): the manifests
have the same keys (with the health tag when health is on), quarantine,
``keep``, ``discard_newer`` and the healthy-only restore behave alike.  A
checkpoint written by JAX's step loads into the port's `TrainStep` and one
written by the port's loads into JAX's step, with every parameter, every
optimizer state tensor and the step count bit-equal.  The RNG stays per
package: JAX's ``meta:rng_key`` is ignored by the port, and the port's
dropout generators (``meta:torch_generator:<i>``) by JAX; the port's own
round trip restores them, bf16 weights included.  (The crossing runs in
``tests/test_torch_elastic.py``, beside the other case that builds JAX's
step, so one worker compiles it.)"""
import json
import os

import numpy as np
import pytest
import torch

from torch_plane_common import (  # noqa: F401
    batches, clean_plane, jrecovery, thealth, trecovery)

from mxnet_tpu.utils.checkpoint import CheckpointManager as JManager
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import CheckpointManager as TManager


class Target:
    def __init__(self, v=0.0):
        self.state = np.full(3, v)

    def save(self, path):
        with open(path, "wb") as f:
            np.savez(f, state=self.state)

    def load(self, path):
        with np.load(path) as z:
            self.state = z["state"]


def _manifest(mgr_cls, d, health_on):
    if health_on:
        for mod in (trecovery, jrecovery):
            mod.enable()
    m = mgr_cls(d, keep=2)
    path = m.save(Target(1.0), 4)
    with open(path + ".manifest.json") as f:
        meta = json.load(f)
    return meta


@pytest.mark.parametrize("health_on", [False, True])
def test_manifests_agree_in_keys(tmp_path, health_on):
    t = _manifest(TManager, str(tmp_path / "t"), health_on)
    j = _manifest(JManager, str(tmp_path / "j"), health_on)
    assert sorted(t) == sorted(j)
    assert t["step"] == j["step"] == 4 and t["size"] == j["size"]
    assert t["sha256"] == j["sha256"]          # same target bytes
    if health_on:
        assert t["health"] == j["health"]


def _chain(mgr_cls, d, case):
    m = mgr_cls(d, keep=3)
    for s in (2, 4, 6, 8):
        m.save(Target(float(s)), s)
    path = dict(m.checkpoints())[8]
    if case == "bitflip":
        with open(path, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 0xFF]))
    elif case == "truncate":
        with open(path, "r+b") as f:
            f.truncate(10)
    elif case == "discard":
        assert m.discard_newer(4) == [6, 8]
    t = Target()
    got = m.restore(t)
    names = sorted(os.listdir(d))
    return got, t.state.tolist(), [n for n in names if not n.startswith(".")]


@pytest.mark.parametrize("case", ["plain", "bitflip", "truncate", "discard"])
def test_quarantine_keep_and_discard_alike(tmp_path, case):
    got = _chain(TManager, str(tmp_path / "t"), case)
    want = _chain(JManager, str(tmp_path / "j"), case)
    assert got == want
    if case in ("bitflip", "truncate"):
        assert got[0] == 6 and "ckpt-8.npz.corrupt" in got[2]
    if case == "plain":
        assert got[2] == ["ckpt-4.npz", "ckpt-4.npz.manifest.json",
                          "ckpt-6.npz", "ckpt-6.npz.manifest.json",
                          "ckpt-8.npz", "ckpt-8.npz.manifest.json"]


def test_explicit_step_and_all_corrupt_raise(tmp_path):
    m = TManager(str(tmp_path), keep=2)
    m.save(Target(1.0), 3)
    with pytest.raises(MXNetError, match="no checkpoint for step 5"):
        m.restore(Target(), step=5)
    with open(dict(m.checkpoints())[3], "r+b") as f:
        f.truncate(5)
    with pytest.raises(MXNetError, match="failed verification"):
        m.restore(Target(), step=3)
    with pytest.raises(MXNetError, match="failed to restore"):
        m.restore(Target())
    with pytest.raises(MXNetError, match="A13"):
        m.attach_pipeline(object())


def test_healthy_only_restore_skips_unhealthy_tags(tmp_path):
    trecovery.enable()
    mon = thealth.monitor()
    m = TManager(str(tmp_path), keep=5)
    m.save(Target(2.0), 2)
    mon.observe(10, loss=1.0, grad_norm=float("nan"), nonfinite=0)
    m.save(Target(12.0), 12)
    assert m.newest_healthy()[0] == 2
    t = Target()
    assert m.restore(t, healthy_only=True) == 2 and t.state[0] == 2.0


def test_port_round_trip_bf16_with_dropout_generators(tmp_path,
                                                      monkeypatch):
    """bf16 weights (stored as uint16 bits) and a dropout generator: save,
    step on, load, step again — the same bits both times."""
    from mxnet_tpu_torch.models import bert as tbert
    from mxnet_tpu_torch.ops import softmax_cross_entropy
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep
    from torch_plane_common import SMALL, TorchBench

    monkeypatch.setenv("MXTPU_PALLAS", "kernel")
    cfg = dict(SMALL, dropout=0.1, dtype="bfloat16")
    m = TorchBench.__new__(TorchBench)
    torch.nn.Module.__init__(m)
    m.model = tbert.BertForPretraining(tbert.BertConfig(**cfg), device="cpu",
                                       seed=3)
    step = TrainStep(m, Adam(learning_rate=1e-3),
                     lambda out, ids, vl, mp, lab, flag:
                     softmax_cross_entropy(out[0], lab).mean(),
                     num_model_args=3)
    data = batches(4)
    for b in data[:2]:
        step.dispatch(*b)
    path = str(tmp_path / "bf16.npz")
    fut = step.save_async(path)
    assert fut.result(timeout=30) == path
    first = [float(step.dispatch(*b).loss) for b in data[2:]]
    after = {n: p.detach().clone() for n, p in step.params.items()}
    step.load(path)
    assert step._t == 2
    again = [float(step.dispatch(*b).loss) for b in data[2:]]
    assert first == again
    for n, p in step.params.items():
        assert torch.equal(p, after[n]), n
    with np.load(path) as z:
        assert any(k.startswith("__bf16__p:") for k in z.files)
        assert "meta:torch_generator:0" in z.files
