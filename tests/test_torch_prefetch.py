"""Port parity: `mxnet_tpu_torch.parallel.prefetch` (`DevicePrefetcher`,
`AsyncMetricBuffer`) against ``mxnet_tpu.parallel.prefetch`` on the CPU,
the port under ``with tm.cpu():``.

The prefetcher hands out the source's batches in order with their values
unchanged (compared exactly), keeps at most ``depth + 1`` batches ahead,
re-raises a source's error — or an injected ``prefetch_next`` fault — in
the consumer, skips, counts what it pulled ahead (`pending`, which JAX's
prefetcher reports alike for the same source and depth) and closes
mid-epoch without hanging.  Its thread runs under the device that was
current where it was built.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.parallel.prefetch as jpf
import mxnet_tpu_torch as tm
import mxnet_tpu_torch.parallel.prefetch as tpf
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(1)


def _source(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, 4).astype(np.float32),
             rng.randint(0, 9, 3).astype(np.int32)) for _ in range(n)]


class Counting:
    """A source that counts how far it was pulled, optionally raising at
    item `fail_at` or sleeping `delay` seconds an item."""

    def __init__(self, items, fail_at=None, delay=0.0):
        self.items, self.fail_at, self.delay = items, fail_at, delay
        self.pulled = 0

    def __iter__(self):
        for i, it in enumerate(self.items):
            if i == self.fail_at:
                raise ValueError(f"source broke at {i}")
            time.sleep(self.delay)
            self.pulled += 1
            yield it


def _settle(pf, want, limit=5.0):
    t0 = time.time()
    while pf.pending() < want and time.time() - t0 < limit:
        time.sleep(0.01)


def test_batches_come_in_order_with_their_values():
    src = _source()
    with tm.cpu():
        pf = tpf.DevicePrefetcher(src, depth=2)
        got = list(pf)
    assert len(got) == len(src)
    for (x, y), (gx, gy) in zip(src, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
        assert gx.dtype == torch.float32 and gy.dtype == torch.int32
    assert pf.stats()["batches"] == len(src)


def test_bare_items_dicts_and_arrays_keep_their_shape():
    items = [np.arange(3, dtype=np.int32),
             {"tokens": np.ones((2, 2), np.int32), "mask": [np.zeros(2)]},
             (tm.np.array([1.0, 2.0], device="cpu"),)]
    with tm.cpu():
        got = list(tpf.DevicePrefetcher(iter(items)))
    assert isinstance(got[0], torch.Tensor)
    assert set(got[1]) == {"tokens", "mask"} and \
        isinstance(got[1]["mask"], list)
    assert isinstance(got[2], torch.Tensor)       # a 1-tuple comes back bare
    np.testing.assert_array_equal(got[2].numpy(), [1.0, 2.0])


def test_a_place_hook_is_splatted_and_runs_under_the_callers_device():
    seen = []

    def place(x, y):
        seen.append(threading.current_thread().name)
        # the current device inside the prefetch thread is the caller's
        return tm.np.array(x), tm.current_device()

    with tm.cpu():
        got = list(tpf.DevicePrefetcher(_source(3), place=place))
    assert seen == ["mxtpu-prefetch"] * 3
    assert all(d == tm.cpu() and a.device == tm.cpu() for a, d in got)


@pytest.mark.parametrize("depth", [1, 3])
def test_backpressure_and_pending_match_jax(depth):
    out = []
    for pkg in (tpf, jpf):
        src = Counting(_source(12))
        with tm.cpu():
            pf = pkg.DevicePrefetcher(src, depth=depth)
        next(pf)
        _settle(pf, depth + 1)
        time.sleep(0.1)                 # nothing more may be pulled
        out.append((src.pulled, pf.pending()))
        pf.close()
    assert out[0] == out[1] == (depth + 2, depth + 1)


def test_source_errors_reach_the_consumer_after_the_good_batches():
    for pkg in (tpf, jpf):
        with tm.cpu():
            pf = pkg.DevicePrefetcher(Counting(_source(6), fail_at=3))
        assert len([next(pf) for _ in range(3)]) == 3
        with pytest.raises(ValueError, match="broke at 3"):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)
        assert not pf._thread.is_alive()


def test_an_injected_fault_at_prefetch_next_propagates(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "prefetch_next@2")
    kinds = []
    for pkg in (tpf, jpf):
        with tm.cpu():
            pf = pkg.DevicePrefetcher(_source(5))
        next(pf)
        with pytest.raises(BaseException) as e:
            next(pf)
        kinds.append(type(e.value).__name__)
    assert kinds[0] == kinds[1]


def test_skip_drops_batches_and_stops_short_at_the_end():
    src = _source(5)
    with tm.cpu():
        pf = tpf.DevicePrefetcher(src, depth=2)
    assert pf.skip(2) == 2
    x, _ = next(pf)
    np.testing.assert_array_equal(x.numpy(), src[2][0])
    assert pf.skip(5) == 2


def test_close_mid_epoch_never_hangs():
    src = Counting(_source(50))
    with tm.cpu():
        pf = tpf.DevicePrefetcher(src, depth=2)
    next(pf)
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 2.0 and not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pulled = src.pulled
    time.sleep(0.1)
    assert src.pulled == pulled < 50


def test_a_stuck_source_times_out():
    with tm.cpu():
        pf = tpf.DevicePrefetcher(Counting(_source(3), delay=0.6),
                                  timeout=0.1)
    with pytest.raises(MXNetError, match="no batch arrived"):
        next(pf)
    pf.close()


def test_depth_and_stats_match_jax(monkeypatch):
    for v in ("4", "0", "junk"):
        monkeypatch.setenv("MXTPU_PREFETCH_DEPTH", v)
        assert tpf.default_prefetch_depth() == jpf.default_prefetch_depth()
    with pytest.raises(MXNetError, match="depth"):
        with tm.cpu():
            tpf.DevicePrefetcher([], depth=0)
    stats = []
    for pkg in (tpf, jpf):
        with tm.cpu():
            pf = pkg.DevicePrefetcher(_source(4), depth=2)
        list(pf)
        stats.append(pf.stats())
    assert stats[0].keys() == stats[1].keys()
    assert stats[0]["batches"] == stats[1]["batches"] == 4


def test_the_card_is_wanted_unless_the_caller_asks_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        tpf.DevicePrefetcher(_source(2))


def test_async_metric_buffer_fetches_in_windows_like_jax():
    vals = [0.5, 1.25, 3.0, -2.0, 7.5]
    out = []
    for pkg, make in ((tpf, lambda v: torch.tensor(v)),
                      (jpf, lambda v: np.float32(v))):
        buf = pkg.AsyncMetricBuffer(drain_every=2)
        for v in vals:
            buf.append(make(v))
        assert buf.in_flight == 1 and len(buf) == 5
        out.append((buf.drain(), buf.max_in_flight, buf.mean(last_n=2)))
    assert out[0] == out[1]
    # handles (``.loss``), arrays and plain floats mix in one window
    buf = tpf.AsyncMetricBuffer(drain_every=8)

    class Handle:
        loss = torch.tensor(2.0)
    buf.append(Handle()).append(tm.np.array(4.0, device="cpu")).append(1.0)
    assert buf.drain() == [2.0, 4.0, 1.0]
    with pytest.raises(MXNetError):
        tpf.AsyncMetricBuffer(drain_every=0)
    with pytest.raises(MXNetError, match="empty"):
        tpf.AsyncMetricBuffer().mean()
