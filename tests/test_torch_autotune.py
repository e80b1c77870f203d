"""Port parity: the autotuner (mxnet_tpu_torch.ops.autotune) against the JAX
package's ``ops/pallas/autotune.py``, and the chunk kernel's tunable.

On the CPU the tuner ranks, times (the plain versions) and persists, but
measures nothing of the card; these tests cover its logic: the shape
buckets and keys equal JAX's, a cold search persists its winner to the
JSON cache in a temporary directory and a warm call is a hit with 0
trials, ``MXTPU_AUTOTUNE=0`` turns every lookup off, a search whose every
survivor fails pins nothing, and `apply_updates` picks a tuned chunk up —
with the same bits as at the static ``CHUNK`` (exact equality: the chunk
only cuts the work into blocks).
"""
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import autotune as jat

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.benchmark import time_callable
from mxnet_tpu_torch.ops import autotune as at
from mxnet_tpu_torch.ops import fused_optimizer as fo
from mxnet_tpu_torch.optimizer import Adam

torch.set_num_threads(1)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("MXTPU_AUTOTUNE", raising=False)
    at.clear_memory_cache()
    yield tmp_path
    at.clear_memory_cache()


@pytest.mark.parametrize("shapes", [(1,), (5000,), (4096,), (37_800_000,),
                                    (133_600_000,), (53, 4, 6, 128),
                                    (0, 3)])
def test_shape_bucket_and_key_match_jax(shapes):
    assert at.shape_bucket(shapes) == jat.shape_bucket(shapes)
    for dt in ("float32", "bfloat16"):
        for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
            assert at._key("fused_optimizer", shapes, dt, kind) == \
                jat._key("fused_optimizer", shapes, dt, kind)
    assert at._key("op", (3,), torch.bfloat16, "cpu") == \
        jat._key("op", (3,), "bfloat16", "cpu")


def test_cache_dir_and_device_kind(monkeypatch, tmp_path):
    monkeypatch.delenv("MXTPU_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("MXTPU_COMPILE_CACHE", raising=False)
    assert at.cache_dir() is None
    monkeypatch.setenv("MXTPU_COMPILE_CACHE", str(tmp_path))
    assert at.cache_dir() == os.path.join(str(tmp_path), "autotune")
    monkeypatch.setenv("MXTPU_AUTOTUNE_CACHE", "/x")
    assert at.cache_dir() == "/x"
    assert at.device_kind() == "cpu"
    assert at._model_for("NVIDIA H100 80GB HBM3")[1] == 3.35e12
    assert at._model_for("something else") == at._model_for("cpu")


def test_chunk_candidates_and_pruning():
    cands = fo._candidates((5000,), "float32")
    assert [c.chunk for c in cands] == [2048, 4096]
    assert [c.chunk for c in fo._candidates((100,), "float32")] == [2048]
    big = fo._candidates((37_800_000,), "float32")
    assert [c.chunk for c in big] == [2048, 4096, 8192, 16384, 32768]
    tun = at._REGISTRY["fused_optimizer"]
    ranked = sorted(big, key=lambda c: at.predict_s(
        tun, c, (37_800_000,), "float32", "NVIDIA H100 80GB HBM3"))
    # fewer blocks, less overhead: the smallest block is pruned at top_k 4
    assert ranked[-1].chunk == 2048
    r = fo._roofline(at.BlockConfig(chunk=8192), (10_000,), "bfloat16")
    assert r == {"flops": 180000.0, "bytes": 10_000 * 24.0, "steps": 2.0}
    assert at.tunables() == ["fused_optimizer", "moe_dispatch"]


def test_cold_search_persists_and_warm_hit_runs_no_trial(cache):
    kernels.reset_launch_counts()
    cold = at.tune("fused_optimizer", (5000,), "float32", runs=2)
    assert not cold.cache_hit and cold.source == "search"
    assert cold.trials == 2 and len(cold.timings_ms) == 2
    # the CPU trial runs the plain version: no kernel launch is counted
    assert not any(kernels.launch_counts().values())
    path = cache / "autotune_fused_optimizer.json"
    data = json.loads(path.read_text())
    key = at._key("fused_optimizer", (5000,), "float32", "cpu")
    assert data[key]["config"] == dict(cold.config)
    warm = at.tune("fused_optimizer", (5000,), "float32")
    assert warm.cache_hit and warm.trials == 0
    assert warm.config == cold.config
    # a fresh process (memory cleared) reads the disk, same bucket
    at.clear_memory_cache()
    assert at.cached_config("fused_optimizer", (6000,), "float32") == \
        cold.config
    assert at.lookup_any("fused_optimizer") == cold.config
    assert at.cached_config("fused_optimizer", (5000,), "bfloat16") is None


def test_autotune_off_disables_every_lookup(cache, monkeypatch):
    at.tune("moe_dispatch", (16, 2, 8, 32), "float32", runs=1)
    assert at.cached_config("moe_dispatch", (16, 2, 8, 32)) is not None
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    assert at.cached_config("moe_dispatch", (16, 2, 8, 32)) is None
    assert at.lookup_any("moe_dispatch") is None


def test_every_survivor_failing_pins_nothing(cache):
    def build(cfg, shapes, dtype):
        raise RuntimeError("does not build here")

    at.register_tunable("broken", lambda s, d: [at.BlockConfig(b=1),
                                                at.BlockConfig(b=2)],
                        build, lambda c, s, d: {"bytes": 1.0})
    try:
        res = at.tune("broken", (8,), "float32")
        assert res.trials == 0 and not res.cache_hit
        assert at.cached_config("broken", (8,)) is None
        assert not (cache / "autotune_broken.json").exists()
    finally:
        at._REGISTRY.pop("broken")
    with pytest.raises(MXNetError, match="unknown tunable"):
        at.tune("broken", (8,))


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    sizes = {"a": 5000, "b": 37, "c": 3000}
    p = {n: torch.from_numpy(rng.randn(k).astype(np.float32))
         for n, k in sizes.items()}
    g = {n: torch.from_numpy(rng.randn(k).astype(np.float32))
         for n, k in sizes.items()}
    s = {n: (torch.from_numpy((0.1 * rng.randn(k)).astype(np.float32)),
             torch.from_numpy(rng.rand(k).astype(np.float32)))
         for n, k in sizes.items()}
    return p, g, s


def test_apply_updates_uses_the_tuned_chunk_with_the_same_bits(cache):
    hp = {"lr": torch.tensor(1e-2), "wd": torch.tensor(0.01),
          "rescale_grad": torch.tensor(0.5), "clip_gradient": None,
          "t": torch.tensor(3.0)}
    opt = Adam(learning_rate=1e-2)
    p0, g0, s0 = _tree()
    fo.apply_updates(opt, p0, g0, s0, hp, use_kernel=True)
    assert fo.last_chunk["float32"] == fo.CHUNK
    key = at._key("fused_optimizer", (8037,), "float32", "cpu")
    (cache / "autotune_fused_optimizer.json").write_text(json.dumps(
        {key: {"config": {"chunk": 2048}}}))
    at.clear_memory_cache()
    p1, g1, s1 = _tree()
    fo.apply_updates(opt, p1, g1, s1, hp, use_kernel=True)
    assert fo.last_chunk["float32"] == 2048
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        assert all(torch.equal(a, b) for a, b in zip(s0[n], s1[n])), n


def test_the_chunk_is_looked_up_once_per_tuner_generation(cache,
                                                         monkeypatch):
    """The step does not ask the tuner at every update: one lookup per
    group shape until a search keeps a config, the memory cache is
    cleared or ``MXTPU_AUTOTUNE`` is switched."""
    hp = {"lr": torch.tensor(1e-2), "wd": torch.tensor(0.0),
          "rescale_grad": torch.tensor(1.0), "clip_gradient": None,
          "t": torch.tensor(1.0)}
    opt = Adam(learning_rate=1e-2)
    lookups = []
    real = at.cached_config
    monkeypatch.setattr(at, "cached_config",
                        lambda *a, **k: lookups.append(a) or real(*a, **k))
    p, g, s = _tree()

    def update():
        fo.apply_updates(opt, p, g, s, hp, use_kernel=True)
        return fo.last_chunk["float32"]
    assert [update() for _ in range(3)] == [fo.CHUNK] * 3
    assert len(lookups) == 1
    at.tune("fused_optimizer", (8037,), "float32", runs=1)
    tuned = real("fused_optimizer", (8037,), "float32").chunk
    lookups.clear()                 # the search's own lookups
    assert update() == tuned and len(lookups) == 1
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    assert update() == fo.CHUNK and len(lookups) == 2
    monkeypatch.delenv("MXTPU_AUTOTUNE")
    at.clear_memory_cache()
    assert update() == tuned and len(lookups) == 3     # read from disk
    assert update() == tuned and len(lookups) == 3


def test_time_callable_schema_and_moe_tunable(cache):
    calls = []
    t = time_callable(lambda: calls.append(1), warmup=2, runs=3)
    assert len(calls) == 5
    assert set(t) == {"median_ms", "mean_ms", "min_ms", "max_ms", "runs",
                      "warmup"}
    assert t["runs"] == 3 and t["min_ms"] <= t["median_ms"] <= t["max_ms"]
    res = at.tune("moe_dispatch", (64, 4, 20, 128), "bfloat16", runs=1)
    assert res.trials == 2 and res.config in (
        at.BlockConfig(use_kernel=1), at.BlockConfig(use_kernel=0))
