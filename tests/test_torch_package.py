"""The port as a package: it imports neither JAX nor the JAX package, its
entry points refuse to drop to the CPU quietly, the weight converter
checks every name, and a CUDA kernel is built or the call raises."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch
from mxnet_tpu_torch import kernels, load_jax_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from mxnet_tpu_torch.ops.paged_attention import ragged_paged_attention
from mxnet_tpu_torch.serve import InferenceEngine, ServeConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=31, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position=32, dropout=0.0)


def test_import_leaves_no_jax_and_no_jax_package():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.ops, "
            "mxnet_tpu_torch.convert, mxnet_tpu_torch.kernels, "
            "mxnet_tpu_torch.models.bert, mxnet_tpu_torch.ops.nn, "
            "mxnet_tpu_torch.ops.flash_attention, "
            "mxnet_tpu_torch.ops.softmax_xent, "
            "mxnet_tpu_torch.ops.fused_optimizer, "
            "mxnet_tpu_torch.ops.fused_norm, mxnet_tpu_torch.ops.policy, "
            "mxnet_tpu_torch.optimizer.sgd, mxnet_tpu_torch.optimizer.lamb, "
            "mxnet_tpu_torch.gluon.loss, mxnet_tpu_torch.optimizer.adam, "
            "mxnet_tpu_torch.parallel.train, mxnet_tpu_torch.parallel.moe, "
            "mxnet_tpu_torch.ops.moe_dispatch, mxnet_tpu_torch.ops.autotune, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.benchmark, "
            "mxnet_tpu_torch.optimizer.updater, mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.telemetry, mxnet_tpu_torch.tracing, "
            "mxnet_tpu_torch.health, mxnet_tpu_torch.recovery, "
            "mxnet_tpu_torch.elastic, mxnet_tpu_torch.profiler, "
            "mxnet_tpu_torch.utils.checkpoint, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.numpy, mxnet_tpu_torch.numpy.random, "
            "mxnet_tpu_torch.numpy_extension, mxnet_tpu_torch.engine, "
            "mxnet_tpu_torch.runtime, mxnet_tpu_torch.dlpack, "
            "mxnet_tpu_torch.utils.config\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_file_imports_jax_or_the_jax_package():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mxnet_tpu)\b",
                     re.M)
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                             "serve_profile.py",
                                             "train_profile.py",
                                             "flash_profile.py",
                                             "norm_profile.py",
                                             "k1_profile.py",
                                             "k2_profile.py",
                                             "k47_profile.py",
                                             "gluon_cost.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            bad += [f"{f}: {m.group(0).strip()}"
                    for m in pat.finditer(fh.read())]
    assert len(files) > 20 and not bad, bad


def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig(**TINY))
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    with pytest.raises(MXNetError, match="device='cpu'"):
        InferenceEngine(model, ServeConfig(max_slots=1, max_len=16))
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    with pytest.raises(MXNetError, match="device='cpu'"):
        load_jax_params(model, params)
    eng = InferenceEngine(model, ServeConfig(max_slots=1, max_len=16),
                          device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(MXNetError, match="unsupported device"):
        mxnet_tpu_torch.resolve_device("meta")


def test_load_jax_params_checks_names_shapes_and_dtypes():
    model = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*p.shape).astype(np.float32)
              for k, p in model.named_parameters()}
    load_jax_params(model, params, device="cpu")
    np.testing.assert_array_equal(
        model.transformer.word_embed.weight.data().detach().numpy(),
        params["transformer.word_embed.weight"])
    missing = dict(params)
    missing.pop("transformer.final_norm.beta")
    with pytest.raises(MXNetError, match="missing .*final_norm.beta"):
        load_jax_params(model, missing, device="cpu")
    extra = dict(params, **{"lm_head.weight": np.zeros((31, 16),
                                                       np.float32)})
    with pytest.raises(MXNetError, match="extra .*lm_head.weight"):
        load_jax_params(model, extra, device="cpu")
    bad = dict(params, **{"transformer.final_norm.beta":
                          np.zeros(15, np.float32)})
    with pytest.raises(MXNetError, match="final_norm.beta"):
        load_jax_params(model, bad, device="cpu")
    bad = dict(params, **{"transformer.final_norm.beta":
                          np.zeros(16, np.float64)})
    with pytest.raises(MXNetError, match="float64"):
        load_jax_params(model, bad, device="cpu")


def test_parameter_names_follow_the_jax_tree():
    names = [n for n, _ in GPTForCausalLM(
        GPTConfig(**dict(TINY, tie_embeddings=False)),
        device="cpu").named_parameters()]
    assert names[:2] == ["transformer.word_embed.weight",
                         "transformer.position_embed.weight"]
    assert "transformer.layers.0.attention.attn_qkv.weight" in names
    assert "transformer.layers.0.ffn.ffn_output.bias" in names
    assert names[-1] == "lm_head.weight"


def test_seeded_weights_are_deterministic():
    a = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=3)
    b = GPTForCausalLM(GPTConfig(**TINY), device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


def test_missing_nvcc_raises_with_a_reason(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(MXNetError, match="nvcc not found"):
        kernels.build_all()


def test_kernel_sources_and_counters():
    assert sorted(f for f in os.listdir(kernels.CSRC)
                  if f.endswith(".cu")) == ["flash_attention.cu",
                                            "fused_norm.cu",
                                            "fused_optimizer.cu",
                                            "moe_dispatch.cu",
                                            "paged_attention.cu",
                                            "quantized_matmul.cu",
                                            "softmax_xent.cu"]
    assert set(kernels.LAUNCHES) == {
        "ragged_paged_attention", "ragged_paged_attention_int8",
        "quantized_matmul", "flash_attention_fwd",
        "flash_attention_bwd", "softmax_xent_fwd", "softmax_xent_bwd",
        "fused_norm", "fused_optimizer_chunk", "lamb_phase_a",
        "lamb_phase_b", "moe_dispatch", "moe_combine"}
    kernels.LAUNCHES["quantized_matmul"] += 2
    assert kernels.launch_counts()["quantized_matmul"] >= 2
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_split_sources_build_one_library_a_part():
    """The flash source builds once per input type and K1's once per
    query width (`kernels.SPLITS`): every K1 `types` code is in exactly
    one part's bit mask, the part of its query's dtype (`_LIBRARY`)."""
    import re
    from mxnet_tpu_torch.ops import paged_attention as pa
    libs = kernels._libraries()
    assert {n for n, (src, _) in libs.items()
            if src == "paged_attention"} == {"paged_attention_q32",
                                             "paged_attention_q16"}
    assert {n for n, (src, _) in libs.items()
            if src == "flash_attention"} == {
        "flash_attention_f32", "flash_attention_bf16", "flash_attention_f16"}
    masks = {n: int(re.fullmatch(r"-DMXT_RPA_TYPES=(\d+)", flags[0])[1])
             for n, (src, flags) in libs.items()
             if src == "paged_attention"}
    for (pool, q), code in pa._TYPES.items():
        owners = [n for n, m in masks.items() if m >> code & 1]
        assert owners == [pa._LIBRARY[q]], (pool, q, code)
    assert sum(masks.values()) == 2 ** len(pa._TYPES) - 1


def test_dispatch_refuses_other_devices():
    q = torch.zeros(1, 2, 1, 8, device="meta")
    pool = torch.zeros(2, 8, 2, 8, device="meta")
    i32 = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="cuda or cpu"):
        ragged_paged_attention(q, pool, pool, i32, i32[0], i32[0])


def test_kernel_build_dir_hash_follows_headers(monkeypatch, tmp_path):
    """The build directory is keyed by every source AND header under
    ``csrc/``: an edited ``.cuh`` rebuilds instead of loading a stale
    library."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    assert any(p.suffix == ".cuh" for p in src.iterdir())
    monkeypatch.setattr(kernels, "CSRC", str(src))
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = kernels._build_dir()
    assert kernels._build_dir() == before
    header = next(p for p in src.iterdir() if p.suffix == ".cuh")
    header.write_text(header.read_text() + "\n// edited\n")
    after = kernels._build_dir()
    assert after != before
    source = next(p for p in src.iterdir() if p.suffix == ".cu")
    source.write_text(source.read_text() + "\n// edited\n")
    assert kernels._build_dir() not in (before, after)
