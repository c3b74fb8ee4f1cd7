"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to fall back to the CPU, and its kernel
wrappers run their plain versions only for CPU tensors."""

import ast
from pathlib import Path

import pytest
import torch

import ladcast_torch
from ladcast_torch import config
from ladcast_torch.bench import make_bench
from ladcast_torch.models.dcae import build_dcae
from ladcast_torch.models.ladcast_dit import build_dit
from ladcast_torch.ops import _build
from ladcast_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ladcast_tpu", "safetensors")
PORT_FILES = sorted((ROOT / "ladcast_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path.name} imports {mod}"


def test_kernel_sources_ship_with_the_package():
    srcs = _build.sources()
    replaces = {"norm_rope": "flash_attention.py:70",
                "fused_attention": "flash_attention.py:113",
                "flash_bwd": "flash_attention.py:279",
                "flash_plain": "flash_attention.py:601",
                "dense_conv": "dense_conv.py:83",
                "depthwise_conv": "depthwise_conv.py:101"}
    assert set(srcs) == set(replaces)
    for name, src in srcs.items():
        text = src.read_text()
        assert f"Replaces: ladcast_tpu/ops/pallas/{replaces[name]}" in text
        assert "Bound on an H100" in text
        assert 'extern "C" int' in text and "cudaGetLastError()" in text


def test_native_reader_source_ships_with_the_package():
    """The port builds its own copy of the C++ shard reader, which the
    package data lists, and no port file names the JAX package's native/
    directory or its library."""
    import re
    import tomllib

    from ladcast_torch.data import native_reader

    src = ROOT / "ladcast_torch" / "native" / "shard_reader.cpp"
    assert native_reader._SOURCE == src and src.is_file()
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "native/*.cpp" in data["tool"]["setuptools"]["package-data"]["ladcast_torch"]
    for path in PORT_FILES + [src]:
        text = path.read_text()
        assert "native/libshard_reader.so" not in text, path
        assert "make -C" not in text, path
        for m in re.finditer(r"native/", text):
            assert text[:m.start()].endswith("ladcast_torch/"), (path, m.start())


def test_profile_categories_name_every_kernel():
    """chip_smoke.py's profile puts each kernel of ladcast_torch/csrc under
    its own category, never under "gemm" (whose "wgmma" fragment would take
    a kernel that issues wgmma) or "other", as mangled or demangled."""
    import chip_smoke

    own = {"norm_rope": "norm_rope", "fused_attention": "fused_attention",
           "flash_bwd": "flash_bwd", "flash_plain": "flash_plain (K6)",
           "dense_conv": "dense_conv (K4)", "depthwise_conv": "depthwise_conv (K5)"}
    kernels = chip_smoke.csrc_kernels()
    assert set(kernels) == set(_build.sources()) == set(own)
    for src, names in kernels.items():
        assert names, src
        for name in names:
            for shown in (name, f"_ZN12_GLOBAL__N_1{len(name)}{name}EPKfS1_",
                          f"void (anonymous namespace)::{name}(CUtensorMap_st)"):
                assert chip_smoke.category(shown) == own[src], (src, shown)


def test_kernels_build_inside_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    assert _build._build_root() == ROOT / "build" / "ladcast_torch"
    # an installed package has no pyproject.toml above it
    monkeypatch.setattr(_build, "_CHECKOUT", tmp_path)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "cache"))
    assert _build._build_root() == tmp_path / "cache" / "ladcast_torch"
    assert _build._build_dir().parent == tmp_path / "cache" / "ladcast_torch"


TINY_DIT = config.LaDCastDiTConfig(
    in_channels=4, out_channels=4, num_attention_heads=1, attention_head_dim=128,
    num_layers=1, num_single_layers=1, num_refiner_layers=1, mlp_ratio=1.0,
    conditioning_tensor_in_channels=4)
TINY_DCAE = config.DCAEConfig(
    in_channels=9, out_channels=9, latent_channels=4, attention_head_dim=4,
    encoder_block_out_channels=(8, 16, 16, 32),
    decoder_block_out_channels=(8, 16, 16, 32),
    encoder_layers_per_block=(1, 1, 1, 1), decoder_layers_per_block=(1, 1, 1, 1))


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for hosts without CUDA")
    rcfg = config.RolloutConfig(ensemble_size=2, num_inference_steps=2,
                                total_lead_time_hour=24)
    for call in (lambda: ladcast_torch.resolve_device(),
                 lambda: build_dit(TINY_DIT),
                 lambda: build_dcae(TINY_DCAE),
                 lambda: make_bench(TINY_DIT, TINY_DCAE,
                                    config.EDMSchedulerConfig(), rcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_entry_points_run_on_cpu_when_asked():
    dit = build_dit(TINY_DIT, device="cpu", seed=1)
    assert next(dit.parameters()).device.type == "cpu"
    again = build_dit(TINY_DIT, device="cpu", seed=1)
    for a, b in zip(dit.parameters(), again.parameters()):
        assert torch.equal(a, b)
    # flax defaults: unit norm weights, zero biases, lecun-normal kernels
    assert torch.equal(dit.transformer_blocks[0].attn.norm_q.weight,
                       torch.ones(128))
    assert not dit.proj_out.bias.any()
    w = dit.transformer_blocks[0].attn.to_q.weight
    assert abs(w.std().item() * 128 ** 0.5 - 1.0) < 0.05
    rcfg = config.RolloutConfig(ensemble_size=2, num_inference_steps=2,
                                return_seq_len=2, total_lead_time_hour=12)
    bench = make_bench(TINY_DIT, TINY_DCAE, config.EDMSchedulerConfig(), rcfg,
                       device="cpu", compute_dtype=torch.float32,
                       latent_hw=(2, 4), grid_hw=(16, 32))
    stats = {}
    acc, mean = bench["full_forecast"](3, stats)
    assert stats["traj_shape"] == (2, 2, 2, 4, 4)
    assert stats["decode_shape"] == (4, 16, 32, 4)
    assert len(stats["repetition_s"]) == len(stats["decode_s"]) == 1


def _attn_inputs(dtype, device="cpu"):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 10, 2, 128, generator=g).to(device, dtype)
               for _ in range(3))
    cos, sin = (torch.randn(10, 128, generator=g).to(device) for _ in range(2))
    w = torch.rand(10, 128, generator=g).to(device) + 0.5
    return q, k, v, cos, sin, w


def test_wrappers_take_plain_path_for_cpu_tensors():
    q, k, v, cos, sin, w = _attn_inputs(torch.float32)
    before = (fa.norm_rope.launches, fa.fused_attention.launches)
    assert torch.equal(fa.norm_rope(k, w, cos, sin),
                       fa.norm_rope_plain(k, w, cos, sin))
    kn = fa.norm_rope_plain(k, w, cos, sin)
    assert torch.equal(fa.fused_attention(q, kn, v, cos, sin, w),
                       fa.fused_attention_plain(q, kn, v, cos, sin, w))
    assert (fa.norm_rope.launches, fa.fused_attention.launches) == before


def test_wrappers_reject_other_devices():
    q, k, v, cos, sin, w = _attn_inputs(torch.float32, "meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        fa.norm_rope(k, w, cos, sin)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        fa.fused_attention(q, k, v, cos, sin, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_plain_on_cuda(dtype):
    """Each CUDA kernel against its plain version at a ragged small shape,
    with chip_smoke.py's tolerances (which covers the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    dname = str(dtype).split(".")[-1]
    q, k, v, cos, sin, w = _attn_inputs(dtype, "cuda")
    n0, f0 = fa.norm_rope.launches, fa.fused_attention.launches
    kn = fa.norm_rope(k, w, cos, sin)
    ref = fa.norm_rope_plain(k, w, cos, sin)
    rec = chip_smoke.compare(kn, ref, chip_smoke.kernel_tolerance("norm_rope", dname, ref))
    assert rec["ok"], rec
    out = fa.fused_attention(q, kn, v, cos, sin, w)
    ref = fa.fused_attention_plain(q, kn, v, cos, sin, w)
    rec = chip_smoke.compare(
        out, ref, chip_smoke.kernel_tolerance("fused_attention", dname, ref))
    assert rec["ok"], rec
    assert (fa.norm_rope.launches - n0, fa.fused_attention.launches - f0) == (1, 1)
