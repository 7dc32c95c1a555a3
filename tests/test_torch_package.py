"""Port package rules, the kernel loader's contract, and the kernels on the
card (marked ``cuda``: skipped where there is no card)."""

import ast
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "moka_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "profile_port.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "moka_tpu"), \
            f"{path} imports {name}"


def test_entry_points_need_cuda_unless_told_cpu():
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    g = torch.Generator()
    cfg = LlamaConfig.tiny()
    for call in (lambda: llama.init_llama_params(g, cfg),
                 lambda: llama.init_moka_adapters(g, cfg, MokaSpec.avt()),
                 lambda: llama.init_kv_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert llama.init_kv_cache(cfg, 1, 8, device="cpu")["k"].shape == \
        (2, 1, 8, 2, 16)


def test_kernel_loader_builds_nothing_at_import():
    """Importing every port module touches no compiler; the loader names a
    source per kernel and keys the library by its content."""
    import importlib
    from moka_tpu_torch import kernels
    for path in (ROOT / "moka_tpu_torch").rglob("*.py"):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
    assert kernels._libs == {}
    for name, src in kernels.SOURCES.items():
        assert (kernels.CSRC / src).is_file()
        assert kernels._target(name).parent == kernels.BUILD_DIR
        assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        kernels.check(7, "flash_fwd")
    kernels.check(0, "flash_fwd")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (chip_smoke.py runs the "
                    "kernels at full size on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(card):
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 77, 8, 128), generator=g, device=card).bfloat16()
    k = torch.randn((2, 100, 2, 128), generator=g, device=card).bfloat16()
    v = torch.randn((2, 100, 2, 128), generator=g, device=card).bfloat16()
    mask = torch.ones((2, 100), dtype=torch.int32, device=card)
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, mask, q_offset=23)
    ref, ref_lse = flash_fwd_plain(q, k, v, mask, q_offset=23)
    assert flash_fwd.launches == before + 1
    assert (out.float() - ref.float()).abs().max() <= \
        4e-3 + 2 ** -7 * ref.float().abs().max()
    assert (lse - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
def test_moka_kernel_matches_plain_on_card(card):
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    g = torch.Generator(device=card).manual_seed(0)
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    x = torch.randn((2, 70, 256), generator=g, device=card)
    a = torch.rand((3, 256, 4), generator=g, device=card) / math.sqrt(256)
    bm = torch.randn((4, 96), generator=g, device=card) * 0.1
    mod = torch.zeros((3, 2, 70), device=card)
    mod[0, :, :30], mod[1, :, 30:50], mod[2, :, 50:] = 1, 1, 1
    qm = torch.zeros((2, 70), device=card)
    qm[0, 3:9] = 1  # row 1 has no question
    got = moka_delta_fused(x, a, bm, mod, qm, spec)
    ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
