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


def test_kernel_loader_builds_nothing_at_import(tmp_path):
    """Importing every port module touches no compiler; the loader names a
    source per kernel and keys the library by its content and that of the
    headers under csrc/ (checked on a copy: an edited header changes the
    key of every kernel, an edited source only its own)."""
    import importlib
    import shutil
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
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    keys = {n: kernels._target(n, csrc) for n in kernels.SOURCES}
    assert keys == {n: kernels._target(n) for n in kernels.SOURCES}
    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(kernels._target(n, csrc) != keys[n] for n in kernels.SOURCES)
    keys = {n: kernels._target(n, csrc) for n in kernels.SOURCES}
    src = csrc / kernels.SOURCES["flash_bwd"]
    src.write_text(src.read_text() + "\n// edited\n")
    assert {n for n in kernels.SOURCES
            if kernels._target(n, csrc) != keys[n]} == {"flash_bwd"}


def test_flash_ablation_edits_apply():
    """profile_port.py's kernel-1 ablations edit the source by text: each
    edit must still find its text in flash_fwd.cu (or hopper.cuh), so the
    timed variants are the kernel with exactly that part taken out."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import profile_port
    base = profile_port.ablation_source([], kernels.CSRC)
    for name, edits in profile_port.FLASH_ABLATIONS.items():
        src = profile_port.ablation_source(edits, kernels.CSRC)
        assert (src == base) == (not edits), name
    with pytest.raises(ValueError, match="no longer applies"):
        profile_port.ablation_source([("no such text", "")], kernels.CSRC)


def test_fused_ce_ablation_edits_apply():
    """profile_port.py's kernel-9 ablations and tile orders edit
    fused_ce_bwd.cu by text: each edit must still find its text there (or
    in hopper.cuh), so each timed variant is the kernel with exactly that
    part taken out."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import profile_port
    src = "fused_ce_bwd.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    assert "wgmma_m64n128_ss" in base and "tma_reduce_add_4d" in base
    variants = set()
    for name, edits in profile_port.CE_ABLATIONS.items():
        edited = profile_port.ablation_source(edits, kernels.CSRC, src)
        assert (edited == base) == (not edits), name
        variants.add(edited)
    assert len(variants) == len(profile_port.CE_ABLATIONS)
    with pytest.raises(ValueError, match="no longer applies"):
        profile_port.ablation_source([("no such text", "")], kernels.CSRC,
                                     src)


@pytest.mark.parametrize("edits", ["RANK_ABLATIONS", "BD_ABLATIONS",
                                   "RANK_MUTANTS", "BD_MUTANTS"])
def test_rank_and_block_diag_edits_apply(edits):
    """The rank forward's and kernel 10's edited copies (profile_port.py's
    ablations, chip_smoke.py's mutants, which phase 3 requires to fail)
    edit their source by text: each old text must occur exactly once in
    flash_rank.cu or block_diag.cu (hopper.cuh inlined), so each copy is
    the kernel with exactly that part changed, and no two are alike."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import profile_port
    table = getattr(profile_port if "ABLATIONS" in edits else chip_smoke,
                    edits)
    src = "flash_rank.cu" if edits.startswith("RANK") else "block_diag.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    variants = {base}
    for name, changes in table.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        edited = profile_port.ablation_source(changes, kernels.CSRC, src)
        assert (edited == base) == (not changes), name
        variants.add(edited)
    assert len(variants) == len(table) + (0 if "kernel" in table else 1)


def test_rank_and_block_diag_source_contract():
    """The rank forward walks keys straight from global memory (no shared
    staging, 16-byte loads, one __syncthreads for the span and one for
    V's sum); kernel 10 streams x by TMA through hopper.cuh's swizzled
    tensor map and mbarriers, with no atomics."""
    import re
    from moka_tpu_torch import kernels
    rank = (kernels.CSRC / "flash_rank.cu").read_text()
    fwd = rank[rank.index("flash_rank_fwd_kernel(const float*"):
               rank.index("flash_rank_dq_kernel(const float*")]
    fwd = re.sub(r"//[^\n]*", "", fwd)
    assert "stage<" not in fwd and fwd.count("__syncthreads()") == 2
    assert "__reduce_min_sync" in fwd and "load_row<HD>" in fwd
    bd = re.sub(r"//[^\n]*", "", (kernels.CSRC / "block_diag.cu")
                .read_text())
    assert "tma_load_4d" in bd and "swizzled_map" in bd
    assert "mbar_wait" in bd and "atomic" not in bd


@pytest.mark.parametrize("name", sorted(__import__(
    "moka_tpu_torch.kernels", fromlist=["SOURCES"]).SOURCES))
def test_each_source_keys_only_its_library(tmp_path, name):
    """An edited source rebuilds its own library and no other (the fused
    CE pair lives in two sources since kernel 9's redesign)."""
    import shutil
    from moka_tpu_torch import kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    keys = {n: kernels._target(n, csrc) for n in kernels.SOURCES}
    src = csrc / kernels.SOURCES[name]
    src.write_text(src.read_text() + "\n// edited\n")
    assert {n for n in kernels.SOURCES
            if kernels._target(n, csrc) != keys[n]} == {name}


def test_fused_ce_wrappers_bind_their_libraries(monkeypatch):
    """Kernel 8 binds ``moka_fused_ce_fwd`` of library ``fused_ce`` and
    kernel 9 ``moka_fused_ce_bwd`` of ``fused_ce_bwd``, each with twelve
    arguments (seven pointers, four ints, the stream), on first use."""
    import ctypes
    import types
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import fused_ce as fc
    asked = []

    def library(name):
        asked.append(name)
        return types.SimpleNamespace(
            moka_fused_ce_fwd=types.SimpleNamespace(),
            moka_fused_ce_bwd=types.SimpleNamespace())

    monkeypatch.setattr(kernels, "library", library)
    monkeypatch.setattr(fc, "_libs", {})
    fwd = fc._library("fused_ce").moka_fused_ce_fwd
    bwd = fc._library("fused_ce_bwd").moka_fused_ce_bwd
    assert fc._library("fused_ce_bwd").moka_fused_ce_bwd is bwd
    assert asked == ["fused_ce", "fused_ce_bwd"]
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (fwd, bwd):
        assert fn.argtypes == [p] * 7 + [i] * 4 + [p] and fn.restype is i
    assert kernels.SOURCES["fused_ce_bwd"] == "fused_ce_bwd.cu"


def test_fused_ce_backward_source_contract():
    """Kernel 9's source: wgmma and TMA reductions, no atomics on dx, the
    head read as int8 codes (a UINT8 tensor map, no bf16 copy), and the
    vocab span kernel 8 pads to (CHUNK, VOCAB_TILE)."""
    import re
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import fused_ce as fc
    bwd = (kernels.CSRC / "fused_ce_bwd.cu").read_text()
    fwd = (kernels.CSRC / "fused_ce.cu").read_text()
    code = re.sub(r"//[^\n]*", "", bwd)
    assert "atomicAdd" not in code and "tma_reduce_add_4d" in code
    assert "wgmma_m64n128_ss" in code and "wgmma_m64n64_rs" in code
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in code
    assert "fused_ce_bwd_kernel" not in fwd and "mma_bf16" in fwd

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const(bwd, "SPAN") == fc.VOCAB_TILE
    assert const(fwd, "BV") * const(fwd, "SUB") == fc.VOCAB_TILE
    assert const(bwd, "BK") == fc.K_TILE


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
def test_flash_kernel_negative_offset_on_card(card):
    """A ring key shard above part of the diagonal: at q_offset -100 rows
    0..99 see no key (query tile 0, rows 0..63, runs no key tile) and must
    read out 0 and lse <= -1e29; the other rows match the plain version."""
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((2, 200, 8, 128), generator=g, device=card).bfloat16()
    k = torch.randn((2, 256, 2, 128), generator=g, device=card).bfloat16()
    v = torch.randn((2, 256, 2, 128), generator=g, device=card).bfloat16()
    mask = torch.ones((2, 256), dtype=torch.int32, device=card)
    out, lse = flash_fwd(q, k, v, mask, q_offset=-100)
    ref, ref_lse = flash_fwd_plain(q, k, v, mask, q_offset=-100)
    assert (out[:, :100] == 0).all() and (lse[:, :, :100] <= -1e29).all()
    d = (out[:, 100:].float() - ref[:, 100:].float()).abs()
    assert (d <= 4e-3 + 2 ** -7 * ref[:, 100:].float().abs()).all()
    assert (lse[:, :, 100:] - ref_lse[:, :, 100:]).abs().max() <= 1e-3


@pytest.mark.cuda
def test_flash_kernel_head_dim_64_non_causal_on_card(card):
    """The CLIP tower's shape: head_dim 64, non-causal, 257 keys (the last
    key tile holds one and runs narrow), every key valid."""
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn((3, 257, 16, 64), generator=g, device=card)
               .bfloat16() for _ in range(3))
    mask = torch.ones((3, 257), dtype=torch.int32, device=card)
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, mask, causal=False)
    ref, ref_lse = flash_fwd_plain(q, k, v, mask, causal=False)
    assert flash_fwd.launches == before + 1
    assert (out.float() - ref.float()).abs().max() <= \
        4e-3 + 2 ** -7 * ref.float().abs().max()
    assert (lse - ref_lse).abs().max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [False, True], ids=["cache", "key_shard"])
@pytest.mark.parametrize("which", ["fused", "dq", "dkv"])
def test_flash_bwd_kernels_match_plain_on_card(card, which, shard):
    """Each backward kernel against ``flash_bwd_plain`` with GQA 8:2, a
    left-padded row, ragged lengths and a query offset; max|err| within 2%
    of max|plain| (bf16 roundings of p and ds summed in another order) and
    exact zeros on the dq rows of queries that see no key.  ``key_shard``:
    the keys are ring attention's second shard of 100 at q_offset -40 (the
    queries at positions 60..136 of both shards), with the global rows' lse
    and delta from a forward over both, so the mask and not the lse zeroes
    p where a key lies above the diagonal (every key of the shard for
    queries 0..39)."""
    from moka_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(1)
    q, dout = (torch.randn((2, 77, 8, 128), generator=g, device=card)
               .bfloat16() for _ in range(2))
    S = 200 if shard else 100
    k, v = (torch.randn((2, S, 2, 128), generator=g, device=card)
            .bfloat16() for _ in range(2))
    mask = torch.ones((2, S), dtype=torch.int32, device=card)
    mask[1, :40] = 0  # with q_offset 23, queries 0..16 of row 1 see no key
    q_offset = 60 if shard else 23
    out, lse = fa.flash_fwd(q, k, v, mask, q_offset=q_offset)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if shard:
        k, v, mask = (t[:, 100:].contiguous() for t in (k, v, mask))
        q_offset -= 100
    args = (q, k, v, mask, dout, lse, delta, q_offset)
    fn = getattr(fa, f"flash_bwd_{which}")
    before = fn.launches
    got = fn(*args)
    got = (got,) if which == "dq" else got
    ref = fa.flash_bwd_plain(*args)
    ref = {"fused": ref, "dq": ref[:1], "dkv": ref[1:]}[which]
    assert fn.launches == before + 1
    for x, y in zip(got, ref):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert (x.float() - y.float()).abs().max() <= \
            2e-2 * y.float().abs().max()
    if which != "dkv" and not shard:
        assert (got[0][1, :17] == 0).all()
    if which != "dq" and shard:  # keys 77 - 40 = 37.. of the shard: unseen
        assert all((t[:, 37:] == 0).all() for t in got[-2:])


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


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True])
def test_fused_dropout_kernels_match_plain_on_card(card, forced):
    """Kernels 6 and 7 against their plain versions on the same words: the
    same mask exactly, out and dA to fp32 summation order, dx to one bf16
    ulp; two calls bit-identical."""
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    g = torch.Generator(device=card).manual_seed(2)
    n, d = 300, 1000
    x = torch.randn((n, d), generator=g, device=card).bfloat16()
    a = torch.randn((d, 12), generator=g, device=card) * 0.03
    gout = torch.randn((n, 12), generator=g, device=card)
    key = DropoutKey(4)
    bits = torch.randint(0, 1 << 32, (n, d), generator=g, device=card,
                         dtype=torch.int64) if forced else None
    before = (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches)
    out = fd.dropout_a_fwd(x, a, key, 0.05, bits)
    dx, da = fd.dropout_a_bwd(x, a, gout, key, 0.05, bits)
    assert torch.equal(out, fd.dropout_a_fwd(x, a, key, 0.05, bits))
    assert (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    ref = fd.dropout_a_fwd_plain(x, a, key, 0.05, bits)
    rdx, rda = fd.dropout_a_bwd_plain(x, a, gout, key, 0.05, bits)
    words = bits if forced else key.bits32((n, d), card)
    assert torch.equal(dx != 0, words < fd.threshold(0.05))
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (da - rda).abs().max() <= 1e-5 * rda.abs().max()
    assert ((dx.float() - rdx.float()).abs()
            <= 2 ** -7 * rdx.float().abs()).all()


@pytest.mark.cuda
def test_fused_ce_kernels_match_plain_on_card(card):
    """Kernels 8 and 9 against their plain versions on ragged rows and
    vocab (50 rows, V 203): nll and lse to 1e-3, dx to 2% of max|plain|
    (the same bf16 roundings of p, fp32 sums in other orders)."""
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops.quant import quantize_int8
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((50, 128), generator=g, device=card).bfloat16()
    head = quantize_int8(torch.randn((128, 203), generator=g, device=card))
    w, s = head["w_i8"], head["scale"].reshape(-1)
    t = torch.randint(0, 203, (50,), generator=g, device=card)
    t[::5] = -100
    cot = torch.rand((50,), generator=g, device=card) * (t >= 0)
    before = (fc.fused_ce_fwd.launches, fc.fused_ce_bwd.launches)
    nll, lse = fc.fused_ce_fwd(x, w, s, t)
    dx = fc.fused_ce_bwd(x, w, s, t, lse, cot)
    assert (fc.fused_ce_fwd.launches, fc.fused_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    rnll, rlse = fc.fused_ce_fwd_plain(x, w, s, t)
    rdx = fc.fused_ce_bwd_plain(x, w, s, t, rlse, cot)
    assert (nll - rnll).abs().max() <= 1e-3
    assert (lse - rlse).abs().max() <= 1e-3
    assert (dx.float() - rdx.float()).abs().max() <= \
        2e-2 * rdx.float().abs().max()
    assert (dx[::5] == 0).all()


@pytest.mark.cuda
def test_fused_ce_backward_across_its_tiles_on_card(card):
    """Kernel 9 where rows and vocab cut across its tiles (300 rows: two
    128-row blocks and a ragged third; V 1100: two 512-column spans and a
    ragged third, whose second 256-column stage is all padding), targets
    in every span: dx within 2% of max|plain| and exactly zero on the
    zero-cotangent rows."""
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops.quant import quantize_int8
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((300, 256), generator=g, device=card).bfloat16()
    head = quantize_int8(torch.randn((256, 1100), generator=g, device=card)
                         * 0.05)
    w, s = head["w_i8"], head["scale"].reshape(-1)
    t = torch.randint(0, 1100, (300,), generator=g, device=card)
    t[::3] = -100
    cot = torch.rand((300,), generator=g, device=card) * (t >= 0)
    lse = fc.fused_ce_fwd_plain(x, w, s, t)[1]
    dx = fc.fused_ce_bwd(x, w, s, t, lse, cot)
    ref = fc.fused_ce_bwd_plain(x, w, s, t, lse, cot)
    assert (dx.float() - ref.float()).abs().max() <= \
        2e-2 * ref.float().abs().max()
    assert (dx[::3] == 0).all()


@pytest.mark.cuda
def test_block_diag_kernel_matches_plain_on_card(card):
    """Kernel 10 against the plain einsum at bf16 and fp32 x, the gate's
    smallest block and a wider one: each element within one bf16 ulp
    (bf16) or 1e-5 of max|plain| (fp32); forward only."""
    from moka_tpu_torch.ops import fbd
    g = torch.Generator(device=card).manual_seed(4)
    for (z, n, b, m), dtype in (((1, 64, 8, 384), torch.bfloat16),
                                ((2, 3, 16, 256), torch.float32)):
        blocks = torch.randn((z, n, b, b), generator=g, device=card) * 0.3
        x = torch.randn((z, n * b, m), generator=g, device=card).to(dtype)
        before = fbd.block_diag_matmul.launches
        y = fbd.block_diag_matmul(blocks, x)
        assert fbd.block_diag_matmul.launches == before + 1
        ref = fbd.block_diag_matmul_plain(blocks, x).float()
        err = (y.float() - ref).abs()
        if dtype == torch.bfloat16:
            assert (err <= 2 ** -7 * ref.abs()).all()
        else:
            assert err.max() <= 1e-5 * ref.abs().max()
    blocks.requires_grad_(True)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        fbd.block_diag_matmul(blocks, x).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [4, 8, 16])
def test_rank_flash_kernels_match_plain_on_card(card, hd, causal):
    """The rank route's three kernels against the plain versions, fp32,
    one head, a ragged length and a sample that sees no key (random keys:
    the kernels visit every key, so its rows equal the plain mean), also
    causal with a query offset: out and lse to 1e-5, dq/dk/dv to 1e-4 of
    max|plain| (fp32 sums in another order)."""
    from moka_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(hd)
    b, L = 3, 133
    q, k, v, dout = (torch.randn((b, L, 1, hd), generator=g, device=card)
                     for _ in range(4))
    mask = torch.zeros((b, L), dtype=torch.int32, device=card)
    mask[0, 5:40] = 1
    mask[1, 100:133] = 1
    args = (3, True) if causal else (0, False)  # (q_offset, causal)
    launches = (fa.flash_rank_fwd.launches, fa.flash_rank_bwd_dq.launches,
                fa.flash_rank_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, mask, *args)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    dq = fa.flash_rank_bwd_dq(q, k, v, mask, dout, lse, delta, *args)
    dk, dv = fa.flash_rank_bwd_dkv(q, k, v, mask, dout, lse, delta, *args)
    assert (fa.flash_rank_fwd.launches, fa.flash_rank_bwd_dq.launches,
            fa.flash_rank_bwd_dkv.launches) == tuple(n + 1 for n in launches)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mask, *args)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    live = ref_lse > -1e29  # a dead row's lse is about -6.9e29
    assert (lse[live] - ref_lse[live]).abs().max() <= 1e-5 * \
        ref_lse[live].abs().max()
    assert torch.allclose(lse[~live], ref_lse[~live], rtol=1e-6, atol=0)
    for got, want in zip((dq, dk, dv), fa.flash_bwd_plain(
            q, k, v, mask, dout, lse, delta, *args)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert not dq[2].any()
