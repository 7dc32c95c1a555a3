"""Port package rules, the kernel loader's contract, and the kernels on the
card (marked ``cuda``: skipped where there is no card)."""

import ast
import dataclasses
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
    from moka_tpu_torch.adapters import prompt
    from moka_tpu_torch.cli import eval_vt, infer
    g = torch.Generator()
    cfg = LlamaConfig.tiny()
    for call in (lambda: llama.init_llama_params(g, cfg),
                 lambda: llama.init_moka_adapters(g, cfg, MokaSpec.avt()),
                 lambda: llama.init_kv_cache(cfg, 1, 8),
                 lambda: llama.init_kv_cache(cfg, 1, 8, quantized=True),
                 lambda: prompt.init_prefix(g, cfg, 2),
                 lambda: infer.main(["--model-preset", "tiny"]),
                 lambda: eval_vt.main(["--task", "seed",
                                       "--model-preset", "tiny"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert llama.init_kv_cache(cfg, 1, 8, device="cpu")["k"].shape == \
        (2, 1, 8, 2, 16)


def test_kernel_loader_builds_nothing_at_import(tmp_path):
    """Importing every port module touches no compiler: in a fresh process
    no subprocess starts and neither the CUDA kernels' loader nor the
    native fbank's (``native/``) holds a library.  The kernel loader names
    a source per kernel and keys the library by its content and that of
    the headers under csrc/ (checked on a copy: an edited header changes
    the key of every kernel, an edited source only its own); the native
    library goes to the same build directory, keyed by its source and
    flags."""
    import importlib
    import shutil
    import subprocess
    import sys
    from moka_tpu_torch import kernels, native
    for path in (ROOT / "moka_tpu_torch").rglob("*.py"):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
    assert kernels._libs == {}
    code = (
        "import importlib, pathlib, subprocess, sys\n"
        "started = []\n"
        "subprocess.Popen.__init__ = lambda self, *a, **k: started.append(a)"
        "\n"
        f"root = pathlib.Path({str(ROOT)!r})\n"
        "for p in sorted((root / 'moka_tpu_torch').rglob('*.py')):\n"
        "    mod = '.'.join(p.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        "from moka_tpu_torch import kernels, native\n"
        "print(started, kernels._libs, native._lib)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["[]", "{}", "None"]
    assert native.target().parent == kernels.BUILD_DIR
    assert native.target().name.startswith("libmoka_native-")
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


@pytest.mark.parametrize("table, src, marks", [
    ("CE_ABLATIONS", "fused_ce_bwd.cu",
     ("wgmma_m64n128_ss", "tma_reduce_add_4d")),
    ("CE_FWD_ABLATIONS", "fused_ce.cu",
     ("wgmma_m64n128_ss", "tma_load_4d_multicast"))])
def test_fused_ce_ablation_edits_apply(table, src, marks):
    """profile_port.py's kernel-9 and kernel-8 ablations and tile orders
    edit fused_ce_bwd.cu and fused_ce.cu by text: each edit must still find
    its text there (or in hopper.cuh), so each timed variant is the kernel
    with exactly that part taken out."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import profile_port
    base = profile_port.ablation_source([], kernels.CSRC, src)
    assert all(mark in base for mark in marks)
    ablations = getattr(profile_port, table)
    variants = set()
    for name, edits in ablations.items():
        edited = profile_port.ablation_source(edits, kernels.CSRC, src)
        assert (edited == base) == (not edits), name
        variants.add(edited)
    assert len(variants) == len(ablations)
    if table == "CE_FWD_ABLATIONS":  # and kernel 8's counted copy
        for old, _ in profile_port.CE_FWD_CLOCKS:
            assert base.count(old) == 1, old
    with pytest.raises(ValueError, match="no longer applies"):
        profile_port.ablation_source([("no such text", "")], kernels.CSRC,
                                     src)


@pytest.mark.parametrize("edits", ["RANK_ABLATIONS", "BD_ABLATIONS",
                                   "RANK_MUTANTS", "BD_MUTANTS",
                                   "RANK_BWD_ABLATIONS", "RANK_BWD_MUTANTS",
                                   "CE_FWD_MUTANTS"])
def test_rank_and_block_diag_edits_apply(edits):
    """The rank kernels', kernel 10's and kernel 8's edited copies
    (profile_port.py's ablations, chip_smoke.py's mutants, which phase 3
    requires to fail) edit their source by text: each old text must occur
    exactly once in flash_rank.cu, block_diag.cu or fused_ce.cu (hopper.cuh
    inlined), so each copy is the kernel with exactly that part changed,
    and no two are alike."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import profile_port
    table = getattr(profile_port if "ABLATIONS" in edits else chip_smoke,
                    edits)
    src = {"RANK": "flash_rank.cu", "BD": "block_diag.cu",
           "CE": "fused_ce.cu"}[edits.split("_")[0]]
    base = profile_port.ablation_source([], kernels.CSRC, src)
    variants = {base}
    for name, changes in table.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        edited = profile_port.ablation_source(changes, kernels.CSRC, src)
        assert (edited == base) == (not changes), name
        variants.add(edited)
    assert len(variants) == len(table) + (0 if "kernel" in table else 1)
    if edits == "CE_FWD_MUTANTS":
        assert chip_smoke.MUTANT_SOURCES["fused_ce"] == (src, table)


def test_moka_prefill_splits_the_wide_path():
    """profile_port.py's ``moka_prefill`` splits kernel 5's wide path by
    kernel name into its down product (A's split and the product), R1
    past head_dim 64 and its up product (the pass that forms buf and the
    product), for this design's kernels and the first design's (a parent
    checkout's), and leaves every other kernel out."""
    import sys
    sys.path.insert(0, str(ROOT))
    import profile_port
    ns = "void (anonymous namespace)::"
    names = {
        "down": [ns + "wide::split_kernel(float const*, __nv_bfloat16*, int, "
                 "int)", ns + "wide::gemm_kernel<false>(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::wide"
                 "::Args, int)", ns + "wide::moka_wide_kernel<__nv_bfloat16, "
                 "false>((anonymous namespace)::wide::Args)"],
        "up": [ns + "wide::prep_kernel((anonymous namespace)::wide::Args, "
               "__nv_bfloat16*, __nv_bfloat16*)", ns + "wide::gemm_kernel"
               "<true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
               "(anonymous namespace)::wide::Args, int)", ns + "wide::"
               "moka_wide_kernel<__nv_bfloat16, true>((anonymous namespace)"
               "::wide::Args)"],
        "R1": [ns + "flash_rank_fwd_wide<32>(float const*, float const*, "
               "float const*, int const*, float*, float*, int, int, int, int, "
               "int, float)", ns + "flash_rank_fwd_wide(float const*, float "
               "const*, float const*, int const*, float*, float*, int, int, "
               "int, int, int, float)"],
        None: [ns + "moka_delta_kernel<64, 3>(CUtensorMap_st)",
               ns + "flash_rank_fwd_kernel<64>(float const*)",
               "nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT"]}
    for part, keys in names.items():
        assert [profile_port.wide_part(k) for k in keys] == [part] * len(keys)
    assert profile_port.WIDE_PARTS == ("down", "R1", "up")


@pytest.mark.parametrize("edits", ["MOKA_ABLATIONS", "MOKA_MUTANTS"])
def test_moka_edits_apply(edits):
    """Kernel 5's edited copies (profile_port.py's ablations: the loads
    alone, no attention, no up product, the key pass alone, ...;
    chip_smoke.py's mutants, which phase 3 requires to fail) edit
    moka_delta_fwd.cu by text: each old text occurs exactly once
    (hopper.cuh inlined) and no two copies are alike."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import profile_port
    table = getattr(profile_port if "ABLATIONS" in edits else chip_smoke,
                    edits)
    src = "moka_delta_fwd.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    variants = {base}
    for name, changes in table.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        edited = profile_port.ablation_source(changes, kernels.CSRC, src)
        assert (edited == base) == (not changes), name
        variants.add(edited)
    assert len(variants) == len(table) + (0 if "kernel" in table else 1)
    assert chip_smoke.MUTANT_SOURCES["moka_delta_fwd"] == (
        src, chip_smoke.MOKA_MUTANTS)


@pytest.mark.parametrize("edits", ["DROP_ABLATIONS", "DROP_MUTANTS"])
def test_fused_dropout_edits_apply(edits):
    """Kernels 6-7's edited copies (profile_port.py's ablations: the loads
    alone, no stores, no generator; chip_smoke.py's mutants, which phase 3
    requires to fail) edit fused_dropout.cu by text: each old text occurs
    exactly once (hopper.cuh inlined) and no two copies are alike."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import profile_port
    table = getattr(profile_port if "ABLATIONS" in edits else chip_smoke,
                    edits)
    src = "fused_dropout.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    variants = {base}
    for name, changes in table.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        edited = profile_port.ablation_source(changes, kernels.CSRC, src)
        assert (edited == base) == (not changes), name
        variants.add(edited)
    assert len(variants) == len(table) + (0 if "kernel" in table else 1)
    assert chip_smoke.MUTANT_SOURCES["fused_dropout"] == (
        src, chip_smoke.DROP_MUTANTS)


def test_fused_dropout_source_contract():
    """Kernels 6-7's bf16-x path: the forward and the backward stream x by
    TMA into an mbarrier ring; the forward's product runs on wgmma
    (m64n32, M*r on the 64-row side, A^T's parts by TMA from a transpose
    pass, not transposed in every CTA), the backward's dA^T on wgmma
    (m64n64, both warpgroups, no branch around the products) and its dx
    as an fp32 FMA chain over M*r in the plain product's order, stored by
    TMA; the backward's CTA pairs add dA through distributed shared memory
    (a cluster of two), with no atomics and no workspace (the forward's
    only scratch is A^T's parts), and a second kernel only for dx past
    M*r 64 (the dx kernel, the same chain); M*r is a runtime width up to
    256, the widest the wrapper takes."""
    import re
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import fused_dropout as fd
    src = re.sub(r"//[^\n]*", "", (kernels.CSRC / "fused_dropout.cu")
                 .read_text())
    fwd = src[src.index("dropout_fwd_kernel(const __grid_constant__"):
              src.index("constexpr int BWD_COLS")]
    bwd = src[src.index("dropout_bwd_kernel(const __grid_constant__"):
              src.index("constexpr int F32_FWD_WARPS")]
    assert "&tm_x, full" in fwd and "&tm_at, full" in fwd
    assert "wgmma_m64nN_ss<FWD_ROWS>" in fwd and "mbar_wait(full" in fwd
    assert "transpose_a_kernel<TA><<<" in src and "transpose_a<" not in fwd
    assert "tma_load_4d(st, &tm_x" in bwd and "&tm_g, full" in bwd
    assert "wgmma_m64n64_ss<1, 1>" in bwd and "if (wg == 0) {" not in \
        bwd[:bwd.index("wgmma_commit()")]
    assert "acc[u][e] = fmaf(gj[u][jj], av[e], acc[u][e]);" in bwd
    assert "tma_store_4d(&tm_dx" in bwd and "map_shared_rank" in bwd
    assert "__cluster_dims__(1, 2, 1)" in src
    entry = src[src.index('"C" int moka_dropout_a_bwd('):]
    assert "atomic" not in src and "work" not in bwd + entry
    assert "sum_tiles" not in src and src.count("<<<") == 8
    takes = src[src.index("bool takes("):src.index("uint32_t bf16_pair(")]
    # no widest M*r: past 64 the kernels loop over tiles, dx over chunks
    assert "mr >= 1" in takes and "MAX_MR" not in src
    assert not hasattr(fd, "MAX_MR") and fd.fused_dropout_supported(1536, 8)
    dx = src[src.index("dropout_dx_kernel(const TA*"):
             src.index("bool takes(")]
    assert "DX_JC" in dx and "for (int ch = 0; ch < chunks; ++ch)" in dx


def test_moka_delta_source_contract():
    """Kernel 5's bf16 path: the down product on wgmma (m64nN, N = 2 M r,
    A's bf16 halves), x by TMA into an mbarrier ring and the delta out by
    TMA stores; the attention walks the row's n_q compacted keys (no
    question mask read in the main kernel); the key pass runs a fixed
    number of CTAs a row (at most KP_CTAS), not one a token; instances for
    ranks 4, 8, 16, 32 and 64 (``KERNEL_RANKS``), every rank up to 64
    padded to one of them, and past 64 the wide path (down product, R1,
    up product), no largest rank, as ``fused_moka_supported`` says; for
    bf16 x its two products run on wgmma fed by a TMA mbarrier ring
    (``gemm_kernel``: A's bf16 halves K-major for the down product, B's
    MN-major for the up product, the delta stored by TMA) after passes
    that split their operands into bf16 halves; fp32 x keeps the SIMT
    kernel."""
    import re
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import moka_pallas as mp
    src = re.sub(r"//[^\n]*", "", (kernels.CSRC / "moka_delta_fwd.cu")
                 .read_text())
    main = src[src.index("moka_delta_kernel(const __grid_constant__"):
               src.index("namespace f32")]
    assert "wgmma_m64nN_ss<C::NP>" in main and "wgmma_m64n64_rs<1>" in main
    assert "tma_load_4d(ring" in main and "tma_store_4d(&tm_out" in main
    assert "mbar_wait(full" in main and "a.qmask" not in main
    assert "kq < cn" in main and "a.nq[bi]" in main
    assert re.search(r"question_keys_kernel<T, R><<<dim3\(ctas, a\.nb\)",
                     src)
    assert int(re.search(r"constexpr int KP_CTAS = (\d+);", src)[1]) <= 32
    assert "dim3(a.L" not in src and "dim3(L" not in src
    for r in mp.KERNEL_RANKS:
        assert f"launch<{r}>(a, x_bf16, st)" in src
    assert mp.KERNEL_RANKS == (4, 8, 16, 32, 64) and \
        not hasattr(mp, "MAX_RANK")
    assert "moka_wide_kernel<UP>" in src and "moka_delta_keys" in src
    wide = src[src.index("gemm_kernel(const __grid_constant__"):
               src.index("int launch_gemm(")]
    assert "wgmma_m64nN_ss<GN>" in wide and "wgmma_m64n256_ss<1>" in wide
    assert "tma_load_4d(dst" in wide and "tma_store_4d(&tm_out" in wide
    assert "mbar_wait(full" in wide and "mbar_wait(empty" in wide
    assert "split_kernel<<<" in src and "prep_kernel<<<" in src
    assert "launch_gemm<false>(w, x, halves, st)" in src and \
        "launch_gemm<true>(w, bufs, bs, st)" in src
    assert [mp.kernel_rank(r) for r in (64, 65, 128, 129, 512)] == \
        [64, 128, 128, 192, 512]


def test_rank_and_block_diag_source_contract():
    """The rank forward walks keys straight from global memory (no shared
    staging, 16-byte loads, one __syncthreads for the span and one for
    V's sum); kernel 10 streams x by TMA through hopper.cuh's swizzled
    tensor map and mbarriers, with no atomics, and releases a stage only
    after a proxy fence."""
    import re
    from moka_tpu_torch import kernels
    rank = (kernels.CSRC / "flash_rank.cu").read_text()
    fwd = rank[rank.index("flash_rank_fwd_kernel(const float*"):
               rank.index("flash_rank_dq_kernel(const float*")]
    fwd = re.sub(r"//[^\n]*", "", fwd)
    assert "stage<" not in fwd and fwd.count("__syncthreads()") == 2
    assert "__reduce_min_sync" in fwd and "load_row<W>" in fwd
    bd = re.sub(r"//[^\n]*", "", (kernels.CSRC / "block_diag.cu")
                .read_text())
    assert "tma_load_4d" in bd and "swizzled_map" in bd
    assert "mbar_wait" in bd and "atomic" not in bd
    # each stage release follows a proxy fence: the warp's generic reads
    # of the stage are performed before the next TMA write into it
    releases = re.findall(r"(fence_proxy_async_smem\(\);\s*__syncwarp\(\);\s*"
                          r"if \(lane == 0\) mbar_arrive)|(mbar_arrive\()", bd)
    assert len(releases) == 2 and all(fenced for fenced, _ in releases)


def _kernel_body(src: str, name: str, end: str) -> str:
    """Kernel ``name``'s parameters and body in ``src``, up to ``end``."""
    return src[src.index(f"{name}(const float*"):src.index(end)]


def test_rank_backward_source_contract():
    """The rank backward walks only what the softmax needs: dq (R2) finds
    the sample's visible span (``visible_span``: one mask scan, warp
    reductions, one barrier) and walks it a warp a row, k and v straight
    from global memory; dk/dv (R3) stores the zeros of masked keys in CTAs
    that return before any scan, finds the span the same way and stages
    queries only for a block with a key to walk.  Neither stages all S
    keys (``stage<``), uses an atomic or takes a pointer beyond its inputs
    and outputs (no workspace)."""
    import re
    from moka_tpu_torch import kernels
    rank = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_rank.cu")
                  .read_text())
    span = rank[rank.index("int2 visible_span("):
                rank.index("flash_rank_fwd_kernel(const float*")]
    assert "__reduce_min_sync" in span and "__reduce_max_sync" in span
    assert span.count("__syncthreads()") == 1
    dq = _kernel_body(rank, "flash_rank_dq_kernel", "constexpr int BWD_KEYS")
    dkv = _kernel_body(rank, "flash_rank_dkv_kernel", "bool bad_dims(")
    for body, outs in ((dq, ["dq"]), (dkv, ["dk", "dv"])):
        assert "visible_span<" in body
        assert "stage<" not in body and "atomic" not in body
        params = body[:body.index("{")]
        assert re.findall(r"\*\s*__restrict__\s+(\w+)", params) == \
            ["q", "k", "v", "mask", "dout", "lse", "delta", *outs]
    assert "__syncthreads()" not in dq and "load_row<W>(k + " in dq
    assert "j0 = first + slot; j0 <= stop" in dq
    assert dkv.index("return;") < dkv.index("visible_span<")
    assert dkv.index("if (live == 0u) continue;") < dkv.index("q_sm)[e]")


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


def _const(src, name):
    import re
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_fused_ce_backward_source_contract():
    """Kernel 9's source: wgmma and TMA reductions, no atomics on dx, the
    head read as int8 codes (a UINT8 tensor map, no bf16 copy), and the
    vocab span the head is padded to (VOCAB_TILE)."""
    import re
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import fused_ce as fc
    bwd = (kernels.CSRC / "fused_ce_bwd.cu").read_text()
    fwd = (kernels.CSRC / "fused_ce.cu").read_text()
    code = re.sub(r"//[^\n]*", "", bwd)
    assert "atomicAdd" not in code and "tma_reduce_add_4d" in code
    assert "wgmma_m64n128_ss" in code and "wgmma_m64n64_rs" in code
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in code
    assert "fused_ce_bwd_kernel" not in fwd
    assert _const(bwd, "SPAN") == fc.VOCAB_TILE
    assert _const(bwd, "BK") == fc.K_TILE


def test_fused_ce_forward_source_contract():
    """Kernel 8's source (comments stripped): the logits on wgmma
    (m64n128 over shared-memory operands), each int8 head tile multicast
    by TMA to the two CTAs of a row pair within a thread-block cluster,
    the head read as int8 codes (a UINT8 tensor map, no bf16 copy), no
    mma.sync and no atomics; a CTA's vocab span divides the head's padding
    (VOCAB_TILE) and its d step is the wrappers' K_TILE."""
    import re
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import fused_ce as fc
    code = re.sub(r"//[^\n]*", "",
                  (kernels.CSRC / "fused_ce.cu").read_text())
    assert "wgmma_m64n128_ss" in code
    load_w8 = code[code.index("void load_w8("):code.index(" load_unit(")]
    assert "tma_load_4d_multicast" in load_w8
    assert _const(code, "ROW_PAIR") == 2
    assert "__cluster_dims__" in code or \
        "cudaLaunchAttributeClusterDimension" in code
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in code
    assert "mma_bf16" not in code and "atomicAdd" not in code
    assert fc.VOCAB_TILE % _const(code, "SPAN") == 0
    assert _const(code, "BK") == fc.K_TILE


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flavour", ["avt", "vt"])
@pytest.mark.parametrize("rank", [4, 8, 16])
def test_moka_kernel_matches_plain_on_card(card, rank, flavour, dtype):
    """Kernel 5 against its plain version at each rank it takes, AVT and
    VT, fp32 x (1e-4 of max|plain|) and bf16 x (1e-2: one bf16 ulp), a
    ragged L, a question mask with a gap and a row with no question."""
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    g = torch.Generator(device=card).manual_seed(0)
    make = MokaSpec.avt if flavour == "avt" else MokaSpec.vt
    spec = make(rank=rank, dropout_rate=0.0)
    M = spec.num_modalities
    x = torch.randn((2, 70, 256), generator=g, device=card).to(
        getattr(torch, dtype))
    a = torch.rand((M, 256, rank), generator=g, device=card) / \
        math.sqrt(256)
    bm = torch.randn((rank, 96), generator=g, device=card) * 0.1
    mod = torch.zeros((M, 2, 70), device=card)
    mod[0, :, :30], mod[1, :, 30:50], mod[M - 1, :, 50:] = 1, 1, 1
    qm = torch.zeros((2, 70), device=card)
    qm[0, 3:9], qm[0, 20] = 1, 1  # row 1 has no question
    got = moka_delta_fused(x, a, bm, mod, qm, spec)
    ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert (got.float() - ref.float()).abs().max() <= \
        tol * ref.float().abs().max()


@pytest.mark.cuda
def test_moka_kernel_at_the_vt_prefill_on_card(card, tmp_path):
    """Kernel 5 at the VT spec (M 2, the rank attention on the image
    modality) and the exact shape of chip_smoke's VT eval prefill (its
    8 MMBench prompts: b, L, left pads, text and image masks; LLaMA-2-7B's
    three projection shapes), on the batch's empty question mask and on
    one over the text after the image, against its plain version (1e-2 of
    max|plain|: one bf16 ulp)."""
    import sys
    from moka_tpu_torch.data.benchmarks import build_eval_batch
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    ds, tok = chip_smoke.vt_eval_data(tmp_path)
    batch = {k: torch.as_tensor(v, device=card) for k, v in
             build_eval_batch([ds[i] for i in range(len(ds))],
                              tok.as_tokenize(), 32).items()}
    b, L = batch["attn_mask"].shape
    assert b == 8 and (batch["attn_mask"] == 0).any()
    spec = MokaSpec.vt(rank=4, dropout_rate=0.0).with_bf16_dots()
    mod = torch.stack([batch["text_mask"], batch["image_mask"]]).float()
    after = torch.arange(L, device=card)[None] > batch["image_pos"][:, -1:]
    g = torch.Generator(device=card).manual_seed(0)
    for d_in, d_out in ((4096, 4096), (4096, 11008), (11008, 4096)):
        x = torch.randn((b, L, d_in), generator=g, device=card).bfloat16()
        a = torch.rand((2, d_in, 4), generator=g, device=card) / \
            math.sqrt(d_in)
        bm = torch.randn((4, d_out), generator=g, device=card) * 0.02
        for qm in (batch["question_mask"].float(),
                   (batch["text_mask"] * after).float()):
            before = moka_delta_fused.launches
            got = moka_delta_fused(x, a, bm, mod, qm, spec)
            assert moka_delta_fused.launches == before + 1
            ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
            assert (got.float() - ref.float()).abs().max() <= \
                1e-2 * ref.float().abs().max()


@pytest.mark.cuda
def test_fused_moka_route_on_card(card):
    """Adapter trees of ranks 8, 32 and 128 serve on the card through
    ``greedy_generate``'s defaults, which take kernel 5 at every rank; a
    forced fused delta raises only on a spec kernel 5 still refuses (five
    modalities, or d_in not a multiple of 8)."""
    import dataclasses
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.eval.decode import greedy_generate
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
    cfg = LlamaConfig.tiny()
    g = torch.Generator(device=card).manual_seed(0)
    base = llama.init_llama_params(g, cfg, device=card)
    b, L = 2, 40
    embeds = torch.randn((b, L, cfg.dim), generator=g,
                         device=card).bfloat16()
    mod = torch.zeros((3, b, L), device=card)
    mod[0, :, :20], mod[1, :, 20:30], mod[2, :, 30:] = 1, 1, 1
    qm = torch.zeros((b, L), device=card)
    qm[:, 2:10] = 1
    kw = dict(cfg=cfg, inputs_embeds=embeds,
              prompt_mask=torch.ones((b, L), device=card),
              masks=llama.MaskBundle(mod, qm), max_new_tokens=3, eos_id=-1,
              use_flash=False)  # tiny head_dim 16: no flash kernel
    for rank in (8, 32, 128):
        spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
        adapters = llama.init_moka_adapters(g, cfg, spec, device=card)
        counters = ("launches", "wide_down_launches", "wide_up_launches")
        for name in counters:
            setattr(moka_delta_fused, name, 0)
        toks = greedy_generate(base, adapters, spec=spec, **kw)
        assert toks.shape == (b, 3)
        calls = 7 * cfg.n_layers  # past rank 64: the wide path's two
        want = (0, calls, calls) if rank > 64 else (calls, 0, 0)
        assert tuple(getattr(moka_delta_fused, n) for n in counters) == want
    five = dataclasses.replace(spec, num_modalities=5)
    x = torch.randn((b, L, 12), device=card)
    a5 = torch.zeros((5, 12, 128), device=card)
    with pytest.raises(ValueError, match="modalities"):
        moka_delta_fused(x, a5, torch.zeros((128, 8), device=card),
                         torch.zeros((5, b, L), device=card), qm, five)
    with pytest.raises(ValueError, match="multiples of 8"):
        moka_delta_fused(x, a5[:3], torch.zeros((128, 8), device=card),
                         mod, qm, spec)


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
@pytest.mark.parametrize("mr", [4, 8, 12, 16, 24, 32, 48, 64])
def test_fused_dropout_kernels_at_each_width_on_card(card, mr):
    """Kernels 6 and 7 against their plain versions at every M*r they take,
    bf16 x with fp32 and bf16 A and fp32 x (a ragged N and d): the mask
    exact, out and fp32 dA to fp32 summation order (1e-4 of the largest),
    dx and a bf16 dA to one bf16 ulp; two calls bit-identical."""
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    g = torch.Generator(device=card).manual_seed(mr)
    n, d = 333, 200
    key = DropoutKey(mr)
    for xdt, adt in ((torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.float32)):
        x = torch.randn((n, d), generator=g, device=card).to(xdt)
        a = (torch.randn((d, mr), generator=g, device=card) * 0.05).to(adt)
        gout = torch.randn((n, mr), generator=g, device=card)
        out = fd.dropout_a_fwd(x, a, key, 0.05)
        dx, da = fd.dropout_a_bwd(x, a, gout, key, 0.05)
        again = fd.dropout_a_bwd(x, a, gout, key, 0.05)
        assert torch.equal(dx, again[0]) and torch.equal(da, again[1])
        ref = fd.dropout_a_fwd_plain(x, a, key, 0.05)
        rdx, rda = fd.dropout_a_bwd_plain(x, a, gout, key, 0.05)
        assert torch.equal(dx != 0, key.bits32((n, d), card) <
                           fd.threshold(0.05))
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
        assert ((dx.float() - rdx.float()).abs()
                <= 2 ** -7 * rdx.float().abs()).all()
        if adt == torch.float32:
            assert (da - rda).abs().max() <= 1e-4 * rda.abs().max()
        else:
            assert ((da.float() - rda.float()).abs()
                    <= 2 ** -7 * rda.float().abs() + 1e-6).all()


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
def test_fused_ce_forward_across_its_tiles_on_card(card):
    """Kernel 8 where rows and vocab cut across its clusters (300 rows:
    three 128-row blocks, so a cluster of two along the rows holds a CTA
    past the rows; V 1500: three 512-column spans) at d 64 (two stages,
    fewer than a ring holds), targets in every span: nll and lse within
    1e-3 of the plain version, and 20 more launches bit-identical to the
    first."""
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops.quant import quantize_int8
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.randn((300, 64), generator=g, device=card).bfloat16()
    head = quantize_int8(torch.randn((64, 1500), generator=g, device=card))
    w, s = head["w_i8"], head["scale"].reshape(-1)
    t = torch.randint(0, 1500, (300,), generator=g, device=card)
    t[::7] = -100
    nll, lse = fc.fused_ce_fwd(x, w, s, t)
    rnll, rlse = fc.fused_ce_fwd_plain(x, w, s, t)
    assert (nll - rnll).abs().max() <= 1e-3
    assert (lse - rlse).abs().max() <= 1e-3
    for _ in range(20):
        again = fc.fused_ce_fwd(x, w, s, t)
        assert torch.equal(again[0], nll) and torch.equal(again[1], lse)


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
    one head, a ragged length, a hole inside a span and a sample that sees
    no key (random keys: its rows equal the plain mean), also causal with
    a query offset: out and lse to 1e-5, dq/dk/dv to 1e-4 of max|plain|
    (fp32 sums in another order), and exactly 0 where no pair is seen: dq
    on a row that sees no key, dk and dv on a key no query sees."""
    from moka_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(hd)
    b, L = 3, 133
    q, k, v, dout = (torch.randn((b, L, 1, hd), generator=g, device=card)
                     for _ in range(4))
    mask = torch.zeros((b, L), dtype=torch.int32, device=card)
    mask[0, 5:40] = 1
    mask[0, 20] = 0
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
    seen = fa._valid(mask, L, L, *args)  # (b, L, S)
    assert not dq[~seen.any(dim=-1)].any()
    assert not dk[~seen.any(dim=1)].any() and not dv[~seen.any(dim=1)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [128, 512])
def test_rank_wide_forward_matches_plain_on_card(card, hd, causal):
    """R1 past head_dim 64 (each visible score once, the output in
    registers) against the plain version: a span of 700 keys with a hole
    (six 128-key tiles), a sample with a short span at the end and one
    with no visible key (random keys: its rows are the plain mean of V),
    a ragged L, also causal with a query offset (rows before the first
    visible key see none): out and lse to 1e-5 of max|plain| (fp32 sums
    in another order), and a second launch bit-identical."""
    from moka_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(hd)
    b, L = 3, 901
    q, k, v = (torch.randn((b, L, 1, hd), generator=g, device=card)
               for _ in range(3))
    mask = torch.zeros((b, L), dtype=torch.int32, device=card)
    mask[0, 100:800] = 1
    mask[0, 300] = 0
    mask[1, 850:901] = 1
    args = (3, True) if causal else (0, False)  # (q_offset, causal)
    before = fa.flash_rank_fwd.launches
    out, lse = fa.flash_rank_fwd(q, k, v, mask, *args)
    again = fa.flash_rank_fwd(q, k, v, mask, *args)
    assert fa.flash_rank_fwd.launches == before + 2
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mask, *args)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    live = ref_lse > -1e29  # a dead row's lse is about -6.9e29
    assert (~live).any() and live.any()
    assert (lse[live] - ref_lse[live]).abs().max() <= 1e-5 * \
        ref_lse[live].abs().max()
    assert torch.allclose(lse[~live], ref_lse[~live], rtol=1e-6, atol=0)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [128, 512])
def test_moka_wide_path_matches_plain_on_card(card, rank):
    """Kernel 5's wide path (past rank 64: the down product, R1 a stream,
    the up product; bf16 x on the tensor cores) against its plain
    version: AVT (three modalities) and four modalities with three
    attending, a question span of 700 keys in the first row and none in
    the second, d_out not a multiple of 64; 1e-2 of max|plain| (one bf16
    ulp).  A call is one down and one up launch and R1 once a stream."""
    from moka_tpu_torch.ops import flash_attention as fa
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    g = torch.Generator(device=card).manual_seed(rank)
    b, L, d_in, d_out = 2, 900, 1024, 1032
    for bounds in ((0, 450, 675, 900), (0, 450, 600, 750, 900)):
        M = len(bounds) - 1
        spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
        spec = dataclasses.replace(spec, num_modalities=M,
                                   attn_modalities=tuple(range(1, M)))
        x = torch.randn((b, L, d_in), generator=g, device=card).bfloat16()
        a = (torch.rand((M, d_in, rank), generator=g, device=card) * 2 -
             1) / math.sqrt(d_in)
        bm = torch.randn((rank, d_out), generator=g, device=card) * 0.02
        mod = torch.zeros((M, b, L), device=card)
        for m in range(M):
            mod[m, :, bounds[m]:bounds[m + 1]] = 1
        qm = torch.zeros((b, L), device=card)
        qm[0, 100:800] = 1  # row 1 has no question
        counts = (moka_delta_fused.wide_down_launches,
                  moka_delta_fused.wide_up_launches,
                  fa.flash_rank_fwd.launches)
        got = moka_delta_fused(x, a, bm, mod, qm, spec)
        assert (moka_delta_fused.wide_down_launches,
                moka_delta_fused.wide_up_launches,
                fa.flash_rank_fwd.launches) == \
            (counts[0] + 1, counts[1] + 1, counts[2] + M - 1)
        ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
        assert (got.float() - ref.float()).abs().max() <= \
            1e-2 * ref.float().abs().max()


def test_decode_mutant_edits_apply():
    """The decode kernel's mutants (chip_smoke.py's DECODE_MUTANTS, which
    phase 3 requires to fail) edit paged_decode.cu by text: each old text
    occurs exactly once and the copy differs; the merge's mutants are
    among them."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import profile_port
    src = "paged_decode.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    for name, changes in chip_smoke.DECODE_MUTANTS.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        assert profile_port.ablation_source(changes, kernels.CSRC,
                                            src) != base
    assert chip_smoke.MUTANT_SOURCES["paged_decode"] == (
        src, chip_smoke.DECODE_MUTANTS)
    assert set(chip_smoke.DECODE_MERGE_MUTANTS) < set(
        chip_smoke.DECODE_MUTANTS)


def test_decode_ablation_edits_apply():
    """profile_port.py's DECODE_ABLATIONS edit paged_decode.cu by text:
    each old text occurs exactly once and each copy differs."""
    import sys
    from moka_tpu_torch import kernels
    sys.path.insert(0, str(ROOT))
    import profile_port
    src = "paged_decode.cu"
    base = profile_port.ablation_source([], kernels.CSRC, src)
    for name, changes in profile_port.DECODE_ABLATIONS.items():
        for old, _ in changes:
            assert base.count(old) == 1, (name, old)
        assert (profile_port.ablation_source(changes, kernels.CSRC, src)
                != base) == bool(changes)


def test_decode_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: fp32 q,
    head_dim 64, GQA above 8:1, an int64 mask and a length past the cache
    raise before any launch (the library is never loaded)."""
    from moka_tpu_torch.ops import paged_decode as pd
    monkeypatch.setattr(pd, "_library", lambda: pytest.fail("launched"))

    def case(hd=128, H=8, K=2, dtype=torch.bfloat16, mask=torch.int32,
             length=10):
        q = torch.zeros((2, 1, H, hd), dtype=dtype)
        cache = torch.zeros((1, 2, 16, K, hd), dtype=torch.bfloat16)
        return (q, cache, cache.clone(), torch.ones((2, 16), dtype=mask), 0,
                length)

    for kw, err in ((dict(dtype=torch.float32), TypeError),
                    (dict(hd=64), ValueError), (dict(H=18, K=2), ValueError),
                    (dict(mask=torch.int64), TypeError),
                    (dict(length=17), ValueError)):
        with pytest.raises(err):
            pd._launch(*case(**kw))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,K,length", [(8, 8, 300), (16, 2, 100),
                                        (8, 8, 1025)])
def test_decode_kernel_matches_plain_on_card(card, quantized, H, K, length):
    """The decode kernel against ``paged_decode_attention_plain`` on a bf16
    and an int8 cache: 5, 2 and 17 64-key tiles (the last holding one
    key), each pair's keys in several spans on an H100 (5, 2 and 9), GQA
    8:1, left pads, a row without keys (out 0) and a poisoned tail; kernel
    1's rule (4e-3 + 2^-7 |plain|), one launch counted."""
    from moka_tpu_torch.models.llama import _kv_quantize
    from moka_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_plain)
    g = torch.Generator(device=card).manual_seed(H + length)
    B, S = 3, max(512, -(-(length + 1) // 256) * 256)
    q = torch.randn((B, 1, H, 128), generator=g, device=card).bfloat16()
    k, v = (torch.randn((2, B, S, K, 128), generator=g, device=card)
            for _ in range(2))
    k[:, :, length:], v[:, :, length:] = 1e6, -1e6
    mask = torch.ones((B, S), dtype=torch.int32, device=card)
    mask[1, :7] = 0
    mask[2] = 0
    if quantized:
        (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
        ck, cv = {"q": kq, "s": ks}, {"q": vq, "s": vs}
    else:
        ck, cv = k.bfloat16(), v.bfloat16()
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, ck, cv, mask, 1, length)
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q, ck, cv, mask, 1, length)
    assert ((out[:2].float() - ref[:2].float()).abs() -
            2 ** -7 * ref[:2].float().abs()).max() <= 4e-3
    assert not out[2].any() and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["batch", "sequence"])
@pytest.mark.parametrize("xdt", ["bf16", "fp32"])
def test_fused_dropout_kernels_at_a_ranks_rows_on_card(card, split, xdt):
    """Kernels 6 and 7 on one rank's rows of a split array, with the key's
    row map: the masks of the whole array's rows exactly, out to fp32
    summation order and dx to one bf16 ulp of both the whole array's
    rows and the plain versions at the same rows."""
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    g = torch.Generator(device=card).manual_seed(5)
    B, L, d, mr = 3, 100, 200, 12
    dt = torch.bfloat16 if xdt == "bf16" else torch.float32
    x = torch.randn((B, L, d), generator=g, device=card).to(dt)
    a = torch.randn((d, mr), generator=g, device=card) * 0.05
    gout = torch.randn((B, L, mr), generator=g, device=card)
    key = DropoutKey(9)
    whole = fd.dropout_a_fwd(x.reshape(-1, d), a, key, 0.05)
    wdx, _ = fd.dropout_a_bwd(x.reshape(-1, d), a, gout.reshape(-1, mr),
                              key, 0.05)
    idx, view = ((slice(1, 3),), (0, 1, B)) if split == "batch" else \
        ((slice(None), slice(40, 100)), (1, 40, L))
    xl = x[idx].reshape(-1, d).contiguous()
    gl = gout[idx].reshape(-1, mr).contiguous()
    rk = key.rows(*view)
    rows = rk.row_map(x[idx].shape)
    out = fd.dropout_a_fwd(xl, a, rk, 0.05, rows=rows)
    dx, _ = fd.dropout_a_bwd(xl, a, gl, rk, 0.05, rows=rows)
    want = whole.reshape(B, L, mr)[idx].reshape(-1, mr)
    wantdx = wdx.reshape(B, L, d)[idx].reshape(-1, d)
    ref = fd.dropout_a_fwd_plain(xl, a, rk, 0.05, rows=rows)
    rdx, _ = fd.dropout_a_bwd_plain(xl, a, gl, rk, 0.05, rows=rows)
    assert torch.equal(dx != 0, wantdx != 0)
    assert torch.equal(dx != 0, rdx != 0)
    for w in (want, ref):
        assert (out - w).abs().max() <= 1e-4 * w.abs().max()
    for w in (wantdx, rdx):
        assert ((dx.float() - w.float()).abs()
                <= 2 ** -7 * w.float().abs()).all()
