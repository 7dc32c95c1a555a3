"""The port's three training CLIs (``cli/{finetune,train_vt,pretrain}.py``)
at tiny size on the CPU, from checkpoint files to exported artifacts, and
the JAX package reading those artifacts back.

The life cycle is ``chip_smoke.py``'s phase 15 run at the CLIs' tiny
preset with ``--device cpu`` (its rehearsal), then phase 16 (inference
from those files) likewise: LLaMA, CLIP and BEATs
checkpoints written from a seed in bf16 and read back exactly by every
importer; ``finetune`` with the AVT shipping flags for 3 steps, a second
invocation that resumes from step 3, and the step-2 checkpoint stepped on
batch 3 to the uninterrupted step-3 loss; ``train_vt`` with the VT
shipping flags; ``pretrain --branch visual`` (the JAX driver hard-codes
``avt_7b``; here that preset is the tiny config).  The JAX importers must
read the port's ``adapter_model.bin``, ``non_lora_trainables.bin`` and
``model.safetensors`` back to the port's final parameters exactly.
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JLlamaConfig
from moka_tpu.models import unified as junified
from moka_tpu.models.llava import LlavaConfig as JLlavaConfig
from moka_tpu.train import import_torch as jimp
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import unified

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 32011  # the SentencePiece model's 32000 pieces + 11 special tokens


@contextlib.contextmanager
def one_thread():
    """One torch and one BLAS thread.  These runs are many small ops: in
    the parallel test run (a worker on every core) idle intra-op threads
    spin against the other workers' (the life cycle beside 7 busy
    processes: 174 s with torch's default threads, 31 s with one, 12 s
    alone)."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    return cs


@pytest.fixture(scope="module")
def life_cycle(chip_smoke, tmp_path_factory):
    def tiny_avt(vocab_size=VOCAB, spec=None):
        t = unified.UnifiedConfig.tiny(spec)
        return dataclasses.replace(t, llama=LlamaConfig.tiny(
            vocab_size=vocab_size))

    work = tmp_path_factory.mktemp("p15")
    with one_thread(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(unified.UnifiedConfig, "avt_7b", staticmethod(tiny_avt))
        res = chip_smoke.phase15(work, device="cpu", tiny=True)
        # phase 16 runs on phase 15's files, as on the card
        res["p16"] = chip_smoke.phase16(work, res, device="cpu", tiny=True)
        res["p19"] = chip_smoke.p19_cli(work, res, device="cpu")
        return res


def _same(got, want, path=""):
    """Port tensors against a JAX tree carried over: exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


def _jax(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def test_life_cycle_runs(life_cycle):
    res = life_cycle
    assert res["format"] == "safetensors"
    assert res["resume_parity"]["abs_diff"] == 0.0
    assert "[trainer] resumed from step 3" in \
        res["finetune_resumed"]["stdout"]
    for cli, steps in (("finetune", 3), ("finetune_resumed", 3),
                       ("train_vt", 3), ("pretrain", 2)):
        rec = res[cli]
        assert rec["steps"] == steps and np.all(np.isfinite(rec["losses"]))
        assert rec["import_s"] is not None
        assert not any(rec["launches_per_step"].values())  # the CPU


def test_finetune_artifacts_read_back_by_jax(life_cycle):
    out = life_cycle["finetune_out"]
    params = life_cycle["finetune_resumed_params"]
    jcfg = JLlamaConfig.tiny(vocab_size=VOCAB)
    sd = jimp.load_torch(str(out / "adapter_model.bin"))
    _same(params["adapters"],
          _jax(jimp.import_moka_adapters_avt(sd, jcfg, 3, 4)))
    sd = jimp.load_torch(str(out / "non_lora_trainables.bin"))
    assert all(k.startswith("base_model.model.model.") for k in sd)
    ucfg = junified.UnifiedConfig.tiny()
    for key, kind in (("vl_projector", "visual"), ("al_projector", "audio")):
        back = jimp.import_projector(jimp.strip_to_submodule(sd, f"{key}."),
                                     getattr(ucfg, key), kind=kind)
        _same(params[key], _jax(back), key)


def test_train_vt_safetensors_read_back_by_jax(life_cycle):
    out = life_cycle["train_vt_out"]
    params = life_cycle["train_vt_params"]
    jcfg = JLlavaConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llama=JLlamaConfig.tiny(
        vocab_size=VOCAB))
    sd = jimp.load_torch(str(out / "model.safetensors"))  # safetensors.numpy
    back = jimp.import_vt_trainable(sd, jcfg, {})
    _same(params, _jax(back))


def test_pretrain_stage1_artifacts_read_back_by_jax(life_cycle):
    out = life_cycle["pretrain_out"]
    params = life_cycle["pretrain_params"]
    sd = jimp.load_torch(str(out / "non_lora_trainables.bin"))
    assert all(k.startswith("model.") for k in sd)
    assert not (out / "adapter_model.bin").exists()
    ucfg = junified.UnifiedConfig.tiny()
    for key, kind in (("vl_projector", "visual"), ("al_projector", "audio")):
        back = jimp.import_projector(jimp.strip_to_submodule(sd, f"{key}."),
                                     getattr(ucfg, key), kind=kind)
        _same(params[key], _jax(back), key)


def _tiny_assets(life_cycle):
    data = life_cycle["finetune_out"].parent / "data"
    return data / "tokenizer.model", data / "avqa.json"


def test_finetune_loftq_quantized(life_cycle, tmp_path):
    """--quantize-base 4 --loftq-iters 2 on the tiny random base: LoftQ
    adapters (B non-zero at step 0) train and export."""
    from moka_tpu_torch.cli.finetune import main
    tok, ann = _tiny_assets(life_cycle)
    with one_thread():
        trainer, _ = main(["--tokenizer-json", str(tok),
                           "--avqa-annotation", str(ann),
                           "--output-dir", str(tmp_path / "run"),
                           "--model-preset", "tiny", "--global-batch", "4",
                           "--epochs", "1", "--pad-to", "256",
                           "--quantize-base", "4", "--loftq-iters", "2",
                           "--device", "cpu"])
    assert trainer.state.step == 3
    sd = torch.load(tmp_path / "run" / "adapter_model.bin",
                    weights_only=True)
    b_keys = [k for k in sd if ".lora_B0.weight" in k]
    assert b_keys and any(float(sd[k].abs().max()) > 0 for k in b_keys)
    q = trainer.frozen["llama"]["layers"]["q"]
    assert set(q) == {"w_i4", "scale"}


@pytest.mark.parametrize("cli,extra", [
    ("finetune", ["--mesh", "1,2,1"]), ("finetune", ["--host-offload"]),
    ("train_vt", ["--mesh", "2,1,1"]), ("train_vt", ["--host-offload"]),
    ("pretrain", ["--mesh", "1,1,2"])])
def test_parallelism_flags_refused(cli, extra, tmp_path):
    """What one process refuses: a mesh of two devices, on the data, fsdp
    or model axis (JAX's ``make_mesh`` refuses sizes that are not the
    device count).  ``--host-offload`` is taken: the run gets past the
    parallel setup to the missing tokenizer file (the CLIs run with it in
    ``tests/test_torch_phase17.py``, and with a model axis in
    ``tests/test_torch_tp.py``)."""
    import importlib
    main = importlib.import_module(f"moka_tpu_torch.cli.{cli}").main
    argv = extra + ["--device", "cpu", "--tokenizer-json",
                    str(tmp_path / "missing.json")]
    if extra[0] == "--host-offload":
        # the tokenizers library's own error for a missing file
        with pytest.raises(Exception, match="No such file or directory"):
            main(argv)
    else:
        with pytest.raises(ValueError, match="wants 2 devices, have 1"):
            main(argv)


def test_one_device_meshes_accepted():
    from moka_tpu_torch.cli.finetune import make_mesh_from_flag, \
        mesh_from_flag
    for flag in ("fsdp", "data", "1,1,1"):
        assert mesh_from_flag(flag).num_devices == 1
        assert make_mesh_from_flag(flag) is None  # one process: no mesh


def test_objectives_name_the_parallelism_item():
    """The objectives take ``context_parallel`` and ``host_stream``; a
    sequence ring combined with a data-parallel mesh raises.  The model
    axis is placed as JAX's rules place it: the lm_head over (fsdp,
    model), the column- and row-parallel projections of a tiny tree on a
    (1, 1, 2) mesh, leaf by leaf against JAX's ``param_shardings``."""
    import jax
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.core.config import MeshConfig as JMesh
    from moka_tpu.models.llama import init_llama_params as j_init
    from moka_tpu.parallel.mesh import make_mesh
    from moka_tpu.parallel.sharding import param_shardings
    from moka_tpu_torch.core.config import MeshConfig
    from moka_tpu_torch.models.llama import init_llama_params
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.parallel import sharding
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    for kw in ({"context_parallel": object()}, {"host_stream": {}}):
        make_llama_moka_loss(LlamaConfig.tiny(), MokaSpec.avt(), **kw)
    with pytest.raises(ValueError, match="do not combine"):
        make_llama_moka_loss(LlamaConfig.tiny(), MokaSpec.avt(),
                             context_parallel=object(), mesh=object())
    assert sharding.param_shardings(MeshConfig(1, 1, 2), {
        "lm_head": torch.zeros((8, 4))})["lm_head"].spec == ("fsdp", "model")
    mesh = make_mesh(JMesh(1, 1, 2), devices=jax.devices()[:2])
    want = param_shardings(mesh, jax.eval_shape(
        lambda: j_init(jax.random.key(0), JCfg.tiny())))
    got = sharding.param_shardings(MeshConfig(1, 1, 2), init_llama_params(
        torch.Generator().manual_seed(0), LlamaConfig.tiny(), device="cpu"))
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert got["layers"][name].spec == \
            tuple(want["layers"][name].spec), name
    assert got["lm_head"].spec == tuple(want["lm_head"].spec)


def test_cli_flags_match_jax():
    """The same flags with the same defaults, plus ``--device``."""
    import importlib
    for cli in ("finetune", "train_vt", "pretrain"):
        tp = importlib.import_module(
            f"moka_tpu_torch.cli.{cli}").build_argparser()
        jp = importlib.import_module(f"moka_tpu.cli.{cli}").build_argparser()
        tacts = {a.dest: a for a in tp._actions}
        jacts = {a.dest: a for a in jp._actions}
        assert set(tacts) - set(jacts) == {"device"}, cli
        assert tacts["device"].default == "cuda"
        for dest, a in jacts.items():
            b = tacts[dest]
            assert (b.default, b.const, b.choices, b.nargs, b.type) == \
                (a.default, a.const, a.choices, a.nargs, a.type), (cli, dest)


def test_phase16_rehearsal_runs(life_cycle):
    """chip_smoke's phase 16 at the CLIs' tiny preset on phase 15's files:
    ``infer`` with a bf16 and an int8 cache (12 items in 2 generate calls,
    no launch on the CPU, each JSONL scored), the continuous server in a
    process of its own answering 200, ``eval_vt`` on ``train_vt``'s
    ``model.safetensors`` scoring all 8 MMBench items, and the decode step
    timed eager and paged."""
    res = life_cycle["p16"]
    for kind in ("bf16", "int8"):
        rec = res[f"infer_{kind}"]
        assert len(rec["predictions"]) == 12 and "overall" in rec["scores"]
        assert len(rec["generate_s"]) == 2
        assert not any(rec["launches_per_generate"].values())
    assert res["serve"]["statuses"] == [200, 200, 200]
    assert res["eval_vt"]["result"]["total"] == 8
    for kind in ("bf16", "int8"):
        gate = res["paged_gate"][kind]
        assert {"eager_ms", "paged_ms"} <= set(gate["by_capacity"][256])
        assert gate["pairings"] == 2 and gate["paged"] == (
            2 * gate["paged_won"] > 2)


def test_phase19_cli_rehearsal_runs(life_cycle):
    """chip_smoke's phase 19 (d) at the CLIs' tiny preset on phase 15's
    files: ``infer --lora-r 32`` with the rank-32 adapter files the phase
    writes, on 4 AVQA items in one generate call (no launch on the CPU)."""
    res = life_cycle["p19"]
    assert res["rank"] == 32 and res["rows"] == 4
    assert not any(res["launches_per_generate"].values())
