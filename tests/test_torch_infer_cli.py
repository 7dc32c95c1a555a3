"""Port parity: the inference CLIs (``cli/{infer,eval_vt,score}.py``)
against the JAX package's on the CPU.  (``chip_smoke.py``'s phase 16 is
rehearsed in ``test_torch_cli.py``, on the files of its phase 15 run.)

``infer``: the tiny world of ``tests/test_cli_e2e.py`` (a WordLevel
``tokenizer.json``, an MJPG ``.avi``, a 60 s ``.wav``, AVQA items) with
``adapter_model.bin`` and ``non_lora_trainables.bin`` exported from a
seeded tree.  The frozen towers come from ``init_frozen`` in both CLIs
(no checkpoint), and the two packages draw different numbers from one
seed, so both packages' ``init_frozen`` / ``init_trainable`` return the
same fp32 trees here.  ``eval_vt``: the synthetic SEED set of
``tests/test_vt_import_and_benchmarks.py``.  ``score``: both packages'
scorers on the files written.  ``make_serve_generate_fn``:
``tests/test_serve_sampling.py``'s behaviours, and its greedy texts.
Tolerance: exact throughout (greedy tokens of fp32 models, the same text
and JSON).  The CLI runs hold torch and BLAS to one thread
(``test_torch_cli.one_thread``).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.cli import eval_vt as jeval_vt
from moka_tpu.cli import infer as jinfer
from moka_tpu.cli import score as jscore
from moka_tpu.models import llava as jllava
from moka_tpu.models import unified as junified
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu_torch.cli import eval_vt, infer, score
from moka_tpu_torch.data.tokenizer import load_tokenizer
from moka_tpu_torch.models import llava, unified
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train.checkpoint import export_torch_artifacts
from tests.test_torch_cli import one_thread

WORDS = ("this is a video audio please answer the question how many "
         "instruments two [INST] [/INST] <<SYS>> you are helpful assistant "
         ". : ? <answer> </answer> an image what color options with option "
         "letter ( ) b c d 1 2 3 4 ▁ are there")


def _tokenizer(path: Path) -> str:
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for w in WORDS.split():
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))
    return str(path)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.numpy()
    return tree


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, _np_tree(tree))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)) if isinstance(
        tree, np.ndarray) else tree


def _same_trees(mp, jmod, tmod, frozen: dict, trainable: dict):
    """Both packages' ``init_frozen`` / ``init_trainable`` return these
    trees (fresh copies each call)."""
    mp.setattr(jmod, "init_frozen", lambda *a, **k: _jax_tree(frozen))
    mp.setattr(jmod, "init_trainable", lambda *a, **k: _jax_tree(trainable))
    mp.setattr(tmod, "init_frozen", lambda *a, **k: _torch_tree(
        _np_tree(frozen)))
    mp.setattr(tmod, "init_trainable", lambda *a, **k: _torch_tree(
        _np_tree(trainable)))


def _seeded(trainable: dict, g) -> dict:
    for p in trainable["adapters"]["layers"].values():
        p["b"].normal_(0.0, 0.05, generator=g)
    return trainable


@pytest.fixture(scope="module")
def avt_world(tmp_path_factory):
    """test_cli_e2e's tiny world, the tiny config at its vocabulary, fp32
    trees from a seed and the artifacts exported from them."""
    import cv2
    from scipy.io import wavfile
    tmp = tmp_path_factory.mktemp("avt")
    tok_path = _tokenizer(tmp / "tokenizer.json")
    rng = np.random.default_rng(0)
    vid = str(tmp / "v.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 5, (32, 32))
    for _ in range(8):
        w.write(rng.integers(0, 255, (32, 32, 3), np.uint8))
    w.release()
    wav = str(tmp / "a.wav")
    wavfile.write(wav, 16000,
                  (rng.standard_normal(16000 * 60) * 3000).astype(np.int16))
    ann = [{"video_id": f"v{i}", "question_id": i,
            "type": ["Audio", "Counting"], "video_path": vid,
            "audio_path": wav, "question": "how many instruments ?",
            "answer": "two", "label": "<answer> two </answer>"}
           for i in range(4)]
    (tmp / "avqa.json").write_text(json.dumps(ann))
    tok = load_tokenizer(tok_path)
    base = unified.UnifiedConfig.tiny(MokaSpec.avt(rank=4, dropout_rate=0.0))
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, vocab_size=max(tok.vocab_size, base.llama.vocab_size)))
    g = torch.Generator().manual_seed(3)
    frozen = unified.init_frozen(g, cfg, device="cpu", dtype=torch.float32)
    trainable = _seeded(unified.init_trainable(g, cfg, device="cpu"), g)
    export_torch_artifacts(str(tmp / "run"), trainable)
    blank = unified.init_trainable(torch.Generator().manual_seed(4), cfg,
                                   device="cpu")
    return {"tok": tok_path, "ann": str(tmp / "avqa.json"), "dir": tmp,
            "frozen": frozen, "blank": blank, "cfg": cfg}


def _infer_argv(w, out: str) -> list:
    run = w["dir"] / "run"
    return ["--tokenizer-json", w["tok"], "--annotation", w["ann"],
            "--adapter-ckpt", str(run / "adapter_model.bin"),
            "--non-lora-ckpt", str(run / "non_lora_trainables.bin"),
            "--output-dir", out, "--model-preset", "tiny", "--task", "avqa",
            "--batch-size", "2", "--max-new-tokens", "4", "--pad-to", "128"]


@pytest.fixture(scope="module")
def infer_rows(avt_world):
    """Both packages' ``infer`` on the tiny world: {"jax", "port"} -> the
    rank's JSONL path."""
    w = avt_world
    out = {}
    with pytest.MonkeyPatch.context() as mp, one_thread():
        # the artifacts must be what sets the trainable tree
        _same_trees(mp, junified, unified, w["frozen"], w["blank"])
        jinfer.main(_infer_argv(w, str(w["dir"] / "jax")))
        out["port"] = infer.main(_infer_argv(w, str(w["dir"] / "port")) +
                                 ["--device", "cpu"])
    out["jax"] = str(w["dir"] / "jax" / "result_rank0_avqa.jsonl")
    return out


def _rows(path) -> list:
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def test_infer_predictions_match_jax(infer_rows):
    got, want = _rows(infer_rows["port"]), _rows(infer_rows["jax"])
    assert len(got) == 4 and got == want
    assert all("predict" in r and "question_type" in r for r in got)


def test_score_matches_jax(infer_rows, capsys):
    for path in (infer_rows["port"], infer_rows["jax"]):
        assert score.main(["--task", "avqa", "--path", path]) == \
            jscore.main(["--task", "avqa", "--path", path])
    merged = score.main(["--task", "avqa", "--merge-dir",
                         str(Path(infer_rows["port"]).parent)])
    assert merged == jscore.main(["--task", "avqa", "--path",
                                  infer_rows["jax"]])
    assert "overall" in merged


@pytest.fixture(scope="module")
def seed_world(tmp_path_factory):
    """The synthetic SEED set of test_vt_import_and_benchmarks.py and the
    tiny VT trees at its tokenizer's vocabulary."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("seed")
    tok_path = _tokenizer(tmp / "tokenizer.json")
    (tmp / "imgs").mkdir()
    qs = []
    for i in range(4):
        Image.new("RGB", (32, 32), color=(i * 50, 0, 0)).save(
            tmp / "imgs" / f"img{i}.png")
        qs.append({"question": "what color", "answer": "ABCD"[i % 4],
                   "choice_a": "1", "choice_b": "2", "choice_c": "3",
                   "choice_d": "4", "data_id": f"img{i}.png"})
    (tmp / "seed.json").write_text(json.dumps({"questions": qs}))
    tok = load_tokenizer(tok_path)
    base = llava.LlavaConfig.tiny()
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, vocab_size=max(tok.vocab_size, base.llama.vocab_size)))
    g = torch.Generator().manual_seed(5)
    frozen = llava.init_frozen(g, cfg, device="cpu", dtype=torch.float32)
    trainable = _seeded(llava.init_trainable(g, cfg, device="cpu"), g)
    return {"tok": tok_path, "dir": tmp, "frozen": frozen,
            "trainable": trainable}


def test_eval_vt_scores_match_jax(seed_world):
    """One invocation of each package's ``eval_vt`` on the SEED set: the
    same rows and the same scores JSON."""
    w = seed_world

    def argv(out):
        return ["--task", "seed", "--tokenizer-json", w["tok"],
                "--data", str(w["dir"] / "seed.json"),
                "--image-root", str(w["dir"] / "imgs"), "--output-dir", out,
                "--model-preset", "tiny", "--batch-size", "2",
                "--pad-to", "128", "--max-new-tokens", "3"]

    jout, tout = str(w["dir"] / "jax"), str(w["dir"] / "port")
    with pytest.MonkeyPatch.context() as mp, one_thread():
        _same_trees(mp, jllava, llava, w["frozen"], w["trainable"])
        jeval_vt.main(argv(jout))
        got = eval_vt.main(argv(tout) + ["--device", "cpu"])
    for name in ("result_rank0_seed.jsonl", "scores_seed.json"):
        assert (Path(tout) / name).read_text() == \
            (Path(jout) / name).read_text(), name
    assert got == json.loads((Path(jout) / "scores_seed.json").read_text())
    assert got["total"] == 4
    for task in ("seed", "mmbench"):
        assert score.main(["--task", task, "--merge-dir", tout]) == \
            jscore.main(["--task", task, "--merge-dir", jout])


def test_cli_flags_match_jax():
    """JAX's flags and defaults, plus ``--device`` (default cuda)."""
    for jmod, tmod in ((jinfer, infer), (jeval_vt, eval_vt)):
        jp, tp = jmod.build_argparser(), tmod.build_argparser()
        jopts = {a.dest: a.default for a in jp._actions}
        topts = {a.dest: a.default for a in tp._actions}
        assert topts.pop("device") == "cuda"
        assert topts == jopts
    assert eval_vt.MAX_NEW == jeval_vt.MAX_NEW


@pytest.fixture(scope="module")
def serve_fns(avt_world):
    """JAX's and the port's ``make_serve_generate_fn`` over the same tiny
    trees (test_serve_sampling.py's world)."""
    from moka_tpu.data.tokenizer import load_tokenizer as jload
    w = avt_world
    trees = (w["frozen"], _seeded(unified.init_trainable(
        torch.Generator().manual_seed(6), w["cfg"], device="cpu"),
        torch.Generator().manual_seed(7)))
    jbase = junified.UnifiedConfig.tiny(spec=JSpec.avt(rank=4,
                                                      dropout_rate=0.0))
    jcfg = dataclasses.replace(jbase, llama=dataclasses.replace(
        jbase.llama, vocab_size=w["cfg"].llama.vocab_size))

    def port(**kw):
        kw = dict(dict(pad_to=32, max_new_tokens=8), **kw)
        return infer.make_serve_generate_fn(
            load_tokenizer(w["tok"]), _torch_tree(_np_tree(trees[1])),
            _torch_tree(_np_tree(trees[0])), w["cfg"], **kw)

    def jax_fn(**kw):
        kw = dict(dict(pad_to=32, max_new_tokens=8), **kw)
        return jinfer.make_serve_generate_fn(
            jload(w["tok"]), _jax_tree(trees[1]), _jax_tree(trees[0]), jcfg,
            **kw)

    return port, jax_fn


def test_serve_generate_fn_matches_jax(serve_fns):
    """test_serve_sampling.py's behaviours on the port, and its greedy
    texts equal to JAX's: a greedy row overrides a hot server default, hot
    rows diverge, per-request max_new_tokens truncates, the same seed
    repeats and batches see different noise."""
    port, jax_fn = serve_fns
    prompt = "how many instruments ?"
    with one_thread():
        greedy = port()([{"prompt": prompt}])[0]
        assert greedy == jax_fn()([{"prompt": prompt}])[0]
        hot = port(temperature=5.0, seed=3)
        out = hot([{"prompt": prompt, "temperature": 0.0}, {"prompt": prompt}])
        assert out[0] == greedy
        hots = [hot([{"prompt": prompt}])[0] for _ in range(4)]
        assert any(h != greedy for h in hots), (hots, greedy)
        full, short = port()([{"prompt": prompt},
                              {"prompt": prompt, "max_new_tokens": 2}])
        assert len(short.split()) <= 2 and full.startswith(short)
        gen_a, gen_b = (port(temperature=5.0, seed=7) for _ in range(2))
        a = [gen_a([{"prompt": prompt}])[0] for _ in range(4)]
        b = [gen_b([{"prompt": prompt}])[0] for _ in range(4)]
    assert a == b and len(set(a)) > 1, a
