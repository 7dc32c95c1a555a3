"""Port parity: the VT benchmark datasets and eval batch
(``data/benchmarks.py``), the VT samples (``data/vt_dataset.py``), the
inference runner (``eval/runner.py``) and the scorers
(``eval/scorers/*``) against the JAX package's copies, on fixtures the
tests write themselves (an MMBench TSV with base64 PNGs, an MME directory,
SEED and POPE files, synthetic prediction rows).  Everything exact.
"""

import base64
import io
import json
import sys
import types

import numpy as np
import pytest

from moka_tpu.data import benchmarks as jbench
from moka_tpu.data import vt_dataset as jvt
from moka_tpu.eval import runner as jrunner
from moka_tpu.eval.scorers import ave as jave
from moka_tpu.eval.scorers import avqa as javqa
from moka_tpu.eval.scorers import mme as jmme
from moka_tpu.eval.scorers import options as joptions
from moka_tpu_torch.data import assembler as tasm
from moka_tpu_torch.data import benchmarks as tbench
from moka_tpu_torch.data import vt_dataset as tvt
from moka_tpu_torch.eval import runner as trunner
from moka_tpu_torch.eval.scorers import ave as tave
from moka_tpu_torch.eval.scorers import avqa as tavqa
from moka_tpu_torch.eval.scorers import mme as tmme
from moka_tpu_torch.eval.scorers import options as toptions
from tests.test_datasets import toy_tokenizer
from tests.test_torch_data import assert_tree_equal


def _png_b64(color, size=(32, 24)):
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def mmbench_tsv(tmp_path):
    rows = ["index\tquestion\tanswer\timage\tA\tB\tC\thint"]
    rows.append(f"0\tWhat color?\tA\t{_png_b64((120, 30, 200))}\tpurple\t"
                f"green\t\tLook closely")
    rows.append(f"1\tWhat shape?\tB\t{_png_b64((5, 90, 9), (50, 50))}\t"
                f"square\tcircle\ttriangle\t")
    rows.append(f"7\tHow many?\tC\t{_png_b64((0, 0, 0), (7, 300))}\tone\t"
                f"two\tthree\tCount them")
    path = tmp_path / "mmbench.tsv"
    path.write_text("\n".join(rows))
    return str(path)


def test_mmbench_items_and_eval_batch_equal(mmbench_tsv):
    tds, jds = tbench.MMBenchDataset(mmbench_tsv), \
        jbench.MMBenchDataset(mmbench_tsv)
    assert len(tds) == len(jds) == 3
    items = [tds[i] for i in range(3)]
    for i, it in enumerate(items):
        assert_tree_equal(it, jds[i])
    assert items[2]["meta"]["index"] == 7 and "(C) triangle" in \
        items[1]["prompt"] and "Hint" not in items[1]["prompt"]
    tok = toy_tokenizer()
    got = tbench.build_eval_batch(items, tok, num_image_tokens=4)
    want = jbench.build_eval_batch(items, tok, num_image_tokens=4)
    assert_tree_equal(got, want)
    assert got["pixel_values"].shape == (3, 3, 224, 224)
    assert (got["attn_mask"][:, -1] == 1).all()
    assert_tree_equal(tbench.build_eval_batch(items, tok, 4, pad_to=128),
                      jbench.build_eval_batch(items, tok, 4, pad_to=128))


def test_mme_and_seed_items_equal(tmp_path):
    from PIL import Image
    for sub, color in (("existence", (9, 9, 9)), ("count", (200, 1, 1))):
        (tmp_path / "mme" / sub).mkdir(parents=True)
        Image.new("RGB", (16, 20), color).save(tmp_path / "mme" / sub /
                                                "img1.jpg")
        (tmp_path / "mme" / sub / "img1.txt").write_text(
            "Is there a dog? Please answer yes or no. Yes\n"
            "Are there two? Please answer yes or no. No\nno question\n")
    tds, jds = tbench.MMEDataset(str(tmp_path / "mme")), \
        jbench.MMEDataset(str(tmp_path / "mme"))
    assert tds.samples == jds.samples and len(tds) == 4
    for i in range(4):
        assert_tree_equal(tds[i], jds[i])
    (tmp_path / "imgs").mkdir()
    qs = []
    for i in range(2):
        Image.new("RGB", (16, 16), (i * 90, 3, 3)).save(
            tmp_path / "imgs" / f"x{i}.png")
        qs.append({"question": f"What {i}?", "answer": "AB"[i],
                   "choice_a": "1", "choice_b": "2", "choice_c": "3",
                   "choice_d": "4", "data_id": f"x{i}.png"})
    (tmp_path / "seed.json").write_text(json.dumps({"questions": qs}))
    args = (str(tmp_path / "seed.json"), str(tmp_path / "imgs"))
    tds, jds = tbench.SEEDDataset(*args), jbench.SEEDDataset(*args)
    for i in range(2):
        assert_tree_equal(tds[i], jds[i])


def test_pope_items_equal_and_hf_loader_is_the_hf_package(tmp_path,
                                                          monkeypatch):
    """POPE from a JSONL and from ``from_hf``, whose ``load_dataset`` is
    the HF ``datasets`` package's (a stand-in here), never the port's own
    ``data/datasets.py``."""
    from PIL import Image
    Image.new("RGB", (20, 20), (1, 2, 3)).save(tmp_path / "p.png")
    rows = [{"question": "Is there a cat?", "answer": "no",
             "image_source": "p.png"},
            {"question": "Is there a dog?", "answer": "yes",
             "image": "p.png"}]
    path = tmp_path / "pope.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    tds = tbench.POPEDataset.from_jsonl(str(path), str(tmp_path))
    jds = jbench.POPEDataset.from_jsonl(str(path), str(tmp_path))
    for i in range(2):
        assert_tree_equal(tds[i], jds[i])
    calls = []
    hf_rows = [{"question": "Is it red?", "answer": "yes",
                "image": Image.new("RGB", (9, 9), (250, 0, 0)),
                "image_source": "red"}]
    stand_in = types.ModuleType("datasets")
    stand_in.load_dataset = lambda path: calls.append(path) or \
        {"test": hf_rows}
    monkeypatch.setitem(sys.modules, "datasets", stand_in)
    tds = tbench.POPEDataset.from_hf("lmms-lab/POPE")
    jds = jbench.POPEDataset.from_hf("lmms-lab/POPE")
    assert calls == ["lmms-lab/POPE"] * 2
    assert_tree_equal(tds[0], jds[0])


def test_img_from_pil_equal():
    from PIL import Image
    rng = np.random.default_rng(0)
    for mode, shape in (("RGB", (31, 47, 3)), ("L", (64, 20)),
                        ("RGBA", (300, 200, 4))):
        img = Image.fromarray(rng.integers(0, 255, shape, np.uint8), mode)
        assert_tree_equal(tbench._img_from_pil(img),
                          jbench._img_from_pil(img))


# ---------------------------------------------------------------- VT samples

def _vt_samples(mod, b=3, nq=4, ph=99, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        pre = rng.integers(4, 90, 2 + i).tolist()
        q = rng.integers(4, 90, 3 + 2 * i).tolist()
        ans = rng.integers(4, 90, 3).tolist()
        ids = np.asarray(pre + [ph] * nq + q + ans)
        labels = np.asarray([-100] * (len(pre) + nq + len(q)) + ans)
        out.append(mod.build_vt_sample(ids, labels, ph, 0,
                                       num_image_tokens=nq))
    return out


def test_build_vt_sample_and_collate_vt_equal():
    got, want = _vt_samples(tvt), _vt_samples(jvt)
    assert_tree_equal(got, want)
    assert_tree_equal(tvt.collate_vt(got, 0), jvt.collate_vt(want, 0))
    assert_tree_equal(tvt.collate_vt(got, 0, pad_to=40),
                      jvt.collate_vt(want, 0, pad_to=40))
    with pytest.raises(ValueError, match="not a multiple"):
        tvt.build_vt_sample(np.asarray([1, 99, 99]), np.full(3, -100), 99,
                            0, num_image_tokens=4)
    no_image = tvt.build_vt_sample(np.asarray([1, 2, 3]), np.full(3, -100),
                                   99, 0)
    assert no_image["question_mask"].sum() == 0


def test_collate_vt_question_window_equal():
    """A question span of 7 tokens against a window of 5: raise by
    default (the port's ``QuestionWindowOverflow``), or zero the sample's
    question mask for training, as the JAX package does."""
    got, want = _vt_samples(tvt), _vt_samples(jvt)
    with pytest.raises(tasm.QuestionWindowOverflow):
        tvt.collate_vt(got, 0, max_question_tokens=5)
    kw = dict(max_question_tokens=5, question_overflow="disable")
    t, j = tvt.collate_vt(got, 0, **kw), jvt.collate_vt(want, 0, **kw)
    assert_tree_equal(t, j)
    assert t["question_mask"][2].sum() == 0 < t["question_mask"][1].sum()


def test_target_spans_from_markers_equal():
    marker = np.array([70, 71])
    rng = np.random.default_rng(1)
    for ids in (np.array([1, 2, 70, 71, 30, 31, 9, 4, 70, 71, 40, 9]),
                np.array([70, 71, 5, 6]), rng.integers(0, 80, 300)):
        assert_tree_equal(tvt.target_spans_from_markers(ids, marker, 9),
                          jvt.target_spans_from_markers(ids, marker, 9))


# ------------------------------------------------------------------ runner

class Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"prompt": f"p{i}", "answer": "ABCD"[i % 4],
                "meta": {"index": i}}


def _generate(items):
    return [{**it["meta"], "answer": it["answer"],
             "output": [f"({'abcd'[len(it['prompt']) % 4]}) x"]}
            for it in items]


@pytest.mark.parametrize("rank, world", [(None, None), (1, 3)])
def test_run_inference_files_equal(tmp_path, rank, world):
    """The same shard file; without a rank the port reads rank 0 of 1
    (no process group), as JAX's single process."""
    got = trunner.run_inference(Items(11), _generate, str(tmp_path / "t"),
                                "mmbench", batch_size=4, rank=rank,
                                world=world)
    want = jrunner.run_inference(Items(11), _generate, str(tmp_path / "j"),
                                 "mmbench", batch_size=4, rank=rank,
                                 world=world)
    assert got.endswith(f"result_rank{rank or 0}_mmbench.jsonl")
    assert open(got).read() == open(want).read()
    n = len(open(got).read().splitlines())
    assert n == (11 if world is None else 4)
    assert trunner.shard_indices(23, 2, 8) == jrunner.shard_indices(23, 2, 8)
    assert list(trunner.batched(range(10), 4)) == \
        list(jrunner.batched(range(10), 4))


def test_run_inference_reads_the_process_group(tmp_path):
    """With a ``torch.distributed`` group, the rank and world size come
    from it (a one-process gloo group here: rank 0 of 1)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        path = trunner.run_inference(Items(5), _generate,
                                     str(tmp_path / "out"), "seed")
    finally:
        dist.destroy_process_group()
    assert path.endswith("result_rank0_seed.jsonl")
    assert len(open(path).read().splitlines()) == 5


# ----------------------------------------------------------------- scorers

OPTION_ROWS = [{"answer": a, "output": [o]} for a, o in (
    ("A", "(A) </s>"), ("B", "a </s>"), ("(c)", "c "), ("D", "no idea"),
    ("E", "e  e"), ("b", "B b"))]
YESNO_ROWS = [{"answer": a, "output": [o]} for a, o in (
    ("yes", "Yes, it is."), ("no", "no"), ("yes", "maybe"), ("no", "YES"))]


def test_option_scorers_equal(tmp_path):
    assert toptions.score_option_rows(OPTION_ROWS) == \
        joptions.score_option_rows(OPTION_ROWS)
    assert toptions.score_yesno_rows(YESNO_ROWS) == \
        joptions.score_yesno_rows(YESNO_ROWS)
    assert toptions.score_option_rows([])["accuracy"] == 0.0
    for name, rows in (("result_rank0_x.jsonl", OPTION_ROWS[:3]),
                       ("result_rank1_x.jsonl", OPTION_ROWS[3:]),
                       ("other.jsonl", YESNO_ROWS)):
        (tmp_path / name).write_text("".join(json.dumps(r) + "\n"
                                             for r in rows))
    got = toptions.merge_rank_files(str(tmp_path), "t.jsonl")
    want = joptions.merge_rank_files(str(tmp_path), "j.jsonl")
    assert open(got).read() == open(want).read()
    assert toptions.score_option_file(got) == \
        joptions.score_option_file(want)
    (tmp_path / "yn.jsonl").write_text("".join(json.dumps(r) + "\n"
                                               for r in YESNO_ROWS))
    assert toptions.score_yesno_file(str(tmp_path / "yn.jsonl")) == \
        joptions.score_yesno_file(str(tmp_path / "yn.jsonl"))


def test_mme_scorer_equal():
    rows = []
    for task in ("existence", "count", "OCR", "code_reasoning"):
        for img in range(3):
            for q, ans in ((f"q{img}a", "Yes"), (f"q{img}b", "No")):
                pred = ["yes", "No.", "not sure", "yes indeed"][
                    (img + len(q) + len(task)) % 4]
                rows.append({"subtask": task, "image_path": f"{img}.png",
                             "question": q, "answer": ans,
                             "output": [pred]})
    rows.append(dict(rows[0]))  # a wrap-around duplicate
    assert tmme.score_rows(rows) == jmme.score_rows(rows)
    for p in ("yes", "no", "yesterday", "nope", "other"):
        assert tmme.parse_pred_ans(p) == jmme.parse_pred_ans(p)


def test_avqa_scorer_equal():
    rows = []
    for i, (ans, pred) in enumerate((
            ("two", "<answer>two</answer>"), ("yes", "<answer>no</answer>"),
            ("left", "<answer>LEFT </answer>"), ("one", "one"),
            ("cello", "<answer>cello</answer><answer>x</answer>"),
            ("piano", "<answer>banana</answer>"))):
        rows.append({"output": ans + "</s>", "predict": pred,
                     "question_type": [("Audio", "Counting"),
                                       ("Visual", "Location"),
                                       ("Audio-Visual", "Temporal")][i % 3]})
    assert tavqa.score_rows(rows) == javqa.score_rows(rows)


def test_ave_scorer_equal(tmp_path):
    annot = tmp_path / "Annotations.txt"
    annot.write_text("Church bell&x&0&10\nDog barking&y&2&5\n"
                     "Church bell&z&1&3\n")
    mapping = tave.load_vocab(str(annot))
    assert mapping == jave.load_vocab(str(annot))
    rows = [
        {"output": "event:Church bell start_time:0 end_time:9</s>",
         "predict": "<event>Church bell</event><range>0,9</range>"},
        {"output": "event:dog barking start_time:2 end_time:5",
         "predict": "<event>Dog barking (1 4), (6 7)</event>"},
        {"output": "event:dog barking start_time:3 end_time:8",
         "predict": "<event>dog barking</event><range>3 8</range>"},
        {"output": "event:church bell start_time:1 end_time:2",
         "predict": "nothing"}]
    assert tave.score_rows(rows, mapping) == jave.score_rows(rows, mapping)
    path = tmp_path / "ave.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert tave.score_file(str(path), str(annot)) == \
        jave.score_file(str(path), str(annot))
