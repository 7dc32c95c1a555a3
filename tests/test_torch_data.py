"""Port parity: the host data pipeline (``data/{audio,video,fbank,datasets,
spm,tokenizer,prefetch}.py`` and ``native/``) against the JAX package's
copies on the same inputs, built from seeds by the tests themselves (a
cv2 MJPG AVI, a PNG, scipy WAVs, sentencepiece models serialized by hand,
a WordLevel ``tokenizer.json``).

Everything is array-equal or string-equal, except where each package
builds its own native fbank library from the same source: there the
log-mel features may differ by 1e-6 absolute (other compiler flags may
contract a multiply-add differently).
"""

import json
import shutil

import numpy as np
import pytest

from moka_tpu.data import audio as jaudio
from moka_tpu.data import datasets as jdatasets
from moka_tpu.data import fbank as jfbank
from moka_tpu.data import prefetch as jprefetch
from moka_tpu.data import spm as jspm
from moka_tpu.data import tokenizer as jtokenizer
from moka_tpu.data import video as jvideo
from moka_tpu_torch import native
from moka_tpu_torch.data import audio as taudio
from moka_tpu_torch.data import datasets as tdatasets
from moka_tpu_torch.data import fbank as tfbank
from moka_tpu_torch.data import prefetch as tprefetch
from moka_tpu_torch.data import spm as tspm
from moka_tpu_torch.data import tokenizer as ttokenizer
from moka_tpu_torch.data import video as tvideo
from tests.test_datasets import avqa_fixture, toy_tokenizer  # noqa: F401
from tests.test_spm import BPE_PIECES, W, _model

NATIVE_TOL = 1e-6


def assert_tree_equal(got, want, path="", atol=0.0):
    """Nested dicts/lists of arrays, strings and numbers: equal, arrays
    to ``atol`` (0: exactly)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}", atol)
    elif isinstance(want, (list, tuple)) and want and \
            not isinstance(want[0], (int, float, str)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


# ------------------------------------------------------------ audio, video

@pytest.mark.parametrize("total, stride, before, after, n", [
    (60, 6, 0.5, 1.5, 16000 * 60), (10, 1, 0.0, 1.0, 16000 * 10),
    (3, 1, 0.0, 1.0, 47_999)])
def test_segment_windows_equal(total, stride, before, after, n):
    wav = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = taudio.segment_windows(wav, total, stride, before, after)
    want = jaudio.segment_windows(wav, total, stride, before, after)
    assert_tree_equal(got, want)


@pytest.mark.parametrize("src, dst", [(44100, 16000), (8000, 16000),
                                      (16000, 16000)])
def test_resample_linear_equal(src, dst):
    wav = np.random.default_rng(src).standard_normal(src // 3)
    got = taudio.resample_linear(wav.astype(np.float32), src, dst)
    want = jaudio.resample_linear(wav.astype(np.float32), src, dst)
    assert_tree_equal(got, want)


def test_load_audio_wav_equal(tmp_path):
    """int16 stereo at 22.05 kHz: downmix and resample to 16 kHz."""
    from scipy.io import wavfile
    path = str(tmp_path / "a.wav")
    rng = np.random.default_rng(0)
    wavfile.write(path, 22050, (rng.standard_normal((22050, 2)) * 3000)
                  .astype(np.int16))
    assert_tree_equal(taudio.load_audio(path), jaudio.load_audio(path))
    with pytest.raises(NotImplementedError, match="mp3"):
        taudio.load_audio(str(tmp_path / "a.mp3"))


@pytest.fixture
def avi(tmp_path):
    import cv2
    path = str(tmp_path / "v.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(13):
        w.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    w.release()
    return path


@pytest.mark.parametrize("n_frames, size", [(4, 224), (20, 32)])
def test_read_video_frames_and_clip_preprocess_equal(avi, n_frames, size):
    got = tvideo.read_video_frames(avi, n_frames, size)
    want = jvideo.read_video_frames(avi, n_frames, size)
    assert got.shape == (min(n_frames, 13), size, size, 3)
    assert_tree_equal(got, want)
    assert_tree_equal(tvideo.clip_preprocess(got, 32),
                      jvideo.clip_preprocess(want, 32))
    assert tvideo.uniform_frame_indices(13, n_frames) == \
        jvideo.uniform_frame_indices(13, n_frames)


def test_load_image_equal(tmp_path):
    from PIL import Image
    path = str(tmp_path / "x.png")
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 255, (37, 50, 3), np.uint8)).save(path)
    got = tvideo.load_image(path)
    assert got.shape == (3, 224, 224) and got.dtype == np.float32
    assert_tree_equal(got, jvideo.load_image(path))


# ------------------------------------------------------------------ fbank

def test_native_fbank_matches_jax_native():
    """Each package builds its own library from the same C++ source: the
    normalized features within NATIVE_TOL, the frame counts equal."""
    from moka_tpu.native import native_fbank as j_native
    if j_native(np.zeros(400, np.float32)) is None:
        pytest.fail("the JAX package's native fbank did not build")
    rng = np.random.default_rng(3)
    for n in (400, 16000, 32_123):
        wav = (rng.standard_normal(n) * 0.2).astype(np.float32)
        got, want = tfbank.beats_fbank(wav), jfbank.beats_fbank(wav)
        assert got.shape == want.shape == (1 + (n - 400) // 160, 128)
        np.testing.assert_allclose(got, want, rtol=0, atol=NATIVE_TOL)
    assert native.native_fbank(np.zeros(399, np.float32)).shape == (0, 128)


def test_numpy_fbank_equal(monkeypatch):
    """``MOKA_FBANK=numpy``: both packages take the float64 numpy twin."""
    monkeypatch.setenv("MOKA_FBANK", "numpy")
    wav = np.random.default_rng(4).standard_normal(16000) * 0.2
    assert_tree_equal(tfbank.beats_fbank(wav), jfbank.beats_fbank(wav))
    assert_tree_equal(tfbank.mel_banks(128, 512, 16000),
                      jfbank.mel_banks(128, 512, 16000))


def test_native_library_is_built_into_the_build_dir(tmp_path):
    """The library sits in ``build/moka_tpu_torch/``, keyed by the source
    and the flags (an edited copy gets another name), never beside the
    source; a source that does not compile raises."""
    lib = native.get_lib()
    path = native.target()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert lib._name == str(path)
    assert not list(native.SOURCE.parent.glob("*.so"))
    edited = tmp_path / "fbank.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    assert native.target(edited) != path
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(broken)
    assert not native.target(broken).exists()


# --------------------------------------------------------------- datasets

def _tokenize_pair():
    """One toy word tokenizer behind both packages' ``Tokenize``: its
    vocabulary grows as it encodes, so both see the same ids when they
    encode the same texts in turn."""
    tok = toy_tokenizer()
    fields = dict(encode=tok.encode, token_to_id=tok.token_to_id,
                  pad_id=tok.pad_id, eos_id=tok.eos_id)
    return tdatasets.Tokenize(**fields), jdatasets.Tokenize(**fields)


def _ave_root(tmp_path):
    import cv2
    from scipy.io import wavfile
    rng = np.random.default_rng(1)
    root = tmp_path / "ave"
    for d in ("AVE", "audio_data", "converted_label"):
        (root / d).mkdir(parents=True)
    w = cv2.VideoWriter(str(root / "AVE" / "v1.avi"),
                        cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 64))
    for _ in range(12):
        w.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
    w.release()
    wavfile.write(str(root / "audio_data" / "v1.wav"), 16000,
                  (rng.standard_normal(16000 * 10) * 3000).astype(np.int16))
    (root / "converted_label" / "v1.txt").write_text(
        "<event>Church bell</event><range>0,9</range>")
    ann = tmp_path / "ave.json"
    ann.write_text(json.dumps([{"vid": "v1", "event": "Church bell"}]))
    return str(ann), str(root)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("task", ["avqa", "ave"])
def test_unified_dataset_samples_and_batches_equal(avqa_fixture, tmp_path,
                                                   task, mode):
    """AVQA and AVE samples on ``tests/test_datasets.py``'s fixtures: the
    prompt, the frames, the fbank segments and the collated batch."""
    kw = dict(mode=mode, video_frame_nums=4, n_video_tokens=8,
              n_audio_tokens=8, qformer_tokenize=lambda t: [
                  5 + len(w) for w in t.split()], qformer_question_len=16)
    if task == "avqa":
        kw["avqa_annotation"] = avqa_fixture
    else:
        kw["ave_annotation"], kw["ave_data_root"] = _ave_root(tmp_path)
    ttok, jtok = _tokenize_pair()
    tds = tdatasets.UnifiedDataset(ttok, **kw)
    jds = jdatasets.UnifiedDataset(jtok, **kw)
    assert tds.samples == jds.samples and len(tds) == 1
    got, want = tds[0], jds[0]
    audio = want.pop("audio")
    np.testing.assert_allclose(got.pop("audio"), audio, rtol=0,
                               atol=NATIVE_TOL)
    assert_tree_equal(got, want)
    got["audio"] = want["audio"] = audio
    assert_tree_equal(tds.collate([got]), jds.collate([want]))


def test_chat_prompt_and_pretrain_items_equal(tmp_path):
    from PIL import Image
    assert tdatasets.llama2_chat_prompt("Q", "S") == \
        jdatasets.llama2_chat_prompt("Q", "S")
    path = str(tmp_path / "x.png")
    Image.new("RGB", (40, 30), (10, 200, 30)).save(path)
    entries = [{"kind": "image", "path": path, "caption": "green"}]
    ttok, jtok = _tokenize_pair()
    assert_tree_equal(tdatasets.PretrainDataset(ttok, entries)[0],
                      jdatasets.PretrainDataset(jtok, entries)[0])


# --------------------------------------------------------------- tokenizers

UNIGRAM_PIECES = [
    ("<unk>", 0.0, jspm.UNKNOWN), ("<s>", 0.0, jspm.CONTROL),
    ("</s>", 0.0, jspm.CONTROL), (W, -2.0, jspm.NORMAL),
    (W + "ab", -6.0, jspm.NORMAL), ("c", -1.0, jspm.NORMAL),
    (W + "a", -1.0, jspm.NORMAL), ("bc", -1.0, jspm.NORMAL),
    ("b", -4.0, jspm.NORMAL)]
BPE_TEXTS = ["how", "how many", "z!", "many how", "howz many!",
             "how<image>many <question_start>z</s>"]
UNIGRAM_TEXTS = ["abc", "abc c", "ab", "cab x", "<s>abc<video>bc</s>"]


@pytest.mark.parametrize("pieces, model_type, texts", [
    (BPE_PIECES, 2, BPE_TEXTS), (UNIGRAM_PIECES, 1, UNIGRAM_TEXTS)],
    ids=["bpe", "unigram"])
def test_spm_encode_decode_equal(tmp_path, pieces, model_type, texts):
    path = tmp_path / "tokenizer.model"
    path.write_bytes(_model(pieces, model_type=model_type))
    tm, jm = tspm.SPModel.from_file(str(path)), jspm.SPModel.from_file(
        str(path))
    assert tm.pieces == jm.pieces and tm.model_type == jm.model_type
    ttok = ttokenizer.load_tokenizer(str(path))
    jtok = jtokenizer.load_tokenizer(str(path))
    assert (ttok.token_to_id, ttok.vocab_size, ttok.eos_id) == \
        (jtok.token_to_id, jtok.vocab_size, jtok.eos_id)
    for text in texts:
        ids = jtok.encode(text)
        assert ttok.encode(text) == ids, text
        assert ttok.decode(ids) == jtok.decode(ids), text
        plain = text.split("<")[0]
        seg = jm.encode_segment(plain)
        assert tm.encode_segment(plain) == seg
        assert tm.decode_ids(seg) == jm.decode_ids(seg)


def test_wordlevel_tokenizer_json_equal(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for w in "this is an image question what color".split():
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    d = tmp_path / "tok"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    shutil.copy(d / "tokenizer.json", tmp_path / "other.json")
    for path in (str(d), str(tmp_path / "other.json")):
        ttok, jtok = ttokenizer.load_tokenizer(path), \
            jtokenizer.load_tokenizer(path)
        assert (ttok.token_to_id, ttok.vocab_size, ttok.pad_id) == \
            (jtok.token_to_id, jtok.vocab_size, jtok.pad_id)
        text = "this is an <image> what color <question_end> zebra"
        assert ttok.encode(text) == jtok.encode(text)
        ids = jtok.encode(text)
        assert ttok.decode(ids) == jtok.decode(ids)
        assert ttok.as_tokenize().encode(text) == ids


# ---------------------------------------------------------------- prefetch

class Slow:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i, "x": np.full(3, i)}


def test_prefetch_and_parallel_loader_equal():
    assert list(tprefetch.prefetch(iter(range(20)), size=3)) == \
        list(jprefetch.prefetch(iter(range(20)), size=3))
    order = list(np.random.default_rng(0).permutation(23))

    def collate(items):
        return {"i": [it["i"] for it in items],
                "x": np.stack([it["x"] for it in items])}

    got = list(tprefetch.ParallelLoader(Slow(23), collate, 4,
                                        workers=3).epoch(order))
    want = list(jprefetch.ParallelLoader(Slow(23), collate, 4,
                                         workers=3).epoch(order))
    assert len(got) == 5
    assert_tree_equal(got, want)


def test_prefetch_raises_the_producers_error():
    def gen():
        yield 1
        raise ValueError("boom")

    it = tprefetch.prefetch(gen(), size=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_data_modules_import_no_decoder():
    """The decoders (scipy's wavfile, cv2, PIL, tokenizers) and the native
    library are imported or built only where a function needs them."""
    import subprocess
    import sys
    code = ("import sys; import moka_tpu_torch.data.datasets, "
            "moka_tpu_torch.data.benchmarks, moka_tpu_torch.data.tokenizer,"
            " moka_tpu_torch.data.prefetch, moka_tpu_torch.data.vt_dataset, "
            "moka_tpu_torch.eval.runner, moka_tpu_torch.native as n; "
            "print(sorted(m for m in ('cv2', 'PIL', 'scipy.io', 'tokenizers',"
            " 'pandas', 'datasets', 'jax') if m in sys.modules), n._lib)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["[]", "None"]
