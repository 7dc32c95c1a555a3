"""Port: the continuous-batching engine and the HTTP front, on the CPU.

Mirrors ``tests/test_engine.py``: every engine output must equal the port's
own per-request ``greedy_generate`` token for token (fp32, tiny config),
under mid-stream admission, compaction, multi-step dispatch, pipelining and
batched multimodal admission."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.eval.decode import greedy_generate
from moka_tpu_torch.eval.engine import DecodeEngine
from moka_tpu_torch.eval.server import serve, serve_continuous
from moka_tpu_torch.models import llama
from moka_tpu_torch.ops.moka import MokaSpec

CFG = LlamaConfig.tiny()
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)
EOS = 2


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    base = llama.init_llama_params(g, CFG, device="cpu", dtype=torch.float32)
    adapters = llama.init_moka_adapters(g, CFG, SPEC, device="cpu")
    for p in adapters["layers"].values():
        p["b"] += 0.01
    return base, adapters


def _prompts(seed=0, n=4, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, CFG.vocab_size, rng.integers(lo, hi)).astype(
        np.int64) for _ in range(n)]


def _strip(toks):
    keep = []
    for t in toks:
        keep.append(int(t))
        if t == EOS:
            break
    return keep


def _reference(model, prompts, max_new, masks=None):
    base, adapters = model
    outs = []
    for i, p in enumerate(prompts):
        embeds = base["embed"][torch.from_numpy(p)[None]]
        toks = greedy_generate(
            base, adapters, cfg=CFG, spec=SPEC, inputs_embeds=embeds,
            prompt_mask=torch.ones((1, len(p))),
            masks=None if masks is None else masks[i],
            max_new_tokens=max_new, eos_id=EOS)[0]
        outs.append(_strip(toks.tolist()))
    return outs


def _submit(engine, base, p, max_new, bucket=16, masks=None):
    padded = np.zeros(bucket, np.int64)
    padded[:len(p)] = p
    embeds = base["embed"][torch.from_numpy(padded)[None]]
    mask = np.zeros((1, bucket), np.float32)
    mask[0, :len(p)] = 1
    return engine.submit(embeds, mask, masks=masks, max_new_tokens=max_new)


def _engine(model, **kw):
    base, adapters = model
    kw.setdefault("cache_capacity", 64)
    return DecodeEngine(base, adapters, cfg=CFG, spec=SPEC, eos_id=EOS,
                        cache_dtype=torch.float32, **kw)


@pytest.mark.parametrize("case", [
    dict(n_slots=4, prompts=dict(seed=0), max_new=12),           # parity
    dict(n_slots=2, prompts=dict(seed=1, n=7), max_new=10,
         cache_capacity=96),                                     # admission
    dict(n_slots=2, prompts=dict(seed=2, n=6, lo=3, hi=7), max_new=8,
         cache_capacity=28, bucket=8),                           # compaction
    dict(n_slots=2, prompts=dict(seed=5, n=6), max_new=10,
         cache_capacity=48, steps_per_dispatch=4),               # multi-step
])
def test_engine_matches_greedy(model, case):
    case = dict(case)
    prompts = _prompts(**case.pop("prompts"))
    max_new = case.pop("max_new")
    bucket = case.pop("bucket", 16)
    ref = _reference(model, prompts, max_new)
    eng = _engine(model, **case)
    futs = [_submit(eng, model[0], p, max_new, bucket) for p in prompts]
    steps = eng.run_until_drained()
    assert [_strip(f.get(timeout=1)) for f in futs] == ref
    assert steps > 0


def test_engine_mixed_buckets_and_oversized(model):
    prompts = _prompts(seed=6, n=6)
    ref = _reference(model, prompts, 8)
    eng = _engine(model, n_slots=4)
    futs = []
    for i, p in enumerate(prompts):
        futs.append(_submit(eng, model[0], p, 8, 16 if i % 2 == 0 else 24))
        if i == 2:  # an unfittable request between groups
            bad = _submit(eng, model[0], prompts[0], 200)
    eng._admit()
    assert eng._dispatch_no == 2  # two grouped prefills, not four
    eng.run_until_drained()
    assert [_strip(f.get(timeout=1)) for f in futs] == ref
    assert len(bad.get_nowait()) == 0  # rejected, not hung


def test_engine_multimodal_batched_admission(model):
    """Multimodal requests sharing a bucket prefill as one batch; the
    prefill runs the flash and fused-MokA entry points."""
    base, _ = model
    rng = np.random.default_rng(8)
    bucket, max_new = 16, 8
    prompts, ref_masks, sub_masks = [], [], []
    for _ in range(4):
        n = int(rng.integers(8, bucket + 1))
        prompts.append(rng.integers(4, CFG.vocab_size, n).astype(np.int64))
        mod = np.zeros((3, 1, bucket), np.float32)
        mod[0, 0, : n // 2] = 1
        mod[1, 0, n // 2: 3 * n // 4] = 1
        mod[2, 0, 3 * n // 4: n] = 1
        q = np.zeros((1, bucket), np.float32)
        q[0, 1:4] = 1
        ref_masks.append(llama.MaskBundle(torch.from_numpy(mod[:, :, :n]),
                                          torch.from_numpy(q[:, :n])))
        sub_masks.append(llama.MaskBundle(torch.from_numpy(mod),
                                          torch.from_numpy(q)))
    ref = _reference(model, prompts, max_new, masks=ref_masks)
    eng = _engine(model, n_slots=4, use_flash=True, use_fused_moka=True)
    futs = [_submit(eng, base, p, max_new, bucket, masks=m)
            for p, m in zip(prompts, sub_masks)]
    eng.run_until_drained()
    assert [_strip(f.get(timeout=1)) for f in futs] == ref
    assert eng._dispatch_no > 1


def test_engine_pipeline_depth_and_early_readmission(model):
    prompts = _prompts(seed=9, n=6)
    budgets = [int(b) for b in np.random.default_rng(9).integers(1, 14, 6)]

    def run(depth, k):
        eng = _engine(model, n_slots=2, pipeline_depth=depth,
                      steps_per_dispatch=k)
        futs = [_submit(eng, model[0], p, b) for p, b in zip(prompts,
                                                            budgets)]
        eng.run_until_drained()
        return [_strip(f.get(timeout=1)) for f in futs]

    ref = run(0, 1)
    for depth in (1, 2):
        for k in (1, 4):
            assert run(depth, k) == ref, (depth, k)
    two = _prompts(seed=12, n=2)
    eng = _engine(model, n_slots=1, steps_per_dispatch=16)
    futs = [_submit(eng, model[0], p, 2) for p in two]
    eng.run_until_drained()
    assert [_strip(f.get(timeout=1)) for f in futs] == _reference(model, two,
                                                                  2)
    assert eng.cur <= 16 + 4 * 2, eng.cur  # scans capped at the horizon


def _front(model, max_new):
    base, _ = model

    def prep(item):
        p = np.asarray(json.loads(item["prompt"]), np.int64)
        padded = np.zeros(16, np.int64)
        padded[:len(p)] = p
        mask = np.zeros((1, 16), np.float32)
        mask[0, :len(p)] = 1
        return base["embed"][torch.from_numpy(padded)[None]], mask, None

    eng = _engine(model, n_slots=2)
    server = serve_continuous(eng, prep, lambda t: " ".join(map(str, t)),
                              host="127.0.0.1", port=0,
                              max_new_tokens=max_new)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, eng


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_http_generate_stream_and_image_rejected(model):
    """Two concurrent /generate requests and one /generate_stream resolve
    with the reference tokens; an image that does not decode answers
    400."""
    prompts = _prompts(seed=3, n=3, lo=4, hi=7)
    ref = _reference(model, prompts, 6)
    server, eng = _front(model, 6)
    port = server.server_address[1]
    outs = [None, None]

    def fetch(i):
        body = _post(port, "/generate",
                     {"prompt": json.dumps(prompts[i].tolist())})
        outs[i] = json.loads(body)["output"]

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        lines = [json.loads(x) for x in _post(
            port, "/generate_stream",
            {"prompt": json.dumps(prompts[2].tolist())}).splitlines()]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/generate", {"prompt": "[5]", "image": "aGk="})
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    assert not any(t.is_alive() for t in threads)
    assert outs == [" ".join(map(str, r)) for r in ref[:2]]
    toks = [x["token"] for x in lines if "token" in x]
    assert _strip(toks) == ref[2]
    assert lines[-1]["output"] == " ".join(map(str, _strip(toks)))
    assert err.value.code == 400


def test_microbatcher_server_roundtrip():
    seen = []

    def generate(items):
        seen.append(len(items))
        return [f"echo {it['prompt']}" for it in items]

    server = serve(generate, host="127.0.0.1", port=0, max_batch=4)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        out = json.loads(_post(server.server_address[1], "/generate",
                               {"prompt": "hi"}))
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.server_address[1], "/generate_stream",
                  {"prompt": "hi"})
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    assert out == {"output": "echo hi"} and seen == [1]
    assert err.value.code == 501
