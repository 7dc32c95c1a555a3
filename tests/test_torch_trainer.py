"""Port parity: the training loop (``train/trainer.py``) and the metrics
logging (``utils/logging.py``) against the JAX package.

- ``grouped_indices`` and ``host_sharded_order`` give JAX's orders, exact.
- A tiny MokA AVT run (fp32 base, dropout 0) through the port's
  ``Trainer`` and JAX's from the same trees and batches: four steps with a
  checkpoint every two, ``finalize``, then a fresh trainer of six steps
  that resumes from step 4.  ``metrics.jsonl`` losses agree to 1e-5
  relative and the exported adapters to 1e-4 relative + 1e-5 absolute
  (as ``tests/test_torch_train.py``: fp32 on both sides, other summation
  orders, AdamW dividing each gradient by its running magnitude);
  ``saved_config.json`` and ``model_trainable_params.txt`` are the same
  text.
- Fractional save steps, the eval hook, the profiler window, the AdaLoRA
  rank schedule against JAX's (masks exact), and ``param_report`` and
  the ``[step N]`` line as text.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg, TrainConfig as JTrain
from moka_tpu.models import llama as jllama
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu.train import trainer as jtrainer
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu.utils import logging as jlogging
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train import checkpoint as tckpt
from moka_tpu_torch.train import trainer as ttrainer
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from moka_tpu_torch.utils import logging as tlogging

JCFG, CFG = JCfg.tiny(vocab_size=64), LlamaConfig.tiny(vocab_size=64)
JSPEC = JSpec.avt(rank=4, dropout_rate=0.0)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)
LOSS_RTOL = 1e-5
PARAM = dict(rtol=1e-4, atol=1e-5)


def _batches(n, b=2, L=16):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(4, 64, (b, L)).astype(np.int32)
        out.append({"tokens": toks, "labels": toks})
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_grouped_indices_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 37
    lengths = rng.integers(5, 40, n).tolist()
    groups = rng.choice(["avqa", "ave", "image"], n).tolist()
    for bs in (2, 4):
        for drop in (False, True):
            assert ttrainer.grouped_indices(lengths, groups, bs, seed,
                                            drop) == \
                jtrainer.grouped_indices(lengths, groups, bs, seed, drop)


@pytest.mark.parametrize("seed,world", [(0, 1), (7, 4), (3, 2)])
def test_host_sharded_order_matches_jax(seed, world):
    rng = np.random.default_rng(seed)
    n = 50
    lengths = rng.integers(5, 40, n).tolist()
    groups = (["avqa"] * 30) + (["ave"] * 20)
    for rank in range(world):
        got = ttrainer.host_sharded_order(lengths, groups, 8, rank, world,
                                          seed)
        assert got == jtrainer.host_sharded_order(lengths, groups, 8, rank,
                                                  world, seed)


def _jax_trainer(out, total, save_every):
    r1, r2 = jax.random.split(jax.random.key(0))
    frozen = jllama.init_llama_params(r1, JCFG, dtype=jnp.float32)
    trainable = {"adapters": jllama.init_moka_adapters(r2, JCFG, JSPEC)}
    tcfg = JTrain(learning_rate=1e-3, warmup_ratio=0.0,
                  save_every_steps=save_every, output_dir=str(out))
    return jtrainer.Trainer(j_make_loss(JCFG, JSPEC, remat=False),
                            trainable, frozen, tcfg, total_steps=total)


def _port_trainer(out, total, save_every, trees):
    frozen, trainable = trees
    tcfg = TrainConfig(learning_rate=1e-3, warmup_ratio=0.0,
                       save_every_steps=save_every, output_dir=str(out))
    return ttrainer.Trainer(make_llama_moka_loss(CFG, SPEC, remat=False),
                            params_from_numpy(trainable, "cpu"),
                            params_from_numpy(frozen, "cpu"), tcfg,
                            total_steps=total)


def _metrics(out):
    return [json.loads(line) for line in open(out / "metrics.jsonl")]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run: four steps, finalize, then a resumed six-step trainer."""
    out = tmp_path_factory.mktemp("jax") / "run"
    tr = _jax_trainer(out, 4, 2)
    trees = (jax.tree.map(np.asarray, tr.frozen),
             jax.tree.map(np.asarray, tr.state.params))
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in _batches(10)]
    tr.train(jb)
    tr.finalize()
    tr2 = _jax_trainer(out, 6, 2)
    assert int(tr2.state.step) == 4
    tr2.train(jb)
    return out, trees


def test_trainer_run_resume_and_artifacts_match_jax(jax_run, tmp_path,
                                                    capsys):
    jout, trees = jax_run
    out = tmp_path / "run"
    batches = [params_from_numpy(b, "cpu") for b in _batches(10)]
    tr = _port_trainer(out, 4, 2, trees)
    state = tr.train(batches)
    assert state.step == 4
    tr.finalize()
    assert tckpt.latest_step(str(out / "checkpoints")) == 4
    assert (out / "model_trainable_params.txt").read_text() == \
        (jout / "model_trainable_params.txt").read_text()
    assert (out / "saved_config.json").read_text().replace(str(out), "D") \
        == (jout / "saved_config.json").read_text().replace(str(jout), "D")
    exported = torch.load(out / "adapter_model.bin", weights_only=True)
    want = torch.load(jout / "adapter_model.bin", weights_only=True)
    assert exported.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(exported[k].numpy(), want[k].numpy(),
                                   **PARAM, err_msg=k)

    tr2 = _port_trainer(out, 6, 2, trees)
    assert "[trainer] resumed from step 4" in capsys.readouterr().out
    assert tr2.state.step == 4
    assert tr2.train(batches).step == 6
    got, ref = _metrics(out), _metrics(jout)
    assert [m["step"] for m in got] == [m["step"] for m in ref] == \
        [1, 2, 3, 4, 5, 6]
    for g, r in zip(got, ref):
        assert list(g) == list(r)  # the same fields in the same order
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=LOSS_RTOL)
        assert g["supervised_tokens"] == r["supervised_tokens"]
    # the resumed run replays the iterator from its start (as JAX's)
    np.testing.assert_allclose(got[4]["loss"], got[0]["loss"], rtol=0.05)
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == \
        ["2", "4", "6"]


def test_fractional_save_steps_and_eval_hook(jax_run, tmp_path):
    _, trees = jax_run
    tr = _port_trainer(tmp_path / "r", 6, 0.5, trees)
    assert tr.save_every == 3
    calls = []

    def eval_fn(state):
        calls.append(state.step)
        return {"loss": 1.23}

    batches = [params_from_numpy(b, "cpu") for b in _batches(6)]
    tr.train(batches, eval_fn=eval_fn, eval_every_steps=2)
    assert calls == [2, 4, 6]
    assert sorted(p.name for p in (tmp_path / "r" / "checkpoints")
                  .iterdir()) == ["3", "6"]
    rows = _metrics(tmp_path / "r")
    assert [r["eval_loss"] for r in rows if "eval_loss" in r] == [1.23] * 3


def test_profile_window_writes_a_trace(jax_run, tmp_path):
    _, trees = jax_run
    tr = _port_trainer(tmp_path / "r", 3, 0, trees)
    tr.train([params_from_numpy(b, "cpu") for b in _batches(3)],
             profile_steps=(1, 2))
    assert [p.name for p in (tmp_path / "r" / "trace").iterdir()] == \
        ["steps_1_2.json"]


def test_param_report_and_logger_text_match_jax(tmp_path, capsys):
    tree = {"b": [np.zeros((2, 3), np.float32), None,
                  {"z": np.zeros((), np.float32)}],
            "a": {"y": np.zeros((4,), np.float32),
                  "x": (np.zeros((1, 5), np.float32),)}}
    ported = params_from_numpy(tree, "cpu")
    assert tlogging.param_report(ported) == jlogging.param_report(tree)
    assert tlogging.param_count(ported) == jlogging.param_count(tree) == 16
    metrics = {"loss": torch.tensor(1.2345678), "supervised_tokens": 18,
               "note": "x", "step_time_s": 0.5}
    for mod, sub in ((tlogging, "t"), (jlogging, "j")):
        logger = mod.MetricsLogger(str(tmp_path / sub))
        logger.log(3, {k: (np.float32(v) if torch.is_tensor(v) else v)
                       for k, v in metrics.items()}
                   if mod is jlogging else metrics)
        logger.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] == \
        "[step 3] loss=1.2346 supervised_tokens=18 note=x step_time_s=0.5"
    assert (tmp_path / "t" / "metrics.jsonl").read_text() == \
        (tmp_path / "j" / "metrics.jsonl").read_text()


def test_adalora_schedule_matches_jax(tmp_path):
    """``adalora_budget`` > 0: every ``adalora_update_every`` steps the
    trainer re-allocates the rank budget from the step's lam gradients.
    Two AdaLoRA layers on a regression loss, four steps with an update
    every two: the masks equal JAX's and the losses agree to LOSS_RTOL."""
    from moka_tpu.adapters import peft as jpeft
    from moka_tpu_torch.adapters import peft as tpeft
    rng = np.random.default_rng(3)
    trees = {f"l{i}": {"p": rng.standard_normal((8, 6)).astype(np.float32),
                       "lam": rng.standard_normal(6).astype(np.float32),
                       "q": rng.standard_normal((6, 8)).astype(np.float32),
                       "mask": np.ones(6, np.float32)} for i in range(2)}
    w = rng.standard_normal((8, 8)).astype(np.float32)
    batches = [{"x": rng.standard_normal((5, 8)).astype(np.float32),
                "y": rng.standard_normal((5, 8)).astype(np.float32)}
               for _ in range(4)]

    def jloss(tr, frozen, batch, key):
        h = batch["x"]
        for i in range(2):
            h = jpeft.adalora_linear(h, frozen, tr["ada"][f"l{i}"])
        return jnp.mean((h - batch["y"]) ** 2), {}

    def tloss(tr, frozen, batch, key):
        h = batch["x"]
        for i in range(2):
            h = tpeft.adalora_linear(h, frozen, tr["ada"][f"l{i}"])
        return torch.mean((h - batch["y"]) ** 2), {}

    kw = dict(learning_rate=1e-2, warmup_ratio=0.0, adalora_budget=5,
              adalora_update_every=2)
    jt = jtrainer.Trainer(jloss, {"ada": trees}, jnp.asarray(w),
                          JTrain(output_dir=str(tmp_path / "j"), **kw), 4)
    jt.train([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    tt = ttrainer.Trainer(tloss, params_from_numpy({"ada": trees}, "cpu"),
                          torch.from_numpy(w),
                          TrainConfig(output_dir=str(tmp_path / "t"), **kw),
                          4)
    tt.train([params_from_numpy(b, "cpu") for b in batches])
    for i in range(2):
        got = tt.state.params["ada"][f"l{i}"]["mask"].numpy()
        want = np.asarray(jt.state.params["ada"][f"l{i}"]["mask"])
        np.testing.assert_array_equal(got, want)
    masks = np.concatenate([tt.state.params["ada"][f"l{i}"]["mask"].numpy()
                            for i in range(2)])
    assert masks.sum() == 5  # the budget, one update after another
    for g, r in zip(_metrics(tmp_path / "t"), _metrics(tmp_path / "j")):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=LOSS_RTOL)
