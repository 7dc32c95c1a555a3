"""``chip_smoke.py``'s phase 17 (parallelism) rehearsed on the CPU at
``LlamaConfig.tiny``, so that a broken phase shows here before the card
runs it: the host-streamed step and kernels 6-7 at a rank's rows in this
process, then a gloo world of 2 ranks for the flash ring, the FSDP and
data-parallel steps (one of them with the fused dropout) and the finetune
CLI with ``--mesh 1,2,1 --host-offload``, whose losses must be one
process's (that run goes on in a thread beside the phase).  The kernel
wrappers run their plain versions here (the launch counts are 0)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    return cs


def one_process_cli(chip_smoke, data, out):
    """The finetune CLI in this process on phase 17's files (made again,
    from the same seed, under ``data``): the 2-rank run's reference."""
    from moka_tpu_torch.cli import finetune
    chip_smoke.p15_data(data, chip_smoke.p15_configs(True)[1].image_size, 2)
    return finetune.main(
        ["--tokenizer-json", str(data / "tokenizer.model"),
         "--avqa-annotation", str(data / "avqa.json"),
         "--model-preset", "tiny", "--global-batch", "4", "--pad-to", "256",
         "--epochs", "1", "--output-dir", str(out), "--device", "cpu"])


def test_phase17_rehearsal(chip_smoke, tmp_path):
    from concurrent.futures import ThreadPoolExecutor
    from threadpoolctl import threadpool_limits
    work = tmp_path / "p17"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1), ThreadPoolExecutor(1) as pool:
            # the CLI's one-process reference runs beside the phase
            one = pool.submit(one_process_cli, chip_smoke,
                              tmp_path / "one_data", tmp_path / "one")
            res = chip_smoke.phase17(work, device="cpu", tiny=True)
            trainer, _ = one.result()
    finally:
        torch.set_num_threads(threads)
    long_cfg, cfg, _ = chip_smoke.p17_configs(True)
    stream = res["stream"]
    assert stream["moved"]["layer_fetches"] == 2 * cfg.n_layers
    assert stream["loss"]["streamed"] == stream["loss"]["resident"][0]
    assert res["transport"] == {"all_reduce": "device",
                                "all_gather": "device", "send": "host"}
    assert res["backend"] == "gloo"
    assert all(not any(c.values()) for c in res["ring"]["launches_by_rank"])
    # phase 20 (d), kernel 5's wrapper under the ring (its plain version)
    fused = res["ring_fused"][f"r{chip_smoke.P20_RING[2][-1]}"]
    assert fused["loss_rel"] <= chip_smoke.P20_RING_TOL[0]
    fault, tol = fused["fault"], chip_smoke.P20_RING_TOL
    assert fault["loss_rel"] > tol[0] or \
        max(fault["grad_rel_l2"].values()) > tol[1]
    assert all(not any(c.values()) for c in fused["launches_by_rank"])
    assert set(res["ring"]["shallow"]) == {"flash", "dense"}
    for name in ("1,2,1", "2,1,1"):
        rec = res["mesh"][name]
        assert len(rec["losses"]) == sum(chip_smoke.P17_TINY_STEPS)
        assert rec["loss_abs"] <= 1e-5 * rec["one_losses"][0]
    fused = res["mesh"]["2,1,1+fused_dropout"]
    assert fused["loss_abs"] <= 1e-5 * fused["one_losses"][0]
    assert max(fused["grad_rel_l2"].values()) <= 1e-4
    for rec in res["dropout_rows"].values():
        assert rec["mask_is_whole"] and rec["mask_without_map_differs"]
    assert res["mesh"]["1,2,1"]["gathered_bytes_per_step"] > 0
    assert res["mesh"]["2,1,1"]["gathered_bytes_per_step"] == 0
    cli = res["cli"]
    assert cli["steps"] == 3 and cli["q_device"] == "cpu"
    assert cli["q_shape"][1] == cfg.dim // 2  # fsdp 2 splits d_in
    rows = [json.loads(x) for x in
            (tmp_path / "one" / "metrics.jsonl").read_text().splitlines()]
    np.testing.assert_allclose(cli["losses"],
                               [r["loss"] for r in rows if "loss" in r],
                               rtol=1e-5)
    assert int(trainer.state.step) == 3
