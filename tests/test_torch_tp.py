"""Tensor parallelism on the mesh's ``model`` axis (``parallel/tensor.py``
and the model side of ``parallel/{mesh,sharding,stream}.py``,
``ops/{moka,quant,fused_dropout}.py``, ``core/rng.py``, ``train/step.py``)
against JAX's step on the same ``MeshConfig`` and against one port
process, on the CPU.

One world of 4 gloo ranks runs every case, started once for the file
(``parallel.mesh.start_world``); a case on a (1, 1, 2) mesh runs on two
replicas side by side (``_mesh``), each its own case.  Each case takes two
steps of ``make_train_step`` on each rank's rows of a global batch of 4
rows whose supervised counts differ, with AVT modality masks and a
question span, so MokA's rank attention runs; JAX runs the same steps on
``jax.devices()[:n]`` of the conftest's virtual devices, in spawned
processes of its own beside the world (the ranks import no JAX).  The
config is JAX's tensor-parallel one (``tests/test_sharding_rules.py``:
dim 64, 8 heads, intermediate 176), with a GQA variant of 4 kv heads and
one of 2 on model 4, whose kv heads do not split (k and v whole on every
rank).

Tolerances.  An fp32 base: ``tests/test_torch_mesh.py``'s LOSS and PARAM,
and its GRAD with the atol raised to 1e-4 of the leaf's largest gradient
(GRAD_SCALE): on the GQA config one port process and JAX's one device
already differ by 2.4e-5 of it, 4e-6 absolute, where the rank attention's
gradients cancel (measured), while the split changes only fp32 summation
orders (one port process against the split: 4e-6 relative L2, measured);
a gradient part summed m times, or missing, is off by its own size.  The int8 and int4
bases with ``a8_dots="full"`` and ``save_q8``: the forward's a8 and q8
codes take the whole row's scale (all-reduced maxima) and the row-parallel
int32 sums are summed before they scale, so one port process and the
split agree to the bit there; but the column-parallel dX of ``bwd_a8``
sums fp32 parts, and a per-token int8 rounding downstream flips a code by
one where a value sits on a rounding boundary, and the two packages sum
fp32 products in other orders anyway (``tests/test_torch_quant_train.py``).
Gradients and parameters are held to QUANT_L2 relative L2 per leaf
(measured: 4.7e-3 for int8 against one port process), the loss to
QUANT_LOSS relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from moka_tpu_torch.core.config import LlamaConfig, MeshConfig
from moka_tpu_torch.ops.moka import MokaSpec

WORLD = 4
STEPS = 2
B, L = 4, 16
CFGS = {"mha": LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=8,
                           n_kv_heads=8, intermediate=176)}
CFGS["gqa"] = dataclasses.replace(CFGS["mha"], n_kv_heads=4)
CFGS["kv2"] = dataclasses.replace(CFGS["mha"], n_kv_heads=2)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)
TRAIN = dict(learning_rate=1e-2, warmup_ratio=0.0)
# the multimodal steps: ``tests/test_torch_unified_step.py``'s schedule
# (warm-up: learning rates 0 and 1/3 of the peak), with PARAM: Adam's
# update of an entry whose gradient is near zero is ill-conditioned, and
# a few of the Q-Formers' entries move 3.2e-5 away from JAX's (measured;
# at the full rate from the second step one port process is 1.1e-4 from
# JAX there)
UNI_TRAIN, UNI_TOTAL = dict(learning_rate=1e-2, weight_decay=0.01), 100
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
GRAD_SCALE = 1e-4
PARAM = dict(rtol=1e-4, atol=1e-4)
QUANT = dict(a8_dots="full", save_q8=True, remat_policy="proj")
QUANT_L2 = 2e-2
QUANT_LOSS = 1e-4
# case: (config, mesh, base, loss options); JAX runs every one of these
JAX_CASES = {
    "mha/1,2,2": ("mha", (1, 2, 2), "fp32", {}),
    "mha/1,1,4": ("mha", (1, 1, 4), "fp32", {}),
    "mha/2,1,2": ("mha", (2, 1, 2), "fp32", {}),
    "gqa/1,2,2": ("gqa", (1, 2, 2), "fp32", {}),
    "kv2/1,1,4": ("kv2", (1, 1, 4), "fp32", {}),
    "int8/1,1,2": ("mha", (1, 1, 2), "int8", QUANT),
    "int4/1,1,2": ("mha", (1, 1, 2), "int4", QUANT),
}
STEP_CASES = [k for k in JAX_CASES if not k.startswith("int")]
# against one port process on the global batch
DROP = {"unfused": MokaSpec.avt(rank=4, dropout_rate=0.05),
        "fused": MokaSpec.avt(rank=4, dropout_rate=0.05).with_fused_dropout()}
UNIFIED = {"unified/2,1,2": ((2, 1, 2), True),
           "pretrain/1,1,2": ((1, 1, 2), False)}
# the JAX jobs, a process each (a compile each case)
JAX_JOBS = [STEP_CASES[:3], STEP_CASES[3:] + ["int8/1,1,2"],
            ["int4/1,1,2"], list(UNIFIED)]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().cpu().numpy()


def with_masks(toks, labels):
    """The batch with AVT modality masks (text, video, audio: half, a
    quarter, a quarter of each row) and a question span."""
    masks = np.zeros((3, B, L), np.int32)
    masks[0, :, :L // 2] = 1
    masks[1, :, L // 2:3 * L // 4] = 1
    masks[2, :, 3 * L // 4:] = 1
    question = np.zeros((B, L), np.int32)
    question[:, 2:L // 4] = 1
    return dict(tokens=toks, labels=labels, modality_masks=masks,
                question_mask=question)


def step_inputs(cfg_name, kind="fp32", spec=SPEC):
    """The base (fp32, or quantized by the port: int8, int4) and the
    adapters (B non-zero) as numpy, and the global batch: rows whose
    supervised counts differ (13, 9, 3, 1)."""
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.quant import quantize_llama_base
    cfg = CFGS[cfg_name]
    g = torch.Generator().manual_seed(0)
    base = llama.init_llama_params(g, cfg, device="cpu", dtype=torch.float32)
    if kind != "fp32":
        base = quantize_llama_base(base, bits=int(kind[-1]))
    ad = llama.init_moka_adapters(g, cfg, spec, device="cpu")
    rng = np.random.default_rng(3)
    ad = {"layers": {n: {k: (v.numpy() + 0.1 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in p.items()}
        for n, p in ad["layers"].items()}}
    toks = rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32)
    labels = np.full((B, L), -100, np.int32)
    for row, first in enumerate((2, 6, 12, 14)):
        labels[row, first:] = toks[row, first:]
    return _numpy(base), {"adapters": ad}, with_masks(toks, labels)


N_VIDEO, N_AUDIO, FRAMES = 2, 2, 32


def unified_inputs(stage2: bool):
    """``UnifiedConfig.tiny``'s fp32 frozen trees and trainables (the
    adapters' B non-zero; stage 1: projectors and the new token rows
    alone, as ``cli/pretrain.py`` trains) from the port's initializers,
    and a batch of 4 samples in bench.py's layout (prefix, <video>,
    <audio>, question, answer), as numpy."""
    from moka_tpu_torch.data import assembler as asm
    from moka_tpu_torch.models import unified
    cfg = unified.UnifiedConfig.tiny(SPEC)
    g = torch.Generator().manual_seed(0)
    frozen = unified.init_frozen(g, cfg, device="cpu", dtype=torch.float32)
    trainable = unified.init_trainable(
        g, cfg, with_adapters=stage2,
        n_new_token_embeds=len(asm.SPECIAL_TOKENS), frozen=frozen,
        device="cpu")
    trainable = _numpy(trainable)
    rng = np.random.default_rng(5)
    if stage2:
        for p in trainable["adapters"]["layers"].values():
            p["b"] = (0.05 * rng.standard_normal(p["b"].shape)).astype(
                np.float32)
    nv = N_VIDEO * cfg.vl_projector.num_query_tokens
    na = N_AUDIO * cfg.al_projector.num_query_tokens
    first = cfg.llama.vocab_size - len(asm.SPECIAL_TOKENS)
    t2i = {t: first + i for i, t in enumerate(asm.SPECIAL_TOKENS)}
    samples = []
    for i in range(B):
        answer = rng.integers(4, first, 8 - 2 * i).tolist()
        ids = (rng.integers(4, first, 6 + i).tolist()
               + [t2i["<video_start>"], t2i["<video>"], t2i["<video_end>"]]
               + [t2i["<audio_start>"], t2i["<audio>"], t2i["<audio_end>"]]
               + [t2i["<question_start>"]]
               + rng.integers(4, first, 6).tolist()
               + [t2i["<question_end>"]] + answer)
        lab = [-100] * (len(ids) - len(answer)) + answer
        samples.append(asm.assemble_sample(
            np.asarray(ids), np.asarray(lab), t2i, pad_id=0,
            n_video_tokens=nv, n_audio_tokens=na))
    batch = asm.pad_batch(samples, pad_id=0, pad_to=56)
    img = cfg.clip.image_size
    batch["video"] = rng.standard_normal(
        (B, N_VIDEO, 3, img, img)).astype(np.float32)
    batch["audio"] = rng.standard_normal(
        (B, N_AUDIO, FRAMES, 128)).astype(np.float32)
    return cfg, _numpy(frozen), trainable, batch


def _rows(batch, index, size):
    n = B // size
    return {k: (v[:, index * n:(index + 1) * n] if k == "modality_masks"
                else v[index * n:(index + 1) * n]) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _steps(mesh, loss_fn, frozen, trainable, batch, train=TRAIN,
           total=4):
    """STEPS steps of ``make_train_step`` on this rank's rows: per step the
    loss, grad norm, supervised count, every gradient and parameter."""
    import copy
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel import sharding as tsh
    from moka_tpu_torch.parallel.mesh import data_parallel_index
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    tx = make_optimizer(TrainConfig(**train), total_steps=total)
    state = init_train_state(params_from_numpy(copy.deepcopy(trainable),
                                               "cpu"), tx, DropoutKey(2))
    step = make_train_step(loss_fn, tx, mesh=mesh, grad_taps=lambda g: g)
    local = params_from_numpy(_rows(batch, *data_parallel_index(mesh)),
                              "cpu")
    out = {}
    for i in range(STEPS):
        state, m = step(state, frozen, local)
        for k in ("loss", "grad_norm", "supervised_tokens"):
            out[f"{i}:{k}"] = m[k].numpy().copy()
        for path, p in _flat(state.params).items():
            out[f"{i}:{path}"] = p.numpy().copy()  # updated in place
        for path, g in _flat(m["grad_taps"]).items():
            out[f"{i}:grad:{path}"] = g.numpy()
    return out


def run_llama(mesh, cfg_name, kind="fp32", spec=SPEC, host_offload=False,
              **opts):
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.parallel import sharding as tsh
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    base, trainable, batch = step_inputs(cfg_name, kind, spec)
    frozen = tsh.shard_params(mesh, params_from_numpy(base, "cpu"),
                              host_offload=host_offload)
    stream = tsh.stream_shardings(mesh, frozen) if host_offload else None
    loss_fn = make_llama_moka_loss(CFGS[cfg_name], spec, remat=True,
                                   mesh=mesh, host_stream=stream, **opts)
    return _steps(mesh, loss_fn, frozen, trainable, batch)


def run_unified(mesh, name):
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.parallel import sharding as tsh
    stage2 = UNIFIED[name][1]
    cfg, frozen, trainable, batch = unified_inputs(stage2)
    frozen = params_from_numpy(frozen, "cpu")
    frozen["llama"] = tsh.shard_params(mesh, frozen["llama"])
    loss_fn = unified.unified_loss(cfg, remat=True, train_adapters=stage2,
                                   mesh=mesh)
    return _steps(mesh, loss_fn, frozen, trainable, batch, UNI_TRAIN,
                  UNI_TOTAL)


def _mesh(sizes, rank):
    """The mesh of ``sizes`` over the world, or, for a smaller one, this
    rank's of the meshes laid side by side (a leading "replica" dim), and
    the rank's replica."""
    from torch.distributed.device_mesh import init_device_mesh
    from moka_tpu_torch.parallel.mesh import AXES, make_mesh
    cfg = MeshConfig(*sizes)
    if cfg.num_devices == WORLD:
        return make_mesh(cfg), 0
    full = init_device_mesh("cpu", (WORLD // cfg.num_devices, *sizes),
                            mesh_dim_names=("replica", *AXES))
    return full[AXES], rank // cfg.num_devices


def worker(rank, out_dir):
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        _worker(rank, out_dir)


def _worker(rank, out_dir):
    from moka_tpu_torch.parallel.mesh import (data_parallel_index,
                                              host_local_batch_size)
    res = {}

    def put(name, out):
        res.update({f"{name}/{k}": v for k, v in out.items()})

    for name in STEP_CASES:
        cfg_name, sizes, _, _ = JAX_CASES[name]
        mesh, _ = _mesh(sizes, rank)
        put(name, run_llama(mesh, cfg_name))
        res[f"{name}/index"] = np.asarray(data_parallel_index(mesh))
        res[f"{name}/host_batch"] = np.asarray(host_local_batch_size(8, mesh))
        if name == "mha/1,2,2":
            put("offload/1,2,2", run_llama(mesh, "mha", host_offload=True))
    for drop, spec in DROP.items():
        mesh, _ = _mesh((1, 1, 4), rank)
        put(f"drop_{drop}/1,1,4", run_llama(mesh, "mha", spec=spec))
    # two (1, 1, 2) replicas, two cases side by side
    mesh, replica = _mesh((1, 1, 2), rank)
    name = ("int8/1,1,2", "int4/1,1,2")[replica]
    put(name, run_llama(mesh, "mha", JAX_CASES[name][2], **QUANT))
    if replica == 0:
        put("pretrain/1,1,2", run_unified(mesh, "pretrain/1,1,2"))
    else:
        put("fused_moka/1,1,2", run_llama(mesh, "mha", use_fused_moka=True))
    mesh, _ = _mesh((2, 1, 2), rank)
    put("unified/2,1,2", run_unified(mesh, "unified/2,1,2"))
    np.savez(out_dir / f"r{rank}.npz", **res)


def _jax_setup():
    """JAX as the conftest sets it up (8 virtual CPU devices), on one
    thread: the jobs and the world run side by side."""
    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_job(names, out_dir):
    """JAX's steps of each case in ``names``: ``jax_<case>.npz``."""
    torch.set_num_threads(1)
    jax = _jax_setup()
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.core.config import MeshConfig as JMesh
    from moka_tpu.core.config import TrainConfig as JTrain
    from moka_tpu.models import unified as junified
    from moka_tpu.ops.moka import MokaSpec as JSpec
    from moka_tpu.parallel.mesh import make_mesh
    from moka_tpu.parallel.sharding import shard_params
    from moka_tpu.train.objectives import make_llama_moka_loss
    from moka_tpu.train.optim import make_optimizer
    from moka_tpu.train.step import init_train_state, make_train_step
    jspec = JSpec.avt(rank=4, dropout_rate=0.0)
    for name in names:
        if name in UNIFIED:
            sizes, stage2 = UNIFIED[name]
            _, frozen, trainable, batch = unified_inputs(stage2)
            mesh = make_mesh(JMesh(*sizes),
                             devices=jax.devices()[:np.prod(sizes)])
            frozen = jax.tree.map(jnp.asarray, frozen)
            frozen["llama"] = shard_params(mesh, frozen["llama"])
            loss = junified.unified_loss(junified.UnifiedConfig.tiny(jspec),
                                         remat=True, train_adapters=stage2,
                                         mesh=mesh)
            tx = make_optimizer(JTrain(**UNI_TRAIN), total_steps=UNI_TOTAL)
        else:
            cfg_name, sizes, kind, opts = JAX_CASES[name]
            base, trainable, batch = step_inputs(cfg_name, kind)
            mesh = make_mesh(JMesh(*sizes),
                             devices=jax.devices()[:np.prod(sizes)])
            frozen = shard_params(mesh, jax.tree.map(jnp.asarray, base))
            loss = make_llama_moka_loss(
                JCfg(**dataclasses.asdict(CFGS[cfg_name])), jspec,
                remat=True, **opts)
            tx = make_optimizer(JTrain(**TRAIN), total_steps=4)
        rep = NamedSharding(mesh, P())
        state = jax.device_put(init_train_state(
            jax.tree.map(jnp.asarray, trainable), tx, jax.random.key(2)), rep)
        step = make_train_step(loss, tx, donate=False,
                               grad_taps=lambda g: g)
        jb = {k: jax.device_put(jnp.asarray(v), rep)
              for k, v in batch.items()}
        out = {}
        for i in range(STEPS):
            state, m = step(state, frozen, jb)
            state = jax.device_put(state, rep)
            for k in ("loss", "grad_norm", "supervised_tokens"):
                out[f"{i}:{k}"] = np.asarray(m[k])
            for path, p in _flat(jax.tree.map(np.asarray,
                                              state.params)).items():
                out[f"{i}:{path}"] = p
            for path, g in _flat(jax.tree.map(np.asarray,
                                              m["grad_taps"])).items():
                out[f"{i}:grad:{path}"] = g
        np.savez(out_dir / f"jax_{name.replace('/', '_')}.npz", **out)


class World:
    """The port's world and JAX's jobs, each in processes of its own,
    started together."""

    def __init__(self, out_dir):
        import multiprocessing
        from moka_tpu_torch.parallel.mesh import start_world
        self.out_dir = out_dir
        self.ctx = start_world(worker, WORLD, (out_dir,))
        spawn = multiprocessing.get_context("spawn")
        self.jobs = [spawn.Process(target=jax_job, args=(names, out_dir))
                     for names in JAX_JOBS]
        for proc in self.jobs:
            proc.start()
        self.res = None

    def results(self):
        if self.res is None:
            from moka_tpu_torch.parallel.mesh import wait_world
            wait_world(self.ctx, timeout=400)
            self.res = [dict(np.load(self.out_dir / f"r{r}.npz"))
                        for r in range(WORLD)]
        return self.res

    def jax(self, name):
        job = next(p for p, names in zip(self.jobs, JAX_JOBS)
                   if name in names)
        job.join(400)
        assert job.exitcode == 0, f"JAX job of {name}: exit {job.exitcode}"
        return dict(np.load(self.out_dir /
                            f"jax_{name.replace('/', '_')}.npz"))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the file's first test, so that the tests that need
    neither the world nor JAX run while they do."""
    return World(tmp_path_factory.mktemp("tp_world"))


def _ranks_of(name, world):
    """The ranks that ran case ``name`` (a (1, 1, 2) case: its replica's)."""
    res = world.results()
    return [(r, x) for r, x in enumerate(res) if f"{name}/0:loss" in x]


def _check(got, want, name, rel_l2=None):
    """Every entry of ``want`` against ``got[name/...]``: counts exactly,
    loss and grad norm to LOSS (or ``rel_l2[1]`` and ``rel_l2[0]``),
    gradients to GRAD and GRAD_SCALE, parameters to PARAM (or both to
    relative L2 ``rel_l2[0]``)."""
    for key, w in want.items():
        g = got[f"{name}/{key}"]
        if key.endswith("supervised_tokens"):
            assert int(g) == int(w), key
        elif key.endswith("loss"):
            np.testing.assert_allclose(
                g, w, rtol=rel_l2[1] if rel_l2 else LOSS["rtol"],
                err_msg=f"{name} {key}")
        elif key.endswith("grad_norm"):
            np.testing.assert_allclose(
                g, w, rtol=rel_l2[0] if rel_l2 else LOSS["rtol"],
                err_msg=f"{name} {key}")
        elif rel_l2 is not None:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= rel_l2[0], (name, key, err)
        elif ":grad:" in key:
            np.testing.assert_allclose(
                g, w, err_msg=f"{name} {key}", rtol=GRAD["rtol"],
                atol=max(GRAD["atol"], GRAD_SCALE * np.abs(w).max()))
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{name} {key}",
                                       **PARAM)


# ------------------------------------------------- without the world

class _StubMesh:
    """A ``DeviceMesh``'s face to the rule functions: the axes' sizes and
    this rank's coordinates (no process group)."""
    mesh_dim_names = ("data", "fsdp", "model")

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]

    def get_group(self, name):
        return None


@pytest.mark.parametrize("m", [2, 4])
def test_int4_model_slice_holds_its_own_input_rows(m):
    """A row-parallel int4 weight's model slice, repacked, dequantizes to
    the rank's block of the whole weight's input rows (a plain slice of
    the packed rows would hold rows [a, b) and [h + a, h + b)); the
    column-parallel slices and the fsdp split stay plain slices."""
    from moka_tpu_torch.ops.quant import dequantize, quantize_int4
    from moka_tpu_torch.parallel import sharding as tsh
    g = torch.Generator().manual_seed(1)
    w = torch.randn((2, 176, 64), generator=g)
    q = quantize_int4(w)
    whole = dequantize(q, torch.float32)
    for i in range(m):
        for f in range(2):
            mesh = _StubMesh((1, 2, m), (0, f, i))
            local = tsh.shard_params(mesh, {"layers": {"down": q}})
            part = local["layers"]["down"]
            rows, cols = 176 // m, 32
            assert part["w_i4"].shape == (2, rows // 2, cols)
            np.testing.assert_array_equal(
                dequantize(part, torch.float32).numpy(),
                whole[:, i * rows:(i + 1) * rows,
                      f * cols:(f + 1) * cols].numpy())
            assert tsh.shard_info(part["w_i4"]).placement.spec == \
                (None, "model", "fsdp")


def test_grad_parts_by_leaf():
    """Which adapter gradients a model group sums: every A, and B of the
    column-parallel projections; o's and down's B and the projectors are
    whole on every rank (``parallel/tensor.py``'s table)."""
    from moka_tpu_torch.parallel.tensor import grad_is_part
    for name in ("q", "k", "v", "gate", "up"):
        assert grad_is_part(f"adapters/layers/{name}/a")
        assert grad_is_part(f"adapters/layers/{name}/b")
    for name in ("o", "down"):
        assert grad_is_part(f"adapters/layers/{name}/a")
        assert not grad_is_part(f"adapters/layers/{name}/b")
    for path in ("vl_projector/qformer/q/w", "new_token_embeds",
                 "al_projector/proj/b"):
        assert not grad_is_part(path)


@pytest.mark.parametrize("heads,kv,m,want", [
    (8, 2, 4, [[0], [0], [1], [1]]), (8, 4, 2, None),
    (64, 8, 16, [[i // 2] for i in range(16)]),
    (12, 3, 4, None)])
def test_kv_heads_of_a_ranks_query_heads(heads, kv, m, want):
    """Where the kv heads do not split over the model axis, each rank
    reads the kv head of each of its query heads, as one process's GQA
    maps query head j to kv head j // (heads / kv)."""
    from moka_tpu_torch.parallel.tensor import ModelSplit, kv_heads
    for i in range(m):
        sel = kv_heads(heads, kv, ModelSplit(None, m, i, kv % m != 0))
        hl = heads // m
        per_q = [(i * hl + j) // (heads // kv) for j in range(hl)]
        if isinstance(sel, slice):
            got = list(range(sel.start, sel.stop))
            ratio = hl // len(got)
            assert [got[j // ratio] for j in range(hl)] == per_q
            if want is not None:
                assert got == want[i]
        else:
            assert want is None and sel.tolist() == per_q


@pytest.mark.parametrize("c0,width", [(0, 16), (16, 16), (44, 44),
                                      (132, 44)])
def test_column_view_draws_the_whole_rows_columns(c0, width):
    """A key's column view: ``bits`` and ``bits32`` are the whole array's
    at those columns, under a row view too; kernels 6-7's plain versions
    at ``col0`` give the whole array's masks and dx there exactly, and dA
    of those rows."""
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    total = 176
    key = DropoutKey(7).rows(0, 2, 8)
    part = key.cols(c0, total)
    whole = key.bits((2, 5, total), "cpu")
    np.testing.assert_array_equal(part.bits((2, 5, width), "cpu").numpy(),
                                  whole[..., c0:c0 + width].numpy())
    rows = key.row_map((2, 5, total))
    w32 = key.bits32((10, total), "cpu", rows=rows)
    got = part.bits32((10, width), "cpu", rows=rows, col0=part.col_start)
    np.testing.assert_array_equal(got.numpy(), w32[:, c0:c0 + width].numpy())
    g = torch.Generator().manual_seed(3)
    x = torch.randn((10, total), generator=g)
    a = torch.randn((total, 12), generator=g) * 0.05
    gout = torch.randn((10, 12), generator=g)
    wdx, wda = fd.dropout_a_bwd_plain(x, a, gout, key, 0.05, rows=rows)
    xs, as_ = x[:, c0:c0 + width].contiguous(), a[c0:c0 + width].contiguous()
    dx, da = fd.dropout_a_bwd_plain(xs, as_, gout, part, 0.05, rows=rows,
                                    col0=c0)
    np.testing.assert_array_equal(dx.numpy(), wdx[:, c0:c0 + width].numpy())
    np.testing.assert_allclose(da.numpy(), wda[c0:c0 + width].numpy(),
                               rtol=1e-6, atol=1e-7)
    out = fd.dropout_a_fwd_plain(xs, as_, part, 0.05, rows=rows, col0=c0)
    keep = (w32[:, c0:c0 + width] < fd.threshold(0.05)).float()
    np.testing.assert_allclose(
        out.numpy(), ((xs * keep / 0.95) @ as_).numpy(), rtol=1e-5,
        atol=1e-6)


def test_decode_under_a_model_axis_raises():
    """A cached forward on a base split over the model axis raises: no
    entry point serves under a mesh."""
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.parallel import sharding as tsh
    cfg = CFGS["mha"]
    base = llama.init_llama_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu", dtype=torch.float32)
    local = tsh.shard_params(_StubMesh((1, 1, 2), (0, 0, 1)), base)
    cache = llama.init_kv_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="decode with a KV cache under "
                                         "tensor parallelism"):
        llama.forward(local, cfg, tokens=torch.ones((1, 2), dtype=torch.int32),
                      cache=cache, attn_mask=torch.ones((1, 8)))


# ------------------------------------------------- the world

@pytest.mark.parametrize("name", STEP_CASES)
def test_tp_steps_match_jax(world, name):
    """Two steps on each rank's rows against JAX's step on the same
    ``MeshConfig``: the global loss, grad norm and supervised count, every
    adapter leaf's gradient and every parameter, on every rank (the ranks
    of a model group feed the same rows: the data group's index and the
    host batch say so)."""
    want = world.jax(name)
    sizes = JAX_CASES[name][1]
    for r, res in enumerate(world.results()):
        _check(res, want, name)
        mc = MeshConfig(*sizes)
        index, size = res[f"{name}/index"].tolist()
        assert size == mc.data * mc.fsdp
        assert index == r // mc.model
        assert int(res[f"{name}/host_batch"]) == 8 // size


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_tp_steps_match_jax(world, kind):
    """The int8 and int4 bases (int4's o/down slices repacked) with
    ``a8_dots="full"`` and ``save_q8`` on (1, 1, 2): loss within
    QUANT_LOSS, every gradient and parameter within QUANT_L2 relative L2
    of JAX's (the module docstring's tolerance)."""
    name = f"{kind}/1,1,2"
    want = world.jax(name)
    ranks = _ranks_of(name, world)
    assert len(ranks) == 2
    for _, res in ranks:
        _check(res, want, name, rel_l2=(QUANT_L2, QUANT_LOSS))


@pytest.mark.parametrize("drop", list(DROP))
def test_tp_dropout_matches_one_process(world, drop):
    """LoRA dropout 0.05, unfused and fused (kernels 6-7's plain
    versions), on (1, 1, 4) against one process on the global batch: the
    row-parallel o/down draw the global columns' masks (the key's column
    view), the others the whole rows', so the split drops what one
    process drops."""
    want = run_llama(None, "mha", spec=DROP[drop])
    for res in world.results():
        _check(res, want, f"drop_{drop}/1,1,4")


def test_tp_host_offload_matches_resident(world):
    """(1, 2, 2) with the shards in host memory, streamed per layer (fsdp
    dims gathered, model dims local): the same numbers as the resident
    shards."""
    for res in world.results():
        keys = [k for k in res if k.startswith("offload/1,2,2/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(
                res[key], res[key.replace("offload/1,2,2", "mha/1,2,2")],
                err_msg=key)


def test_fused_moka_tp_matches_one_process(world):
    """``use_fused_moka`` on (1, 1, 2): the column-parallel projections
    hand B's columns to the fused delta, o/down take the unfused one;
    against one process's fused step."""
    want = run_llama(None, "mha", use_fused_moka=True)
    ranks = _ranks_of("fused_moka/1,1,2", world)
    assert len(ranks) == 2
    for _, res in ranks:
        _check(res, want, "fused_moka/1,1,2")


def _unified_tol(key, want):
    """``tests/test_torch_unified.py``'s rule: adapters to GRAD, the
    projectors to rtol 1e-4 with an atol of 1e-4 of the leaf's largest
    gradient (the Q-Formers' key biases have zero gradient in exact
    arithmetic) and 1e-8 of the largest of all."""
    if ":grad:" not in key or ":grad:adapters" in key:
        return GRAD if ":grad:" in key else PARAM
    scale = max(np.abs(v).max() for k, v in want.items() if ":grad:" in k)
    return dict(rtol=1e-4, atol=1e-4 * np.abs(want[key]).max() +
                1e-8 * scale)


@pytest.mark.parametrize("name", list(UNIFIED))
def test_unified_tp_step_matches_jax(world, name):
    """``unified_loss`` at ``UnifiedConfig.tiny()``: stage 2 on (2, 1, 2)
    (adapters, both projectors and the new token rows) and the pretrain
    trainables on (1, 1, 2) (projectors and token rows: every gradient
    whole on every rank, none summed over the model group), against JAX's
    steps on the same meshes; the towers, Q-Formers and projectors run
    whole on every rank."""
    want = world.jax(name)
    ranks = _ranks_of(name, world)
    assert len(ranks) == (4 if name.startswith("unified") else 2)
    for _, res in ranks:
        for key, w in want.items():
            got = res[f"{name}/{key}"]
            if key.endswith("supervised_tokens"):
                assert int(got) == int(w)
            elif key.endswith(("loss", "grad_norm")):
                np.testing.assert_allclose(got, w, err_msg=key, **LOSS)
            else:
                np.testing.assert_allclose(got, w, err_msg=f"{name} {key}",
                                           **_unified_tol(key, want))
    if name.startswith("pretrain"):
        assert not any(":grad:adapters" in k for k in want)
