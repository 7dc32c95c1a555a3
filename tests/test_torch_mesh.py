"""The port's mesh, sharding rules, data-parallel and FSDP steps and
host-streamed base (``parallel/{mesh,sharding,stream}.py``,
``train/step.py``) against JAX's on the conftest's 8 virtual CPU devices.

The rule functions run in this process.  The steps run in one world of 4
gloo ranks started once for the file (``parallel.mesh.start_world``): the
meshes (2, 2, 1) over all four, (1, 2, 1) and (2, 1, 1) twice side by side
(``_mesh``: this rank's of two), two steps each on a global batch whose rows
hold different counts of supervised tokens, so the ranks do too; then
(1, 2, 1) with the base in host memory and (4, 1, 1) with LoRA dropout
(unfused and fused) against one process (the model axis:
``tests/test_torch_tp.py``).  JAX runs the same steps on the same ``MeshConfig``, one
process a mesh, beside the world.  The ranks import no JAX: the worker is
a module-level function and the module imports JAX only inside
functions.  The host-streamed step runs in this process.
"""

import numpy as np
import pytest
import torch

from moka_tpu_torch.core.config import LlamaConfig, MeshConfig
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.parallel import sharding as tsh

WORLD = 4
MESHES = {"1,2,1": MeshConfig(1, 2, 1), "2,1,1": MeshConfig(2, 1, 1),
          "2,2,1": MeshConfig(2, 2, 1)}
STEPS = 2
CFG = LlamaConfig.tiny(vocab_size=128, n_layers=2)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)
TRAIN = dict(learning_rate=1e-2, warmup_ratio=0.0)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
# Adam's update of an entry whose gradient is near zero is ill-conditioned:
# JAX's own (2, 2, 1) step differs from its one-device step by 3.3e-5 in
# one element of up.a after two steps at this learning rate (1e-2); the
# parameters are held to a hundredth of it, the gradients to GRAD
PARAM = dict(rtol=1e-4, atol=1e-4)
# LoRA dropout under the data-parallel mesh over the whole world: each
# rank draws its rows of the global batch's masks (unfused: blocks of a
# sample's positions; fused: kernels 6-7's plain versions at the global
# rows' Philox counters), so the mesh equals one process
DROP_SPECS = {"unfused": MokaSpec.avt(rank=4, dropout_rate=0.05),
              "fused": MokaSpec.avt(rank=4,
                                    dropout_rate=0.05).with_fused_dropout()}


def step_inputs():
    """A tiny fp32 base and adapters (B non-zero) as numpy, and a global
    batch of 4 rows of tokens whose supervised counts differ (13, 9, 3, 1):
    the mesh tests' batch (JAX's own mesh steps take tokens alone; the
    modality masks under a mesh are held by the context-parallel test,
    ``tests/test_torch_ring.py``)."""
    from moka_tpu_torch.models import llama
    g = torch.Generator().manual_seed(0)
    base = llama.init_llama_params(g, CFG, device="cpu", dtype=torch.float32)
    ad = llama.init_moka_adapters(g, CFG, SPEC, device="cpu")
    rng = np.random.default_rng(3)
    ad = {"layers": {n: {k: (v.numpy() + 0.1 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in p.items()}
        for n, p in ad["layers"].items()}}
    base = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                else v.numpy()) for k, v in base.items()}
    B, L = 4, 16
    toks = rng.integers(4, CFG.vocab_size, (B, L)).astype(np.int32)
    labels = np.full((B, L), -100, np.int32)
    for row, first in enumerate((2, 6, 12, 14)):
        labels[row, first:] = toks[row, first:]
    return base, {"adapters": ad}, dict(tokens=toks, labels=labels)


def _rows(batch, index, size):
    n = batch["labels"].shape[0] // size
    return {k: (v[:, index * n:(index + 1) * n] if k == "modality_masks"
                else v[index * n:(index + 1) * n]) for k, v in batch.items()}


def with_masks(batch):
    """``batch`` with AVT modality masks (text, video, audio: half, a
    quarter, a quarter of each row) and a question span: MokA's delta,
    and so its LoRA dropout, runs only with them."""
    B, L = batch["labels"].shape
    masks = np.zeros((3, B, L), np.int32)
    masks[0, :, :L // 2] = 1
    masks[1, :, L // 2:3 * L // 4] = 1
    masks[2, :, 3 * L // 4:] = 1
    question = np.zeros((B, L), np.int32)
    question[:, 2:L // 4] = 1
    return dict(batch, modality_masks=masks, question_mask=question)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def worker(rank, out_dir):
    """One rank: every mesh, its results saved as ``r<rank>.npz``."""
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        _worker(rank, out_dir)


def _run_steps(mesh, base, trainable, batch, host_offload=False,
               spec=SPEC):
    import copy
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel.mesh import data_parallel_index
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    frozen = tsh.shard_params(mesh, params_from_numpy(base, "cpu"),
                              host_offload=host_offload)
    stream = tsh.stream_shardings(mesh, frozen) if host_offload else None
    tx = make_optimizer(TrainConfig(**TRAIN), total_steps=4)
    state = init_train_state(params_from_numpy(copy.deepcopy(trainable),
                                               "cpu"), tx, DropoutKey(2))
    step = make_train_step(make_llama_moka_loss(CFG, spec, remat=True,
                                                mesh=mesh,
                                                host_stream=stream), tx,
                           mesh=mesh, grad_taps=lambda g: g)
    local = params_from_numpy(_rows(batch, *data_parallel_index(mesh)),
                              "cpu")
    out = {"q_local_shape": np.asarray(frozen["layers"]["q"].shape)}
    for i in range(STEPS):
        state, m = step(state, frozen, local)
        for k in ("loss", "grad_norm", "supervised_tokens"):
            out[f"{i}:{k}"] = m[k].numpy().copy()
        for path, p in _flat(state.params).items():
            out[f"{i}:{path}"] = p.numpy().copy()  # updated in place
        for path, g in _flat(m["grad_taps"]).items():
            out[f"{i}:grad:{path}"] = g.numpy()
    return out


def _mesh(cfg):
    """``make_mesh(cfg)`` over the world, or, for a smaller mesh, this
    rank's of several laid side by side (a leading "replica" dim)."""
    from torch.distributed.device_mesh import init_device_mesh
    from moka_tpu_torch.parallel.mesh import AXES, make_mesh
    if cfg.num_devices == WORLD:
        return make_mesh(cfg)
    full = init_device_mesh("cpu", (WORLD // cfg.num_devices, cfg.data,
                                    cfg.fsdp, cfg.model),
                            mesh_dim_names=("replica", *AXES))
    return full[AXES]


def _worker(rank, out_dir):
    from moka_tpu_torch.parallel.mesh import make_mesh
    base, trainable, batch = step_inputs()
    res = {}
    for name, cfg in MESHES.items():
        mesh = _mesh(cfg)
        res.update({f"{name}/{k}": v for k, v in
                    _run_steps(mesh, base, trainable, batch).items()})
        if name == "1,2,1":
            res.update({f"{name}+offload/{k}": v for k, v in _run_steps(
                mesh, base, trainable, batch, host_offload=True).items()})
    mesh = make_mesh(MeshConfig(WORLD, 1, 1))
    for name, spec in DROP_SPECS.items():
        res.update({f"drop_{name}/{k}": v for k, v in _run_steps(
            mesh, base, trainable, with_masks(batch), spec=spec).items()})
    np.savez(out_dir / f"r{rank}.npz", **res)


def _jax_setup():
    """JAX as the conftest sets it up (8 virtual CPU devices), on one
    thread: the meshes run side by side."""
    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_job(name, out_dir):
    """JAX's step on mesh ``name``: ``jax_<name>.npz``."""
    jax = _jax_setup()
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.core.config import MeshConfig as JMesh
    from moka_tpu.core.config import TrainConfig as JTrain
    from moka_tpu.ops.moka import MokaSpec as JSpec
    from moka_tpu.parallel.mesh import batch_sharding, make_mesh
    from moka_tpu.parallel.sharding import shard_params
    from moka_tpu.train.objectives import make_llama_moka_loss
    from moka_tpu.train.optim import make_optimizer
    from moka_tpu.train.step import init_train_state, make_train_step
    cfg = MESHES[name]
    mesh = make_mesh(JMesh(cfg.data, cfg.fsdp, cfg.model),
                     devices=jax.devices()[:cfg.num_devices])
    base, trainable, batch = jax.tree.map(jnp.asarray, step_inputs())
    frozen = shard_params(mesh, base)
    tx = make_optimizer(JTrain(**TRAIN), total_steps=4)
    state = jax.device_put(init_train_state(trainable, tx,
                                            jax.random.key(2)),
                           NamedSharding(mesh, P()))
    step = make_train_step(make_llama_moka_loss(
        JCfg.tiny(vocab_size=128, n_layers=2),
        JSpec.avt(rank=4, dropout_rate=0.0), remat=True), tx, donate=False,
        grad_taps=lambda g: g)
    jb = {k: jax.device_put(v, batch_sharding(mesh))
          for k, v in batch.items()}
    out = {}
    for i in range(STEPS):
        state, m = step(state, frozen, jb)
        # the step hands back its own shardings; replicated again, the
        # second step reuses the first one's compile
        state = jax.device_put(state, NamedSharding(mesh, P()))
        for k in ("loss", "grad_norm", "supervised_tokens"):
            out[f"{i}:{k}"] = np.asarray(m[k])
        for path, p in _flat(jax.tree.map(np.asarray,
                                          state.params)).items():
            out[f"{i}:{path}"] = p
        for path, g in _flat(jax.tree.map(np.asarray,
                                          m["grad_taps"])).items():
            out[f"{i}:grad:{path}"] = g
    np.savez(out_dir / f"jax_{name}.npz", **out)


class World:
    """The port's world and JAX's steps, each in processes of its own,
    started together."""

    def __init__(self, out_dir):
        import multiprocessing
        from moka_tpu_torch.parallel.mesh import start_world
        self.out_dir = out_dir
        self.ctx = start_world(worker, WORLD, (out_dir,))
        spawn = multiprocessing.get_context("spawn")
        self.jobs = {name: spawn.Process(target=jax_job, args=(name, out_dir))
                     for name in MESHES}
        for proc in self.jobs.values():
            proc.start()
        self.res = None

    def results(self):
        if self.res is None:
            from moka_tpu_torch.parallel.mesh import wait_world
            wait_world(self.ctx, timeout=300)
            self.res = [dict(np.load(self.out_dir / f"r{r}.npz"))
                        for r in range(WORLD)]
        return self.res

    def jax(self, name):
        proc = self.jobs[name]
        proc.join(300)
        assert proc.exitcode == 0, f"JAX mesh {name}: exit {proc.exitcode}"
        return dict(np.load(self.out_dir / f"jax_{name}.npz"))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the file's first test, so that the tests that need
    neither the world nor JAX's steps run while they do."""
    return World(tmp_path_factory.mktemp("mesh_world"))


# ------------------------------------------------------------------- rules

def _port_llama(kind):
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.quant import quantize_llama_base
    base = llama.init_llama_params(torch.Generator().manual_seed(0), CFG,
                                   device="cpu")
    if kind == "bf16":
        return base
    bits = int(kind[-1])
    return quantize_llama_base(base, bits=bits, head_bits=bits)


def _jax_llama(kind):
    import jax
    import jax.numpy as jnp
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.models import llama as jllama
    from moka_tpu.ops.quant import quantize_llama_base

    def make():
        base = jllama.init_llama_params(
            jax.random.key(0), JCfg.tiny(vocab_size=128, n_layers=2),
            dtype=jnp.bfloat16)
        if kind == "bf16":
            return base
        bits = int(kind[-1])
        return quantize_llama_base(base, bits=bits, head_bits=bits)
    return jax.eval_shape(make)


def _jax_specs(tree, prefix=()):
    import jax
    from moka_tpu.parallel.sharding import _path_str, spec_for_path
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p = _path_str(prefix + tuple(path))
        out[p] = (tuple(spec_for_path(p, len(leaf.shape))), leaf.shape)
    return out


def _port_specs(tree, prefix=""):
    out = {}
    for path, leaf in _flat(tree, prefix).items():
        if leaf is not None:
            out[path] = (tsh.spec_for_path(path, leaf.dim()),
                         tuple(leaf.shape))
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_llama_rules_match_jax(kind):
    """spec_for_path on every leaf of a tiny llama tree, bare and under
    ``llama/``, against JAX's; the same paths and shapes on both sides."""
    for prefix in ("", "llama"):
        want = _jax_specs({"llama": _jax_llama(kind)} if prefix else
                          _jax_llama(kind))
        got = _port_specs({"llama": _port_llama(kind)} if prefix else
                          _port_llama(kind))
        assert got == want


def test_unified_frozen_rules_match_jax():
    """Every leaf of ``UnifiedConfig.tiny``'s frozen tree (LLaMA, CLIP,
    BEATs): the encoders fall to replicated in both."""
    import jax
    from moka_tpu.models import unified as junified
    from moka_tpu_torch.models import unified
    jt = jax.eval_shape(lambda: junified.init_frozen(
        jax.random.key(0), junified.UnifiedConfig.tiny()))
    pt = unified.init_frozen(torch.Generator().manual_seed(0),
                             unified.UnifiedConfig.tiny(), device="cpu")
    want = _jax_specs(jt)
    got = _port_specs(pt)
    assert got == {p: w for p, w in want.items() if p in got}
    # BEATs' absent patch bias is None in both (a leaf JAX drops)
    assert set(want) - set(got) == set()
    assert got["llama/layers/q"][0] == (None, "fsdp", "model")
    assert got["clip/layers/q/w"][0] == (None, None, None)


def test_divisible_spec_matches_jax():
    """``_divisible_spec``'s cases of ``tests/test_multichip_aot.py``: the
    odd vocab 32011 cannot split over model 2; tuple axes multiply."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from moka_tpu.parallel.sharding import _divisible_spec
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 4, 2),
                ("data", "fsdp", "model"))
    cfg = MeshConfig(1, 4, 2)
    for spec, shape in ((("fsdp", "model"), (4096, 32011)),
                        (("fsdp", "model"), (4096, 32000)),
                        ((("data", "fsdp"), None), (6, 32)),
                        ((None, "fsdp"), (32011, 4096)),
                        ((None, "model", "fsdp"), (2, 11008, 4096))):
        want = tuple(_divisible_spec(mesh, P(*spec), shape))
        assert tsh._divisible_spec(cfg, spec, shape) == want, spec
    assert tsh._divisible_spec(cfg, ("fsdp", "model"), (4096, 32011)) == \
        ("fsdp", None)


def test_offload_and_stream_placements_match_jax():
    """``param_shardings(host_offload=True)`` (pinned host memory) and
    ``stream_shardings`` (device memory, the layer axis dropped) on a
    (1, 4, 1) mesh, leaf by leaf, for a bf16 and an int8 tree, and on a
    (1, 2, 2) mesh, whose model axis splits the projections as JAX's
    rules do."""
    import jax
    from moka_tpu.core.config import MeshConfig as JMesh
    from moka_tpu.parallel.mesh import make_mesh
    from moka_tpu.parallel.sharding import param_shardings, stream_shardings
    for sizes in ((1, 4, 1), (1, 2, 2)):
        mesh = make_mesh(JMesh(*sizes), devices=jax.devices()[:4])
        cfg = MeshConfig(*sizes)
        for kind in ("bf16", "int8"):
            jt, pt = _jax_llama(kind), _port_llama(kind)
            for jfn, pfn in (
                    (lambda t: param_shardings(mesh, t, host_offload=True),
                     lambda t: tsh.param_shardings(cfg, t,
                                                   host_offload=True)),
                    (lambda t: stream_shardings(mesh, t),
                     lambda t: tsh.stream_shardings(cfg, t))):
                want = {p: (tuple(s.spec), s.memory_kind)
                        for p, s in _flat(jax.tree.map(
                            lambda s: s, jfn(jt),
                            is_leaf=lambda s: hasattr(s, "spec"))).items()}
                got = {p: (s.spec, s.memory_kind)
                       for p, s in _flat(pfn(pt)).items()}
                assert got == want
    assert tsh.param_shardings(MeshConfig(1, 2, 2), _port_llama("bf16"))[
        "layers"]["o"].spec == (None, "model", "fsdp")


def test_host_local_batch_size_matches_jax():
    """One process: the whole batch, and JAX's warning when the data
    axes do not divide it."""
    import warnings
    import jax
    from moka_tpu.core.config import MeshConfig as JMesh
    from moka_tpu.parallel.mesh import host_local_batch_size, make_mesh
    from moka_tpu_torch.parallel.mesh import host_local_batch_size as port
    mesh = make_mesh(JMesh(2, 2, 1), devices=jax.devices()[:4])
    for global_batch in (8, 6):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = host_local_batch_size(global_batch, mesh)
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            got = port(global_batch, MeshConfig(2, 2, 1))
        assert got == want
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]


# ------------------------------------------------------------------- steps

@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_steps_match_jax(world, name):
    """Two steps on each rank's rows against JAX's step on the same
    ``MeshConfig``: the global loss (the CE over the global count of
    targets, though the ranks hold 13 + 9 against 3 + 1, or 13, 9, 3, 1),
    the grad norm, the global supervised count, every gradient and every
    parameter, on every rank (replicas agree)."""
    want = world.jax(name)
    for r, res in enumerate(world.results()):
        for key, w in want.items():
            got = res[f"{name}/{key}"]
            if key.endswith("supervised_tokens"):
                assert int(got) == int(w), (r, key)
            elif key.endswith(("loss", "grad_norm")):
                np.testing.assert_allclose(got, w, **LOSS,
                                           err_msg=f"rank {r} {key}")
            elif ":grad:" in key:
                np.testing.assert_allclose(got, w, **GRAD,
                                           err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_allclose(got, w, **PARAM,
                                           err_msg=f"rank {r} {key}")
        # fsdp shards q's d_in over its size
        fsdp = MESHES[name].fsdp
        assert res[f"{name}/q_local_shape"].tolist() == \
            [CFG.n_layers, CFG.dim // fsdp, CFG.n_heads * CFG.head_dim]


def test_fsdp_host_offload_step_matches_resident(world):
    """(1, 2, 1) with the shards in host memory, streamed per layer: the
    same numbers as the resident shards."""
    for res in world.results():
        for key, v in res.items():
            if key.startswith("1,2,1+offload/"):
                np.testing.assert_array_equal(
                    v, res[key.replace("+offload", "")], err_msg=key)


@pytest.mark.parametrize("name", list(DROP_SPECS))
def test_mesh_dropout_matches_one_process(world, name):
    """Two steps with LoRA dropout 0.05 on the (4, 1, 1) mesh, one sample
    a rank, against the same steps in one process on the global batch:
    the ranks draw the global rows' masks, so the loss, the gradients and
    the parameters are one process's on every rank, at the tolerances of
    the JAX comparisons above."""
    base, trainable, batch = step_inputs()
    want = _run_steps(None, base, trainable, with_masks(batch),
                      spec=DROP_SPECS[name])
    for r, res in enumerate(world.results()):
        for key, w in want.items():
            got = res[f"drop_{name}/{key}"]
            tol = LOSS if key.endswith(("loss", "grad_norm")) else \
                GRAD if ":grad:" in key else PARAM
            if key == "q_local_shape":
                continue
            np.testing.assert_allclose(got, w, **tol,
                                       err_msg=f"rank {r} {key}")


def test_host_stream_step_matches_resident():
    """The base in host memory with ``host_stream`` against the resident
    base, as JAX's ``test_host_stream_step_matches_device_resident``: the
    same loss and parameters, and each layer fetched twice a step under
    full remat (the forward and the recompute).  On the CPU the fetch is
    the host tensor itself (no device memory to stream into)."""
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel import stream as tstream
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import make_optimizer, tree_leaves
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    base, trainable, batch = step_inputs()
    tb = params_from_numpy(batch, "cpu")
    out = {}
    for offload in (False, True):
        frozen = tsh.shard_params(None, params_from_numpy(base, "cpu"),
                                  host_offload=offload)
        hs = tsh.stream_shardings(None, frozen) if offload else None
        tx = make_optimizer(TrainConfig(**TRAIN), total_steps=4)
        state = init_train_state(params_from_numpy(trainable, "cpu"), tx,
                                 DropoutKey(2))
        step = make_train_step(make_llama_moka_loss(
            CFG, SPEC, remat=True, fused_loss=True, host_stream=hs), tx)
        tstream.reset_counts()
        fetches = []
        for _ in range(STEPS):
            state, m = step(state, frozen, tb)
            fetches.append(tstream.COUNTS["layer_fetches"])
        out[offload] = (float(m["loss"]), tree_leaves(state.params),
                        fetches)
    assert out[False][2] == [0, 0]
    assert out[True][2] == [2 * CFG.n_layers, 4 * CFG.n_layers]
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
