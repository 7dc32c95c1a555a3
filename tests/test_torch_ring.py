"""Context parallelism in the port (``parallel/ring_attention.py``,
``llama.forward(context_parallel=...)``) against JAX's ring on the
conftest's 8 virtual CPU devices.

The port runs in one world of 8 gloo ranks, started once for the file
(``parallel.mesh.start_world``): the dense and flash rings' forward at 4
shards (on ranks 0-3, a 4-rank sequence group of a (2, 4) mesh) and
their gradients at 8 shards of L 40 (5 rows a shard: ragged against the
flash blocks), then ``make_llama_moka_loss(context_parallel=...)`` with
modality masks and remat, flash off and on, on a 4-rank group.  The ranks
import no JAX: the worker is a module-level function and the module
imports JAX only inside functions.  JAX's side runs beside the world, one
process a case (``World``).
Tolerances are JAX's own tests' (``tests/test_ring_attention.py``).
"""

import numpy as np
import pytest
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.ops.moka import MokaSpec

FWD = dict(L=32, shards=4, seed=0)
GRAD = dict(L=40, shards=8, seed=1)
WORLD = 8
CP_SHARDS = 4
CFG = LlamaConfig.tiny(vocab_size=128, n_layers=2)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)


def attn_inputs(L, seed, b=2, H=4, KH=2, hd=8):
    """JAX's test data: fp32 q, k, v and a mask with 5 left pads."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, L, H, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, KH, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, KH, hd)).astype(np.float32)
    mask = np.ones((b, L), np.int32)
    mask[0, :5] = 0
    return q, k, v, mask


def cp_inputs():
    """A tiny fp32 base and adapters (B non-zero) as numpy, and the batch of
    JAX's context-parallel test: a quarter of the labels ignored, text /
    video / audio = 1/2, 1/4, 1/4, a question span."""
    from moka_tpu_torch.models import llama
    g = torch.Generator().manual_seed(0)
    base = llama.init_llama_params(g, CFG, device="cpu", dtype=torch.float32)
    ad = llama.init_moka_adapters(g, CFG, SPEC, device="cpu")
    rng = np.random.default_rng(5)
    ad = {"layers": {n: {k: (v.numpy() + 0.1 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in p.items()}
        for n, p in ad["layers"].items()}}
    base = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                else v.numpy()) for k, v in base.items()}
    b, L = 2, 32
    toks = rng.integers(4, CFG.vocab_size, (b, L)).astype(np.int32)
    labels = toks.copy()
    labels[:, : L // 4] = -100
    mod = np.zeros((3, b, L), np.float32)
    mod[0, :, : L // 2] = 1
    mod[1, :, L // 2: 3 * L // 4] = 1
    mod[2, :, 3 * L // 4:] = 1
    qm = np.zeros((b, L), np.float32)
    qm[:, 2:6] = 1
    batch = dict(tokens=toks, labels=labels, modality_masks=mod,
                 question_mask=qm)
    return base, {"adapters": ad}, batch


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def worker(rank, out_dir):
    """One rank: every case, its results saved as ``r<rank>.npz``.  The
    inputs are made here from their seeds: spawn arguments pass through a
    pipe the parent fills while the child imports, so large ones would
    serialize the ranks' start."""
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        _worker(rank, out_dir)


def _worker(rank, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel.ring_attention import (
        make_ring_attention, make_ring_flash_attention)
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import tree_leaves
    rings = {"dense": make_ring_attention, "flash": make_ring_flash_attention}
    seq8 = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("seq",))
    seq4 = init_device_mesh("cpu", (WORLD // CP_SHARDS, CP_SHARDS),
                            mesh_dim_names=("rep", "seq"))["seq"]
    res = {}
    # the 4-shard cases run on the first 4-rank group; the second group
    # (ranks 4-7) only joins the 8-shard ring
    first = rank < CP_SHARDS
    q, k, v, mask = (torch.from_numpy(t) for t in attn_inputs(
        FWD["L"], FWD["seed"]))
    n = FWD["L"] // FWD["shards"]
    sl = slice(rank * n, (rank + 1) * n)
    for name, make in rings.items() if first else ():
        out = make(seq4, "seq")(q[:, sl], k[:, sl], v[:, sl], mask[:, sl])
        res[f"fwd_{name}"] = out.numpy()

    q, k, v, mask = (torch.from_numpy(t) for t in attn_inputs(
        GRAD["L"], GRAD["seed"]))
    n = GRAD["L"] // GRAD["shards"]
    sl = slice(rank * n, (rank + 1) * n)
    vq = mask.float()[:, sl, None, None]
    for name, make in rings.items():
        ql, kl, vl = (t[:, sl].clone().requires_grad_(True)
                      for t in (q, k, v))
        out = make(seq8, "seq")(ql, kl, vl, mask[:, sl])
        ((out * vq) ** 2).sum().backward()
        for t, g in (("q", ql), ("k", kl), ("v", vl)):
            res[f"d{t}_{name}"] = g.grad.numpy()

    base, trainable, batch = (params_from_numpy(t, "cpu")
                              for t in cp_inputs())
    leaves = tree_leaves(trainable)
    for flash in (False, True) if first else ():
        loss_fn = make_llama_moka_loss(CFG, SPEC, remat=True,
                                       use_flash=flash,
                                       context_parallel=(seq4, "seq"))
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(trainable, base, batch, DropoutKey(1))
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        res[f"cp_loss_{flash}"] = loss.detach().numpy()
        it = iter(grads)
        tree = {"adapters": {"layers": {
            n: {ab: next(it) for ab in sorted(pair)}
            for n, pair in sorted(trainable["adapters"]["layers"].items())}}}
        for path, g in _paths(tree):
            res[f"cp_grad_{flash}:{path}"] = g.numpy()
    np.savez(out_dir / f"r{rank}.npz", **res)


class World:
    """The port's world and JAX's references, each in processes of its own
    started together: the 8 ranks, and one process a JAX case (JAX's
    compiles dominate; run one after another they took most of a minute).
    Each JAX process sets up JAX as the conftest does: 8 virtual CPU
    devices."""

    def __init__(self, out_dir):
        import multiprocessing
        from moka_tpu_torch.parallel.mesh import start_world
        self.out_dir = out_dir
        self.ctx = start_world(worker, WORLD, (out_dir,))
        spawn = multiprocessing.get_context("spawn")
        self.jobs = {name: spawn.Process(target=jax_job, args=(name, out_dir))
                     for name in JAX_JOBS}
        for proc in self.jobs.values():
            proc.start()
        self.res = self.want = None

    def results(self):
        if self.res is None:
            from moka_tpu_torch.parallel.mesh import wait_world
            wait_world(self.ctx, timeout=300)
            self.res = [dict(np.load(self.out_dir / f"r{r}.npz"))
                        for r in range(WORLD)]
        return self.res

    def jax(self, case):
        name = next(j for j, cases in JAX_JOBS.items() if case in cases)
        proc = self.jobs[name]
        proc.join(300)
        assert proc.exitcode == 0, f"JAX job {name}: exit {proc.exitcode}"
        return dict(np.load(self.out_dir / f"jax_{case}.npz"))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("ring_world"))


def _jax_setup():
    """JAX as the conftest sets it up, on one thread: the cases run side by
    side, and XLA's thread pools spun against each other."""
    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _rings():
    from moka_tpu.parallel.ring_attention import (make_ring_attention,
                                                  make_ring_flash_attention)
    return {"dense": make_ring_attention,
            "flash": lambda m, a: make_ring_flash_attention(m, a,
                                                            interpret=True)}


def _jax_rings_fwd(name):
    import jax
    import jax.numpy as jnp
    q, k, v, mask = (jnp.asarray(t) for t in attn_inputs(FWD["L"],
                                                         FWD["seed"]))
    ring = _rings()[name](_mesh(FWD["shards"]), "seq")
    return {"out": np.asarray(jax.jit(ring)(q, k, v, mask))}


def _jax_rings_grad(name):
    import jax
    import jax.numpy as jnp
    q, k, v, mask = (jnp.asarray(t) for t in attn_inputs(GRAD["L"],
                                                         GRAD["seed"]))
    vq = mask.astype(jnp.float32)[:, :, None, None]
    ring = _rings()[name](_mesh(GRAD["shards"]), "seq")
    grads = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum((ring(q, k, v, mask) * vq) ** 2),
        argnums=(0, 1, 2)))(q, k, v)
    return {f"d{t}": np.asarray(g) for t, g in zip("qkv", grads)}


def _jax_cp_loss(use_flash):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.ops.moka import MokaSpec as JSpec
    from moka_tpu.train.objectives import make_llama_moka_loss as j_loss
    base, trainable, batch = jax.tree.map(jnp.asarray, cp_inputs())
    mesh = _mesh(CP_SHARDS)
    loss_fn = j_loss(JCfg.tiny(vocab_size=128, n_layers=2),
                     JSpec.avt(rank=4, dropout_rate=0.0), remat=True,
                     use_flash=use_flash, context_parallel=(mesh, "seq"))
    seq = {"tokens": P(None, "seq"), "labels": P(None, "seq"),
           "modality_masks": P(None, None, "seq"),
           "question_mask": P(None, "seq")}
    batch = {k: jax.device_put(v, NamedSharding(mesh, seq[k]))
             for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, base, batch, jax.random.key(1))
    out = {"loss": np.asarray(loss)}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["/".join(str(p.key) for p in path)] = np.asarray(g)
    return out


CASES = {"fwd_dense": lambda: _jax_rings_fwd("dense"),
         "fwd_flash": lambda: _jax_rings_fwd("flash"),
         "grad_dense": lambda: _jax_rings_grad("dense"),
         "grad_flash": lambda: _jax_rings_grad("flash"),
         "cp_False": lambda: _jax_cp_loss(False),
         "cp_True": lambda: _jax_cp_loss(True)}
# the JAX processes and their cases, balanced by compile time
JAX_JOBS = {"dense": ("fwd_dense", "grad_dense"), "fwd_flash": ("fwd_flash",),
            "grad_flash": ("grad_flash",), "cp_False": ("cp_False",),
            "cp_True": ("cp_True",)}


def jax_job(name, out_dir):
    """JAX's cases of job ``name``, in a process of its own: one
    ``jax_<case>.npz`` each."""
    _jax_setup()
    for case in JAX_JOBS[name]:
        np.savez(out_dir / f"jax_{case}.npz", **CASES[case]())


def test_rings_forward_match_jax(world):
    """Each ring's output over 4 shards, gathered, against JAX's ring."""
    mask = attn_inputs(FWD["L"], FWD["seed"])[3]
    valid = mask[:, :, None, None]
    res = world.results()
    for name in ("dense", "flash"):
        want = world.jax(f"fwd_{name}")["out"]
        got = np.concatenate([res[r][f"fwd_{name}"] for r in
                              range(FWD["shards"])], 1)
        np.testing.assert_allclose(got * valid, want * valid, rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_rings_grads_match_jax(world):
    """dq, dk, dv of sum((ring * valid)^2) over 8 shards of 5 rows."""
    res = world.results()
    for name in ("dense", "flash"):
        want = world.jax(f"grad_{name}")
        for t in "qkv":
            got = np.concatenate([res[r][f"d{t}_{name}"]
                                  for r in range(WORLD)], 1)
            np.testing.assert_allclose(got, want[f"d{t}"], rtol=3e-4,
                                       atol=3e-4, err_msg=f"{name} d{t}")


@pytest.mark.parametrize("use_flash", [False, True])
def test_context_parallel_loss_matches_jax(world, use_flash):
    """``make_llama_moka_loss(context_parallel=...)`` (remat, modality
    masks, the question keys of every shard) against JAX's on a 4-device
    ``("seq",)`` mesh: the loss and every adapter gradient, on each rank
    (the port returns the whole loss and gradient on every rank)."""
    want = world.jax(f"cp_{use_flash}")
    loss = float(want.pop("loss"))
    assert len(want) == 14  # a and b of the seven projections
    for r, res in enumerate(world.results()[:CP_SHARDS]):
        np.testing.assert_allclose(float(res[f"cp_loss_{use_flash}"]), loss,
                                   rtol=1e-5)
        for path, g in want.items():
            np.testing.assert_allclose(res[f"cp_grad_{use_flash}:{path}"], g,
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r} {path}")
