"""Kernel 5's wrapper under context parallelism: the port's
``make_llama_moka_loss(context_parallel=..., use_fused_moka=True)`` over a
2-rank ``("seq",)`` gloo world against JAX's dense ``make_llama_moka_loss``
in one process, at ``LlamaConfig.tiny`` with dropout rate 0.

Each rank's fused delta attends to the question keys of both shards
(``gather_keys``) under the whole sequence's question mask
(``key_question``); on the CPU the wrapper runs its plain version with
the gathered keys, and its backward is autograd through the plain
``moka_delta`` with the same gather, whose backward sums each shard's part
home.  JAX's own fused path under a ring runs only on a TPU (its
``_apply_proj`` passes no ``interpret``), so the reference is JAX's dense
loss, the function the kernel computes.  Rank 4 is the persistent
kernel's, rank 128 the wide path's on the card.

The world is started once for the file (``parallel.mesh.start_world``),
each rank on one thread; the ranks import no JAX (the worker is a
module-level function, JAX is imported only inside functions), and JAX's
references run in spawned processes beside the world, one a rank case.

Tolerances, those of ``tests/test_torch_ring.py::
test_context_parallel_loss_matches_jax``: the loss to 1e-5 relative, each
adapter gradient to 2e-4 relative + 2e-5 absolute (fp32 on both sides; the
ring's online softmax and the gradients' sum over the shards add their
own summation orders).
"""

import numpy as np
import pytest
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.ops.moka import MokaSpec

WORLD = 2
RANKS = (4, 128)  # MokA ranks: the persistent kernel's and the wide path's
CFG = LlamaConfig.tiny(vocab_size=128, n_layers=1)
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def cp_inputs(rank):
    """A tiny fp32 base and MokA AVT adapters at ``rank`` (B non-zero) as
    numpy, and a batch of L 32 (16 a shard): a quarter of the labels
    ignored, text / video / audio = 1/2, 1/4, 1/4, and a question span in
    the first shard, so the second shard's rows attend to keys they do not
    hold."""
    from moka_tpu_torch.models import llama
    spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
    g = torch.Generator().manual_seed(rank)
    base = llama.init_llama_params(g, CFG, device="cpu", dtype=torch.float32)
    ad = llama.init_moka_adapters(g, CFG, spec, device="cpu")
    rng = np.random.default_rng(rank)
    ad = {"layers": {n: {k: (v.numpy() + 0.05 * rng.standard_normal(
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
    qm[:, 2:9] = 1
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
    """One rank: the CP loss with the fused delta at each of RANKS, its
    loss, every adapter gradient and the fused wrapper's calls saved as
    ``r<rank>.npz``."""
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        _worker(rank, out_dir)


def _worker(rank, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from moka_tpu_torch.convert import params_from_numpy
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import moka_pallas
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import tree_leaves
    seq = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("seq",))
    res = {}
    calls = []
    real = moka_pallas._forward

    def counted(*a):
        calls.append(a[-1] is not None)  # gather_keys passed
        return real(*a)

    moka_pallas._forward = counted
    for r in RANKS:
        spec = MokaSpec.avt(rank=r, dropout_rate=0.0)
        base, trainable, batch = (params_from_numpy(t, "cpu")
                                  for t in cp_inputs(r))
        leaves = tree_leaves(trainable)
        loss_fn = make_llama_moka_loss(CFG, spec, remat=True,
                                       use_flash=False, use_fused_moka=True,
                                       context_parallel=(seq, "seq"))
        for p in leaves:
            p.requires_grad_(True)
        calls.clear()
        loss, _ = loss_fn(trainable, base, batch, DropoutKey(1))
        grads = torch.autograd.grad(loss, leaves)
        res[f"calls_{r}"] = np.asarray(calls)
        res[f"loss_{r}"] = loss.detach().numpy()
        it = iter(grads)
        tree = {"adapters": {"layers": {
            n: {ab: next(it) for ab in sorted(pair)}
            for n, pair in sorted(trainable["adapters"]["layers"].items())}}}
        for path, g in _paths(tree):
            res[f"grad_{r}:{path}"] = g.numpy()
    np.savez(out_dir / f"r{rank}.npz", **res)


def jax_job(r, out_dir):
    """JAX's dense loss and gradients at rank ``r``, one process, JAX set
    up as the conftest sets it up (CPU)."""
    import os
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from moka_tpu.core.config import LlamaConfig as JCfg
    from moka_tpu.ops.moka import MokaSpec as JSpec
    from moka_tpu.train.objectives import make_llama_moka_loss as j_loss
    base, trainable, batch = jax.tree.map(jnp.asarray, cp_inputs(r))
    loss_fn = j_loss(JCfg.tiny(vocab_size=128, n_layers=1),
                     JSpec.avt(rank=r, dropout_rate=0.0), remat=True)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, base, batch, jax.random.key(1))
    out = {"loss": np.asarray(loss)}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["/".join(str(p.key) for p in path)] = np.asarray(g)
    np.savez(out_dir / f"jax_{r}.npz", **out)


class World:
    """The port's 2-rank world and JAX's references, started together."""

    def __init__(self, out_dir):
        import multiprocessing
        from moka_tpu_torch.parallel.mesh import start_world
        self.out_dir = out_dir
        self.ctx = start_world(worker, WORLD, (out_dir,))
        spawn = multiprocessing.get_context("spawn")
        self.jobs = {r: spawn.Process(target=jax_job, args=(r, out_dir))
                     for r in RANKS}
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

    def jax(self, r):
        proc = self.jobs[r]
        proc.join(300)
        assert proc.exitcode == 0, f"JAX job {r}: exit {proc.exitcode}"
        return dict(np.load(self.out_dir / f"jax_{r}.npz"))


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("ring_fused_world"))


@pytest.mark.parametrize("rank", RANKS)
def test_fused_moka_under_the_ring_matches_jax(world, rank):
    """The CP loss with kernel 5's wrapper on every projection (seven a
    layer, each with the ring's gathered keys; remat runs each again)
    against JAX's dense loss: the loss and every adapter gradient, on each
    rank (the port returns the whole loss and gradient on every rank)."""
    want = world.jax(rank)
    loss = float(want.pop("loss"))
    assert len(want) == 14  # a and b of the seven projections
    for r, res in enumerate(world.results()):
        calls = res[f"calls_{rank}"]
        assert len(calls) == 2 * 7 * CFG.n_layers and calls.all()
        np.testing.assert_allclose(float(res[f"loss_{rank}"]), loss,
                                   **LOSS_TOL)
        for path, g in want.items():
            np.testing.assert_allclose(res[f"grad_{rank}:{path}"], g,
                                       err_msg=f"rank {r} {path}",
                                       **GRAD_TOL)
