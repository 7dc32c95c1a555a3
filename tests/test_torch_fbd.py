"""Port parity: ``moka_tpu_torch.ops.fbd`` and BOFT's weight
(``adapters.peft.boft_weight``/``boft_linear``) against the JAX package on
the CPU, same numpy inputs on both sides.

JAX's ``block_diag_matmul`` kernel (TPU kernel 10) runs in Pallas
interpret mode, as its own tests run it; ``boft_weight`` does not pass
``interpret`` through, so BOFT is held against JAX's ``use_pallas=False``
path, which computes the same function.  On the CPU the port's
``block_diag_matmul`` takes its plain version whatever ``use_pallas`` says.

Tolerances: fp32 1e-5 relative + absolute (sums of at most 16 products in
another order); bf16 outputs one bf16 ulp of each element (fp32 sums that
differ in the last bit can round to neighbouring bf16 values); gradients
2e-4 relative + 1e-6, JAX's own tolerance for the MokA op's gradients
(``tests/test_moka_op.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.adapters import peft as jpeft
from moka_tpu.ops import fbd as jfbd
from moka_tpu_torch.adapters import peft as tpeft
from moka_tpu_torch.ops import fbd

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-6)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _close_bf16(got: torch.Tensor, want) -> None:
    """Each element within one bf16 ulp of JAX's."""
    g, w = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-30)


def test_fast_block_diag_matches_jax_with_grad():
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 12)).astype(np.float32)
    want = jfbd.fast_block_diag(jnp.asarray(blocks))
    jg = jax.grad(lambda b: jnp.sum(jfbd.fast_block_diag(b) * cot))(
        jnp.asarray(blocks))
    t = torch.tensor(blocks, requires_grad=True)
    got = fbd.fast_block_diag(t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (tg,) = torch.autograd.grad((got * torch.tensor(cot)).sum(), t)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("n,stride", [(8, 1), (8, 2), (8, 4), (12, 2),
                                      (6, 3), (2, 1)])
def test_butterfly_perm_matches_jax(n, stride):
    got = fbd.butterfly_perm(n, stride)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfbd.butterfly_perm(n, stride)))
    assert sorted(got.tolist()) == list(range(n))
    if stride == 1:  # the first BOFT factor's gather permutes nothing
        assert got.tolist() == list(range(n))


def test_cayley_matches_jax_and_is_orthogonal():
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((2, 5, 8, 8)) * 0.3).astype(np.float32)
    want = jfbd.cayley(jnp.asarray(q))
    got = fbd.cayley(torch.tensor(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    eye = torch.eye(8).expand(2, 5, 8, 8)
    np.testing.assert_allclose((got @ got.transpose(-1, -2)).numpy(),
                               eye.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,n,b,m", [(1, 4, 8, 128), (2, 3, 16, 256),
                                     (2, 5, 4, 128), (1, 3, 8, 96),
                                     (1, 2, 4, 12), (1, 2, 32, 256),
                                     (1, 2, 8, 11008)])
def test_block_diag_matmul_matches_jax_kernel(z, n, b, m, dtype):
    """The plain version against JAX's ``block_diag_matmul(use_pallas=
    True)``: its interpret-mode kernel where the gate takes the shape
    (b % 8 == 0, m % 128 == 0), its einsum where it refuses."""
    rng = np.random.default_rng(2)
    blocks = (rng.standard_normal((z, n, b, b)) * 0.3).astype(np.float32)
    x = rng.standard_normal((z, n * b, m)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jfbd.block_diag_matmul(jnp.asarray(blocks), jx, use_pallas=True,
                                  interpret=True)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = fbd.block_diag_matmul(torch.tensor(blocks), tx, use_pallas=True)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert fbd.kernel_takes(b, m, tx.dtype) == (b % 8 == 0 and m % 128 == 0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        _close_bf16(got, want)
    assert fbd.block_diag_matmul.launches == 0  # CPU tensors never launch


def test_block_diag_matmul_grads_match_jax_einsum():
    """Gradients through the plain version (``use_pallas=False``) against
    JAX's einsum path, in blocks and in x."""
    rng = np.random.default_rng(3)
    blocks = (rng.standard_normal((2, 3, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 24, 128)).astype(np.float32)
    cot = rng.standard_normal((2, 24, 128)).astype(np.float32)
    jg = jax.grad(lambda b, v: jnp.sum(jfbd.block_diag_matmul(
        b, v, use_pallas=False) * cot), argnums=(0, 1))(jnp.asarray(blocks),
                                                      jnp.asarray(x))
    tb = torch.tensor(blocks, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = fbd.block_diag_matmul(tb, tx, use_pallas=False)
    tg = torch.autograd.grad((y * torch.tensor(cot)).sum(), (tb, tx))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


def test_kernel_path_has_no_backward(monkeypatch):
    """The kernel path is forward only, as JAX's: autograd through it
    raises instead of differentiating the einsum.  (On the CPU the kernel
    is stood in for by its plain version.)"""
    monkeypatch.setattr(fbd, "_launch", fbd.block_diag_matmul_plain)
    blocks = torch.randn((1, 2, 8, 8), requires_grad=True)
    y = fbd._KernelProduct.apply(blocks, torch.randn((1, 16, 128)))
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        y.sum().backward()


@pytest.mark.parametrize("d_in,d_out,block,factors", [
    (32, 12, 4, 3),   # 8 blocks: strides 1, 2, 4 all permute
    (8, 6, 4, 2),     # 2 blocks: the second factor takes the else branch
    (64, 128, 8, 2),  # the kernel's gate passes: use_pallas=True on the CPU
])
def test_boft_weight_and_linear_match_jax(d_in, d_out, block, factors):
    """``boft_weight`` and ``boft_linear`` against JAX's ``use_pallas=
    False`` path, with gradients in ``q``; the weight keeps column norms
    (an orthogonal transform of the in-features axis)."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    q = (rng.standard_normal((factors, d_in // block, block, block))
         * 0.1).astype(np.float32)
    x = rng.standard_normal((3, d_in)).astype(np.float32)
    cot = rng.standard_normal((3, d_out)).astype(np.float32)
    js, ts = jpeft.BoftSpec(block, factors), tpeft.BoftSpec(block, factors)
    want = jpeft.boft_weight(jnp.asarray(w), {"q": jnp.asarray(q)}, js)
    tq = torch.tensor(q, requires_grad=True)
    got = tpeft.boft_weight(torch.tensor(w), {"q": tq}, ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    kern = tpeft.boft_weight(torch.tensor(w), {"q": torch.tensor(q)}, ts,
                             use_pallas=True)
    np.testing.assert_array_equal(kern.numpy(), got.detach().numpy())
    np.testing.assert_allclose(got.detach().norm(dim=0).numpy(),
                               np.linalg.norm(w, axis=0), rtol=1e-5)
    jg = jax.grad(lambda q_: jnp.sum(jpeft.boft_linear(
        jnp.asarray(x), jnp.asarray(w), {"q": q_}, js) * cot))(jnp.asarray(q))
    out = tpeft.boft_linear(torch.tensor(x), torch.tensor(w), {"q": tq}, ts)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jpeft.boft_linear(
            jnp.asarray(x), jnp.asarray(w), {"q": jnp.asarray(q)}, js)),
        **TOL)
    (tg,) = torch.autograd.grad((out * torch.tensor(cot)).sum(), tq)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


def test_boft_init_is_the_identity():
    spec = tpeft.BoftSpec(block_size=4, n_factors=2)
    p = tpeft.init_boft(16, spec, device="cpu")
    assert p["q"].shape == (2, 4, 4, 4) and not p["q"].any()
    w = torch.randn((16, 8))
    np.testing.assert_allclose(tpeft.boft_weight(w, p, spec).numpy(),
                               w.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        tpeft.init_boft(10, spec, device="cpu")


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """Kernel 10's wrapper checks before any launch: blocks that do not
    tile x, fp64 blocks or x, b % 8 != 0, m % 128 != 0, b above
    MAX_BLOCK (what a CTA's shared memory holds) and a misaligned x each
    raise (here on CPU tensors, which the checks reach first)."""
    def call(z, n, b, m, bdt=torch.float32, xdt=torch.bfloat16, x=None):
        blocks = torch.zeros((z, n, b, b), dtype=bdt)
        x = torch.zeros((z, n * b, m), dtype=xdt) if x is None else x
        fbd._launch(blocks, x)

    with pytest.raises(ValueError, match="do not tile"):
        call(1, 2, 8, 128, x=torch.zeros((1, 24, 128)))
    with pytest.raises(TypeError, match="fp32 blocks"):
        call(1, 2, 8, 128, bdt=torch.float64)
    with pytest.raises(TypeError, match="bf16 or fp32 x"):
        call(1, 2, 8, 128, xdt=torch.float64)
    for b, m in ((12, 128), (8, 96), (fbd.MAX_BLOCK + 8, 128)):
        with pytest.raises(ValueError, match="b % 8 == 0"):
            call(1, 1, b, m)
    flat = torch.zeros(16 * 128 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(1, 2, 8, 128, x=flat[1:].view(1, 16, 128))
    assert fbd.block_diag_matmul.launches == 0
