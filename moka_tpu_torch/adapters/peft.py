"""Adapter library beyond MokA: LoRA, IA3, BOFT, OFT, LoHa, LoKr, VeRA,
AdaLoRA and Poly (port of ``moka_tpu/adapters/peft.py``).

Pure functions on the same convention as MokA's: a frozen base weight
stored ``(d_in, d_out)`` and a plain dict of adapter tensors, so a JAX tree
converts with ``convert.params_from_numpy`` and no renaming.  Each ``init_*``
takes a ``torch.Generator`` where JAX takes a key (the two draw different
numbers: parity tests feed both the same arrays) and a ``device`` (default:
the card).  BOFT's butterfly product runs through ``ops.fbd``'s
block-diagonal product; with ``use_pallas`` on the card that is the
hand-written kernel 10, forward only (merging an adapter into its weight),
as in JAX."""

from __future__ import annotations

import dataclasses
import math

import torch

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.ops.fbd import block_diag_matmul, butterfly_perm, cayley


def _uniform(generator, shape, low, high, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) * (high - low) + low


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _base(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...d,df->...f", x, w)


# ------------------------------------------------------------ plain LoRA --

@dataclasses.dataclass(frozen=True)
class LoraSpec:
    rank: int = 8
    alpha: float = 16.0
    dropout_rate: float = 0.0
    use_rslora: bool = False

    @property
    def scale(self) -> float:
        return self.alpha / math.sqrt(self.rank) if self.use_rslora else \
            self.alpha / self.rank


def init_lora(generator: torch.Generator, d_in: int, d_out: int,
              spec: LoraSpec, *, device=None) -> dict:
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(d_in)
    return {"a": _uniform(generator, (d_in, spec.rank), -bound, bound, dev),
            "b": torch.zeros((spec.rank, d_out), device=dev)}


def lora_linear(x: torch.Tensor, w: torch.Tensor, p: dict,
                spec: LoraSpec) -> torch.Tensor:
    delta = torch.einsum("...r,rf->...f",
                         torch.einsum("...d,dr->...r", x, p["a"]), p["b"])
    return _base(x, w) + delta * spec.scale


def merge_lora(w: torch.Tensor, p: dict, spec: LoraSpec) -> torch.Tensor:
    """The delta-weight merge (stock PEFT)."""
    return w + (p["a"] @ p["b"]) * spec.scale


# ------------------------------------------------------------------- IA3 --

def init_ia3(d_out: int, *, device=None) -> dict:
    return {"scale": torch.ones((d_out,), device=resolve_device(device))}


def ia3_linear(x: torch.Tensor, w: torch.Tensor, p: dict) -> torch.Tensor:
    return _base(x, w) * p["scale"]


# ------------------------------------------------------------------ BOFT --

@dataclasses.dataclass(frozen=True)
class BoftSpec:
    """Butterfly Orthogonal Fine-Tuning: the adapted weight is
    ``(prod_i P_i^T blockdiag(R_i) P_i) @ W`` over the in-features axis,
    each R_i an orthogonal (Cayley-parametrised) block."""
    block_size: int = 4
    n_factors: int = 2


def init_boft(d_in: int, spec: BoftSpec, *, device=None) -> dict:
    """Zero Q: Cayley(0) = I, the identity transform at the start."""
    if d_in % spec.block_size:
        raise ValueError(f"d_in {d_in} % block {spec.block_size}")
    n_blocks = d_in // spec.block_size
    return {"q": torch.zeros((spec.n_factors, n_blocks, spec.block_size,
                              spec.block_size),
                             device=resolve_device(device))}


def boft_weight(w: torch.Tensor, p: dict, spec: BoftSpec,
                use_pallas: bool = False) -> torch.Tensor:
    """The adapted weight: the butterfly product applied to W's
    in-features axis.  The permutation gathers are plain ``index_select``
    (JAX runs them in XLA, outside its kernel); ``use_pallas`` sends the
    block products to kernel 10 where ``block_diag_matmul`` takes it."""
    d_in = w.shape[0]
    n_blocks = d_in // spec.block_size
    out = w
    for i in range(spec.n_factors):
        r = cayley(p["q"][i])  # (n_blocks, b, b) orthogonal
        stride = 2 ** i
        if n_blocks > 1 and stride < n_blocks:
            perm = butterfly_perm(n_blocks, min(stride, n_blocks // 2),
                                  device=w.device)
            full_perm = (perm[:, None] * spec.block_size + torch.arange(
                spec.block_size, device=w.device)[None, :]).reshape(-1)
            out = out.index_select(0, full_perm)
            out = block_diag_matmul(r[None], out[None],
                                    use_pallas=use_pallas)[0]
            out = out.index_select(0, torch.argsort(full_perm))
        else:
            out = block_diag_matmul(r[None], out[None],
                                    use_pallas=use_pallas)[0]
    return out


def boft_linear(x: torch.Tensor, w: torch.Tensor, p: dict,
                spec: BoftSpec) -> torch.Tensor:
    return _base(x, boft_weight(w, p, spec))


# ------------------------------------------------------------------- OFT --

def init_oft(d_in: int, block_size: int = 4, *, device=None) -> dict:
    """OFT: one block-diagonal orthogonal transform (BOFT without the
    butterfly factorisation)."""
    if d_in % block_size:
        raise ValueError(d_in)
    return {"q": torch.zeros((d_in // block_size, block_size, block_size),
                             device=resolve_device(device))}


def oft_weight(w: torch.Tensor, p: dict) -> torch.Tensor:
    r = cayley(p["q"])
    return block_diag_matmul(r[None], w[None], use_pallas=False)[0]


def oft_linear(x: torch.Tensor, w: torch.Tensor, p: dict) -> torch.Tensor:
    return _base(x, oft_weight(w, p))


# ------------------------------------------------------------------ LoHa --

def init_loha(generator: torch.Generator, d_in: int, d_out: int,
              rank: int = 4, *, device=None) -> dict:
    """LoHa: delta = (A1 @ B1) * (A2 @ B2), a Hadamard product."""
    dev = resolve_device(device)
    s = 1.0 / math.sqrt(d_in)
    return {"a1": _uniform(generator, (d_in, rank), -s, s, dev),
            "b1": torch.zeros((rank, d_out), device=dev),
            "a2": _uniform(generator, (d_in, rank), -s, s, dev),
            "b2": _uniform(generator, (rank, d_out), -s, s, dev)}


def loha_delta(p: dict, scale: float = 1.0) -> torch.Tensor:
    return (p["a1"] @ p["b1"]) * (p["a2"] @ p["b2"]) * scale


def loha_linear(x: torch.Tensor, w: torch.Tensor, p: dict,
                scale: float = 1.0) -> torch.Tensor:
    return _base(x, w + loha_delta(p, scale))


# ------------------------------------------------------------------ LoKr --

def init_lokr(generator: torch.Generator, d_in: int, d_out: int,
              factor_in: int, factor_out: int, rank: int = 4, *,
              device=None) -> dict:
    """LoKr: delta = kron(C, A @ B) with C (factor_in, factor_out) and the
    low-rank pair covering the complementary factors."""
    if d_in % factor_in or d_out % factor_out:
        raise ValueError((d_in, factor_in, d_out, factor_out))
    dev = resolve_device(device)
    u_in, u_out = d_in // factor_in, d_out // factor_out
    s = 1.0 / math.sqrt(u_in)
    return {"c": _normal(generator, (factor_in, factor_out), dev) * 0.02,
            "a": _uniform(generator, (u_in, rank), -s, s, dev),
            "b": torch.zeros((rank, u_out), device=dev)}


def lokr_delta(p: dict, scale: float = 1.0) -> torch.Tensor:
    return torch.kron(p["c"], p["a"] @ p["b"]) * scale


def lokr_linear(x: torch.Tensor, w: torch.Tensor, p: dict,
                scale: float = 1.0) -> torch.Tensor:
    return _base(x, w + lokr_delta(p, scale))


# ------------------------------------------------------------------ VeRA --

def init_vera(generator: torch.Generator, d_in: int, d_out: int,
              rank: int = 16, *, device=None) -> dict:
    """VeRA: a shared frozen random A/B and trainable scaling vectors per
    layer (share the frozen pair by passing the same dict)."""
    dev = resolve_device(device)
    return {
        "frozen_a": _normal(generator, (d_in, rank), dev) / math.sqrt(d_in),
        "frozen_b": _normal(generator, (rank, d_out), dev) / math.sqrt(rank),
        "d": torch.ones((rank,), device=dev) * 0.1,
        "b": torch.zeros((d_out,), device=dev),
    }


def vera_linear(x: torch.Tensor, w: torch.Tensor, p: dict) -> torch.Tensor:
    h = torch.einsum("...d,dr->...r", x, p["frozen_a"]) * p["d"]
    delta = torch.einsum("...r,rf->...f", h, p["frozen_b"]) * p["b"]
    return _base(x, w) + delta


# --------------------------------------------------------------- AdaLoRA --

@dataclasses.dataclass(frozen=True)
class AdaLoraSpec:
    """AdaLoRA: an SVD-parametrised delta ``P diag(lam) Q`` with an
    orthogonality regulariser and a global rank budget enforced by masking
    the least important singular values."""
    init_rank: int = 12
    target_rank: int = 4
    orth_reg_weight: float = 0.5


def init_adalora(generator: torch.Generator, d_in: int, d_out: int,
                 spec: AdaLoraSpec, *, device=None) -> dict:
    dev = resolve_device(device)
    r = spec.init_rank
    return {"p": _normal(generator, (d_in, r), dev) * 0.02,
            "lam": torch.zeros((r,), device=dev),
            "q": _normal(generator, (r, d_out), dev) * 0.02,
            "mask": torch.ones((r,), device=dev)}


def adalora_delta(p: dict) -> torch.Tensor:
    # the 0/1 mask lives in the trainable tree for checkpointing but is not
    # a parameter: detached, as JAX's stop_gradient
    mask = p["mask"].detach()
    return (p["p"] * (p["lam"] * mask)) @ p["q"]


def adalora_linear(x: torch.Tensor, w: torch.Tensor,
                   p: dict) -> torch.Tensor:
    return _base(x, w + adalora_delta(p))


def adalora_orth_reg(p: dict) -> torch.Tensor:
    """||P^T P - I||_F^2 + ||Q Q^T - I||_F^2 (added to the loss)."""
    r = p["p"].shape[1]
    eye = torch.eye(r, device=p["p"].device)
    a = p["p"].T @ p["p"] - eye
    b = p["q"] @ p["q"].T - eye
    return torch.sum(a * a) + torch.sum(b * b)


def adalora_importance(p: dict, grads: dict) -> torch.Tensor:
    """|lam * dL/dlam|, the sensitivity of each singular direction."""
    return torch.abs(p["lam"] * grads["lam"])


def adalora_allocate(importances: list[torch.Tensor],
                     total_budget: int) -> list[torch.Tensor]:
    """Global top-k across all layers' singular values -> 0/1 masks (every
    value tied with the k-th largest is kept, as JAX's ``>=``)."""
    sizes = [imp.shape[0] for imp in importances]
    flat = torch.cat(importances)
    k = min(total_budget, flat.shape[0])
    thresh = torch.sort(flat).values[-k]
    masks = []
    off = 0
    for n in sizes:
        masks.append((flat[off:off + n] >= thresh).float())
        off += n
    return masks


# ------------------------------------------------------------------ Poly --

@dataclasses.dataclass(frozen=True)
class PolySpec:
    """Polytropon multi-task routing: a bank of ``n_skills`` LoRA experts
    per ``n_splits`` feature split, mixed per sample by a task-conditioned
    router."""
    n_tasks: int
    n_skills: int = 4
    n_splits: int = 1
    rank: int = 4


def init_poly(generator: torch.Generator, d_in: int, d_out: int,
              spec: PolySpec, *, device=None) -> dict:
    """Upstream init: A kaiming-uniform over the (split-local d_in, r) fan,
    B zeros, router logits ~ U(-1e-3, 1e-3)."""
    dev = resolve_device(device)
    di, do = d_in // spec.n_splits, d_out // spec.n_splits
    bound = math.sqrt(6.0 / ((1 + 5) * di))  # kaiming_uniform a=sqrt(5)
    return {
        "a": _uniform(generator, (spec.n_splits, spec.n_skills, di,
                                  spec.rank), -bound, bound, dev),
        "b": torch.zeros((spec.n_splits, spec.n_skills, spec.rank, do),
                         device=dev),
        "router": _uniform(generator, (spec.n_tasks,
                                       spec.n_splits * spec.n_skills),
                           -1e-3, 1e-3, dev),
    }


def poly_mixing_weights(router: torch.Tensor, task_ids: torch.Tensor,
                        spec: PolySpec,
                        generator: torch.Generator | None = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """(b, n_splits, n_skills) normalised skill weights.

    Eval: sigmoid(logits).  Train (a ``generator``, or the uniform numbers
    ``noise`` themselves, in [1e-6, 1 - 1e-6]): the RelaxedBernoulli(temp=1)
    sample sigmoid(logits + logistic noise), upstream's router forward."""
    logits = router[task_ids].reshape(-1, spec.n_splits, spec.n_skills)
    if noise is None and generator is not None:
        noise = _uniform(generator, logits.shape, 1e-6, 1.0 - 1e-6,
                         logits.device)
    if noise is not None:
        logits = logits + torch.log(noise) - torch.log1p(-noise)
    s = torch.sigmoid(logits)
    return s / (torch.sum(s, dim=-1, keepdim=True) + 1e-12)


def poly_linear(x: torch.Tensor, w: torch.Tensor, p: dict,
                task_ids: torch.Tensor, spec: PolySpec,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """base(x) + x @ A_mix @ B_mix / r with per-sample mixed experts."""
    mw = poly_mixing_weights(p["router"], task_ids, spec, generator, noise)
    b = x.shape[0]
    a_mix = torch.einsum("bqs,qsdr->bqdr", mw, p["a"])
    b_mix = torch.einsum("bqs,qsrd->bqrd", mw, p["b"])
    r = spec.rank
    a_mix = a_mix.reshape(b, -1, r)                      # (b, d_in, r)
    b_mix = b_mix.transpose(1, 2).reshape(b, r, -1)      # (b, r, d_out)
    delta = torch.einsum("bld,bdr->blr", x, a_mix)
    delta = torch.einsum("blr,brd->bld", delta, b_mix) / r
    return _base(x, w) + delta


# ------------------------------------------------- AdaLoRA tree walkers --

def is_adalora_params(node) -> bool:
    return isinstance(node, dict) and {"p", "lam", "q", "mask"} <= set(node)


def adalora_tree_paths(params) -> list[tuple]:
    """Key paths of every AdaLoRA dict inside a tree of dicts."""
    paths = []

    def walk(node, path):
        if is_adalora_params(node):
            paths.append(path)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))

    walk(params, ())
    return paths


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def adalora_grad_taps(grads) -> dict:
    """The lam gradients of every AdaLoRA subtree, by "/"-joined path: what
    the allocator scores importance from without a second backward."""
    return {"/".join(p): _get(grads, p)["lam"]
            for p in adalora_tree_paths(grads)}


def adalora_update_masks(params, lam_grads: dict, total_budget: int):
    """Re-allocate the global rank budget from |lam * dL/dlam| (AdaLoRA's
    schedule step).  Returns a copy of the tree with fresh 0/1 masks; the
    caller's dicts are not modified."""
    paths = adalora_tree_paths(params)
    imps = [adalora_importance(_get(params, p),
                               {"lam": lam_grads["/".join(p)]})
            for p in paths]
    masks = adalora_allocate(imps, total_budget)
    out = dict(params)
    for path, mask in zip(paths, masks):
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = dict(node[path[-1]], mask=mask)
    return out
