"""LoftQ: quantization-aware low-rank adapter initialization (port of
``moka_tpu/adapters/loftq.py``).

Alternate (quantize the residual -> SVD the quantization error) so that at
init ``W ≈ Q + A @ B``: the adapter starts by correcting the quantization
error of the frozen base instead of at zero.

Two quantizers:
  * ``method="nf"``     — blockwise NormalFloat lookup (block 64, abs-max
    per block, asymmetric normal map at offset 0.9677083); indices are
    stored unpacked, one uint8 per value.
  * ``method="linear"`` — the symmetric per-output-channel int8/int4
    scheme of ``ops/quant.py``, so a LoftQ-initialized adapter rides the
    quantized base directly.

Conventions: weights are (d_in, d_out); the returned pair satisfies
``W ≈ deq + a @ b`` with a (d_in, r), b (r, d_out); pass ``scale`` to fold
1/scale into ``b`` when the consuming layer multiplies the delta by
``scale``.

The math is host-side numpy, as in the JAX package (init time only, one
SVD per target weight); ``loftq_init_moka_adapters`` returns the port's
trees on the base's device.
"""

from __future__ import annotations

import numpy as np
import torch

_NF_OFFSET = 0.9677083


def nf_lookup(num_bits: int, offset: float = _NF_OFFSET,
              method: str = "normal") -> np.ndarray:
    """The NormalFloat (or uniform) codebook, sorted and max-normalized."""
    if method == "uniform":
        return np.linspace(-1.0, 1.0, 2 ** num_bits).astype(np.float32)
    from scipy.stats import norm
    variations = 2 ** num_bits
    v1 = norm.ppf(np.linspace(offset, 0.5, variations // 2 + 1)[:-1])
    v3 = -norm.ppf(np.linspace(offset, 0.5, variations // 2)[:-1])
    v = np.concatenate([v1, [0.0], v3])
    v = np.sort(v)
    return (v / v.max()).astype(np.float32)


def nf_quantize_block(w: np.ndarray, num_bits: int = 4,
                      block_size: int = 64, method: str = "normal"):
    """-> (indices uint8 (L, B), block_max (L, 1)): row-major flatten into
    blocks; abs-max normalization for the normal map, mean + 2.5 std for
    the uniform one."""
    if w.ndim != 2:
        raise ValueError(f"only 2D weights, got {w.ndim}D")
    if w.size % block_size != 0:
        raise ValueError(f"{w.shape} not divisible by block {block_size}")
    lookup = nf_lookup(num_bits, method=method)
    blocks = w.astype(np.float32).reshape(-1, block_size)
    if method == "normal":
        bmax = np.abs(blocks).max(axis=-1, keepdims=True)
    else:
        bmax = (blocks.mean(axis=-1) +
                2.5 * blocks.std(axis=-1))[:, None]
    bmax = np.where(bmax == 0, 1.0, bmax)
    idx = np.argmin(np.abs(blocks[..., None] / bmax[..., None] -
                           lookup[None, None, :]), axis=-1)
    return idx.astype(np.uint8), bmax.astype(np.float32)


def nf_dequantize_block(idx: np.ndarray, bmax: np.ndarray,
                        shape: tuple[int, ...], num_bits: int = 4,
                        method: str = "normal") -> np.ndarray:
    lookup = nf_lookup(num_bits, method=method)
    return (lookup[idx.astype(np.int64)] * bmax).reshape(shape)


def low_rank_decomposition(res: np.ndarray, rank: int):
    """res ≈ L @ R with L (m, r), R (r, n) by truncated SVD, the singular
    values split as sqrt(S) on both factors."""
    u, s, vh = np.linalg.svd(res.astype(np.float32), full_matrices=False)
    sq = np.sqrt(s[:rank])
    return u[:, :rank] * sq[None, :], sq[:, None] * vh[:rank]


def _linear_quantize(res: np.ndarray, num_bits: int):
    """``ops.quant``'s symmetric quantization of a (d_in, d_out) fp32
    array: (the code dict as numpy, its fp32 dequantization)."""
    from moka_tpu_torch.ops.quant import dequantize, quantize_int4, \
        quantize_int8
    quant = {8: quantize_int8, 4: quantize_int4}[num_bits]
    q = quant(torch.from_numpy(res))
    deq = dequantize(q, dtype=torch.float32).numpy()
    return {k: v.numpy() for k, v in q.items()}, deq


def loftq_init(w, num_bits: int = 4, rank: int = 16, num_iter: int = 1,
               method: str = "nf", block_size: int = 64,
               scale: float = 1.0):
    """Alternating quantize/SVD init.

    Returns (deq_or_qdict, a, b) with ``W ≈ deq + scale * a @ b``:
      * method="nf":     deq is the dequantized np.float32 weight;
      * method="linear": the first element is the ``ops.quant``
        {w_i8|w_i4, scale} dict (numpy) of the final residual
        quantization.
    """
    w_np = np.asarray(w, np.float32)
    if num_iter <= 0:
        raise ValueError("num_iter must be > 0")
    res = w_np
    deq = qdict = None
    for _ in range(num_iter):
        if method == "linear":
            qdict, deq = _linear_quantize(res, num_bits)
        else:
            # loftq_init's "nf"/"uniform" selects the codebook family; the
            # block quantizer speaks "normal"/"uniform"
            bmethod = "normal" if method == "nf" else method
            idx, bmax = nf_quantize_block(res, num_bits, block_size,
                                          bmethod)
            deq = nf_dequantize_block(idx, bmax, res.shape, num_bits,
                                      bmethod)
        l_f, r_f = low_rank_decomposition(w_np - deq, rank)
        res = w_np - l_f @ r_f
    a, b = l_f, r_f / scale
    if method == "linear":
        return qdict, a, b
    return deq, a, b


def loftq_init_moka_adapters(base: dict, cfg, spec, num_bits: int = 4,
                             num_iter: int = 1,
                             targets: tuple[str, ...] | None = None):
    """LoftQ over a layer-stacked LLaMA tree with MokA adapters: quantizes
    the 7 projection families with the symmetric scheme and initializes
    every modality's A (and the shared B) from the per-layer
    quantization-residual SVD, ``spec.pre_scale`` folded into B.

    Returns (quantized_base_tree, adapters) shaped as
    ``quantize_llama_base`` + ``init_moka_adapters`` outputs, on the
    device of the base's weights; the adapters fp32."""
    from moka_tpu_torch.models.llama import PROJ_DIMS
    from moka_tpu_torch.ops.quant import QUANT_KEYS

    targets = tuple(targets) if targets is not None else tuple(PROJ_DIMS)
    n = cfg.n_layers
    qkey = {8: "w_i8", 4: "w_i4"}[num_bits]
    layers = dict(base["layers"])
    adapters = {}
    for name in QUANT_KEYS:
        w_all = base["layers"][name]
        dev = w_all.device
        q_parts, a_parts, b_parts = [], [], []
        for li in range(n):
            qdict, a, b = loftq_init(
                w_all[li].float().cpu().numpy(), num_bits=num_bits,
                rank=spec.rank, num_iter=num_iter, method="linear",
                scale=spec.pre_scale)
            q_parts.append(qdict)
            a_parts.append(a)
            b_parts.append(b)
        layers[name] = {
            qkey: torch.from_numpy(np.stack([q[qkey] for q in q_parts])
                                   ).to(dev),
            "scale": torch.from_numpy(np.stack([q["scale"]
                                                for q in q_parts])).to(dev),
        }
        if name in targets:
            a_stack = np.stack(a_parts)                     # (n, d_in, r)
            adapters[name] = {
                "a": torch.from_numpy(np.repeat(
                    a_stack[:, None], spec.num_modalities, axis=1)).to(dev),
                "b": torch.from_numpy(np.stack(b_parts)).to(dev),
            }
    out = dict(base)
    out["layers"] = layers
    return out, {"layers": adapters}
