"""Length-aware decode attention (port of ``moka_tpu/ops/paged_decode.py``).

One new token attends to the valid prefix of one layer of the
layer-stacked (N, B, S, K, hd) KV cache, plain or int8 (``{"q": int8,
"s": fp32 (..., 1)}``, ``models/llama.py::init_kv_cache``), so a decode
step reads the keys it needs and not the whole allocation.

``paged_decode_attention_plain`` repeats the JAX package's XLA loop step by
step: ``cdiv(length, block_k)`` blocks of keys, an fp32 online softmax with
NEG_INF -1e30, key j visible when j < length and mask > 0, the int8 scales
folded in as JAX folds them (``s *= ks``, ``p * vs``), and a row whose sum
is 0 set to 0.  ``paged_decode_attention`` runs it for CPU tensors and, for
CUDA tensors, launches the hand-written kernel
``kernels/csrc/paged_decode.cu`` (one launch a layer) or raises on what the
kernel does not take.  The kernel gives 0 to a row that sees no key, where
the loop gives the mean of the values it walked; callers read only rows
that see a key.  Forward only (decode never differentiates).
"""

from __future__ import annotations

import ctypes

import torch

from moka_tpu_torch.core.device import on_card, raw_stream

NEG_INF = -1e30
HEAD_DIM = 128   # the kernel's head_dim
MAX_GROUP = 8    # query heads a kv head the kernel takes (GQA 64:8)
CHUNK = 256      # keys a CTA of the kernel (its split of the prefix)


def _sides(cache_k, cache_v):
    kv_quant = isinstance(cache_k, dict)
    if kv_quant:
        return True, cache_k["q"], cache_v["q"], cache_k["s"], cache_v["s"]
    return False, cache_k, cache_v, None, None


def _check_blocks(S: int, block_k: int) -> int:
    bk = min(block_k, S)
    if S % bk:
        raise ValueError(
            f"cache length {S} must be a multiple of block_k {bk} "
            "(round the allocation up; tail slots are masked)")
    return bk


def paged_decode_attention_plain(q, cache_k, cache_v, attn_mask, layer_idx,
                                 length, *, block_k: int = 256):
    """JAX's block loop.  q (B, 1, H, hd); cache_k/v (N, B, S, K, hd) or
    int8 dicts; attn_mask (B, S); layer_idx, length ints.  Returns (B, 1,
    H, hd) in q's dtype."""
    kv_quant, k_arr, v_arr, k_s, v_s = _sides(cache_k, cache_v)
    B, _, H, hd = q.shape
    _, _, S, KH, _ = k_arr.shape
    G = H // KH
    bk = _check_blocks(S, block_k)
    scale = 1.0 / (hd ** 0.5)
    nb = (int(length) + bk - 1) // bk
    dev = q.device
    qf = q[:, 0].reshape(B, KH, G, hd).float()
    m = torch.full((B, KH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, hd), dtype=torch.float32, device=dev)
    for i in range(nb):
        blk = slice(i * bk, (i + 1) * bk)
        k_blk = k_arr[layer_idx, :, blk].float()           # (B, bk, KH, hd)
        v_blk = v_arr[layer_idx, :, blk].float()
        k_ids = torch.arange(i * bk, (i + 1) * bk, device=dev)
        ok = (k_ids[None, :] < length) & (attn_mask[:, blk] > 0)  # (B, bk)
        s = torch.einsum("bkgd,bskd->bkgs", qf, k_blk) * scale
        p_scale = None
        if kv_quant:
            # (B, bk, KH) scales -> (B, KH, 1, bk), riding the accumulators
            s = s * k_s[layer_idx, :, blk, :, 0].transpose(1, 2)[:, :, None]
            p_scale = v_s[layer_idx, :, blk, :, 0].transpose(1, 2)[:, :, None]
        s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgs,bskd->bkgd",
                          p if p_scale is None else p * p_scale, v_blk)
        acc = acc * alpha[..., None] + pv
        m = m_cur
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / safe[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


_lib = None
_tickets: dict = {}  # device -> int32 zeros, one per (sample, kv head)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``moka_paged_decode``'s argument and result types on ``lib``
    (the built library, or an edited copy of its source) and return it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moka_paged_decode.argtypes = [p, p, p, p, p, p, i, p, p, p, p,
                                      i, i, i, i, i, i, p]
    lib.moka_paged_decode.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        _lib = bind(kernels.library("paged_decode"))
    return _lib


def _tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-(sample, kv head) tickets: zeros that every launch
    leaves at zero, kept per device and grown as needed."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def _launch(q, cache_k, cache_v, attn_mask, layer_idx, length):
    """The decode kernel on the card: checks what it takes (bf16 q with
    head_dim 128; a bf16 cache, or an int8 one with fp32 scales; H / K at
    most 8; an int32 or fp32 mask; 0 < length <= S; one device; contiguous)
    and raises otherwise."""
    kv_quant, k_arr, v_arr, k_s, v_s = _sides(cache_k, cache_v)
    B, L, H, hd = q.shape
    if k_arr.dim() != 5:
        raise ValueError(f"cache {tuple(k_arr.shape)} is not (N, B, S, K, hd)")
    N, Bc, S, K, hdc = k_arr.shape
    if L != 1 or hd != HEAD_DIM or hdc != hd or Bc != B or \
            tuple(v_arr.shape) != tuple(k_arr.shape):
        raise ValueError(f"decode kernel takes q (B, 1, H, {HEAD_DIM}) and a "
                         f"matching cache, not q {tuple(q.shape)}, k "
                         f"{tuple(k_arr.shape)}, v {tuple(v_arr.shape)}")
    if H % K or H // K > MAX_GROUP:
        raise ValueError(f"decode kernel takes H / K <= {MAX_GROUP}, not "
                         f"{H} / {K}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode kernel takes bf16 q, not {q.dtype}")
    want = torch.int8 if kv_quant else torch.bfloat16
    if k_arr.dtype != want or v_arr.dtype != want:
        raise TypeError(f"decode kernel takes a bf16 cache or an int8 one, "
                        f"not {k_arr.dtype} / {v_arr.dtype}")
    if kv_quant and (k_s.dtype != torch.float32 or v_s.dtype != torch.float32
                     or tuple(k_s.shape) != (N, B, S, K, 1)
                     or tuple(v_s.shape) != (N, B, S, K, 1)):
        raise TypeError("decode kernel takes fp32 scales (N, B, S, K, 1)")
    if tuple(attn_mask.shape) != (B, S) or \
            attn_mask.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"decode kernel takes an int32 or fp32 (B, S) mask, "
                        f"not {attn_mask.dtype} {tuple(attn_mask.shape)}")
    length, layer_idx = int(length), int(layer_idx)
    if not 0 < length <= S or not 0 <= layer_idx < N:
        raise ValueError(f"length {length} of {S}, layer {layer_idx} of {N}")
    tensors = [q, k_arr, v_arr, attn_mask] + ([k_s, v_s] if kv_quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode kernel inputs on more than one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode kernel takes contiguous tensors")
    layer_elems = B * S * K * hd
    k_ptr = k_arr.data_ptr() + layer_idx * layer_elems * k_arr.element_size()
    v_ptr = v_arr.data_ptr() + layer_idx * layer_elems * v_arr.element_size()
    if (k_ptr | v_ptr | q.data_ptr()) % 16:
        raise ValueError("decode kernel needs 16-byte aligned q and cache")
    ks_ptr = vs_ptr = None
    if kv_quant:
        ks_ptr = k_s.data_ptr() + layer_idx * B * S * K * 4
        vs_ptr = v_s.data_ptr() + layer_idx * B * S * K * 4
    G = H // K
    n_split = -(-length // CHUNK)
    ws_o = ws_ml = None
    if n_split > 1:
        ws_o = torch.empty((B * K, n_split, G, hd), dtype=torch.float32,
                           device=q.device)
        ws_ml = torch.empty((B * K, n_split, G, 2), dtype=torch.float32,
                            device=q.device)
    out = torch.empty_like(q)
    status = _library().moka_paged_decode(
        q.data_ptr(), k_ptr, v_ptr, ks_ptr, vs_ptr, attn_mask.data_ptr(),
        int(attn_mask.dtype == torch.float32), out.data_ptr(),
        None if ws_o is None else ws_o.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(),
        _tickets_for(q.device, B * K).data_ptr(), B, H, K, S, length,
        int(kv_quant), raw_stream(q.device))
    if status:
        from moka_tpu_torch import kernels
        kernels.check(status, "paged_decode")
    paged_decode_attention.launches += 1
    if kv_quant:
        paged_decode_attention.int8_launches += 1
    return out


def paged_decode_attention(q, cache_k, cache_v, attn_mask, layer_idx,
                           length, *, block_k: int = 256,
                           interpret: bool = False):
    """q (B, 1, H, hd) single-token queries; cache_k/v (N, B, S, K, hd)
    layer-stacked caches, plain or int8 dicts; attn_mask (B, S) validity;
    layer_idx, length: the layer and the valid slots including the token
    just written.  S must be a multiple of ``block_k`` (the caller rounds
    the allocation up).  The kernel for CUDA tensors (its own split is
    ``CHUNK`` keys whatever ``block_k``: keys at or past ``length`` are
    never read), the plain loop for CPU tensors; ``interpret`` is accepted
    as JAX's signature has it.  Returns (B, 1, H, hd) in q's dtype."""
    del interpret
    k_arr = cache_k["q"] if isinstance(cache_k, dict) else cache_k
    _check_blocks(k_arr.shape[2], block_k)
    if on_card(q, "paged decode attention"):
        return _launch(q, cache_k, cache_v, attn_mask, layer_idx, length)
    return paged_decode_attention_plain(q, cache_k, cache_v, attn_mask,
                                        layer_idx, length, block_k=block_k)


paged_decode_attention.launches = 0  # kernel launches (CUDA tensors only)
paged_decode_attention.int8_launches = 0  # those of them on an int8 cache
