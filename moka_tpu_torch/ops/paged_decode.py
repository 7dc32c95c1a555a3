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

The kernel splits each (sample, kv head)'s keys below ``length`` into
spans of whole 64-key tiles, one CTA a span: ``plan_spans`` sizes them
from B * K, ``length`` and the card's SM count so that the grid is about
one wave (one span a pair at the 7B serving shape, several for one
sample), and the last span ends at ``length``.  Spans merge in span order
in the same launch.  ``paged_decode_split_plain`` is that split and merge
in plain PyTorch (the kernel's base-2 arithmetic, in fp32), which the
tests hold against JAX's loop; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from moka_tpu_torch.core.device import on_card, raw_stream

NEG_INF = -1e30
HEAD_DIM = 128   # the kernel's head_dim
MAX_GROUP = 8    # query heads a kv head the kernel takes (GQA 64:8)
TILE_KEYS = 64   # keys a stage of the kernel's ring (a span holds whole tiles)
CTAS_PER_SM = 2  # the kernel's CTAs an SM: its grid is about one wave of them


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


def plan_spans(B: int, K: int, length: int, sms: int) -> tuple[int, int]:
    """The kernel's split of each (sample, kv head)'s keys below ``length``:
    (tiles a span, spans a pair).  About CTAS_PER_SM CTAs an SM over the
    B * K pairs (at least one span a pair, at most one a tile), whole
    TILE_KEYS-key tiles a span, no span empty; the last span ends at
    ``length``."""
    tiles = -(-length // TILE_KEYS)
    want = min(tiles, max(1, sms * CTAS_PER_SM // (B * K)))
    per = -(-tiles // want)
    return per, -(-tiles // per)


def span_ranges(B: int, K: int, length: int, sms: int) -> list:
    """``plan_spans``' spans as [start, stop) key ranges, in order."""
    per, n = plan_spans(B, K, length, sms)
    keys = per * TILE_KEYS
    return [(i * keys, min((i + 1) * keys, length)) for i in range(n)]


def paged_decode_split_plain(q, cache_k, cache_v, attn_mask, layer_idx,
                             length, spans):
    """The kernel's split and merge in plain PyTorch, in fp32: for each
    [start, stop) key range of ``spans`` (``span_ranges``), base-2 scores
    (times log2(e) / sqrt(hd), and ks on an int8 cache), -inf where a key
    is not visible, the span's max m, sum l of p = 2^(s - m) and unscaled
    output (p times vs on an int8 cache) v; then the spans merged in order
    with weights 2^(m_span - max m).  A row that sees no key gives 0.  The
    arguments are ``paged_decode_attention``'s; returns (B, 1, H, hd) in
    q's dtype.  Used by the tests, not by the main path."""
    kv_quant, k_arr, v_arr, k_s, v_s = _sides(cache_k, cache_v)
    B, _, H, hd = q.shape
    KH = k_arr.shape[3]
    G = H // KH
    scale = math.log2(math.e) / math.sqrt(hd)
    qf = q[:, 0].reshape(B, KH, G, hd).float()
    parts = []
    for start, stop in spans:
        k_blk = k_arr[layer_idx, :, start:stop].float()    # (B, n, KH, hd)
        v_blk = v_arr[layer_idx, :, start:stop].float()
        ok = attn_mask[:, start:stop] > 0                  # (B, n); < length
        s = torch.einsum("bkgd,bskd->bkgs", qf, k_blk) * scale
        if kv_quant:
            s = s * k_s[layer_idx, :, start:stop, :, 0].transpose(1, 2)[
                :, :, None]
        s = torch.where(ok[:, None, None, :], s, float("-inf"))
        m = s.amax(dim=-1)
        p = torch.exp2(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
        l = p.sum(dim=-1)
        if kv_quant:
            p = p * v_s[layer_idx, :, start:stop, :, 0].transpose(1, 2)[
                :, :, None]
        parts.append((m, l, torch.einsum("bkgs,bskd->bkgd", p, v_blk)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    base = torch.where(m_all == float("-inf"), 0.0, m_all)
    l_all = torch.zeros_like(m_all)
    o_all = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        wgt = torch.exp2(m - base)
        l_all = l_all + l * wgt
        o_all = o_all + o * wgt[..., None]
    out = torch.where(l_all[..., None] > 0,
                      o_all / torch.where(l_all > 0, l_all, 1.0)[..., None],
                      0.0)
    return out.reshape(B, 1, H, hd).to(q.dtype)


_lib = None
_tickets: dict = {}  # device -> int32 zeros, one per (sample, kv head)
_workspace: dict = {}  # device -> fp32 (m, l, unscaled out) of the spans
_sms: dict = {}  # device -> streaming multiprocessors


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``moka_paged_decode``'s argument and result types on ``lib``
    (the built library, or an edited copy of its source) and return it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moka_paged_decode.argtypes = [p, p, p, p, p, p, i, p, p, p,
                                      i, i, i, i, i, i, i, i, p]
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


def _workspace_for(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` fp32 of span partials, kept per device and grown as
    needed (each launch writes what it reads)."""
    w = _workspace.get(device)
    if w is None or w.numel() < n:
        w = torch.empty(max(n, 1 << 16), dtype=torch.float32, device=device)
        _workspace[device] = w
    return w


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device] = n
    return n


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
            v_arr.shape != k_arr.shape:
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
                     or k_s.shape != (N, B, S, K, 1)
                     or v_s.shape != (N, B, S, K, 1)):
        raise TypeError("decode kernel takes fp32 scales (N, B, S, K, 1)")
    if attn_mask.shape != (B, S) or \
            attn_mask.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"decode kernel takes an int32 or fp32 (B, S) mask, "
                        f"not {attn_mask.dtype} {tuple(attn_mask.shape)}")
    length, layer_idx = int(length), int(layer_idx)
    if not 0 < length <= S or not 0 <= layer_idx < N:
        raise ValueError(f"length {length} of {S}, layer {layer_idx} of {N}")
    tensors = [q, k_arr, v_arr, attn_mask] + ([k_s, v_s] if kv_quant else [])
    device = q.device
    if any(t.device != device for t in tensors):
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
    span_tiles, n_span = plan_spans(B, K, length, _sm_count(device))
    ws = tickets = None
    if n_span > 1:
        ws = _workspace_for(device, B * H * n_span * (hd + 2)).data_ptr()
        tickets = _tickets_for(device, B * K).data_ptr()
    out = torch.empty_like(q)
    status = _library().moka_paged_decode(
        q.data_ptr(), k_ptr, v_ptr, ks_ptr, vs_ptr, attn_mask.data_ptr(),
        int(attn_mask.dtype == torch.float32), out.data_ptr(), ws, tickets,
        B, H, K, S, length, int(kv_quant), span_tiles, n_span,
        raw_stream(device))
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
    ``plan_spans``' whatever ``block_k``: keys at or past ``length`` are
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
