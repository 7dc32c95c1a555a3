"""Continuous-batching decode engine (port of ``moka_tpu/eval/engine.py``).

A fixed number of slots (batch lanes) decode together one token per step;
finished lanes free at once and queued requests prefill into free lanes
mid-stream.  The scheduling is the JAX engine's:

- one shared KV write cursor ``cur`` for all lanes; per-lane validity lives
  in the (slots, S) attention mask and RoPE positions are per-lane token
  counts;
- queued requests sharing a prompt bucket (and modality-mask shape) are
  prefilled as one batch into fresh lane caches and copied into free slots;
- when the cursor reaches capacity, compaction moves each lane's valid
  cells to the front of its row (cached k/v already carry their rotary
  phases) and rewinds the cursor;
- ``steps_per_dispatch`` decode steps per dispatch, capped at the relevant
  lane-retirement horizon;
- dispatches are pipelined: the lane state (last token, count, active flag,
  budget) stays on the device between dispatches, and the host reads a
  dispatch's tokens only after the next one is queued, up to
  ``pipeline_depth`` dispatches behind.

Where JAX donates buffers, the port updates the cache, the mask and the
lane state in place; CUDA stream order keeps every update behind the work
queued before it.  The cache is bf16 (``cache_dtype``) or int8 with
per-(token, head) scales (``kv_quant``; every cache step below handles the
``{"q", "s"}`` sides leaf by leaf); ``paged_decode`` runs the decode steps
through the length-aware decode attention (the CUDA kernel on the card).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback

import numpy as np
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.eval.decode import (PAGED_BLOCK, fused_moka_route,
                                        paged_decode_auto)
from moka_tpu_torch.eval.sampling import sample_tokens
from moka_tpu_torch.models import llama
from moka_tpu_torch.ops.moka import MokaSpec


# ----------------------------------------------------------- device steps

@torch.no_grad()
def _prefill(base, adapters, *, cfg: LlamaConfig, spec: MokaSpec | None,
             inputs_embeds: torch.Tensor, prompt_mask: torch.Tensor,
             masks: llama.MaskBundle | None, generator: torch.Generator,
             temperature: torch.Tensor, top_k: torch.Tensor,
             top_p: torch.Tensor, use_flash: bool = False,
             use_fused_moka: bool = False, cache_dtype=torch.bfloat16,
             kv_quant: bool = False):
    """Batched prefill of n bucket-padded requests into fresh lane caches.

    Returns (first tokens (n,) int32, lane k, lane v (layers, n, Lp, K, hd),
    or int8 ``{"q", "s"}`` sides with ``kv_quant``); the first token is
    sampled per request (temperature 0 = argmax)."""
    n, Lp, _ = inputs_embeds.shape
    cache = llama.init_kv_cache(cfg, n, Lp, dtype=cache_dtype,
                                quantized=kv_quant,
                                device=inputs_embeds.device)
    pos = torch.clamp(torch.cumsum(prompt_mask, dim=-1) - 1, min=0)
    h, cache = llama.forward(
        base, cfg, adapters=adapters, spec=spec, inputs_embeds=inputs_embeds,
        masks=masks, attn_mask=prompt_mask, positions=pos, cache=cache,
        use_flash=use_flash, use_fused_moka=use_fused_moka, logits=False)
    # last valid prompt position (left- or right-padded prompts); the head
    # runs on that row only
    last_idx = Lp - 1 - torch.argmax(torch.flip(prompt_mask, dims=(1,)),
                                     dim=1)
    last = h[torch.arange(n, device=h.device), last_idx]
    logits = llama.head_logits(last[:, None], base["lm_head"])[:, 0]
    tok = sample_tokens(logits, generator, temperature, top_k, top_p)
    return tok, cache["k"], cache["v"]


def _leaves(side) -> list:
    """A cache side's tensors: itself, or an int8 side's codes and
    scales."""
    return [side["q"], side["s"]] if isinstance(side, dict) else [side]


def _insert(gk, gv, amask, lanes_k, lanes_v, lane_masks, slots) -> None:
    """Copy n prefilled lanes into the global cache rows ``slots``, in
    place, leaf by leaf; cells past the lane's bucket are zeroed (an int8
    side's scales too, as JAX pads them) and masked, so the previous
    occupant never leaks into attention."""
    Lp = llama.kv_cache_shape({"k": lanes_k})[2]
    pairs = [*zip(_leaves(gk), _leaves(lanes_k)),
             *zip(_leaves(gv), _leaves(lanes_v))]
    for i, slot in enumerate(slots):
        for g, lane in pairs:
            g[:, slot, Lp:] = 0
            g[:, slot, :Lp] = lane[:, i]
        amask[slot, Lp:] = 0
        amask[slot, :Lp] = lane_masks[i]


@torch.no_grad()
def _step_multi(base, adapters, gk, gv, amask, tokens, counts, active,
                budget, cur: int, generator, temperature, top_k, top_p, *,
                cfg: LlamaConfig, spec: MokaSpec | None, paged_decode: bool,
                n_steps: int, eos_id: int):
    """``n_steps`` decode steps for every lane; the cache and mask update in
    place (no autograd: adapters that require grad, a trainer's live
    tree, would make ``llama.forward`` write the cache out of place).  Lanes that emit eos or exhaust their budget go inactive (their
    cells stay masked, their rows repeat the last token).

    Returns (toks (n_steps, slots), tokens, counts, active, budget)."""
    toks = []
    for i in range(n_steps):
        cell = cur + i
        amask[:, cell] = active.to(amask.dtype)
        embeds = base["embed"][tokens[:, None].long()]
        logits, _ = llama.forward(
            base, cfg, adapters=adapters, spec=spec, inputs_embeds=embeds,
            masks=None, attn_mask=amask, positions=counts[:, None],
            cache={"k": gk, "v": gv, "length": cell},
            paged_decode=paged_decode)
        new_tok = sample_tokens(logits[:, -1, :], generator, temperature,
                                top_k, top_p)
        new_tok = torch.where(active, new_tok, tokens)
        counts = counts + active.to(counts.dtype)
        budget = budget - active.to(budget.dtype)
        active = active & (new_tok != eos_id) & (budget > 0)
        tokens = new_tok
        toks.append(new_tok)
    return torch.stack(toks), tokens, counts, active, budget


def _compact(gk, gv, amask) -> int:
    """Move each lane's valid cells to the front of its row, in place.
    Returns the new cursor (the longest lane)."""
    S = amask.shape[1]
    # stable argsort of ~valid puts valid cell indices first, in order
    order = torch.argsort(1 - amask, dim=1, stable=True)
    for slot in range(amask.shape[0]):
        for g in (*_leaves(gk), *_leaves(gv)):
            g[:, slot] = g[:, slot].index_select(1, order[slot])
    counts = amask.sum(dim=1).to(torch.int32)
    amask.copy_((torch.arange(S, device=amask.device)[None, :]
                 < counts[:, None]).to(amask.dtype))
    return int(counts.max())


def _concat_masks(group) -> "llama.MaskBundle | None":
    """Concatenate per-request MaskBundles along the batch axis: modality
    (M, 1, Lp) and question (1, Lp) per request."""
    if group[0].masks is None:
        return None
    if len(group) == 1:
        return group[0].masks
    return llama.MaskBundle(
        torch.cat([r.masks.modality for r in group], dim=1),
        torch.cat([r.masks.question for r in group], dim=0))


# ----------------------------------------------------------------- engine

@dataclasses.dataclass
class _Request:
    embeds: torch.Tensor        # (1, Lp, d) bucket-padded prompt embeddings
    prompt_mask: np.ndarray     # (1, Lp)
    masks: llama.MaskBundle | None
    max_new_tokens: int
    done: "queue.Queue"
    tokens: list = dataclasses.field(default_factory=list)
    # optional live token feed: every emitted token id, then None (end)
    stream: "queue.Queue | None" = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


class DecodeEngine:
    """Continuous-batching decode over a fixed slot grid.

    n_slots: concurrent decode lanes; cache_capacity: KV cells per lane;
    eos_id / pad_id: termination token / padding of returned sequences;
    use_flash / use_fused_moka: the prefill through the kernels (None = on
    for a base on the card; the fused delta only for a spec the kernel
    takes, ``decode.fused_moka_route``); paged_decode: the decode steps
    through the length-aware decode attention (None =
    ``decode.paged_decode_auto`` for the capacity, cache and device; a
    capacity above ``PAGED_BLOCK`` is then rounded up to a multiple of it,
    where the JAX engine's first step raises); kv_quant: an int8 cache.  The
    engine runs on the device of ``base["embed"]``."""

    def __init__(self, base, adapters, *, cfg: LlamaConfig,
                 spec: MokaSpec | None, n_slots: int = 8,
                 cache_capacity: int = 2048, eos_id: int = 2,
                 pad_id: int = 0, use_flash: bool | None = None,
                 use_fused_moka: bool | None = None,
                 paged_decode: bool | None = None,
                 steps_per_dispatch: int = 1,
                 cache_dtype=torch.bfloat16, kv_quant: bool = False,
                 sample_seed: int = 0, pipeline_depth: int = 1):
        self.base, self.adapters = base, adapters
        self.cfg, self.spec = cfg, spec
        self.n_slots, self.S = n_slots, cache_capacity
        self.eos_id, self.pad_id = eos_id, pad_id
        dev = base["embed"].device
        self.device = dev
        on_card = dev.type == "cuda"
        self.use_flash = on_card if use_flash is None else use_flash
        self.use_fused_moka = fused_moka_route(dev, use_fused_moka, cfg, spec)
        if paged_decode is None:
            paged_decode = paged_decode_auto(cfg, cache_capacity,
                                             kv_quant=kv_quant, device=dev,
                                             dtype=cache_dtype)
        self.paged_decode = paged_decode
        if paged_decode and cache_capacity % min(PAGED_BLOCK,
                                                 cache_capacity):
            cache_capacity = -(-cache_capacity // PAGED_BLOCK) * PAGED_BLOCK
            self.S = cache_capacity
        self.steps_per_dispatch = steps_per_dispatch
        self.cache_dtype = cache_dtype
        self.kv_quant = kv_quant
        cache = llama.init_kv_cache(cfg, n_slots, cache_capacity,
                                    dtype=cache_dtype, quantized=kv_quant,
                                    device=dev)
        self.gk, self.gv = cache["k"], cache["v"]
        self.amask = torch.zeros((n_slots, cache_capacity),
                                 dtype=torch.float32, device=dev)
        self.cur = 0                       # next shared write cell
        self.budget = np.zeros(n_slots, np.int32)   # remaining new tokens
        self._generator = torch.Generator(device=dev).manual_seed(sample_seed)
        self._dispatch_no = 0
        # device-resident lane state: each dispatch is issued from the
        # previous one's carry, before the host has read its tokens
        self.pipeline_depth = max(0, int(pipeline_depth))

        def zeros(dtype):
            return torch.zeros((n_slots,), dtype=dtype, device=dev)
        self._tokens_dev = zeros(torch.int32)
        self._counts_dev = zeros(torch.int32)
        self._active_dev = zeros(torch.bool)
        self._budget_dev = zeros(torch.int32)
        self._temp_dev = zeros(torch.float32)
        self._topk_dev = zeros(torch.int64)
        self._topp_dev = torch.ones((n_slots,), dtype=torch.float32,
                                    device=dev)
        # in-flight dispatches: (device toks (k, slots), slot snapshot)
        self._inflight: "collections.deque" = collections.deque()
        # (group, slots, device first tokens) awaiting host emission
        self._pending_admits: list = []
        self.slot_req: list[_Request | None] = [None] * n_slots
        self.pending: "collections.deque[_Request]" = collections.deque()
        self._lock = threading.Lock()
        self._stop = False
        self._thread = None

    # -- public API --------------------------------------------------------

    def submit(self, embeds, prompt_mask, masks=None,
               max_new_tokens: int = 128,
               stream: "queue.Queue | None" = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> "queue.Queue":
        """Queue one request: embeds (1, Lp, d), prompt_mask (1, Lp) 0/1
        (bucket-padded on the right), masks a MaskBundle or None.  Returns a
        Queue that receives the np.int32 token array when generation ends;
        ``stream`` receives each token id as it is emitted, then None."""
        done: queue.Queue = queue.Queue(maxsize=1)
        self.pending.append(_Request(
            torch.as_tensor(embeds, device=self.device),
            np.asarray(prompt_mask, np.float32), masks, max_new_tokens,
            done, stream=stream, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p)))
        return done

    def start(self) -> None:
        """Run the admit/step loop on a daemon thread (server mode)."""
        self._stop = False
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _serve_loop(self) -> None:
        while not self._stop:
            try:
                with self._lock:
                    self._admit()
                    busy = any(self.slot_req)
                    issued = self._issue() if busy else False
                    depth = self.pipeline_depth if busy else 0
                    if not issued:
                        depth = min(depth, max(0, len(self._inflight) - 1))
                    self._harvest_to(depth)
                    busy = busy or bool(self._inflight)
            except Exception:
                # fail every waiter instead of hanging clients, then exit
                traceback.print_exc()
                err = np.asarray([], np.int32)
                for r in self.slot_req:
                    if r is not None:
                        self._finish(r, err)
                self.slot_req = [None] * self.n_slots
                self._inflight.clear()
                while self.pending:
                    self._finish(self.pending.popleft(), err)
                self._stop = True
                return
            if not busy:
                time.sleep(0.005)

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        """Drive the engine until no pending or active request remains.
        Returns the number of decode dispatches."""
        steps = 0
        while (self.pending or any(self.slot_req) or self._inflight) \
                and steps < max_steps:
            self._admit()
            issued = False
            if any(self.slot_req):
                issued = self._issue()
                steps += int(issued)
            depth = self.pipeline_depth if any(self.slot_req) else 0
            if not issued:
                depth = min(depth, max(0, len(self._inflight) - 1))
            self._harvest_to(depth)
        return steps

    # -- scheduler internals -------------------------------------------------

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @staticmethod
    def _finish(req: _Request, tokens: np.ndarray) -> None:
        if req.stream is not None:
            req.stream.put(None)  # end-of-stream sentinel
        req.done.put(tokens)

    def _fits(self, req: _Request) -> bool:
        if int(req.prompt_mask.sum()) + req.max_new_tokens > self.S:
            self._finish(req, np.asarray([], np.int32))  # cannot fit
            return False
        return True

    def _admit(self):
        free = self._free_slots()
        while free and self.pending:
            req = self.pending.popleft()
            if not self._fits(req):
                continue
            Lp = req.embeds.shape[1]
            # batch every pending request with the same bucket and modality
            # kind into ONE prefill; the others keep their order
            group = [req]
            is_mm = req.masks is not None

            def _matches(cand: _Request) -> bool:
                if cand.embeds.shape[1] != Lp:
                    return False
                if (cand.masks is not None) != is_mm:
                    return False
                return not is_mm or (cand.masks.modality.shape
                                     == req.masks.modality.shape)

            skipped = []
            while self.pending and len(group) < len(free):
                nxt = self.pending.popleft()
                if not _matches(nxt):
                    skipped.append(nxt)
                elif self._fits(nxt):
                    group.append(nxt)
            self.pending.extendleft(reversed(skipped))
            self._dispatch_no += 1
            dev = self.device
            pmask = np.concatenate([r.prompt_mask for r in group])

            def row(vals, dtype):
                return torch.tensor(vals, dtype=dtype, device=dev)
            toks, ks, vs = _prefill(
                self.base, self.adapters, cfg=self.cfg, spec=self.spec,
                inputs_embeds=torch.cat([r.embeds for r in group]),
                prompt_mask=torch.as_tensor(pmask, device=dev),
                masks=_concat_masks(group), generator=self._generator,
                temperature=row([r.temperature for r in group],
                                torch.float32),
                top_k=row([r.top_k for r in group], torch.int64),
                top_p=row([r.top_p for r in group], torch.float32),
                use_flash=self.use_flash,
                use_fused_moka=self.use_fused_moka,
                cache_dtype=self.cache_dtype, kv_quant=self.kv_quant)
            slots = [free.pop(0) for _ in group]
            _insert(self.gk, self.gv, self.amask, ks, vs,
                    torch.as_tensor(pmask, device=dev), slots)
            # scatter the new lanes' state into the device mirrors without a
            # host sync; the first token is read in _flush_admits, after the
            # next decode dispatch is queued.  The active flag is computed on
            # the device, so an eos first token or a budget of 1 never decodes
            slots_d = torch.tensor(slots, dtype=torch.int64, device=dev)
            buds_d = row([r.max_new_tokens - 1 for r in group], torch.int32)
            self._tokens_dev[slots_d] = toks
            self._counts_dev[slots_d] = row(
                [int(r.prompt_mask.sum()) for r in group], torch.int32)
            self._budget_dev[slots_d] = buds_d
            self._active_dev[slots_d] = (toks != self.eos_id) & (buds_d > 0)
            self._temp_dev[slots_d] = row([r.temperature for r in group],
                                          torch.float32)
            self._topk_dev[slots_d] = row([r.top_k for r in group],
                                          torch.int64)
            self._topp_dev[slots_d] = row([r.top_p for r in group],
                                          torch.float32)
            self._pending_admits.append((group, slots, toks))
            for r, slot in zip(group, slots):
                self.slot_req[slot] = r
                # the prefill token is paid for here (emitted later with
                # charge=False), matching buds_d
                self.budget[slot] = r.max_new_tokens - 1
                self.cur = max(self.cur, Lp)

    def _emit(self, slot: int, tok: int, charge: bool = True):
        """Record one generated token; retire the lane on eos/budget.
        ``charge=False`` for the deferred prefill token."""
        req = self.slot_req[slot]
        req.tokens.append(tok)
        if req.stream is not None:
            req.stream.put(tok)
        if charge:
            self.budget[slot] -= 1
        if tok == self.eos_id or self.budget[slot] <= 0:
            self._finish(req, np.asarray(req.tokens, np.int32))
            self.slot_req[slot] = None
            self.amask[slot] = 0.0  # reclaimable cells

    def _flush_admits(self):
        """Host-side emission of the deferred first tokens."""
        for group, slots, toks in self._pending_admits:
            vals = toks.cpu().numpy()
            for i, slot in enumerate(slots):
                self._emit(slot, int(vals[i]), charge=False)
        self._pending_admits.clear()

    def _issue(self):
        """Queue ONE decode dispatch from the device-resident lane state.
        Returns False (issuing nothing) when every token the active lanes
        still owe is already covered by in-flight dispatches."""
        k = self.steps_per_dispatch

        # steps dispatched but not yet harvested, per lane (a lane admitted
        # after a dispatch gets nothing from it)
        def lane_inflight(i, r):
            return sum(t.shape[0] for t, snap in self._inflight
                       if snap[i] is r)
        if k > 1:
            # cap the scan at the soonest retirement when requests queue
            # (early re-admission), else at the latest; rounded up to a
            # power of two
            remaining = [self.budget[i] - lane_inflight(i, r)
                         for i, r in enumerate(self.slot_req)
                         if r is not None]
            owed = [r for r in remaining if r > 0]
            if not owed:
                if self._inflight:
                    return False
                owed = [1]
            horizon = min(owed) if self.pending else max(owed)
            cap = 1
            while cap < max(1, horizon):
                cap *= 2
            k = min(k, cap)
        elif self._inflight and not any(
                self.budget[i] - lane_inflight(i, r) > 0
                for i, r in enumerate(self.slot_req) if r is not None):
            return False
        if self.cur > self.S - k:
            # compaction reads lane occupancy: drain the pipeline first so
            # retired lanes' cells are already masked
            self._harvest_to(0)
            self.cur = _compact(self.gk, self.gv, self.amask)
            if self.cur > self.S - k:
                raise RuntimeError(
                    f"cache capacity {self.S} exhausted by active lanes")
        self._dispatch_no += 1
        (toks_d, self._tokens_dev, self._counts_dev, self._active_dev,
         self._budget_dev) = _step_multi(
            self.base, self.adapters, self.gk, self.gv, self.amask,
            self._tokens_dev, self._counts_dev, self._active_dev,
            self._budget_dev, self.cur, self._generator, self._temp_dev,
            self._topk_dev, self._topp_dev, cfg=self.cfg, spec=self.spec,
            paged_decode=self.paged_decode, n_steps=k, eos_id=self.eos_id)
        # which request held each slot at issue time: harvest emits a row
        # only while the same request still owns the slot
        self._inflight.append((toks_d, list(self.slot_req)))
        self.cur += k
        self._flush_admits()
        return True

    def _harvest_to(self, depth: int):
        """Emit tokens of in-flight dispatches until <= ``depth`` remain."""
        while len(self._inflight) > depth:
            toks_d, snapshot = self._inflight.popleft()
            toks = toks_d.cpu().numpy()  # the one host sync per dispatch
            for i in range(toks.shape[0]):
                for slot in range(self.n_slots):
                    if snapshot[slot] is None or \
                            self.slot_req[slot] is not snapshot[slot]:
                        continue
                    self._emit(slot, int(toks[i, slot]))
