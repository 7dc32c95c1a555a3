"""Batched generation: multimodal prefill + text-only decode loop (port of
``moka_tpu/eval/decode.py``).

Prompts are LEFT-padded, so every sample's last prompt token sits at the
same index.  The prefill carries the modality masks; each decode step uses
the text-adapter path (masks None) and attends over the cache, eagerly or,
with ``paged_decode``, through the length-aware decode attention
(``ops/paged_decode.py``: the CUDA decode kernel on the card).  The KV
cache is written in place, bf16 or int8 (``kv_quant``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.ops.moka_pallas import fused_moka_supported
from moka_tpu_torch.ops.paged_decode import HEAD_DIM, MAX_GROUP


def positions_from_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """HF-style: cumsum(mask) - 1, clipped at 0 (pad rows get position 0)."""
    return torch.clamp(torch.cumsum(attn_mask, dim=-1) - 1, min=0)


def paged_decode_auto(cfg: LlamaConfig, capacity: int, kv_quant: bool = False,
                      device: torch.device | str | None = None,
                      dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the decode steps take the length-aware paged attention.
    False off the card (the JAX package answers False off the TPU) and for
    a model the decode kernel does not take (not bf16, head_dim not 128,
    more than 8 query heads a kv head); on the card True at every
    ``capacity`` and on either cache.  JAX's capacity thresholds are the
    TPU's; on the card the paged 7B decode step won most pairings against
    the eager one at every capacity measured, 512 to 4096 cells, on both
    caches, with no crossover outside the readings' spread
    (``chip_smoke.py::paged_gate_readings``, which phase 16 holds to this
    answer)."""
    del capacity, kv_quant
    if device is None or torch.device(device).type != "cuda":
        return False
    return dtype == torch.bfloat16 and cfg.head_dim == HEAD_DIM and \
        cfg.n_heads % cfg.n_kv_heads == 0 and \
        cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP


def _on_card(t: torch.Tensor, flag: bool | None) -> bool:
    return t.device.type == "cuda" if flag is None else flag


def fused_moka_route(device: torch.device, flag: bool | None,
                     cfg: LlamaConfig, spec: MokaSpec | None) -> bool:
    """``use_fused_moka``'s route, chosen before any launch: a flag the
    caller set stands (True with a spec the kernel does not take raises at
    the first prefill); None takes the fused kernel on the card for a spec
    and projection widths it takes (``moka_pallas.fused_moka_supported``),
    and the unfused ``moka_delta`` for any other, as the JAX decode always
    runs it."""
    if flag is not None:
        return flag
    return device.type == "cuda" and all(
        fused_moka_supported(spec, d_in, d_out)
        for d_in, d_out in llama._proj_shapes(cfg).values())


PAGED_BLOCK = 256  # the paged allocation's multiple (JAX's block_k)


def prefill(base, adapters, *, cfg, spec, inputs_embeds, prompt_mask, masks,
            max_new_tokens, use_flash, use_fused_moka, kv_quant=False,
            paged_decode=False):
    """The prefill of ``greedy_generate`` / ``sample_generate``: a KV cache
    of L + max_new_tokens positions (rounded up to a multiple of
    PAGED_BLOCK for ``paged_decode``, the tail masked) is made and filled
    in place with the prompt.  Returns (final-normed hidden states (b, L,
    d), cache, the cache's (b, S) valid-key mask)."""
    b, L, _ = inputs_embeds.shape
    S = L + max_new_tokens
    if paged_decode:
        S = -(-S // PAGED_BLOCK) * PAGED_BLOCK
    cache = llama.init_kv_cache(cfg, b, S, dtype=inputs_embeds.dtype,
                                quantized=kv_quant,
                                device=inputs_embeds.device)
    cache_mask = F.pad(prompt_mask, (0, S - L))
    h, cache = llama.forward(
        base, cfg, adapters=adapters, spec=spec, inputs_embeds=inputs_embeds,
        masks=masks, attn_mask=cache_mask,
        positions=positions_from_mask(prompt_mask), cache=cache,
        use_flash=use_flash, use_fused_moka=use_fused_moka, logits=False)
    return h, cache, cache_mask


def _generate(base, adapters, *, cfg, spec, inputs_embeds, prompt_mask,
              masks, max_new_tokens, eos_id, pad_id, use_flash,
              use_fused_moka, paged_decode, kv_quant, generator=None,
              temperature=None, top_k=None, top_p=None) -> torch.Tensor:
    b, L, _ = inputs_embeds.shape
    dev = inputs_embeds.device

    def pick(step_logits):
        if temperature is None:
            return torch.argmax(step_logits, dim=-1).to(torch.int32)
        from moka_tpu_torch.eval.sampling import sample_tokens
        return sample_tokens(step_logits, generator, temperature, top_k,
                             top_p)

    h, cache, cache_mask = prefill(
        base, adapters, cfg=cfg, spec=spec, inputs_embeds=inputs_embeds,
        prompt_mask=prompt_mask, masks=masks, max_new_tokens=max_new_tokens,
        use_flash=use_flash, use_fused_moka=use_fused_moka, kv_quant=kv_quant,
        paged_decode=paged_decode)
    # only the last position's logits are read: the head runs on that row
    tok = pick(llama.head_logits(h[:, -1:], base["lm_head"])[:, 0])

    n_prompt = prompt_mask.sum(dim=-1)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for t in range(max_new_tokens):
        out.append(torch.where(done, torch.full_like(tok, pad_id), tok))
        done = done | (tok == eos_id)
        if t + 1 == max_new_tokens:
            break  # the last step's logits would be discarded
        cache_mask[:, L + t] = 1
        embeds = base["embed"][tok[:, None].long()]
        logits, cache = llama.forward(
            base, cfg, adapters=adapters, spec=spec, inputs_embeds=embeds,
            masks=None, attn_mask=cache_mask,
            positions=(n_prompt + t)[:, None], cache=cache,
            paged_decode=paged_decode)
        new_tok = pick(logits[:, -1, :])
        tok = torch.where(done, torch.full_like(new_tok, eos_id), new_tok)
    return torch.stack(out, dim=1)  # (b, max_new_tokens)


def _paged(flag, cfg, inputs_embeds, max_new_tokens, kv_quant) -> bool:
    if flag is not None:
        return flag
    return paged_decode_auto(cfg, inputs_embeds.shape[1] + max_new_tokens,
                             kv_quant=kv_quant, device=inputs_embeds.device,
                             dtype=inputs_embeds.dtype)


def greedy_generate(base: dict, adapters: dict | None, *,
                    cfg: LlamaConfig, spec: MokaSpec | None,
                    inputs_embeds: torch.Tensor, prompt_mask: torch.Tensor,
                    masks: llama.MaskBundle | None,
                    max_new_tokens: int, eos_id: int, pad_id: int = 0,
                    use_flash: bool | None = None,
                    use_fused_moka: bool | None = None,
                    paged_decode: bool | None = None,
                    kv_quant: bool = False) -> torch.Tensor:
    """Greedy decode of left-padded prompts.

    inputs_embeds (b, L, d); prompt_mask (b, L) 0/1; masks: modality masks
    over the prompt or None.  ``use_flash`` / ``use_fused_moka``: the prefill
    through the flash and fused-MokA kernels; None means on for CUDA tensors
    (the fused delta only for a spec the kernel takes: ``fused_moka_route``;
    the JAX package leaves it off by default because its TPU kernel rounds
    A to bf16; the CUDA kernel keeps A fp32).  ``paged_decode``: the
    decode steps through the length-aware decode attention (None =
    ``paged_decode_auto`` on the device and dtype of ``inputs_embeds``).
    ``kv_quant``: an int8 cache with per-(token, head) scales.  Returns
    (b, max_new_tokens) int32, pad_id after eos."""
    return _generate(
        base, adapters, cfg=cfg, spec=spec, inputs_embeds=inputs_embeds,
        prompt_mask=prompt_mask, masks=masks, max_new_tokens=max_new_tokens,
        eos_id=eos_id, pad_id=pad_id,
        use_flash=_on_card(inputs_embeds, use_flash),
        use_fused_moka=fused_moka_route(inputs_embeds.device, use_fused_moka,
                                        cfg, spec),
        paged_decode=_paged(paged_decode, cfg, inputs_embeds,
                            max_new_tokens, kv_quant),
        kv_quant=kv_quant)


def sample_generate(base: dict, adapters: dict | None, *,
                    cfg: LlamaConfig, spec: MokaSpec | None,
                    inputs_embeds: torch.Tensor, prompt_mask: torch.Tensor,
                    masks: llama.MaskBundle | None,
                    max_new_tokens: int, eos_id: int, pad_id: int = 0,
                    generator: torch.Generator | None = None,
                    temperature=1.0, top_k=0, top_p=1.0,
                    use_flash: bool | None = None,
                    use_fused_moka: bool | None = None,
                    paged_decode: bool | None = None,
                    kv_quant: bool = False) -> torch.Tensor:
    """Stochastic decode with per-sample temperature / top-k / top-p
    (scalars or (b,) tensors; temperature 0 rows run greedy).  Without a
    ``generator`` the noise comes from a fresh generator seeded 0, so the
    default is deterministic."""
    dev = inputs_embeds.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    b = inputs_embeds.shape[0]

    def row(x, dtype):
        t = torch.as_tensor(x, dtype=dtype, device=dev).reshape(-1)
        return t.expand(b) if t.numel() == 1 else t

    return _generate(
        base, adapters, cfg=cfg, spec=spec, inputs_embeds=inputs_embeds,
        prompt_mask=prompt_mask, masks=masks, max_new_tokens=max_new_tokens,
        eos_id=eos_id, pad_id=pad_id,
        use_flash=_on_card(inputs_embeds, use_flash),
        use_fused_moka=fused_moka_route(inputs_embeds.device, use_fused_moka,
                                        cfg, spec),
        paged_decode=_paged(paged_decode, cfg, inputs_embeds,
                            max_new_tokens, kv_quant),
        kv_quant=kv_quant, generator=generator,
        temperature=row(temperature, torch.float32),
        top_k=row(top_k, torch.int64), top_p=row(top_p, torch.float32))
