"""Token sampling: temperature / top-k / top-p, vectorized over rows (port of
``moka_tpu/eval/sampling.py``).

Per-row parameters are tensors, so a continuous-batching step samples each
lane with its own settings.  Filtering follows HF: top_k <= 0 and
top_p >= 1 are off, the nucleus keeps the boundary-crossing token and is
taken over the top-k survivors, the argmax always survives, and
temperature 0 means greedy.  Sampling is Gumbel-max: the argmax of the
filtered logits plus Gumbel noise, drawn from a ``torch.Generator`` (or
given as ``gumbel``, which is how the tests feed both packages the same
noise).
"""

from __future__ import annotations

import torch


def _as_row(x, b: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device).reshape(-1)
    return t.expand(b) if t.numel() == 1 else t


def filter_logits(logits: torch.Tensor, top_k=0, top_p=1.0) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus set to the dtype's minimum.

    logits (b, V); top_k int or (b,) ints; top_p float or (b,) floats."""
    b, v = logits.shape
    top_k = _as_row(top_k, b, torch.int64, logits.device)
    top_p = _as_row(top_p, b, torch.float32, logits.device)
    neg = torch.tensor(torch.finfo(logits.dtype).min, dtype=logits.dtype,
                       device=logits.device)

    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.clamp(top_k, 1, v)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    k_off = top_k[:, None] <= 0
    out = torch.where((logits >= kth) | k_off, logits, neg)

    # nucleus over the top-k-filtered distribution: a token is dropped when
    # the probability mass before it already reaches p
    sorted_f = torch.where((sorted_desc >= kth) | k_off, sorted_desc, neg)
    probs = torch.softmax(sorted_f.float(), dim=-1)
    csum_before = torch.cumsum(probs, dim=-1) - probs
    kept_sorted = csum_before < top_p[:, None]
    inf = torch.tensor(float("inf"), dtype=sorted_f.dtype,
                       device=logits.device)
    thresh = torch.where(kept_sorted, sorted_f, inf).amin(dim=-1,
                                                          keepdim=True)
    keep_p = (out >= thresh.to(out.dtype)) | (top_p[:, None] >= 1.0)
    keep_p = keep_p | (out >= sorted_desc[:, :1])
    return torch.where(keep_p, out, neg)


def gumbel_noise(shape, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))``, u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor,
                  generator: torch.Generator | None = None,
                  temperature=1.0, top_k=0, top_p=1.0, *,
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row; rows with temperature 0 take the argmax.

    logits (b, V); the noise is ``gumbel`` if given, else drawn from
    ``generator``.  Returns (b,) int32."""
    b, v = logits.shape
    temperature = _as_row(temperature, b, torch.float32, logits.device)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temperature[:, None], min=1e-6)
    filtered = filter_logits(scaled, top_k, top_p)
    if gumbel is None:
        gumbel = gumbel_noise((b, v), generator, logits.device)
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
