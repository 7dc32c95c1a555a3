"""Tokenizer loading: HF fast tokenizer (tokenizer.json) + the 11 multimodal
special tokens (port of ``moka_tpu/data/tokenizer.py``).

Replaces ``initialize_MM_tokenizer`` (``unified_arch.py:351-377``): special
tokens are appended after the base vocab in the same order, so token ids
match a reference checkpoint whose embeddings were resized the same way.
Accepts either a fast ``tokenizer.json`` or a sentencepiece
``tokenizer.model`` (meta-format LLaMA-2 dirs ship only the latter; parsed
by ``data/spm.py`` with no sentencepiece dependency — the reference loads
it via ``AutoTokenizer``, ``finetune.py:57-66``)."""

from __future__ import annotations

import dataclasses
import os

from moka_tpu_torch.data.assembler import SPECIAL_TOKENS
from moka_tpu_torch.data.datasets import Tokenize


@dataclasses.dataclass
class MMTokenizer:
    tok: object           # tokenizers.Tokenizer
    token_to_id: dict
    pad_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text).ids

    def decode(self, ids) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=False)

    def as_tokenize(self) -> Tokenize:
        return Tokenize(encode=self.encode, token_to_id=self.token_to_id,
                        pad_id=self.pad_id, eos_id=self.eos_id)


def load_tokenizer(path: str, pad_id: int = 0, eos_id: int = 2
                   ) -> MMTokenizer:
    """path: tokenizer.json / tokenizer.model file, or a directory holding
    either (tokenizer.json preferred when both exist, like AutoTokenizer's
    fast-first resolution)."""
    if os.path.isdir(path):
        for name in ("tokenizer.json", "tokenizer.model"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".model"):
        from moka_tpu_torch.data.spm import SPModel, SPTokenizer
        model = SPModel.from_file(path)
        tok = SPTokenizer(model)
        eos_id = model.eos_id
        tok.add_special_tokens(SPECIAL_TOKENS)
    else:
        from tokenizers import AddedToken, Tokenizer
        tok = Tokenizer.from_file(path)
        tok.add_special_tokens(
            [AddedToken(t, special=True) for t in SPECIAL_TOKENS])
    token_to_id = {t: tok.token_to_id(t) for t in SPECIAL_TOKENS}
    return MMTokenizer(tok=tok, token_to_id=token_to_id, pad_id=pad_id,
                       eos_id=eos_id, vocab_size=tok.get_vocab_size())
