"""Standalone sentencepiece ``tokenizer.model`` reader (port of
``moka_tpu/data/spm.py``; no sentencepiece dependency).

Meta-format LLaMA-2 directories ship only ``tokenizer.model``; the reference
loads it via ``AutoTokenizer.from_pretrained``
(``AudioVisualText/scripts/finetune/finetune.py:57-66``).  This module parses
the serialized ``ModelProto`` protobuf directly (wire format only — ~40
lines) and implements both sentencepiece inference algorithms:

- **BPE** (LLaMA's model_type): greedily merge the adjacent symbol pair
  whose concatenation is the highest-scoring vocab piece (ties -> leftmost),
  exactly sentencepiece's ``bpe_model.cc`` loop.
- **Unigram**: Viterbi over the piece lattice (max piece score path).

Both use byte fallback (``<0xNN>`` pieces) for out-of-vocabulary characters
when the model defines byte pieces.  Special/control pieces (``<s>``,
``</s>``) and tokens added on top (the 11 multimodal markers) are split out
of the text before encoding and each remaining text segment gets the
``▁`` dummy prefix — matching the HF fast-tokenizer behavior our
``tokenizer.json`` path produces (added-token split happens before
normalization, so every segment is prepended).
"""

from __future__ import annotations

import dataclasses
import re
import struct

_WHITESPACE = "▁"  # ▁

# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ------------------------------------------------------- protobuf wire format

def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = val = 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    value: int for varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(data, i)
        elif wire == 1:  # 64-bit
            val = struct.unpack_from("<Q", data, i)[0]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            val = data[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = struct.unpack_from("<I", data, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------- model proto

@dataclasses.dataclass
class SPModel:
    pieces: list            # [(piece, score, type), ...] in id order
    model_type: int         # 1=unigram, 2=bpe (TrainerSpec.model_type)
    add_dummy_prefix: bool
    unk_id: int
    bos_id: int
    eos_id: int

    @staticmethod
    def from_file(path: str) -> "SPModel":
        data = open(path, "rb").read()
        pieces = []
        model_type, add_dummy_prefix = 1, True
        unk_id, bos_id, eos_id = 0, 1, 2
        for field, _, val in iter_fields(data):
            if field == 1:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in iter_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", struct.pack("<I", v2))[0]
                    elif f2 == 3:
                        typ = v2
                pieces.append((piece, score, typ))
            elif field == 2:  # TrainerSpec
                for f2, _, v2 in iter_fields(val):
                    if f2 == 3:
                        model_type = v2
                    elif f2 == 40:
                        unk_id = v2
                    elif f2 == 41:
                        bos_id = v2
                    elif f2 == 42:
                        eos_id = v2
            elif field == 3:  # NormalizerSpec
                for f2, _, v2 in iter_fields(val):
                    if f2 == 3:
                        add_dummy_prefix = bool(v2)
        return SPModel(pieces, model_type, add_dummy_prefix,
                       unk_id, bos_id, eos_id)

    def __post_init__(self):
        # mergeable/matchable vocab: NORMAL + USER_DEFINED pieces only
        self.piece_to_id = {}
        self.byte_to_id = {}
        for i, (p, _, t) in enumerate(self.pieces):
            if t in (NORMAL, USER_DEFINED):
                self.piece_to_id.setdefault(p, i)
            elif t == BYTE:
                self.byte_to_id[int(p[1:-1], 16)] = i  # "<0xNN>"
        self.control_pieces = {p: i for i, (p, _, t) in
                               enumerate(self.pieces) if t == CONTROL}
        self._max_piece_len = max((len(p) for p in self.piece_to_id), default=1)

    # -- encoding --------------------------------------------------------

    def _byte_fallback(self, ch: str) -> list[int]:
        if self.byte_to_id:
            return [self.byte_to_id[b] for b in ch.encode("utf-8")]
        return [self.unk_id]

    def _encode_bpe(self, text: str) -> list[int]:
        """sentencepiece bpe_model.cc: repeatedly merge the adjacent symbol
        pair whose concatenation is the best-scoring vocab piece."""
        syms = list(text)
        if not syms:
            return []
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                cand = syms[i] + syms[i + 1]
                j = self.piece_to_id.get(cand)
                if j is None:
                    continue
                s = self.pieces[j][1]
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out = []
        for s in syms:
            j = self.piece_to_id.get(s)
            out.extend([j] if j is not None else self._byte_fallback(s))
        return out

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi best-score segmentation over the piece lattice."""
        n = len(text)
        if n == 0:
            return []
        UNK_PENALTY = 10.0
        min_score = min((s for _, s, t in self.pieces if t == NORMAL),
                        default=0.0)
        best = [-1e18] * (n + 1)
        back: list[tuple[int, list[int]] | None] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if back[i] is None and i > 0:
                continue
            for k in range(1, min(self._max_piece_len, n - i) + 1):
                sub = text[i:i + k]
                j = self.piece_to_id.get(sub)
                if j is None:
                    continue
                s = best[i] + self.pieces[j][1]
                if s > best[i + k]:
                    best[i + k] = s
                    back[i + k] = (i, [j])
            # single-char unknown fallback keeps the lattice connected
            if back[i + 1] is None or \
                    best[i] + min_score - UNK_PENALTY > best[i + 1]:
                s = best[i] + min_score - UNK_PENALTY
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, self._byte_fallback(text[i]))
        out, pos = [], n
        while pos > 0:
            prev, ids = back[pos]
            out[:0] = ids
            pos = prev
        return out

    def encode_segment(self, text: str, dummy_prefix: bool = True) -> list:
        """Encode one plain-text segment (no specials inside)."""
        text = text.replace(" ", _WHITESPACE)
        if dummy_prefix and self.add_dummy_prefix:
            text = _WHITESPACE + text
        if self.model_type == 2:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def decode_ids(self, ids) -> str:
        """Pieces -> text: byte pieces combine via utf-8, ▁ -> space,
        leading space stripped (sentencepiece DecodePieces behavior)."""
        out: list[bytes] = []
        for i in ids:
            piece, _, typ = self.pieces[i]
            if typ == BYTE:
                out.append(bytes([int(piece[1:-1], 16)]))
            elif typ == CONTROL:
                continue
            else:
                out.append(piece.replace(_WHITESPACE, " ").encode("utf-8"))
        text = b"".join(out).decode("utf-8", errors="replace")
        return text[1:] if text.startswith(" ") else text


# -------------------------------------------------- HF-shaped wrapper


class SPTokenizer:
    """tokenizers.Tokenizer-shaped wrapper over SPModel: splits special
    tokens (control pieces + added tokens) out of the text before
    sp-encoding each remaining segment, like the fast tokenizer's
    added-vocabulary split."""

    def __init__(self, model: SPModel):
        self.model = model
        self.added: dict[str, int] = {}   # token -> id (appended after base)
        self._rebuild_split()

    def _rebuild_split(self):
        specials = list(self.model.control_pieces) + list(self.added)
        self._special_ids = dict(self.model.control_pieces)
        self._special_ids.update(self.added)
        if specials:
            pat = "|".join(re.escape(s) for s in
                           sorted(specials, key=len, reverse=True))
            self._split_re = re.compile(f"({pat})")
        else:
            self._split_re = None

    # tokenizers.Tokenizer API surface used by MMTokenizer ----------------

    def get_vocab_size(self) -> int:
        return len(self.model.pieces) + len(self.added)

    def add_special_tokens(self, toks) -> int:
        n0 = len(self.added)
        for t in toks:
            t = getattr(t, "content", t)
            if t not in self._special_ids:
                self.added[t] = len(self.model.pieces) + len(self.added)
        self._rebuild_split()
        return len(self.added) - n0

    def token_to_id(self, token: str):
        if token in self._special_ids:
            return self._special_ids[token]
        return self.model.piece_to_id.get(token)

    def encode(self, text: str):
        ids: list[int] = []
        parts = (self._split_re.split(text) if self._split_re else [text])
        for part in parts:
            if not part:
                continue
            if part in self._special_ids:
                ids.append(self._special_ids[part])
            else:
                ids.extend(self.model.encode_segment(part))

        class _Enc:
            pass

        enc = _Enc()
        enc.ids = ids
        return enc

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        inv_added = {i: t for t, i in self._special_ids.items()}
        out, run = [], []
        for i in ids:
            if i in inv_added and (i >= len(self.model.pieces)
                                   or self.model.pieces[i][2] == CONTROL):
                if run:
                    out.append(self.model.decode_ids(run))
                    run = []
                if not skip_special_tokens:
                    out.append(inv_added[i])
            else:
                run.append(i)
        if run:
            out.append(self.model.decode_ids(run))
        return " ".join(x for x in out if x)
