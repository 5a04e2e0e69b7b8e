"""Offline BERT-style WordPiece tokenizer (numpy only; same algorithm and ids
as ``psg_tpu/text/tokenizer.py``, whose serving side this copies).

It loads a ``vocab.txt`` (standard BERT vocab format, one token per line)
and turns text into fixed-length ids + mask.  Building a vocabulary from a
training corpus belongs to the data slice and is not ported yet.

The basic-tokenizer (lowercase, accent strip, punctuation split) and the
greedy longest-match WordPiece algorithm follow the published BERT
tokenization spec.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """Whitespace + punctuation splitting with accent stripping."""
    if lower:
        text = text.lower()
    text = unicodedata.normalize("NFD", text)
    out: List[str] = []
    word: List[str] = []

    def flush():
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        if unicodedata.category(ch) == "Mn":  # strip accents
            continue
        if ch.isspace():
            flush()
        elif _is_punctuation(ch):
            flush()
            out.append(ch)
        else:
            word.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: Sequence[str], lower: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab: List[str] = list(vocab)
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(self.vocab)}
        self.lower = lower
        self.max_chars_per_word = max_chars_per_word
        for s in SPECIALS:
            if s not in self.ids:
                raise ValueError(f"vocab missing special token {s}")
        self.pad_id = self.ids[PAD]
        self.unk_id = self.ids[UNK]
        self.cls_id = self.ids[CLS]
        self.sep_id = self.ids[SEP]

    # -- construction ------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path) -> "WordPieceTokenizer":
        vocab = Path(path).read_text(encoding="utf-8").splitlines()
        return cls([v for v in vocab if v])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- tokenization ------------------------------------------------------

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.ids:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in basic_tokenize(text, self.lower):
            out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str, max_len: int = 256) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [max_len], mask [max_len]) with [CLS] ... [SEP] framing,
        truncation and [PAD] padding (matches HF padding/truncation
        semantics at fixed length)."""
        toks = self.tokenize(text)[: max_len - 2]
        ids = [self.cls_id] + [self.ids.get(t, self.unk_id) for t in toks] + [self.sep_id]
        n = len(ids)
        ids = ids + [self.pad_id] * (max_len - n)
        mask = [1] * n + [0] * (max_len - n)
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(self, texts: Sequence[str], max_len: int = 256):
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, max_len)
        return ids, mask
