"""Offline BERT-style WordPiece tokenizer (numpy only; same algorithm and ids
as ``psg_tpu/text/tokenizer.py``, of which this is a copy).

It loads a ``vocab.txt`` (standard BERT vocab format, one token per line) or
builds a deterministic vocabulary from a caption corpus
(``build_vocab_from_corpus``), and turns text into fixed-length ids + mask.

The basic-tokenizer (lowercase, accent strip, punctuation split) and the
greedy longest-match WordPiece algorithm follow the published BERT
tokenization spec.
"""

from __future__ import annotations

import unicodedata
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

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


def build_vocab_from_corpus(texts: Iterable[str], max_size: int = 30000,
                            min_freq: int = 1) -> List[str]:
    """Deterministic offline vocab: specials + all seen characters (with ##
    continuations) as the OOV fallback + corpus words by frequency."""
    word_counts: Counter = Counter()
    chars: set = set()
    for t in texts:
        for w in basic_tokenize(t):
            word_counts[w] += 1
            chars.update(w)
    vocab: List[str] = list(SPECIALS)
    seen = set(vocab)
    for c in sorted(chars):
        for tok in (c, f"##{c}"):
            if tok not in seen:
                vocab.append(tok)
                seen.add(tok)
    # frequency then lexicographic for determinism
    for w, n in sorted(word_counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if n < min_freq or w in seen:
            continue
        vocab.append(w)
        seen.add(w)
        if len(vocab) >= max_size:
            break
    return vocab


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

    @classmethod
    def from_corpus(cls, texts: Iterable[str], max_size: int = 30000) -> "WordPieceTokenizer":
        return cls(build_vocab_from_corpus(texts, max_size=max_size))

    def save_vocab(self, path) -> None:
        Path(path).write_text("\n".join(self.vocab) + "\n", encoding="utf-8")

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

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.vocab[int(i)] for i in ids]
        text = ""
        for t in toks:
            if t in (PAD, CLS, SEP):
                continue
            if t.startswith("##"):
                text += t[2:]
            else:
                text += (" " if text else "") + t
        return text
