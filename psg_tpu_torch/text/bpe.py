"""CLIP byte-pair-encoding tokenizer (port of ``psg_tpu/text/bpe.py``; the
package keeps its own copy).

OpenAI CLIP's ``SimpleTokenizer`` from a ``vocab.json`` (token -> id) and a
rank-ordered ``merges.txt`` (the first line may be a ``#version`` header).
Converted ``openai/clip-vit-base-patch32`` weights are only usable with this
exact BPE: token ids index the pretrained embedding table.  Text is
html-unescaped, whitespace-collapsed and lower-cased (no ``ftfy``), which is
the original's cleaning for ASCII captions.

Pre-tokenization uses the ``regex`` package's Unicode classes (``\\p{L}``,
``\\p{N}``) where it is installed, and otherwise the standard library's
``re`` with the equivalent classes (``[^\\W\\d_]`` for letters, ``\\d`` for
digits), so the package does not need ``regex``.  The two give the same
tokens on ASCII text.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPECIAL = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
# the standard library's branch: letters are word characters that are not
# digits or '_'
PAT_RE = re.compile(_SPECIAL + r"""[^\W\d_]+|\d|[^\s\w]+""", re.IGNORECASE)
try:  # perl-compatible classes, as in the original
    import regex as _regex

    PAT_REGEX = _regex.compile(_SPECIAL + r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                               _regex.IGNORECASE)
except ImportError:
    PAT_REGEX = None
_PAT = PAT_REGEX or PAT_RE


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class ClipBPETokenizer:
    """encode(text) -> BPE ids; encode_batch -> [sot, ids..., eot], padded
    or truncated to 77."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, encoder: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = encoder
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.sot_id = encoder[self.SOT]
        self.eot_id = encoder[self.EOT]
        self.vocab_size = len(encoder)
        self._cache = {self.SOT: self.SOT, self.EOT: self.EOT}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_json, merges_txt) -> "ClipBPETokenizer":
        encoder = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        lines = Path(merges_txt).read_text(encoding="utf-8").splitlines()
        if lines and (lines[0].startswith("#") or " " not in lines[0]):
            lines = lines[1:]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(encoder, merges)

    @classmethod
    def find(cls, directory="weights") -> Optional["ClipBPETokenizer"]:
        """``clip_vocab.json`` and ``clip_merges.txt`` from
        ``$PSG_TPU_CLIP_BPE`` or ``directory``.  A directory the environment
        names must hold both files, or this raises; the default directory
        without them gives None."""
        named = os.environ.get("PSG_TPU_CLIP_BPE")
        d = Path(named or directory)
        v, m = d / "clip_vocab.json", d / "clip_merges.txt"
        if v.exists() and m.exists():
            return cls.from_files(v, m)
        if named:
            raise FileNotFoundError(f"PSG_TPU_CLIP_BPE names {d}, which lacks "
                                    f"clip_vocab.json or clip_merges.txt")
        return None

    # -- BPE -----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _PAT.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def encode_batch(self, texts: Sequence[str], length: int = 77
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [N, length], mask [N, length]): sot ... eot, zero-padded
        (CLIPProcessor(padding='max_length', truncation=True))."""
        out = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot_id] + self.encode(t)[: length - 2] + [self.eot_id]
            out[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return out, mask
