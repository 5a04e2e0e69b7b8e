"""Train-time caption augmentation: offline substitute for pretrained BERT
(a copy of ``psg_tpu/data/caption_augment.py``, with the same
``np.random.RandomState`` draws, so both packages make the same variants).

The reference buys wording generalization with a pretrained BERT text
encoder (src/models/text_encoder.py:30-40).  On a zero-egress box the
text encoder trains from scratch on 898 captions, every one of which
starts "Pokemon named X." — so the model can bind generations to the
name token and to sentence *positions* instead of to visual content
words, and name-free paraphrases condition at chance (round-3
docs/eval_conditioning_paraphrase.json).

This module generates K deterministic text-level variants per caption
for stage-2/3 training (config ``extra.caption_augment = K``):

- variant 0 is always the canonical ``full_description`` (the serving
  and validation distribution);
- other variants independently apply: NAME DROP (the "Pokemon named X."
  prefix removed, p=0.5) so name tokens cannot be the only retrieval
  key; SENTENCE SHUFFLE (p=0.5) so content is not bound to position in
  the 128-token window — shuffling also rotates which sentences survive
  truncation, widening effective text coverage; and SENTENCE DROPOUT
  (each body sentence dropped with p=0.2, at least 2 kept) so no single
  sentence is load-bearing.

Variants are plain strings, pre-tokenized once by the dataset
(``PokemonDataset.set_caption_variants``); the training loader draws a
variant index per sample per step.  Everything is seeded —
the same (seed, K) always yields the same variant strings.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

# Dotted species names ("Mr. Mime", "Mime Jr.", "Mr. Rime") never reach
# this regex intact: the source CSV itself splits them at the first
# period ("Mr; Mime. …"), so english_name is already "Mr"/"Mime" by
# parse time — identically in the reference's pandas read (dataset
# noise shared with src/data/dataset_improved.py, not ours to repair).
_NAME_RE = re.compile(r"^\s*Pokemon named [^.]*\.\s*")


def split_sentences(text: str) -> List[str]:
    """Split on sentence boundaries, keeping non-empty parts."""
    parts = re.split(r"(?<=\.)\s+", text.strip())
    return [p.strip() for p in parts if p.strip(" .")]


def strip_name(full_desc: str) -> str:
    """Remove the leading 'Pokemon named X.' sentence if present."""
    return _NAME_RE.sub("", full_desc, count=1)


def augment_caption(full_desc: str, rng: np.random.RandomState,
                    p_name_drop: float = 0.5, p_shuffle: float = 0.5,
                    p_sent_drop: float = 0.2, min_sentences: int = 2) -> str:
    """One augmented variant of ``full_desc`` (seeded by ``rng``)."""
    body = strip_name(full_desc)
    has_name = body != full_desc
    sents = split_sentences(body)
    if len(sents) > min_sentences and p_sent_drop > 0.0:
        keep = rng.rand(len(sents)) >= p_sent_drop
        if keep.sum() < min_sentences:
            # force-keep a random subset of min_sentences
            keep[:] = False
            keep[rng.choice(len(sents), min_sentences, replace=False)] = True
        sents = [s for s, k in zip(sents, keep) if k]
    if len(sents) > 1 and rng.rand() < p_shuffle:
        order = rng.permutation(len(sents))
        sents = [sents[i] for i in order]
    out = " ".join(s if s.endswith(".") else s + "." for s in sents)
    if has_name and rng.rand() >= p_name_drop:
        prefix = _NAME_RE.match(full_desc).group(0).strip()
        out = f"{prefix} {out}"
    return out


def caption_variants(full_descriptions: Sequence[str], k: int,
                     seed: int = 0,
                     p_name_drop: float = 0.5) -> List[List[str]]:
    """K variants per caption; ``out[i][0]`` is always the canonical
    caption.  Deterministic in (seed, k, p_name_drop).

    ``p_name_drop`` exists because round 4 measured that dropping the
    "Pokemon named X." prefix at the default 0.5 collapses name-keyed
    conditioning (retrieval@1 0.375 -> 0.0); a name-preserving fine-tune
    sets it to 0 and keeps only sentence shuffle/dropout."""
    out = []
    for i, desc in enumerate(full_descriptions):
        rng = np.random.RandomState(
            np.random.RandomState(seed).randint(1 << 31) ^ (i * 2654435761 % (1 << 31)))
        variants = [desc]
        for _ in range(max(k - 1, 0)):
            variants.append(augment_caption(desc, rng, p_name_drop=p_name_drop))
        out.append(variants)
    return out
