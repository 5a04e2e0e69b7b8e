"""Helpers every training stage shares (the JAX package keeps them in
``psg_tpu/train/stage1_vae.py``, which stage 2 imports)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from psg_tpu_torch.text.tokenizer import WordPieceTokenizer


def device_batch(batch, device):
    """A loader batch's image, ids and mask (and CLIP's BPE ids and mask
    where the batch has them) as tensors on ``device``."""
    out = {"image": torch.from_numpy(np.asarray(batch["image"])).to(device)}
    for k in ("text_ids", "text_mask", "clip_ids", "clip_mask"):
        if k in batch:
            out[k] = torch.from_numpy(np.asarray(batch[k])).long().to(device)
    return out


def get_tokenizer(cfg, stage_dir: Path, corpus=None) -> WordPieceTokenizer:
    """vocab.txt resolution: the stage dir, the experiment dir,
    ``config/vocab.txt``; then the pretrained-BERT vocabulary when both
    ``$PSG_TPU_BERT`` and ``$PSG_TPU_BERT_VOCAB`` exist; else a vocabulary
    built from ``corpus``.  The winner is saved to the stage dir, so later
    stages resolve the same one."""
    for cand in (stage_dir / "vocab.txt", Path(cfg.experiment_dir) / "vocab.txt",
                 Path("config/vocab.txt")):
        if cand.exists():
            return WordPieceTokenizer.from_vocab_file(cand)
    bert_ckpt = Path(os.environ.get("PSG_TPU_BERT", "weights/bert_base.ckpt"))
    bert_vocab = Path(os.environ.get("PSG_TPU_BERT_VOCAB", "weights/bert_vocab.txt"))
    if bert_vocab.exists() and bert_ckpt.exists():
        tok = WordPieceTokenizer.from_vocab_file(bert_vocab)
    elif corpus is not None:
        tok = WordPieceTokenizer.from_corpus(corpus)
    else:
        raise FileNotFoundError("no vocab.txt found and no corpus provided")
    stage_dir.mkdir(parents=True, exist_ok=True)
    tok.save_vocab(stage_dir / "vocab.txt")
    return tok
