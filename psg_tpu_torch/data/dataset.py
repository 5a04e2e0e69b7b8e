"""Pokemon sprite dataset (port of ``psg_tpu/data/dataset.py``).

The caption CSV and the sprites, for serving (the ``mean`` CFG negative,
retrieval seeding, the tokenizer's corpus fallback) and for training (the
seeded train/val/test split, caption variants, dataset statistics):

- semicolon-separated 2-column CSV (``name; description``) with
  ``national_number`` synthesized as row-index+1 and utf-8 -> utf-16 ->
  latin-1 encoding fallbacks;
- images ``{national_number:03d}.png`` alpha-composited onto a background
  (default white) for RGBA/LA and palette-with-transparency images, resized
  to ``image_size`` (bilinear) and kept as uint8;
- ``full_description = "Pokemon named {name}. {description}."``;
- entries with missing images are filtered out;
- ``split_indices``: the seeded 80/15/5 permutation split;
- ``set_caption_variants``: K pre-tokenized caption variants per sample
  (``caption_augment.py``), variant 0 canonical.

numpy and PIL only.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

log = logging.getLogger(__name__)

_NAMED_COLORS = {
    "white": (255, 255, 255),
    "black": (0, 0, 0),
    "gray": (128, 128, 128),
    "grey": (128, 128, 128),
}


def _resolve_background(color) -> Tuple[int, int, int]:
    if isinstance(color, str):
        if color in _NAMED_COLORS:
            return _NAMED_COLORS[color]
        raise ValueError(f"invalid background color: {color!r}")
    c = tuple(int(v) for v in color)
    if len(c) != 3:
        raise ValueError(f"invalid background color: {color!r}")
    return c


def read_description_csv(csv_path) -> List[Dict]:
    """Semicolon 2-col CSV with encoding fallbacks; returns rows with
    ``national_number``, ``english_name``, ``description``."""
    raw = Path(csv_path).read_bytes()
    text = None
    for enc in ("utf-8", "utf-16", "latin-1"):
        try:
            text = raw.decode(enc)
            break
        except (UnicodeDecodeError, UnicodeError):
            continue
    if text is None:  # pragma: no cover (latin-1 decodes any bytes)
        raise ValueError(f"could not decode {csv_path}")

    rows = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, _, desc = line.partition(";")
        desc = desc.strip()
        if desc.startswith('"') and desc.endswith('"'):
            desc = desc[1:-1]
        rows.append({
            "national_number": len(rows) + 1,
            "english_name": name.strip(),
            "description": desc,
        })
    return rows


def load_sprite(path, background: Tuple[int, int, int], image_size: int) -> np.ndarray:
    """PNG -> uint8 [H, W, 3], alpha-composited onto ``background``."""
    img = Image.open(path)
    if img.mode in ("RGBA", "LA") or (img.mode == "P" and "transparency" in img.info):
        bg = Image.new("RGB", img.size, background)
        if img.mode == "P":
            img = img.convert("RGBA")
        bg.paste(img, mask=img.split()[-1])
        img = bg
    else:
        img = img.convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.Resampling.BILINEAR)
    return np.asarray(img, np.uint8)


def full_description(name: str, description: str) -> str:
    parts = [f"Pokemon named {name}"]
    if description:
        parts.append(description)
    return ". ".join(parts) + "."


# Decoded sprites keyed by (csv, dir, size, background): decode the PNGs once
# per process, not once per dataset.  Entries are treated read-only.
_SPRITE_CACHE: Dict[tuple, tuple] = {}


class PokemonDataset:
    """In-memory dataset of composited sprites + pre-tokenized text."""

    def __init__(self, csv_path, image_dir, image_size: int = 215,
                 background_color="white", tokenizer=None, text_len: int = 128):
        self.image_size = image_size
        self.background = _resolve_background(background_color)

        cache_key = (str(csv_path), str(image_dir), image_size, self.background)
        cached = _SPRITE_CACHE.get(cache_key)
        if cached is not None:
            cached_rows, self.images = cached
            # each instance gets its own list (the cache keeps a tuple)
            self.rows = list(cached_rows)
        else:
            rows = read_description_csv(csv_path)
            image_dir = Path(image_dir)
            self.rows = []
            images = []
            missing = 0
            for row in rows:
                p = image_dir / f"{row['national_number']:03d}.png"
                if not p.exists():
                    missing += 1
                    continue
                self.rows.append(row)
                images.append(load_sprite(p, self.background, image_size))
            if missing:
                log.warning("filtered out %d entries with missing images", missing)
            self.images = np.stack(images) if images else np.zeros(
                (0, image_size, image_size, 3), np.uint8)
            self.images.setflags(write=False)
            _SPRITE_CACHE[cache_key] = (tuple(self.rows), self.images)

        self.names = [r["english_name"] for r in self.rows]
        self.descriptions = [r["description"] for r in self.rows]
        self.full_descriptions = [
            full_description(r["english_name"], r["description"]) for r in self.rows]

        self.text_len = text_len
        self.set_tokenizer(tokenizer)

    def set_tokenizer(self, tokenizer) -> None:
        """(Re-)tokenize all text with ``tokenizer`` at ``self.text_len``."""
        self.tokenizer = tokenizer
        if tokenizer is not None:
            self.text_ids, self.text_mask = tokenizer.encode_batch(
                self.full_descriptions, max_len=self.text_len)
            self.desc_ids, self.desc_mask = tokenizer.encode_batch(
                self.descriptions, max_len=self.text_len)
        else:
            self.text_ids = self.text_mask = None
            self.desc_ids = self.desc_mask = None
        self.text_ids_aug = self.text_mask_aug = None

    def set_caption_variants(self, k: int, seed: int = 0,
                             p_name_drop: float = 0.5) -> None:
        """Pre-tokenize K augmented caption variants per sample; batches
        gain ``text_ids_aug`` / ``text_mask_aug`` shaped [N, K, L] with
        variant 0 canonical.  Requires a tokenizer."""
        from psg_tpu_torch.data.caption_augment import caption_variants

        if self.tokenizer is None:
            raise ValueError("set a tokenizer before caption variants")
        variants = caption_variants(self.full_descriptions, k, seed,
                                    p_name_drop=p_name_drop)
        flat = [v for vs in variants for v in vs]
        ids, mask = self.tokenizer.encode_batch(flat, max_len=self.text_len)
        n = len(variants)
        self.text_ids_aug = ids.reshape(n, k, -1)
        self.text_mask_aug = mask.reshape(n, k, -1)

    def set_clip_tokenizer(self, bpe, length: int = 77) -> None:
        """Pre-tokenize the captions with CLIP's BPE (the stage-3 loss on a
        pretrained CLIP); batches gain ``clip_ids`` / ``clip_mask``."""
        self.clip_ids, self.clip_mask = bpe.encode_batch(self.full_descriptions, length)

    def __len__(self) -> int:
        return len(self.rows)

    def image_float(self, idx) -> np.ndarray:
        """uint8 -> fp32 in [-1, 1] (Normalize(0.5, 0.5))."""
        return self.images[idx].astype(np.float32) / 127.5 - 1.0


def split_indices(n: int, val_split: float, test_split: float,
                  seed: int = 42) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded train/val/test split: test = int(n*test), val = int(n*val),
    train = the rest, cut from one ``RandomState(seed)`` permutation."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(n * test_split)
    n_val = int(n * val_split)
    n_train = n - n_val - n_test
    return perm[:n_train], perm[n_train:n_train + n_val], perm[n_train + n_val:]


def dataset_statistics(ds: PokemonDataset, sample: int = 100) -> Dict:
    """Sample count, image size, description word counts over the first
    ``sample`` rows, and the first five names."""
    k = min(sample, len(ds))
    desc_lens = [len(d.split()) for d in ds.descriptions[:k]]
    return {
        "total_samples": len(ds),
        "image_size": ds.image_size,
        "description_length_stats": {
            "mean": float(np.mean(desc_lens)) if desc_lens else 0.0,
            "min": int(np.min(desc_lens)) if desc_lens else 0,
            "max": int(np.max(desc_lens)) if desc_lens else 0,
        },
        "sample_names": ds.names[:5],
    }
