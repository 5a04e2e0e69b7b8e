"""A small sprite corpus made from a seed, in the dataset's on-disk format.

``write_sprite_corpus`` writes a semicolon caption CSV and ``NNN.png``
sprites (RGBA, palette with a transparent index, and plain RGB, in turn), so
the paths that read the dataset (the ``mean`` CFG negative, retrieval
seeding, the tokenizer's corpus fallback) run without the real 898-sprite
dataset.  Up to 12 sprites, each caption takes its own colour, type and
feature, so no two captions share their content words and retrieval has no
near ties; a larger corpus (a training epoch of several batches) gives each
sprite its own (colour, type, feature) triple.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw

COLORS = {"red": (220, 40, 40), "blue": (40, 80, 220), "green": (40, 170, 60),
          "yellow": (240, 210, 40), "purple": (140, 60, 180), "orange": (245, 140, 30),
          "pink": (240, 130, 190), "brown": (130, 80, 40), "black": (20, 20, 20),
          "teal": (30, 150, 150), "grey": (128, 128, 128), "cyan": (60, 220, 230)}
TYPES = ("fire", "water", "grass", "electric", "psychic", "rock", "ghost", "ice",
         "dragon", "bug", "steel", "fairy")
FEATURES = ("a flame on its tail", "a hard shell", "a leaf on its head", "round cheeks",
            "a long whip tail", "sharp claws", "big glowing eyes", "a spiral horn",
            "two small wings", "a crystal crest", "striped fur", "a curled antenna")
SYLLABLES = ("bu", "la", "zor", "mi", "ka", "to", "ren", "vy", "po", "sha", "qui", "dex")

UNIQUE_WORDS = len(TYPES)
MAX_SPRITES = len(COLORS) * len(TYPES) * len(FEATURES)


def write_sprite_corpus(root, n: int = 8, seed: int = 0, size: int = 96,
                        encoding: str = "utf-8") -> Tuple[Path, Path]:
    """Write ``n`` (<= 1728) sprites and their captions under ``root``;
    returns ``(csv_path, image_dir)``."""
    if not 1 <= n <= MAX_SPRITES:
        raise ValueError(f"n must be in 1..{MAX_SPRITES}")
    rng = np.random.RandomState(seed)
    root = Path(root)
    image_dir = root / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    if n <= UNIQUE_WORDS:
        colors = [list(COLORS)[i] for i in rng.permutation(len(COLORS))[:n]]
        types = [TYPES[i] for i in rng.permutation(len(TYPES))[:n]]
        feats = [FEATURES[i] for i in rng.permutation(len(FEATURES))[:n]]
    else:
        nt, nf = len(TYPES), len(FEATURES)
        triples = rng.permutation(MAX_SPRITES)[:n]
        colors = [list(COLORS)[i // (nt * nf)] for i in triples]
        types = [TYPES[i // nf % nt] for i in triples]
        feats = [FEATURES[i % nf] for i in triples]
    lines = []
    for i in range(n):
        name = "".join(SYLLABLES[j] for j in rng.randint(0, len(SYLLABLES), 3)).title()
        lines.append(f'{name}; "A {colors[i]} {types[i]}-type creature with {feats[i]}"')
        box = sorted(rng.randint(size // 8, size - size // 8, 2)), \
            sorted(rng.randint(size // 8, size - size // 8, 2))
        ellipse = [box[0][0], box[1][0], box[0][1] + 4, box[1][1] + 4]
        eye = [size // 2 - 4, size // 3, size // 2 + 4, size // 3 + 8]
        mode = ("RGBA", "P", "RGB")[i % 3]
        if mode == "P":   # palette image whose index 0 is transparent
            img = Image.new("P", (size, size), 0)
            img.putpalette([0, 0, 0, *COLORS[colors[i]], 255, 255, 255] + [0] * 759)
            draw = ImageDraw.Draw(img)
            draw.ellipse(ellipse, fill=1)
            draw.rectangle(eye, fill=2)
            img.save(image_dir / f"{i + 1:03d}.png", transparency=0)
            continue
        img = Image.new(mode, (size, size), (255, 255, 255, 0) if mode == "RGBA"
                        else (250, 250, 250))
        draw = ImageDraw.Draw(img)
        draw.ellipse(ellipse, fill=COLORS[colors[i]])
        draw.rectangle(eye, fill=(255, 255, 255))
        img.save(image_dir / f"{i + 1:03d}.png")
    csv_path = root / "captions.csv"
    csv_path.write_bytes(("\n".join(lines) + "\n").encode(encoding))
    return csv_path, image_dir
