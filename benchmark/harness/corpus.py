"""Synthetic captions and sprites made from a seed, in the dataset's format.

The pattern is ``psg_tpu_torch/data/synthetic.py``; this copy belongs to the
benchmark, so both the program and the reference read what it writes.
"""

from __future__ import annotations

from pathlib import Path

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
MAX_SPRITES = len(COLORS) * len(TYPES) * len(FEATURES)


def captions(rng: np.random.Generator, n: int):
    """``n`` (name, description) pairs, each with its own (colour, type,
    feature) triple while ``n`` <= 1728."""
    nt, nf = len(TYPES), len(FEATURES)
    triples = rng.permutation(MAX_SPRITES)[:n] if n <= MAX_SPRITES else \
        rng.integers(0, MAX_SPRITES, n)
    out = []
    for i in triples:
        name = "".join(SYLLABLES[j] for j in rng.integers(0, len(SYLLABLES), 3)).title()
        color = list(COLORS)[i // (nt * nf)]
        out.append((name, f"A {color} {TYPES[i // nf % nt]}-type creature with "
                          f"{FEATURES[i % nf]}"))
    return out


def write_csv(path, rows) -> Path:
    """The semicolon caption CSV the dataset reader takes."""
    path = Path(path)
    path.write_text("".join(f'{name}; "{desc}"\n' for name, desc in rows))
    return path


def write_vocab(path, rows) -> int:
    """The WordPiece vocabulary of the rows' full descriptions, written to
    ``path`` for both the program and the reference to read; its size."""
    from benchmark.reference.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_corpus([f"Pokemon named {n}. {d}." for n, d in rows])
    tok.save_vocab(path)
    return tok.vocab_size


def prompts(rng: np.random.Generator, n: int):
    """``n`` user prompts in the corpus's words."""
    return [desc for _, desc in captions(rng, n)]


def write_sprites(image_dir, n: int, rng: np.random.Generator, size: int = 96) -> Path:
    """``n`` sprites ``001.png`` ... (RGBA, palette with a transparent index,
    and plain RGB, in turn), each a coloured ellipse with an eye."""
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    colors = list(COLORS.values())
    for i in range(n):
        color = colors[int(rng.integers(0, len(colors)))]
        box = sorted(rng.integers(size // 8, size - size // 8, 2)), \
            sorted(rng.integers(size // 8, size - size // 8, 2))
        ellipse = [int(box[0][0]), int(box[1][0]), int(box[0][1]) + 4, int(box[1][1]) + 4]
        eye = [size // 2 - 4, size // 3, size // 2 + 4, size // 3 + 8]
        mode = ("RGBA", "P", "RGB")[i % 3]
        if mode == "P":
            img = Image.new("P", (size, size), 0)
            img.putpalette([0, 0, 0, *color, 255, 255, 255] + [0] * 759)
            draw = ImageDraw.Draw(img)
            draw.ellipse(ellipse, fill=1)
            draw.rectangle(eye, fill=2)
            img.save(image_dir / f"{i + 1:03d}.png", transparency=0)
            continue
        img = Image.new(mode, (size, size), (255, 255, 255, 0) if mode == "RGBA"
                        else (250, 250, 250))
        draw = ImageDraw.Draw(img)
        draw.ellipse(ellipse, fill=color)
        draw.rectangle(eye, fill=(255, 255, 255))
        img.save(image_dir / f"{i + 1:03d}.png")
    return image_dir
