"""A/B sweep of inference-time CFG recipes on ONE checkpoint, on the card
(the port of ``scripts/recipe_sweep.py``).

Sweeps (guidance scale, guidance rescale, guidance interval, steps,
restarts) through the serving path and scores each recipe with the
retrieval@1 of ``scripts/torch_eval_conditioning.py``.  The checkpoint is
loaded once; ``PokemonGenerator.set_guidance`` changes the knobs of the
live generator between recipes, so each recipe costs one n-caption batch.

Usage:
  python scripts/torch_recipe_sweep.py [experiment] [n] [out.json] \\
      [recipe ...] [section.key=value ...]

A recipe is a comma list, e.g. ``g=2.0,resc=0.7,lo=0.1,hi=0.8,steps=10,restarts=1``
(unset fields default to g=2.0 resc=0 lo=0 hi=1 steps=10 restarts=1).
With no recipes given, ``DEFAULT_SWEEP`` runs.  ``negative=`` (mean) and
``seed=N`` (1234) apply to the whole sweep.  Results print as one JSON
line per recipe plus a ranked table; the report goes to out.json and each
recipe's grid beside it.  Defaults: evidence_r4d, 16,
docs/recipe_sweep.json.  It runs on the card; ``device=cpu`` runs it on the
CPU, and without a card and without that flag it raises before reading a
file.  The dataset is ``config/train_config.yaml``'s unless
``data.csv_path=`` and ``data.image_dir=`` name another.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

DEFAULT_SWEEP = [
    "g=2.0",                              # chain baseline
    "g=2.0,resc=0.7",                     # CFG-rescale (Lin et al. 2023)
    "g=3.5,resc=0.7",                     # stronger guidance, rescued variance
    "g=2.0,lo=0.1,hi=0.8",                # guidance interval (Kynkäänniemi 2024)
    "g=3.5,resc=0.7,lo=0.1,hi=0.8",       # both
    "g=1.0",                              # weak-guidance control
]
RECIPE_KEYS = ("g", "resc", "lo", "hi", "steps", "restarts")


def parse_recipe(s: str) -> dict:
    r = {"g": 2.0, "resc": 0.0, "lo": 0.0, "hi": 1.0, "steps": 10, "restarts": 1}
    for part in s.split(","):
        k, v = part.split("=", 1)
        if k not in r:
            raise SystemExit(f"unknown recipe field {k!r} in {s!r}")
        r[k] = int(v) if k in ("steps", "restarts") else float(v)
    return r


def parse_args(argv):
    """-> dict of name, n, out, recipes, seed, negative, overrides, device."""
    seed, negative = 1234, "mean"
    recipes_raw, overrides, pos = [], [], []
    for a in argv:
        if a.startswith("seed="):
            seed = int(a.split("=", 1)[1])
        elif a.startswith("negative="):
            negative = a.split("=", 1)[1]
        elif "=" in a and a.split("=", 1)[0].split(",")[0] in RECIPE_KEYS:
            recipes_raw.append(a)
        elif "=" in a:
            overrides.append(a)   # config override (section.key=value, device=...)
        else:
            pos.append(a)
    return {"name": pos[0] if len(pos) > 0 else "evidence_r4d",
            "n": int(pos[1]) if len(pos) > 1 else 16,
            "out": Path(pos[2] if len(pos) > 2 else "docs/recipe_sweep.json"),
            "recipes": [parse_recipe(r) for r in (recipes_raw or DEFAULT_SWEEP)],
            "seed": seed, "negative": negative, "overrides": overrides,
            "device": "cpu" if "device=cpu" in overrides else None}


def sweep(gen, captions, real, names, recipes, *, name: str, n: int, seed: int,
          negative: str, out: Path) -> dict:
    """Every recipe on a built generator (its negative is ``negative``):
    one batch each, scored; writes each recipe's grid and the ranked
    report to ``out`` and returns the report."""
    from psg_tpu_torch.eval.metrics import conditioning_report
    from psg_tpu_torch.utils.images import save_image_grid

    rows = []
    for r in recipes:
        gen.set_guidance(scale=r["g"], rescale=r["resc"], interval_lo=r["lo"],
                         interval_hi=r["hi"])
        t0 = time.time()
        imgs = gen.generate_batch(captions, num_inference_steps=r["steps"], seed=seed,
                                  restarts=r["restarts"])
        generated = [np.asarray(im, np.float32) for im in imgs]
        rep = conditioning_report(generated, real, names=names)
        row = {"recipe": r, "retrieval_at_1": rep["retrieval_at_1"],
               "margin": rep.get("margin"), "matched_mean": rep["matched_mean"],
               "wall_s": round(time.time() - t0, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        tag = "_".join(f"{k}{v}" for k, v in r.items())
        save_image_grid(generated, out.parent / f"{out.stem}_{tag}.png", captions=captions)

    rows.sort(key=lambda x: (-x["retrieval_at_1"], -(x["margin"] or 0)))
    report = {"checkpoint": name, "n": n, "seed": seed, "negative": negative,
              "sampler": "dpmpp", "ranked": rows}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"\n# ranked (chance={1.0 / n:.3f})")
    for row in rows:
        r = row["recipe"]
        print(f"r@1={row['retrieval_at_1']:.3f} margin={row['margin']:.4f} "
              f"g={r['g']} resc={r['resc']} band=({r['lo']},{r['hi']}) "
              f"steps={r['steps']} restarts={r['restarts']} [{row['wall_s']}s]")
    return report


def main(argv=None) -> int:
    a = parse_args(sys.argv[1:] if argv is None else list(argv))
    from psg_tpu_torch.serve.generator import resolve_device

    device = resolve_device(a["device"])   # fail before any file is read
    from psg_tpu_torch.core.config import dataset_overrides
    from psg_tpu_torch.data.dataset import PokemonDataset
    from psg_tpu_torch.serve.app import build_generator

    gen = build_generator(None, a["name"], dataset_overrides() + a["overrides"],
                          sampler="dpmpp", guidance=a["recipes"][0]["g"],
                          negative=a["negative"], device=device)
    ds = PokemonDataset(gen.cfg.data.csv_path, gen.cfg.data.image_dir,
                        image_size=gen.cfg.data.image_size)
    n = a["n"]
    sweep(gen, ds.full_descriptions[:n], [ds.image_float(i) for i in range(n)],
          [r["english_name"] for r in ds.rows[:n]], a["recipes"], name=a["name"], n=n,
          seed=a["seed"], negative=a["negative"], out=a["out"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
