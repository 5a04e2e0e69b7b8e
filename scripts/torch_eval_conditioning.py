"""Quantitative text-conditioning evaluation of a checkpoint, on the card
(the port of ``scripts/eval_conditioning.py``).

Generates one sprite per dataset caption (first N species) through the
serving path, scores every generation against every REAL sprite
(``psg_tpu_torch.eval.metrics``), and prints a JSON report whose headline
is ``retrieval_at_1``: the fraction of generations that are most similar
to the very sprite their caption describes (chance = 1/N).

Usage:
  python scripts/torch_eval_conditioning.py [experiment_name] [n] [steps] \\
      [sampler] [guidance] [out.json] [restarts] [negative] [flags]

Defaults: evidence_r3b, 8, 25, dpmpp, 0.0, docs/eval_conditioning.json, 0,
zero.  Flags, as in the JAX script: ``init=retrieval`` seeds every chain
from its caption's nearest sprite, ``init=retrieval-loo`` from the nearest
OTHER sprite, ``strength=S`` is that seeding's noise strength (0.85);
``prompts=paraphrase`` swaps the captions for ``PARAPHRASES``;
``seed=N`` (1234) or ``seeds=A,B,C``: the first seed writes the given out
path and alone may stamp, each further one ``<stem>_seed<N>.json``;
``stamp=1`` records ``eval.retrieval_at_1`` and its recipe in the evaluated
checkpoint's sidecar, which serving resolution ranks by (dataset prompts
from the prior only).  Any other ``section.key=value`` is a config override.

It runs on the card; ``device=cpu`` runs it on the CPU, and without a card
and without that flag it raises before reading a file.  The dataset is
``config/train_config.yaml``'s unless ``data.csv_path=`` and
``data.image_dir=`` name another (the JAX script reads its fixed path
whatever the overrides say).
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

# Freshly worded visual descriptions of the first 16 species, with the
# species NAME deliberately omitted (dataset captions all start "Pokemon
# named X.", so name tokens are a trivial retrieval key).  Used by the
# ``prompts=paraphrase`` mode: retrieval@1 from these measures whether
# conditioning generalizes across wording, not whether caption strings
# were memorized.  The set is adversarial on purpose: evolution-line
# neighbours share a palette.
PARAPHRASES = [
    "A small four-legged dinosaur beast, pale green with dark spots, "
    "carrying a fat round plant bulb on its back",                 # Bulbasaur
    "A mid-sized green quadruped with a leafy plant and tight pink "
    "buds sprouting from its back",                                # Ivysaur
    "A huge dark green beast bearing a giant blooming flower with "
    "bright pink petals and a yellow center on its back",          # Venusaur
    "A little bright orange lizard standing upright, a small flame "
    "burning at the tip of its tail",                              # Charmander
    "A lean red-orange reptile with a horned angular head and a "
    "hot blazing tail flame",                                      # Charmeleon
    "A big orange dragon with wide leathery wings tinged blue and "
    "a roaring fiery tail",                                        # Charizard
    "A tiny light blue turtle with a glossy brown shell and a "
    "curled fluffy tail",                                          # Squirtle
    "A dark blue turtle with long furry ears and a thick ridged "
    "shell",                                                       # Wartortle
    "A massive heavy dark blue tortoise, armored shell fitted "
    "with two metal water cannons",                                # Blastoise
    "A soft bright green worm with a segmented body and a red "
    "antenna on its head",                                         # Caterpie
    "A motionless green cocoon shaped like a crescent, hard "
    "glossy angular shell",                                        # Metapod
    "A butterfly with wide white wings veined in black and a "
    "small purple-blue body",                                      # Butterfree
    "A yellow segmented grub with a pink nose and a sharp "
    "needle stinger on its head",                                  # Weedle
    "A stiff yellow cocoon with a waxy shell and two small "
    "black eyes",                                                  # Kakuna
    "A wasp with a black and yellow striped body, buzzing clear "
    "wings and two long needle arms",                              # Beedrill
    "A plump little bird with brown and cream feathers and a "
    "tiny sharp beak",                                             # Pidgey
]
# evolution families among the first 16 (for the relaxed retrieval count)
FAMILIES = [{0, 1, 2}, {3, 4, 5}, {6, 7, 8}, {9, 10, 11}, {12, 13, 14},
            {15}]

# matched by exact membership: "init=retrieval" does not fire on
# "init=retrieval-loo"
MODE_FLAGS = ("init=retrieval-loo", "init=retrieval", "prompts=paraphrase")


@dataclass
class Options:
    name: str = "evidence_r3b"
    n: int = 8
    steps: int = 25
    sampler: str = "dpmpp"
    guidance: float = 0.0
    out: Path = Path("docs/eval_conditioning.json")
    restarts: int = 0
    negative: str = "zero"
    loo: bool = False
    retrieval: bool = False
    paraphrase: bool = False
    strength: float = 0.85
    seeds: List[int] = field(default_factory=lambda: [1234])
    stamp: bool = False
    overrides: List[str] = field(default_factory=list)

    @property
    def device(self) -> Optional[str]:
        """``"cpu"`` when asked for; ``None`` (the card) otherwise."""
        return "cpu" if "device=cpu" in self.overrides else None


def parse_args(argv: List[str]) -> Options:
    """The JAX script's argument rules: positionals are the arguments
    without ``=``; mode flags match exactly; ``strength=``, ``seed=``,
    ``seeds=`` and ``stamp=`` are options; every other ``k=v`` an override."""
    o = Options(loo="init=retrieval-loo" in argv, retrieval="init=retrieval" in argv,
                paraphrase="prompts=paraphrase" in argv, stamp="stamp=1" in argv)
    for a in argv:
        if a.startswith("strength="):
            o.strength = float(a.split("=", 1)[1])
        if a.startswith("seed="):
            o.seeds = [int(a.split("=", 1)[1])]
        if a.startswith("seeds="):
            o.seeds = [int(s) for s in a.split("=", 1)[1].split(",")]
    o.overrides = [a for a in argv if "=" in a and a not in MODE_FLAGS
                   and not a.startswith(("strength=", "seed=", "seeds=", "stamp="))]
    pos = [a for a in argv if "=" not in a]
    for i, (key, kind) in enumerate((("name", str), ("n", int), ("steps", int),
                                     ("sampler", str), ("guidance", float), ("out", Path),
                                     ("restarts", int), ("negative", str))):
        if len(pos) > i:
            setattr(o, key, kind(pos[i]))
    return o


def eval_set(ds, opts: Options):
    """(captions, names, real sprites) of the first ``n`` species."""
    n = min(opts.n, len(PARAPHRASES)) if opts.paraphrase else opts.n
    captions = PARAPHRASES[:n] if opts.paraphrase else ds.full_descriptions[:n]
    names = [r["english_name"] for r in ds.rows[:n]]
    real = [ds.image_float(i) for i in range(n)]
    return captions, names, real


def _family_retrieval(generated, real) -> dict:
    """The relaxed count: the best match lands in the caption's evolution
    family (the scorer is palette-heavy, so within-family confusions are
    expected even under correct conditioning)."""
    from psg_tpu_torch.eval.metrics import pairwise_conditioning_scores

    best = pairwise_conditioning_scores(generated, real).argmax(axis=1)
    fam_of = {i: fi for fi, fam in enumerate(FAMILIES) for i in fam}
    hits = [fam_of.get(int(best[i])) == fam_of.get(i) for i in range(len(best))]
    return {"family_retrieval_at_1": float(np.mean(hits)),
            "family_chance": float(np.mean(
                [len(FAMILIES[fam_of[i]]) / len(best) for i in range(len(best))])),
            "prompts": "paraphrase"}


def _stamp(ckpt, report: dict, opts: Options, n: int, seed: int) -> None:
    """Record the headline in the evaluated checkpoint's sidecar, so serving
    resolution (``serve/hub.py``) ranks the checkpoint by MEASURED
    conditioning, not only val loss: a stage-3 final bundle shadows a
    stage-2 pair only when its stamp is not worse."""
    side = Path(ckpt).with_suffix(".json")
    meta = json.loads(side.read_text()) if side.exists() else {}
    meta.setdefault("eval", {})["retrieval_at_1"] = report["retrieval_at_1"]
    meta["eval"]["recipe"] = {
        "sampler": report["sampler"], "guidance": opts.guidance,
        "negative": opts.negative, "init": report["init"], "n": n, "seed": seed,
        "prompts": "paraphrase" if opts.paraphrase else "dataset"}
    side.write_text(json.dumps(meta, indent=2))
    print(f"stamped eval.retrieval_at_1={report['retrieval_at_1']} into {side}",
          file=sys.stderr)


def evaluate(gen, captions, real, names, opts: Options, seed: int, out: Path,
             stamp: bool = False):
    """One seed's evaluation on a built generator -> ``(generated, report)``.
    Writes ``out`` (the report), its grid ``.png`` and caption ``.txt``,
    and with ``stamp`` the checkpoint's sidecar."""
    from psg_tpu_torch.eval.metrics import conditioning_report
    from psg_tpu_torch.utils.images import pil_to_array, save_image_grid

    if opts.loo:
        # leave-one-out retrieval seeding: sprite i's generation is seeded
        # from the nearest OTHER sprite; if the prompt dominates, the output
        # should still match sprite i best
        generated = [pil_to_array(gen.generate_from_text_retrieval(
            cap, num_inference_steps=opts.steps, seed=seed + i, restarts=opts.restarts,
            exclude=i, strength=opts.strength), gen.cfg.data.image_size)
            for i, cap in enumerate(captions)]
    else:
        imgs = gen.generate_batch(captions, num_inference_steps=opts.steps, seed=seed,
                                  restarts=opts.restarts,
                                  init="retrieval" if opts.retrieval else "prior",
                                  init_strength=opts.strength)
        generated = [np.asarray(im, np.float32) for im in imgs]

    report = conditioning_report(generated, real, names=names)
    if opts.paraphrase:
        report.update(_family_retrieval(generated, real))
    report["checkpoint"] = opts.name
    report["sampler"] = f"{opts.sampler}@{opts.steps}" + (
        f"+restart{opts.restarts}" if opts.restarts else "")
    report["guidance"] = opts.guidance
    report["negative"] = opts.negative
    report["init"] = (f"retrieval-loo@{opts.strength}" if opts.loo else
                      f"retrieval@{opts.strength}" if opts.retrieval else "prior")
    if opts.retrieval or opts.loo:
        report["retrieval_mode"] = gen.retrieval_mode
    report["seed"] = seed
    out.parent.mkdir(parents=True, exist_ok=True)
    # the grid beside the JSON: generations in caption order
    save_image_grid(generated, out.with_suffix(".png"), captions=captions)
    report["grid"] = str(out.with_suffix(".png"))
    out.write_text(json.dumps(report, indent=2))
    if stamp and (opts.paraphrase or opts.loo or opts.retrieval):
        # a paraphrase stamp lives on another chance scale and a
        # retrieval-seeded one measures the crutch, not the checkpoint
        print("NOT stamping: only dataset-prompt, prior-init evals "
              "are comparable for serving resolution", file=sys.stderr)
        stamp = False
    if stamp and gen.diffusion_checkpoint:
        _stamp(gen.diffusion_checkpoint, report, opts, len(captions), seed)
    print(json.dumps({k: v for k, v in report.items() if k != "per_sprite"}))
    return generated, report


def seed_outputs(opts: Options):
    """(seed, out path, may stamp) per seed: the first seed writes ``out``."""
    out = opts.out
    return [(s, out if i == 0 else out.with_name(f"{out.stem}_seed{s}{out.suffix}"),
             opts.stamp and i == 0) for i, s in enumerate(opts.seeds)]


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else list(argv))
    from psg_tpu_torch.serve.generator import resolve_device

    device = resolve_device(opts.device)   # fail before any file is read
    from psg_tpu_torch.core.config import dataset_overrides
    from psg_tpu_torch.data.dataset import PokemonDataset
    from psg_tpu_torch.serve.app import build_generator

    gen = build_generator(None, opts.name, dataset_overrides() + opts.overrides,
                          sampler=opts.sampler, guidance=opts.guidance,
                          negative=opts.negative, device=device)
    ds = PokemonDataset(gen.cfg.data.csv_path, gen.cfg.data.image_dir,
                        image_size=gen.cfg.data.image_size)
    captions, names, real = eval_set(ds, opts)
    for seed, out, stamp in seed_outputs(opts):
        evaluate(gen, captions, real, names, opts, seed, out, stamp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
