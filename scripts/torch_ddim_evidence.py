"""Captioned sample grid from a checkpoint pair, on the card (the port of
``scripts/ddim_evidence.py``).

Loads the resolved stage-1 VAE + stage-2 UNet (or a stage-3 bundle) and
renders a captioned grid of text-conditioned sprites with the DDIM sampler
(``dpmpp`` = DPM-Solver++(2M), 10-25 steps suffice), seed 7.

Usage:
  python scripts/torch_ddim_evidence.py [experiment_name] [steps] [out.png] \\
      [guidance] [sampler] [restarts] [dataset] [negative] [init]

Defaults: evidence_r3b, 200 steps, docs/samples/ddim_sprites_r3.png, 0.0,
ddim, 0, ``PROMPTS`` (``dataset`` instead takes the first 8 dataset
captions), zero, prior.  Any ``k=v`` argument is a config override.  It
runs on the card; ``device=cpu`` runs it on the CPU, and without a card
and without that flag it raises before reading a file.  The dataset is
``config/train_config.yaml``'s unless ``data.csv_path=`` names another.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PROMPTS = [
    "A small green creature with a bulb on its back",
    "An orange lizard with a flame on its tail",
    "A blue turtle with a hard shell",
    "A yellow electric mouse with red cheeks",
    "A purple poison snake with fierce eyes",
    "A large gray rock snake",
    "A pink round creature with a curl on its forehead",
    "A brown bird with sharp talons and large wings",
]


def dataset_prompts(csv_path, n: int = 8):
    """First n training captions (name + description), so the grid is
    directly comparable to the real sprites the captions describe."""
    from psg_tpu_torch.data.dataset import full_description, read_description_csv

    return [full_description(r["english_name"], r["description"])
            for r in read_description_csv(csv_path)[:n]]


def render(gen, prompts, *, steps: int, out: Path, restarts: int = 0,
           init: str = "prior", seed: int = 7):
    """One batch of ``prompts`` on a built generator, saved as a captioned
    grid at ``out``; returns the images [N, H, W, 3] in [-1, 1]."""
    from psg_tpu_torch.utils.images import save_image_grid

    imgs = gen.generate_batch(prompts, num_inference_steps=steps, seed=seed,
                              restarts=restarts, init=init)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_image_grid(imgs, out, captions=prompts)
    return imgs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    overrides = [a for a in argv if "=" in a]
    pos = [a for a in argv if "=" not in a]
    name = pos[0] if len(pos) > 0 else "evidence_r3b"
    steps = int(pos[1]) if len(pos) > 1 else 200
    out = Path(pos[2] if len(pos) > 2 else "docs/samples/ddim_sprites_r3.png")
    guidance = float(pos[3]) if len(pos) > 3 else 0.0
    sampler = pos[4] if len(pos) > 4 else "ddim"
    restarts = int(pos[5]) if len(pos) > 5 else 0
    use_dataset = len(pos) > 6 and pos[6] == "dataset"
    negative = pos[7] if len(pos) > 7 else "zero"
    init = pos[8] if len(pos) > 8 else "prior"

    from psg_tpu_torch.serve.generator import resolve_device

    # fail before any file is read
    device = resolve_device("cpu" if "device=cpu" in overrides else None)
    from psg_tpu_torch.core.config import dataset_overrides
    from psg_tpu_torch.serve.app import build_generator

    gen = build_generator(None, name, dataset_overrides() + overrides, schedule="auto",
                          sampler=sampler, guidance=guidance, negative=negative,
                          device=device)
    prompts = dataset_prompts(gen.cfg.data.csv_path) if use_dataset else PROMPTS
    render(gen, prompts, steps=steps, out=out, restarts=restarts, init=init)
    print(f"wrote {out} ({len(prompts)} prompts, {sampler} steps={steps}, "
          f"guidance={guidance}, restarts={restarts})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
