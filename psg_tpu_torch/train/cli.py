"""Training CLI (port of ``psg_tpu/train/cli.py``): the JAX CLI's flags plus
``--device``.

    python -m psg_tpu_torch.train.cli --stage 1|2 [--config config/train_config.yaml]
        [--vae-checkpoint PATH] [--experiment-name NAME] [--resume PATH]
        [--override section.key=value ...] [--device cpu]
    python -m psg_tpu_torch.train.cli --data-stats

Stages 1 (``train/stage1_vae.py``) and 2 (``train/stage2_diffusion.py``) and
``--data-stats`` are ported.  Stages 0, 3 and ``all``, and
``--use-diffusers``, raise ``NotImplementedError`` naming the ROADMAP item
that ports them, so that nothing runs half a pipeline.  Runs on the card
unless ``--device cpu``.

Stage 1 writes ``{experiment_dir}/{name}_vae/checkpoints/vae_best_model.ckpt``.
Stage 2 reads its frozen VAE and text encoder from ``--vae-checkpoint``,
which must exist, else from that stage-1 path when it exists, else draws
them from the config's seed (and says so).  ``--resume`` resumes the stage
that runs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from psg_tpu_torch.core.config import load_config

_NOT_PORTED = {
    "0": "stage 0 (MLM pretraining, psg_tpu/train/stage0_mlm.py): ROADMAP Queue A item 5",
    "3": "stage 3 (final, psg_tpu/train/stage3_final.py): ROADMAP Queue A item 3",
    "all": "--stage all needs stage 3 (ROADMAP Queue A item 3)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Pokemon sprite generator training "
                                            "(PyTorch port)")
    p.add_argument("--config", type=str, default="config/train_config.yaml")
    p.add_argument("--stage", type=str, default="all", choices=["0", "1", "2", "3", "all"])
    p.add_argument("--use-diffusers", action="store_true",
                   help="stage 2 on the SD-1.5-family UNet (not ported)")
    p.add_argument("--vae-checkpoint", type=str, default=None)
    p.add_argument("--diffusion-checkpoint", type=str, default=None)
    p.add_argument("--experiment-name", type=str, default="pokemon")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume the active stage from")
    p.add_argument("--data-stats", action="store_true",
                   help="print dataset statistics and exit")
    p.add_argument("--override", action="append", default=[],
                   help="config override, e.g. training.diffusion_epochs=3")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    return p


def stage_ckpt(cfg, name: str, stage: str) -> Path:
    return (Path(cfg.experiment_dir) / f"{name}_{stage}" / "checkpoints"
            / f"{stage}_best_model.ckpt")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config if Path(args.config).exists() else None,
                      overrides=args.override)

    if args.data_stats:
        from psg_tpu_torch.data.dataset import PokemonDataset, dataset_statistics

        ds = PokemonDataset(cfg.data.csv_path, cfg.data.image_dir,
                            image_size=cfg.data.image_size,
                            background_color=cfg.data.background_color)
        for k, v in dataset_statistics(ds).items():
            print(f"{k}: {v}")
        return 0

    if args.stage in _NOT_PORTED:
        raise NotImplementedError(f"not ported yet: {_NOT_PORTED[args.stage]}")
    if args.use_diffusers:
        raise NotImplementedError("not ported yet: --use-diffusers (the SD-UNet stage 2, "
                                  "psg_tpu/train/stage2_sd.py): ROADMAP Queue A item 6")

    if args.stage == "1":
        from psg_tpu_torch.train.stage1_vae import VAETrainer

        t = VAETrainer(cfg, experiment_name=args.experiment_name, device=args.device)
        if args.resume:
            t.load_checkpoint(args.resume)
        best = t.train()
        print(f"stage 1 complete: {best}")
        return 0

    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    vae_ckpt = args.vae_checkpoint
    if vae_ckpt is None and stage_ckpt(cfg, args.experiment_name, "vae").exists():
        vae_ckpt = str(stage_ckpt(cfg, args.experiment_name, "vae"))
    t = DiffusionTrainer(cfg, vae_checkpoint_path=vae_ckpt,
                         experiment_name=args.experiment_name, device=args.device)
    if args.resume:
        t.load_checkpoint(args.resume)
    best = t.train()
    print(f"stage 2 complete: {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
