"""Training CLI (port of ``psg_tpu/train/cli.py``): the JAX CLI's flags plus
``--device``.

    python -m psg_tpu_torch.train.cli [--stage 0|1|2|3|all] [--config config/train_config.yaml]
        [--vae-checkpoint PATH] [--diffusion-checkpoint PATH] [--experiment-name NAME]
        [--resume PATH] [--override section.key=value ...] [--device cpu]
    python -m psg_tpu_torch.train.cli --data-stats

``all`` (the default) runs stages 1 -> 2 -> 3, the reference's three-stage
contract; each stage's best checkpoint feeds the next.  With
``training.fast_path=true`` (``config/r3_evidence.yaml``) stages 1-3 take
the device-resident fast path (``train/fastpath.py``), whose bests are
light (bf16 sampling params): stage 2 then reads stage 1's light best and
stage 3 stage 2's.  Stage 0 (MLM pretraining of the text tower,
``train/stage0_mlm.py``) is not part of ``all``: its best warm-starts stage
1 through ``--override extra.text_init=PATH``.  ``--use-diffusers`` (the
SD-1.5 UNet for stage 2) raises ``NotImplementedError`` naming the ROADMAP
item that ports it.  Runs on the card unless ``--device cpu``.

Checkpoints follow the reference's paths:
``{experiment_dir}/{name}_{vae,diffusion,final}/checkpoints/{stage}_best_model.ckpt``.
Stage 2 reads its frozen VAE and text encoder from ``--vae-checkpoint``
(which must exist), else from stage 1's path when it exists, else draws
them from the config's seed (and says so); stage 3 reads stage 1's and
stage 2's the same way (``--vae-checkpoint``, ``--diffusion-checkpoint``).
``--resume`` resumes the stage that ``--stage`` names.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from psg_tpu_torch.core.config import load_config


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

    name = args.experiment_name
    run_all = args.stage == "all"

    def stage_input(given, stage: str):
        """The named checkpoint, else this experiment's stage path if it exists."""
        if given is not None:
            return given
        path = stage_ckpt(cfg, name, stage)
        return str(path) if path.exists() else None

    if args.stage == "0":
        from psg_tpu_torch.train.stage0_mlm import MLMPretrainer

        best = MLMPretrainer(cfg, experiment_name=name, device=args.device).train()
        print(f"stage 0 complete: {best}")
        print(f"warm-start stage 1 with --override extra.text_init={best}")
        return 0
    if args.use_diffusers and args.stage in ("2", "all"):
        raise NotImplementedError("not ported yet: --use-diffusers (the SD-UNet stage 2, "
                                  "psg_tpu/train/stage2_sd.py): ROADMAP Queue A item 6")

    vae_ckpt, diff_ckpt = args.vae_checkpoint, args.diffusion_checkpoint
    if run_all or args.stage == "1":
        from psg_tpu_torch.train.stage1_vae import VAETrainer

        t = VAETrainer(cfg, experiment_name=name, device=args.device)
        if args.resume and args.stage == "1":
            t.load_checkpoint(args.resume)
        vae_ckpt = str(t.train())
        print(f"stage 1 complete: {vae_ckpt}")
        del t

    if run_all or args.stage == "2":
        from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

        t = DiffusionTrainer(cfg, vae_checkpoint_path=stage_input(vae_ckpt, "vae"),
                             experiment_name=name, device=args.device)
        if args.resume and args.stage == "2":
            t.load_checkpoint(args.resume)
        diff_ckpt = str(t.train())
        print(f"stage 2 complete: {diff_ckpt}")
        del t

    if run_all or args.stage == "3":
        from psg_tpu_torch.train.stage3_final import FinalTrainer

        t = FinalTrainer(cfg, vae_checkpoint_path=stage_input(vae_ckpt, "vae"),
                         diffusion_checkpoint_path=stage_input(diff_ckpt, "diffusion"),
                         experiment_name=name, device=args.device)
        if args.resume and args.stage == "3":
            t.load_checkpoint(args.resume)
        best = t.train()
        print(f"stage 3 complete: {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
