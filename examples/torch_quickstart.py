"""Small-budget end-to-end run on the card (the port of
``examples/quickstart.py``: the reference's Kaggle-notebook recipe).

The full 3-stage pipeline at 5/5/3 epochs, batch 8, through
``psg_tpu_torch.train.cli``: a real but cheap run that leaves a checkpoint
chain and sample grids.  Extra arguments go to the CLI after the recipe's
(``--device cpu`` runs on the CPU; without a card and without it the CLI
raises).

Usage:
    python examples/torch_quickstart.py [--experiment-name quickstart]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from psg_tpu_torch.train.cli import main  # noqa: E402

RECIPE = [
    "--config", "config/train_config.yaml",
    "--stage", "all",
    "--experiment-name", "quickstart",
    "--override", "training.vae_epochs=5",
    "--override", "training.diffusion_epochs=5",
    "--override", "training.final_epochs=3",
    "--override", "data.batch_size=8",
    "--override", "training.sample_every=1",
]

if __name__ == "__main__":
    sys.exit(main([*RECIPE, *sys.argv[1:]]))
