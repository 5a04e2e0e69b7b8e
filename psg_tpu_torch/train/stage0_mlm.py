"""Stage 0 (MLM pretraining of the text tower): only ``load_text_init``, the
warm start stage 1 takes through ``extra.text_init``, is ported yet (port of
``psg_tpu/train/stage0_mlm.py::load_text_init``)."""

from __future__ import annotations

from pathlib import Path

from psg_tpu_torch.core.checkpoint import params_subtree, read_checkpoint
from psg_tpu_torch.models import bridge


def load_text_init(path, text_template):
    """The ``text`` subtree of an MLM (or any) checkpoint mapped onto a
    stage-1 template; the file must exist and its ``text`` fit, or this
    raises."""
    if not Path(path).exists():
        raise FileNotFoundError(f"extra.text_init checkpoint not found: {path}")
    raw = params_subtree(read_checkpoint(path))
    if "text" not in raw:
        raise ValueError(f"{path}: no 'text' parameters (keys {sorted(raw)})")
    return bridge.fit(text_template, bridge.from_jax(raw["text"]), f"{path}:text")
