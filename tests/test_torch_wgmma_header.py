"""``psg_tpu_torch/csrc/wgmma.cuh`` is written by ``scripts/torch_gen_wgmma.py``
and committed: the two must agree, or a hand edit of the header (or an edit
of the script that was never run) would reach the kernels' builds unseen."""

import importlib.util
from pathlib import Path

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_gen_wgmma.py"


def test_wgmma_header_is_the_generators_output():
    spec = importlib.util.spec_from_file_location("torch_gen_wgmma", SCRIPT)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.OUT.read_text() == gen.render(), (
        f"{gen.OUT} differs from the output of {SCRIPT}: run the script")
