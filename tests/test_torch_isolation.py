"""psg_tpu_torch stands alone: importing every one of its modules loads
neither JAX nor any module of psg_tpu, and chip_smoke.py and the mesh
tests' worker (tests/torch_mesh_worker.py) import neither."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "psg_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))

_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "psg_tpu."))
                        or m == "psg_tpu")))
"""


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_modules_are_all_found():
    for name in ("serve.generator", "serve.app", "serve.hub", "data.dataset",
                 "data.synthetic", "eval.metrics", "ops.spatial_xattn", "text.bpe",
                 "models.clip", "train.stage3_final", "train.stage0_mlm",
                 "train.fastpath", "data.device_augment", "models.sd_unet",
                 "models.convert", "train.stage2_sd", "train.legacy", "utils.seed",
                 "utils.profiling", "utils.memory", "utils.attention_viz",
                 "parallel", "parallel.mesh", "parallel.sharding", "parallel.multihost",
                 "graft_entry", "core.draws"):
        assert f"psg_tpu_torch.{name}" in MODULES, name
    assert len(MODULES) >= 40


def test_bpe_needs_no_regex_package():
    """The port's BPE imports and tokenizes with the standard library's re
    where the regex package is missing (the chip machine does not list it)."""
    probe = ("import sys; sys.modules['regex'] = None; "
             "from psg_tpu_torch.text import bpe; "
             "print(bpe.PAT_REGEX is None and bpe._PAT is bpe.PAT_RE, "
             "bpe._PAT.findall(\"it's 2 red-ish lizards!\"))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True ['it', \"'s\", '2', 'red', '-', 'ish', 'lizards', '!']"


def test_serving_front_end_imports_no_optional_package():
    """gradio and huggingface_hub are imported only when the UI launches or
    the Hub is asked."""
    probe = ("import sys, psg_tpu_torch.serve.app, psg_tpu_torch.data; "
             "print([m for m in ('gradio', 'huggingface_hub', 'psg_tpu_torch.data.dataset')"
             " if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_importing_the_port_loads_no_jax_and_no_psg_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(modules=MODULES)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/torch_mesh_worker.py", *(
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "scripts").glob("torch_*.py"))), *(
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "examples").glob("torch_*.py"))), *(
    str(p.relative_to(ROOT)) for p in sorted(PORT.rglob("*.py")))])
def test_no_jax_or_psg_tpu_import_in_source(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "flax", "optax", "psg_tpu"}, roots
